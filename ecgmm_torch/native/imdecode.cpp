// Host kernels of the upload decoder (ecgmm_torch/serve/imdecode.py): the
// Huffman entropy decoding of a baseline JPEG scan, libjpeg's accurate
// integer inverse DCT (jidctint.c, "ISLOW", with its post-IDCT range
// limit), its fancy upsampling (jdsample.c) and YCbCr->RGB conversion
// (jdcolor.c), PNG's row unfiltering, GIF's LZW codes and BMP's RLE8 and
// RLE4 runs (as Pillow's decoders read them). Plain C interface, loaded with
// ctypes; the Python side parses the markers and chunks and checks every
// size before it passes a pointer.
//
// Every entry point returns 0 on success and a negative code otherwise
// (ERR_* below); imdecode.py maps the codes to messages.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum {
  ERR_BAD_HUFFMAN_TABLE = -1,
  ERR_BAD_HUFFMAN_CODE = -2,
  ERR_BAD_PNG_FILTER = -3,
  ERR_BAD_LZW_CODE = -4,
  ERR_TRUNCATED_LZW = -5,
  ERR_TRUNCATED_RLE_DELTA = -6,
};

// zigzag position -> natural (row-major) position; the 16 extra entries
// absorb a run past the 63rd coefficient in corrupt data, as libjpeg's
// jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  // canonical decoding per code length l (1..16): codes in
  // [mincode[l], maxcode[l]] map to vals[valptr[l] + code - mincode[l]]
  int32_t mincode[17];
  int32_t maxcode[18];
  int32_t valptr[17];
  uint8_t vals[256];
  // the first kLookBits bits -> (length << 8 | value), 0 where longer
  uint16_t look[1 << kLookBits];

  bool build(const uint8_t* bits, const uint8_t* huffval) {
    int n = 0;
    for (int l = 1; l <= 16; ++l) n += bits[l];
    if (n > 256) return false;
    std::memcpy(vals, huffval, 256);
    std::memset(look, 0, sizeof(look));
    int32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
      // libjpeg refuses a table whose codes of a length run out (the
      // all-ones code is reserved); checked before `look` is filled, so
      // an over-subscribed table never indexes past it
      if (code + bits[l] >= (1 << l)) return false;
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        if (l <= kLookBits) {
          int shift = kLookBits - l;
          for (int j = 0; j < (1 << shift); ++j)
            look[(code << shift) | j] = uint16_t((l << 8) | vals[k]);
        }
      }
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    return true;
  }
};

// Entropy-coded data: byte-stuffed 0xFF00 is a data 0xFF; a marker ends
// the data, after which zero bits are fed (libjpeg's fill_bit_buffer does
// the same for data that ends early).
struct BitReader {
  const uint8_t* buf;
  int64_t len;
  int64_t pos;
  uint64_t acc = 0;
  int nbits = 0;
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      if (!at_marker && pos < len) {
        byte = buf[pos];
        if (byte == 0xFF) {
          int64_t p = pos + 1;
          while (p < len && buf[p] == 0xFF) ++p;  // fill bytes
          if (p < len && buf[p] == 0x00) {
            pos = p + 1;
          } else {
            at_marker = true;
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= uint64_t(byte) << (56 - nbits);
      nbits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return uint32_t(acc >> (64 - n));
  }
  void skip(int n) {
    acc <<= n;
    nbits -= n;
  }
  uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  // Discard the buffered bits and consume a restart marker (RST0-7), as
  // libjpeg's process_restart does for well-formed data.
  void restart() {
    acc = 0;
    nbits = 0;
    at_marker = false;
    while (pos < len && buf[pos] != 0xFF) ++pos;
    while (pos < len && buf[pos] == 0xFF) ++pos;
    if (pos < len && buf[pos] >= 0xD0 && buf[pos] <= 0xD7) {
      ++pos;
    } else if (pos > 0) {
      --pos;  // not a restart marker: leave it for the marker parser
    }
  }
  // Byte offset just after the scan's data (the next marker).
  int64_t end() const {
    int64_t p = pos;
    while (p < len && !(buf[p] == 0xFF && p + 1 < len && buf[p + 1] != 0x00))
      ++p;
    return p;
  }
};

inline int decode(BitReader& br, const Huffman& h, int* err) {
  uint32_t look = br.peek(kLookBits);
  uint16_t e = h.look[look];
  if (e) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  int l = kLookBits + 1;
  int32_t code = int32_t(br.peek(l));
  while (l <= 16 && code > h.maxcode[l]) {
    ++l;
    code = int32_t(br.peek(l));
  }
  if (l > 16) {
    *err = ERR_BAD_HUFFMAN_CODE;
    br.skip(16);
    return 0;
  }
  br.skip(l);
  return h.vals[h.valptr[l] + code - h.mincode[l]];
}

inline int extend(uint32_t v, int s) {
  return int(v) < (1 << (s - 1)) ? int(v) - (1 << s) + 1 : int(v);
}

// ---- libjpeg's jidctint.c (jpeg_idct_islow), 8-bit samples ----
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// libjpeg's post-IDCT range limit: sample = table[v & 1023], which
// clamps to [0, 255] for |v| up to 512 and wraps beyond (corrupt data)
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int k = 0; k < 1024; ++k) {
      int v = k < 512 ? k : k - 1024;  // the signed value with these bits
      int s = v + 128;
      if (k >= 128 && k < 512) s = 255;
      if (k >= 512 && k < 896) s = 0;
      t[k] = uint8_t(s);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                int64_t stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int dc = int(ip[0]) * int(qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS - PASS1_BITS;
    wp[0] = int(descale(tmp10 + tmp3, n));
    wp[56] = int(descale(tmp10 - tmp3, n));
    wp[8] = int(descale(tmp11 + tmp2, n));
    wp[48] = int(descale(tmp11 - tmp2, n));
    wp[16] = int(descale(tmp12 + tmp1, n));
    wp[40] = int(descale(tmp12 - tmp1, n));
    wp[24] = int(descale(tmp13 + tmp0, n));
    wp[32] = int(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t dc = kRange.t[descale(wp[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = dc;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << CONST_BITS);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS + PASS1_BITS + 3;
    op[0] = kRange.t[descale(tmp10 + tmp3, n) & 1023];
    op[7] = kRange.t[descale(tmp10 - tmp3, n) & 1023];
    op[1] = kRange.t[descale(tmp11 + tmp2, n) & 1023];
    op[6] = kRange.t[descale(tmp11 - tmp2, n) & 1023];
    op[2] = kRange.t[descale(tmp12 + tmp1, n) & 1023];
    op[5] = kRange.t[descale(tmp12 - tmp1, n) & 1023];
    op[3] = kRange.t[descale(tmp13 + tmp0, n) & 1023];
    op[4] = kRange.t[descale(tmp13 - tmp0, n) & 1023];
  }
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" {

// Decode one baseline (sequential, Huffman) scan into the quantised
// coefficients of its components, natural order, 64 int16 per block.
//   buf, len, pos: the file and the offset of the scan's first data byte
//   n_comp: components in the scan (1 to 4)
//   comp: per component 5 ints: h, v (blocks per MCU; 1, 1 in a
//     single-component scan), DC table, AC table (0-3), blocks per row of
//     its coefficient plane
//   coef, coef_off: the int16 coefficient buffer and each component's
//     offset (in int16 elements) into it
//   mcus_x, mcus_y: MCUs across and down the scan
//   restart_interval: MCUs between restart markers (0: none)
//   huff_bits: 8 tables (DC 0-3, AC 0-3) x 17 code-length counts (index 0
//     unused); huff_vals: 8 x 256 symbols
//   end_pos: out, the offset of the marker that ends the scan
int ecgmm_jpeg_decode_scan(const uint8_t* buf, int64_t len, int64_t pos,
                           int n_comp, const int32_t* comp, int16_t* coef,
                           const int64_t* coef_off, int mcus_x, int mcus_y,
                           int restart_interval, const uint8_t* huff_bits,
                           const uint8_t* huff_vals, int64_t* end_pos) {
  Huffman tables[8];
  bool used[8] = {false};
  for (int c = 0; c < n_comp; ++c) {
    used[comp[5 * c + 2]] = true;
    used[4 + comp[5 * c + 3]] = true;
  }
  for (int t = 0; t < 8; ++t)
    if (used[t] && !tables[t].build(huff_bits + 17 * t, huff_vals + 256 * t))
      return ERR_BAD_HUFFMAN_TABLE;
  BitReader br{buf, len, pos};
  int pred[4] = {0, 0, 0, 0};
  int err = 0;
  int64_t mcu = 0;
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx, ++mcu) {
      if (restart_interval && mcu > 0 && mcu % restart_interval == 0) {
        br.restart();
        for (int c = 0; c < 4; ++c) pred[c] = 0;
      }
      for (int c = 0; c < n_comp; ++c) {
        const int32_t* cp = comp + 5 * c;
        const int h = cp[0], v = cp[1], stride = cp[4];
        const Huffman& dc = tables[cp[2]];
        const Huffman& ac = tables[4 + cp[3]];
        for (int by = 0; by < v; ++by) {
          for (int bx = 0; bx < h; ++bx) {
            int64_t row = int64_t(my) * v + by;
            int64_t col = int64_t(mx) * h + bx;
            int16_t* blk = coef + coef_off[c] + (row * stride + col) * 64;
            std::memset(blk, 0, 64 * sizeof(int16_t));
            int s = decode(br, dc, &err);
            int diff = s ? extend(br.get(s), s) : 0;
            pred[c] += diff;
            blk[0] = int16_t(pred[c]);
            for (int k = 1; k < 64; ++k) {
              int rs = decode(br, ac, &err);
              int r = rs >> 4;
              s = rs & 15;
              if (s) {
                k += r;
                blk[kNatural[k]] = int16_t(extend(br.get(s), s));
              } else {
                if (r != 15) break;  // end of block
                k += 15;             // a run of 16 zeros
              }
            }
            if (err) return err;
          }
        }
      }
    }
  }
  *end_pos = br.end();
  return 0;
}

// Decode one scan of a progressive JPEG (jdphuff.c) into the coefficients
// of its components, which earlier scans of the image have filled in
// part. Arguments as for ecgmm_jpeg_decode_scan, plus the scan's spectral
// band ss..se (zigzag positions) and successive approximation ah, al:
//   ss == 0: a DC scan, interleaved over its components; ah == 0 decodes
//     the DC difference (shifted left by al), ah != 0 appends bit al;
//   ss > 0: an AC scan of one component (mcus_x, mcus_y: its blocks);
//     ah == 0 decodes the band's first bits (shifted left by al) with
//     end-of-band runs, ah != 0 refines: one correction bit per nonzero
//     coefficient the band passes, newly nonzero ones +-(1 << al).
// The end-of-band run and the DC predictions restart at each restart
// marker, as in libjpeg.
int ecgmm_jpeg_decode_progressive_scan(
    const uint8_t* buf, int64_t len, int64_t pos, int n_comp,
    const int32_t* comp, int16_t* coef, const int64_t* coef_off, int mcus_x,
    int mcus_y, int restart_interval, int ss, int se, int ah, int al,
    const uint8_t* huff_bits, const uint8_t* huff_vals, int64_t* end_pos) {
  Huffman tables[8];
  bool used[8] = {false};
  for (int c = 0; c < n_comp; ++c) {
    if (ss == 0 && ah == 0) used[comp[5 * c + 2]] = true;
    if (ss > 0) used[4 + comp[5 * c + 3]] = true;
  }
  for (int t = 0; t < 8; ++t)
    if (used[t] && !tables[t].build(huff_bits + 17 * t, huff_vals + 256 * t))
      return ERR_BAD_HUFFMAN_TABLE;
  BitReader br{buf, len, pos};
  int pred[4] = {0, 0, 0, 0};
  int64_t eobrun = 0;
  int err = 0;
  const int p1 = 1 << al, m1 = -(1 << al);
  int64_t mcu = 0;
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx, ++mcu) {
      if (restart_interval && mcu > 0 && mcu % restart_interval == 0) {
        br.restart();
        for (int c = 0; c < 4; ++c) pred[c] = 0;
        eobrun = 0;
      }
      for (int c = 0; c < n_comp; ++c) {
        const int32_t* cp = comp + 5 * c;
        const int h = cp[0], v = cp[1], stride = cp[4];
        for (int by = 0; by < v; ++by) {
          for (int bx = 0; bx < h; ++bx) {
            int64_t row = int64_t(my) * v + by;
            int64_t col = int64_t(mx) * h + bx;
            int16_t* blk = coef + coef_off[c] + (row * stride + col) * 64;
            if (ss == 0) {  // DC
              if (ah == 0) {
                int s = decode(br, tables[cp[2]], &err);
                int diff = s ? extend(br.get(s), s) : 0;
                pred[c] += diff;
                blk[0] = int16_t(uint32_t(pred[c]) << al);
              } else if (br.get(1)) {
                blk[0] = int16_t(blk[0] | p1);
              }
            } else if (ah == 0) {  // AC, first bits
              if (eobrun > 0) {
                --eobrun;
              } else {
                const Huffman& ac = tables[4 + cp[3]];
                for (int k = ss; k <= se; ++k) {
                  int rs = decode(br, ac, &err);
                  int r = rs >> 4, s = rs & 15;
                  if (s) {
                    k += r;
                    blk[kNatural[k]] =
                        int16_t(uint32_t(extend(br.get(s), s)) << al);
                  } else if (r == 15) {
                    k += 15;
                  } else {
                    eobrun = int64_t(1) << r;
                    if (r) eobrun += br.get(r);
                    --eobrun;
                    break;
                  }
                }
              }
            } else {  // AC, refinement
              const Huffman& ac = tables[4 + cp[3]];
              int k = ss;
              // a nonzero coefficient's correction bit raises its
              // magnitude by p1 unless that bit is set already
              auto correct = [&](int16_t* coefp) {
                if (br.get(1) && (*coefp & p1) == 0)
                  *coefp = int16_t(*coefp >= 0 ? *coefp + p1 : *coefp + m1);
              };
              if (eobrun == 0) {
                for (; k <= se; ++k) {
                  int rs = decode(br, ac, &err);
                  int r = rs >> 4, s = rs & 15;
                  if (s) {
                    s = br.get(1) ? p1 : m1;  // the size is always 1
                  } else if (r != 15) {
                    eobrun = int64_t(1) << r;
                    if (r) eobrun += br.get(r);
                    break;  // the rest of the band is the EOB logic's
                  }
                  do {
                    int16_t* coefp = blk + kNatural[k];
                    if (*coefp != 0) {
                      correct(coefp);
                    } else if (--r < 0) {
                      break;  // the zero the new coefficient lands on
                    }
                    ++k;
                  } while (k <= se);
                  if (s) blk[kNatural[k]] = int16_t(s);
                }
              }
              if (eobrun > 0) {
                for (; k <= se; ++k) {
                  int16_t* coefp = blk + kNatural[k];
                  if (*coefp != 0) correct(coefp);
                }
                --eobrun;
              }
            }
            if (err) return err;
          }
        }
      }
    }
  }
  *end_pos = br.end();
  return 0;
}

// Inverse DCT of a plane of blocks_y x blocks_x blocks (64 int16 each,
// natural order) with the quantisation table q (64 values, natural order,
// as int16: libjpeg's ISLOW_MULT_TYPE for 8-bit samples) into out,
// (8 * blocks_y) x (8 * blocks_x) samples.
int ecgmm_jpeg_idct(const int16_t* coef, const int16_t* q, int blocks_y,
                    int blocks_x, uint8_t* out) {
  const int64_t stride = int64_t(blocks_x) * 8;
  for (int64_t by = 0; by < blocks_y; ++by)
    for (int64_t bx = 0; bx < blocks_x; ++bx)
      idct_islow(coef + (by * blocks_x + bx) * 64, q,
                 out + by * 8 * stride + bx * 8, stride);
  return 0;
}

// libjpeg's upsampling of one component plane (rows x cols samples) by
// (fh, fv) into out, (rows * fv) x (cols * fh), with do_fancy_upsampling
// (jdsample.c): the triangle filters for 2x1 and 2x2 where the plane is
// wider than 2 samples and for 1x2, sample replication otherwise. The
// rows above the first and below the last repeat them, as libjpeg's
// context rows do; the filters treat the edge columns the same way.
int ecgmm_jpeg_upsample(const uint8_t* in, int64_t rows, int64_t cols,
                        int fh, int fv, uint8_t* out) {
  const int64_t ocols = cols * fh;
  const bool h2 = fh == 2 && cols > 2, v2 = fv == 2;
  if (fv == 1 && h2) {  // h2v1_fancy_upsample
    for (int64_t y = 0; y < rows; ++y) {
      const uint8_t* r = in + y * cols;
      uint8_t* o = out + y * ocols;
      for (int64_t x = 0; x < cols; ++x) {
        int s3 = 3 * r[x];
        int left = r[x > 0 ? x - 1 : 0];
        int right = r[x + 1 < cols ? x + 1 : x];
        o[2 * x] = uint8_t((s3 + left + 1) >> 2);
        o[2 * x + 1] = uint8_t((s3 + right + 2) >> 2);
      }
    }
    return 0;
  }
  if (v2 && (fh == 1 || h2)) {  // h1v2_fancy_upsample, h2v2_fancy_upsample
    for (int64_t y = 0; y < rows; ++y) {
      const uint8_t* r = in + y * cols;
      for (int v = 0; v < 2; ++v) {
        // the nearer row counts 3, the next nearer (above, then below) 1
        const int64_t yn = v == 0 ? (y > 0 ? y - 1 : 0)
                                  : (y + 1 < rows ? y + 1 : y);
        const uint8_t* n = in + yn * cols;
        uint8_t* o = out + (2 * y + v) * ocols;
        if (fh == 1) {
          const int bias = v == 0 ? 1 : 2;
          for (int64_t x = 0; x < cols; ++x)
            o[x] = uint8_t((3 * r[x] + n[x] + bias) >> 2);
          continue;
        }
        for (int64_t x = 0; x < cols; ++x) {
          int s = 3 * r[x] + n[x];
          int64_t xl = x > 0 ? x - 1 : 0, xr = x + 1 < cols ? x + 1 : x;
          int left = 3 * r[xl] + n[xl];
          int right = 3 * r[xr] + n[xr];
          o[2 * x] = uint8_t((3 * s + left + 8) >> 4);
          o[2 * x + 1] = uint8_t((3 * s + right + 7) >> 4);
        }
      }
    }
    return 0;
  }
  for (int64_t y = 0; y < rows * fv; ++y) {  // int_upsample: replication
    const uint8_t* r = in + (y / fv) * cols;
    uint8_t* o = out + y * ocols;
    for (int64_t x = 0; x < ocols; ++x) o[x] = r[x / fh];
  }
  return 0;
}

// libjpeg's ycc_rgb_convert (jdcolor.c) over n samples of the three full
// planes into n interleaved RGB triples: 16-bit fixed-point tables, the
// red and blue terms rounded in their tables, green's two terms summed
// before the shift, the range limited to [0, 255].
int ecgmm_jpeg_ycc_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                       int64_t n, uint8_t* out) {
  static int cr_r[256], cb_b[256];
  static int64_t cr_g[256], cb_g[256];
  static bool ready = false;
  if (!ready) {  // idempotent: racing first calls write the same values
    const int64_t half = int64_t(1) << 15;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((91881 * x + half) >> 16);
      cb_b[i] = int((116130 * x + half) >> 16);
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + half;
    }
    ready = true;
  }
  auto limit = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (int64_t i = 0; i < n; ++i) {
    int yy = y[i];
    out[3 * i] = limit(yy + cr_r[cr[i]]);
    out[3 * i + 1] = limit(yy + int((cb_g[cb[i]] + cr_g[cr[i]]) >> 16));
    out[3 * i + 2] = limit(yy + cb_b[cb[i]]);
  }
  return 0;
}

// PNG row unfiltering (filter method 0): data holds `rows` rows of
// 1 + row_bytes bytes (the filter type, then the filtered row); out gets
// rows x row_bytes reconstructed bytes. bpp: bytes per complete pixel.
int ecgmm_png_unfilter(const uint8_t* data, int64_t rows, int64_t row_bytes,
                       int bpp, uint8_t* out) {
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t* in = data + y * (row_bytes + 1);
    const int type = in[0];
    ++in;
    uint8_t* cur = out + y * row_bytes;
    const uint8_t* up = y ? cur - row_bytes : nullptr;
    for (int64_t x = 0; x < row_bytes; ++x) {
      int a = x >= bpp ? cur[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= bpp) ? up[x - bpp] : 0;
      int p;
      switch (type) {
        case 0: p = 0; break;
        case 1: p = a; break;
        case 2: p = b; break;
        case 3: p = (a + b) >> 1; break;
        case 4: p = paeth(a, b, c); break;
        default: return ERR_BAD_PNG_FILTER;
      }
      cur[x] = uint8_t(in[x] + p);
    }
  }
  return 0;
}

// GIF's LZW image data, as Pillow's GifDecode.c reads it: `data` is the
// concatenation of the data sub-blocks, `min_code` the LZW minimum code
// size (1-8; a clear code is 1 << min_code, the end code one more). Codes
// grow from min_code + 1 to 12 bits as the table fills; a full table of
// 4096 entries takes no new ones until the next clear code; a code one
// past the table's last entry repeats the previous string plus its first
// byte. Writes up to n_out indices in the stream's order into out and
// their count into *written; stops at the end code or when out is full.
// Returns 0, ERR_BAD_LZW_CODE for a code beyond the table, or
// ERR_TRUNCATED_LZW for data that ends before either.
int ecgmm_gif_lzw(const uint8_t* data, int64_t n, int min_code, uint8_t* out,
                  int64_t n_out, int64_t* written) {
  constexpr int kTable = 4096;
  std::vector<uint16_t> prefix(kTable);
  std::vector<uint8_t> suffix(kTable), first(kTable), stack(kTable + 1);
  const int clear = 1 << min_code, end = clear + 1;
  int size = min_code + 1, next = clear + 2, prev = -1;
  for (int i = 0; i < clear; ++i) {
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    prefix[i] = 0;
  }
  uint32_t acc = 0;
  int nbits = 0;
  int64_t pos = 0, o = 0;
  *written = 0;
  while (o < n_out) {
    while (nbits < size) {
      if (pos >= n) {
        *written = o;
        return ERR_TRUNCATED_LZW;
      }
      acc |= static_cast<uint32_t>(data[pos++]) << nbits;
      nbits += 8;
    }
    const int code = static_cast<int>(acc & ((1u << size) - 1));
    acc >>= size;
    nbits -= size;
    if (code == clear) {
      size = min_code + 1;
      next = clear + 2;
      prev = -1;
      continue;
    }
    if (code == end) break;
    if (prev < 0) {
      if (code >= clear) {
        *written = o;
        return ERR_BAD_LZW_CODE;
      }
      out[o++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }
    if (code > next || (code == next && next >= kTable)) {
      *written = o;
      return ERR_BAD_LZW_CODE;
    }
    // the string of `code` (or, one past the table, prev's plus its first
    // byte), written backwards on the stack
    int sp = 0, c = code;
    uint8_t head;
    if (code == next) {
      stack[sp++] = first[prev];
      c = prev;
    }
    while (c >= clear) {
      stack[sp++] = suffix[c];
      c = prefix[c];
    }
    head = static_cast<uint8_t>(c);
    stack[sp++] = head;
    while (sp > 0 && o < n_out) out[o++] = stack[--sp];
    if (next < kTable) {
      prefix[next] = static_cast<uint16_t>(prev);
      suffix[next] = head;
      first[next] = first[prev];
      if (next == (1 << size) - 1 && size < 12) ++size;
      ++next;
    }
    prev = code;
  }
  *written = o;
  return 0;
}

// RLE8 and RLE4 BMP pixel data, as Pillow's BmpRleDecoder reads it: the
// indices in file order (bottom-up rows unless the header says otherwise)
// into out, up to n_out (width * height; a row overrun runs into the next
// row, as there); *written gets the count. `base` is the data's offset in
// the file: an absolute run is padded to an even file offset. An end of
// line pads the row with 0; a delta skips two bytes and reads (right, up)
// from the next two, as Pillow does; data that ends early ends the image.
// Returns 0, or ERR_TRUNCATED_RLE_DELTA where a delta's (right, up) is cut
// off.
int ecgmm_bmp_rle(const uint8_t* data, int64_t n, int64_t base, int rle4,
                  int64_t width, uint8_t* out, int64_t n_out,
                  int64_t* written) {
  int64_t pos = 0, o = 0, x = 0;
  auto put = [&](uint8_t v) {
    if (o < n_out) out[o] = v;
    ++o;
  };
  int status = 0;
  while (o < n_out) {
    if (pos + 2 > n) break;
    const int count = data[pos], byte = data[pos + 1];
    pos += 2;
    if (count) {
      int64_t k = count;
      if (x + k > width) k = std::max<int64_t>(0, width - x);
      for (int64_t i = 0; i < k; ++i)
        put(rle4 ? static_cast<uint8_t>(i % 2 == 0 ? byte >> 4 : byte & 15)
                 : static_cast<uint8_t>(byte));
      x += k;
    } else if (byte == 0) {
      while (o % width != 0) put(0);
      x = 0;
    } else if (byte == 1) {
      break;
    } else if (byte == 2) {
      if (pos + 2 > n) break;
      pos += 2;
      if (pos + 2 > n) {
        status = ERR_TRUNCATED_RLE_DELTA;
        break;
      }
      const int64_t right = data[pos], up = data[pos + 1];
      pos += 2;
      for (int64_t i = 0; i < right + up * width; ++i) put(0);
      x = o % width;
    } else {
      const int64_t want = rle4 ? byte / 2 : byte;
      const int64_t got = std::min<int64_t>(want, n - pos);
      for (int64_t i = 0; i < got; ++i) {
        const uint8_t b = data[pos + i];
        if (rle4) {
          put(static_cast<uint8_t>(b >> 4));
          put(static_cast<uint8_t>(b & 15));
        } else {
          put(b);
        }
      }
      pos += got;
      if (got < want) break;
      x += byte;
      if ((base + pos) % 2 != 0) ++pos;
    }
  }
  *written = std::min(o, n_out);
  return status;
}

}  // extern "C"
