// A baseline JPEG encoder that writes the bytes Pillow writes for
// `Image.fromarray(rgb).save(buf, format="JPEG", quality=q)` (the JAX
// serving request's JPEG heatmap, quality 85), following libjpeg-turbo's
// compressor with the settings Pillow leaves at libjpeg's defaults:
//
//  - jpeg_set_quality(q, force_baseline=TRUE): the Annex K tables scaled
//    by jpeg_quality_scaling (q < 50: 5000 / q, else 200 - 2q), rounded,
//    clamped to [1, 255];
//  - jccolor.c's RGB -> YCbCr in 16-bit fixed point (the Cb and Cr
//    tables' rounding fudge of one half less one);
//  - 4:2:0: Y at 2x2, Cb and Cr at 1x1; jcsample.c's h2v2_downsample
//    with its bias alternating 1, 2 along a row; each plane extended by
//    replicating its last column and row (expand_right_edge,
//    expand_bottom_edge), at full resolution before the downsample;
//  - jccoefct.c's dummy blocks: where a component's blocks do not fill
//    the last MCU, the missing blocks are zero with the DC of the block
//    before them;
//  - jfdctint.c's accurate integer forward DCT ("ISLOW") and
//    libjpeg-turbo's quantiser, which divides by multiplying with a 16-bit
//    reciprocal (jcdctmgr.c compute_reciprocal, quantize);
//  - the Annex K Huffman tables (no optimisation), no restart markers;
//  - the markers in libjpeg's order: SOI, a JFIF 1.01 APP0 with density
//    1:1 and unit 0, one DQT marker per table, SOF0, one DHT marker per
//    table in the order DC0, AC0, DC1, AC1, SOS, the entropy-coded data
//    (0xFF stuffed, the last byte padded with 1-bits), EOI.
//
// Plain C interface, loaded with ctypes (ecgmm_torch/native/__init__.py).
// `ecgmm_jpeg_std_huffman` hands the Annex K tables to the upload decoder
// (serve/imdecode.py), which fills them in for a JPEG without DHT, as
// libjpeg-turbo does.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// zigzag position -> natural (row-major) position of an 8x8 block
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.1, natural order
const int kLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3: code-length counts (index 0 unused) and symbols
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1,
                                 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1,
                                   1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                   7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct StdTable {
  const uint8_t* bits;
  const uint8_t* vals;
  int n;
};
// DC0, DC1, AC0, AC1
const StdTable kStd[4] = {{kDcLumaBits, kDcVals, 12},
                          {kDcChromaBits, kDcVals, 12},
                          {kAcLumaBits, kAcLumaVals, 162},
                          {kAcChromaBits, kAcChromaVals, 162}};

// jchuff.c jpeg_make_c_derived_tbl: canonical codes by length
struct HuffEnc {
  uint32_t code[256];
  uint8_t size[256];
  explicit HuffEnc(const StdTable& t) {
    std::memset(code, 0, sizeof(code));
    std::memset(size, 0, sizeof(size));
    uint32_t c = 0;
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < t.bits[l]; ++i, ++p, ++c) {
        code[t.vals[p]] = c;
        size[t.vals[p]] = static_cast<uint8_t>(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>* out;
  uint64_t acc = 0;
  int nbits = 0;
  void byte(uint8_t b) {
    out->push_back(b);
    if (b == 0xFF) out->push_back(0);  // byte stuffing
  }
  void put(uint32_t bits, int n) {
    acc = (acc << n) | (bits & ((uint32_t(1) << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      byte(static_cast<uint8_t>(acc >> nbits));
    }
  }
  void flush() {  // fill the partial byte with 1-bits
    if (nbits)
      byte(static_cast<uint8_t>((acc << (8 - nbits)) | (0xFF >> nbits)));
    nbits = 0;
  }
};

// ---- jfdctint.c (jpeg_fdct_islow) ----
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

inline int descale(int64_t x, int n) {
  return static_cast<int>((x + (int64_t(1) << (n - 1))) >> n);
}

// One pass over 8 lines of d (stride s between the 8 values of a line,
// step between lines); pass 1 keeps PASS1_BITS of extra precision, pass 2
// removes it, leaving the result scaled up by 8.
void fdct_pass(int* d, int s, int step, bool first) {
  const int n = first ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
  for (int line = 0; line < 8; ++line, d += step) {
    int64_t tmp0 = d[0] + d[7 * s], tmp7 = d[0] - d[7 * s];
    int64_t tmp1 = d[s] + d[6 * s], tmp6 = d[s] - d[6 * s];
    int64_t tmp2 = d[2 * s] + d[5 * s], tmp5 = d[2 * s] - d[5 * s];
    int64_t tmp3 = d[3 * s] + d[4 * s], tmp4 = d[3 * s] - d[4 * s];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    if (first) {
      d[0] = static_cast<int>((tmp10 + tmp11) * (1 << PASS1_BITS));
      d[4 * s] = static_cast<int>((tmp10 - tmp11) * (1 << PASS1_BITS));
    } else {
      d[0] = descale(tmp10 + tmp11, PASS1_BITS);
      d[4 * s] = descale(tmp10 - tmp11, PASS1_BITS);
    }
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    d[2 * s] = descale(z1 + tmp13 * FIX_0_765366865, n);
    d[6 * s] = descale(z1 + tmp12 * -FIX_1_847759065, n);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6;
    int64_t z3 = tmp4 + tmp6;
    int64_t z4 = tmp5 + tmp7;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    d[7 * s] = descale(tmp4 + z1 + z3, n);
    d[5 * s] = descale(tmp5 + z2 + z4, n);
    d[3 * s] = descale(tmp6 + z2 + z3, n);
    d[s] = descale(tmp7 + z1 + z4, n);
  }
}

// jcdctmgr.c compute_reciprocal for a 16-bit DCTELEM (libjpeg-turbo's
// build with SIMD, which Pillow ships): quantising x by divisor d is
// ((|x| + corr) * recip) >> shift, with x's sign restored.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t d) {
  int b = 31 - __builtin_clz(d);  // flss(d) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / d;
  uint32_t fr = (uint32_t(1) << r) % d;
  uint32_t c = d / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= d / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r};
}

inline int16_t quantize(int x, const Divisor& q) {
  const uint32_t a = static_cast<uint32_t>(x < 0 ? -x : x);
  const int v = static_cast<int>(((a + q.corr) * q.recip) >> q.shift);
  return static_cast<int16_t>(x < 0 ? -v : v);
}

void encode_block(BitWriter& bw, const int16_t* blk, int* last_dc,
                  const HuffEnc& dc, const HuffEnc& ac) {
  int temp = blk[0] - *last_dc, temp2 = temp;
  *last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nbits = 0;
  while (temp) {
    ++nbits;
    temp >>= 1;
  }
  bw.put(dc.code[nbits], dc.size[nbits]);
  if (nbits) bw.put(static_cast<uint32_t>(temp2), nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = blk[kNatural[k]];
    if (temp == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nbits = 1;
    while ((temp >>= 1)) ++nbits;
    const int i = (r << 4) + nbits;
    bw.put(ac.code[i], ac.size[i]);
    bw.put(static_cast<uint32_t>(temp2), nbits);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v));
}

void put_dht(std::vector<uint8_t>& o, int index, const StdTable& t) {
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + t.n);
  o.push_back(static_cast<uint8_t>(index));
  o.insert(o.end(), t.bits + 1, t.bits + 17);
  o.insert(o.end(), t.vals, t.vals + t.n);
}

template <typename F>
void parallel_rows(int64_t n_rows, F&& fn) {
  unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  unsigned n_threads = static_cast<unsigned>(
      std::min<int64_t>(std::min<unsigned>(hw, 8u), n_rows / 2));
  if (n_threads < 2) {
    fn(0, n_rows);
    return;
  }
  int64_t per = (n_rows + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (unsigned t = 0; t < n_threads; ++t) {
    int64_t lo = static_cast<int64_t>(t) * per;
    int64_t hi = std::min(n_rows, lo + per);
    if (lo >= hi) break;
    threads.emplace_back([lo, hi, &fn] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// The Annex K Huffman table `slot` (0: DC0, 1: DC1, 2: AC0, 3: AC1) as 17
// code-length counts (index 0 zero) and 256 symbols (zero-padded).
int ecgmm_jpeg_std_huffman(int slot, uint8_t* bits, uint8_t* vals) {
  if (slot < 0 || slot > 3) return -1;
  std::memcpy(bits, kStd[slot].bits, 17);
  std::memset(vals, 0, 256);
  std::memcpy(vals, kStd[slot].vals, kStd[slot].n);
  return 0;
}

// Encode rgb, [h, w, 3] uint8 row-major, as a baseline 4:2:0 JPEG of the
// given quality (1-100). Returns 0 and the byte count in out_len, -1 if
// out_cap is too small, -2 for a size JPEG cannot hold.
int ecgmm_jpeg_encode(const uint8_t* rgb, int64_t h, int64_t w, int quality,
                      uint8_t* out, int64_t out_cap, int64_t* out_len) {
  if (h < 1 || w < 1 || h > 65535 || w > 65535) return -2;
  quality = std::min(100, std::max(1, quality));
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  int qtab[2][64];
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t) {
    for (int i = 0; i < 64; ++i) {
      int64_t v = ((t ? kChromaQ : kLumaQ)[i] * int64_t(scale) + 50) / 100;
      v = std::min<int64_t>(255, std::max<int64_t>(1, v));
      qtab[t][i] = static_cast<int>(v);
      div[t][i] = reciprocal(static_cast<uint32_t>(v) << 3);
    }
  }

  // jccolor.c rgb_ycc_convert
  const int64_t n = h * w;
  std::vector<uint8_t> plane(static_cast<size_t>(3 * n));
  uint8_t* Y = plane.data();
  uint8_t* Cb = Y + n;
  uint8_t* Cr = Cb + n;
  parallel_rows(h, [&](int64_t r0, int64_t r1) {
    const int32_t half = 1 << 15, off = (128 << 16) + half - 1;
    for (int64_t i = r0 * w; i < r1 * w; ++i) {
      const int32_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
      Y[i] = static_cast<uint8_t>((19595 * r + 38470 * g + 7471 * b + half)
                                  >> 16);
      Cb[i] = static_cast<uint8_t>((-11059 * r - 21709 * g + 32768 * b + off)
                                   >> 16);
      Cr[i] = static_cast<uint8_t>((32768 * r - 27439 * g - 5329 * b + off)
                                   >> 16);
    }
  });

  const int64_t wib_y = (w + 7) / 8, hib_y = (h + 7) / 8;
  const int64_t mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  const int64_t last_c = (h + 1) / 2 - 1;  // last real chroma row
  const int last_col_width = (wib_y % 2) ? 1 : 2;
  const int last_row_height = (hib_y % 2) ? 1 : 2;
  auto at = [&](const uint8_t* p, int64_t r, int64_t c) -> int {
    return p[std::min(r, h - 1) * w + std::min(c, w - 1)];
  };
  // quantised coefficients of every MCU: Y0 Y1 Y2 Y3 Cb Cr, 64 each
  std::vector<int16_t> coef(static_cast<size_t>(mcuy * mcux * 6 * 64));
  parallel_rows(mcuy, [&](int64_t m0, int64_t m1) {
    int ws[64];
    auto dct = [&](int16_t* dst, int t) {
      fdct_pass(ws, 1, 8, true);
      fdct_pass(ws, 8, 1, false);
      for (int i = 0; i < 64; ++i) dst[i] = quantize(ws[i], div[t][i]);
    };
    for (int64_t my = m0; my < m1; ++my) {
      for (int64_t mx = 0; mx < mcux; ++mx) {
        int16_t* mcu = coef.data() + (my * mcux + mx) * 6 * 64;
        const int blockcnt = mx < mcux - 1 ? 2 : last_col_width;
        for (int yi = 0; yi < 2; ++yi) {
          int16_t* row = mcu + yi * 2 * 64;
          if (my < mcuy - 1 || yi < last_row_height) {
            for (int xi = 0; xi < blockcnt; ++xi) {
              const int64_t y0 = (2 * my + yi) * 8, x0 = (2 * mx + xi) * 8;
              for (int r = 0; r < 8; ++r)
                for (int c = 0; c < 8; ++c)
                  ws[8 * r + c] = at(Y, y0 + r, x0 + c) - 128;
              dct(row + xi * 64, 0);
            }
            for (int xi = blockcnt; xi < 2; ++xi) {  // dummy blocks
              std::memset(row + xi * 64, 0, 64 * sizeof(int16_t));
              row[xi * 64] = row[(xi - 1) * 64];
            }
          } else {  // a dummy row: the DC of the block before it
            std::memset(row, 0, 2 * 64 * sizeof(int16_t));
            row[0] = row[64] = row[-64];
          }
        }
        for (int ci = 0; ci < 2; ++ci) {  // h2v2_downsample
          const uint8_t* p = ci ? Cr : Cb;
          for (int r = 0; r < 8; ++r) {
            const int64_t k = std::min(my * 8 + r, last_c);
            for (int c = 0; c < 8; ++c) {
              const int64_t x = (mx * 8 + c) * 2;
              const int bias = (c & 1) ? 2 : 1;
              const int s = at(p, 2 * k, x) + at(p, 2 * k, x + 1) +
                            at(p, 2 * k + 1, x) + at(p, 2 * k + 1, x + 1);
              ws[8 * r + c] = ((s + bias) >> 2) - 128;
            }
          }
          dct(mcu + (4 + ci) * 64, 1);
        }
      }
    }
  });

  std::vector<uint8_t> o;
  o.reserve(static_cast<size_t>(n / 2 + 1024));
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F',
                          'I',  'F',  0x00, 0x01, 0x01, 0x00, 0x00, 0x01,
                          0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), head, head + sizeof(head));
  for (int t = 0; t < 2; ++t) {
    const uint8_t dqt[] = {0xFF, 0xDB, 0x00, 0x43, static_cast<uint8_t>(t)};
    o.insert(o.end(), dqt, dqt + sizeof(dqt));
    for (int k = 0; k < 64; ++k)
      o.push_back(static_cast<uint8_t>(qtab[t][kNatural[k]]));
  }
  const uint8_t sof[] = {0xFF, 0xC0, 0x00, 0x11, 0x08};
  o.insert(o.end(), sof, sof + sizeof(sof));
  put16(o, static_cast<int>(h));
  put16(o, static_cast<int>(w));
  const uint8_t comps[] = {0x03, 0x01, 0x22, 0x00, 0x02,
                           0x11, 0x01, 0x03, 0x11, 0x01};
  o.insert(o.end(), comps, comps + sizeof(comps));
  put_dht(o, 0x00, kStd[0]);
  put_dht(o, 0x10, kStd[2]);
  put_dht(o, 0x01, kStd[1]);
  put_dht(o, 0x11, kStd[3]);
  const uint8_t sos[] = {0xFF, 0xDA, 0x00, 0x0C, 0x03, 0x01, 0x00,
                         0x02, 0x11, 0x03, 0x11, 0x00, 0x3F, 0x00};
  o.insert(o.end(), sos, sos + sizeof(sos));

  const HuffEnc dc0(kStd[0]), dc1(kStd[1]), ac0(kStd[2]), ac1(kStd[3]);
  BitWriter bw{&o};
  int last_dc[3] = {0, 0, 0};
  for (int64_t m = 0; m < mcuy * mcux; ++m) {
    const int16_t* mcu = coef.data() + m * 6 * 64;
    for (int b = 0; b < 4; ++b)
      encode_block(bw, mcu + b * 64, &last_dc[0], dc0, ac0);
    encode_block(bw, mcu + 4 * 64, &last_dc[1], dc1, ac1);
    encode_block(bw, mcu + 5 * 64, &last_dc[2], dc1, ac1);
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  if (static_cast<int64_t>(o.size()) > out_cap) return -1;
  std::memcpy(out, o.data(), o.size());
  *out_len = static_cast<int64_t>(o.size());
  return 0;
}

}  // extern "C"
