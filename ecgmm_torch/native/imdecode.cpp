// Host kernels of the upload decoder (ecgmm_torch/serve/imdecode.py):
// libjpeg-turbo's accurate integer inverse DCT ("ISLOW", as its SIMD code
// computes it),
// the block smoothing of an incomplete progressive image, its fancy
// upsampling (jdsample.c) and YCbCr->RGB conversion
// (jdcolor.c), PNG's row unfiltering, GIF's LZW codes, BMP's RLE8 and
// RLE4 runs (as Pillow's decoders read them) and plain PNM's decimal
// samples. Plain C interface, loaded with
// ctypes; the Python side parses the markers and chunks and checks every
// size before it passes a pointer.
//
// Every entry point but ecgmm_pnm_plain (which returns a count) returns 0
// on success and a negative code otherwise (ERR_* below); imdecode.py maps
// the codes to messages.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum {  // -1, -7, -8 are the JPEG scan decoders' (jpegscan.cpp)
  ERR_BAD_PNG_FILTER = -3,
  ERR_BAD_LZW_CODE = -4,
  ERR_TRUNCATED_LZW = -5,
  ERR_TRUNCATED_RLE_DELTA = -6,
};


// ---- libjpeg-turbo's accurate integer IDCT ("ISLOW") as its SIMD code
// computes it (jidctint-sse2.asm; the AVX2 version computes the same),
// the version Pillow runs on x86. It is jidctint.c's algorithm in 16-bit
// lanes: the dequantised coefficients are 16-bit products (pmullw),
// in0 +- in4 and the odd part's z3 and z4 are 16-bit sums, the products
// by the constants are exact 32-bit pairs (pmaddwd) summed in 32 bits, each
// pass's results saturate to 16 bits (packssdw) and the samples to
// [-128, 127] before the +128 (packsswb, paddb). A block whose rows 1-7
// are all zero takes pass 1's DC shortcut: (in0 * q0) << 2 in 16 bits.
// For coefficients a valid image holds this equals jidctint.c bit for
// bit; for the large ones of corrupt data it is what Pillow gives.
// idct_islow is that arithmetic in scalar C++, whose shortcuts give what
// the full pass gives.
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270,
              F_0_899 = 7373, F_1_175 = 9633, F_1_501 = 12299,
              F_1_847 = 15137, F_1_961 = 16069, F_2_053 = 16819,
              F_2_562 = 20995, F_3_072 = 25172;

inline int16_t w16(int32_t x) { return int16_t(uint16_t(uint32_t(x))); }
inline int16_t sat16(int32_t x) {
  return int16_t(x < -32768 ? -32768 : x > 32767 ? 32767 : x);
}

// One 8-point pass over in0..in7 into o[0..7], descaled by `shift`
// (before any saturation). jidctint.c's formulas: the SIMD code's
// products by constant pairs are the same exact integers, and no sum
// here leaves 32 bits (the largest, tmp10 + tmp3, stays below 1.7e9);
// only the three 16-bit sums differ from C.
inline void idct_pass(int32_t in0, int32_t in1, int32_t in2, int32_t in3,
                      int32_t in4, int32_t in5, int32_t in6, int32_t in7,
                      int shift, int32_t* o) {
  // even part
  const int32_t z1e = (in2 + in6) * F_0_541;
  const int32_t tmp2 = z1e - in6 * F_1_847;
  const int32_t tmp3 = z1e + in2 * F_0_765;
  const int32_t tmp0 = int32_t(w16(in0 + in4)) * (1 << CONST_BITS);
  const int32_t tmp1 = int32_t(w16(in0 - in4)) * (1 << CONST_BITS);
  const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  // odd part: tmp0..3 of jidctint.c are in7, in5, in3, in1
  const int32_t z1 = (in7 + in1) * -F_0_899;
  const int32_t z2 = (in5 + in3) * -F_2_562;
  const int32_t z3w = w16(in7 + in3), z4w = w16(in5 + in1);
  const int32_t z5 = (z3w + z4w) * F_1_175;
  const int32_t z3 = z3w * -F_1_961 + z5, z4 = z4w * -F_0_390 + z5;
  const int32_t o0 = in7 * F_0_298 + z1 + z3;
  const int32_t o1 = in5 * F_2_053 + z2 + z4;
  const int32_t o2 = in3 * F_3_072 + z2 + z3;
  const int32_t o3 = in1 * F_1_501 + z1 + z4;
  const int32_t round = int32_t(1) << (shift - 1);
  o[0] = (tmp10 + o3 + round) >> shift;
  o[7] = (tmp10 - o3 + round) >> shift;
  o[1] = (tmp11 + o2 + round) >> shift;
  o[6] = (tmp11 - o2 + round) >> shift;
  o[2] = (tmp12 + o1 + round) >> shift;
  o[5] = (tmp12 - o1 + round) >> shift;
  o[3] = (tmp13 + o0 + round) >> shift;
  o[4] = (tmp13 - o0 + round) >> shift;
}

inline uint8_t sample(int32_t v) {  // packsswb's saturation, then +128
  return uint8_t((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                int64_t stride) {
  int32_t ws[64];  // pass 1's output, saturated to 16 bits
  // the SIMD code's shortcut for a block with no AC rows: (in0 * q0) << 2
  // in 16 bits, wrapping
  bool ac_rows = false;
  for (int k = 8; k < 64 && !ac_rows; ++k) ac_rows = in[k] != 0;
  for (int c = 0; c < 8; ++c) {  // columns
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    const int32_t d0 = w16(int32_t(ip[0]) * qp[0]);
    if (!ac_rows) {
      const int32_t v = w16(d0 * (1 << PASS1_BITS));
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
      continue;
    }
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      // what the pass gives for d0 alone: (d0 << 13 + 2^10) >> 11
      const int32_t v = sat16(d0 * (1 << PASS1_BITS));
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
      continue;
    }
    int32_t o[8];
    idct_pass(d0, w16(int32_t(ip[8]) * qp[8]), w16(int32_t(ip[16]) * qp[16]),
              w16(int32_t(ip[24]) * qp[24]), w16(int32_t(ip[32]) * qp[32]),
              w16(int32_t(ip[40]) * qp[40]), w16(int32_t(ip[48]) * qp[48]),
              w16(int32_t(ip[56]) * qp[56]), CONST_BITS - PASS1_BITS, o);
    for (int r = 0; r < 8; ++r) ws[8 * r + c] = sat16(o[r]);
  }
  for (int r = 0; r < 8; ++r) {  // rows
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      // the pass for w0 alone: (w0 << 13 + 2^17) >> 18 = (w0 + 16) >> 5
      std::memset(op, sample((wp[0] + 16) >> 5), 8);
      continue;
    }
    int32_t row[8];
    idct_pass(wp[0], wp[1], wp[2], wp[3], wp[4], wp[5], wp[6], wp[7],
              CONST_BITS + PASS1_BITS + 3, row);
    for (int c = 0; c < 8; ++c) op[c] = sample(row[c]);
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

// libjpeg-turbo 3.1's block smoothing of a progressive image's component
// (jdcoefct.c decompress_smooth_data), which its output pass runs when the
// scans leave some of the first ten zigzag coefficients incomplete: each
// block of the image's height_in_blocks x width_in_blocks gets estimates
// of its AC coefficients 1-9 (zigzag) from the DC values of its 5x5
// neighbourhood, where a coefficient is still 0 and not known in full
// (the latch of each zigzag position's Al, -1 where no scan coded it),
// each clamped below 1 << Al; with no AC coefficient coded at all the DC
// value too is smoothed. At the image's edges the rows are libjpeg's
// (counted with the last iMCU row's own block count) and the columns
// repeat the edge column.
// coef (blocks_y x blocks_x blocks, as for ecgmm_jpeg_idct) is copied to
// out, the estimates in the copy; q is the component's quantisation table
// (natural order, 16-bit values in int16s); v_samp is its vertical
// sampling factor and imcu_rows the frame's iMCU rows; bits and
// prev_bits (zigzag 0-9) are the latches of this component's coefficient
// bits after the last scan and before it: iMCU rows after last_good (the
// last scan ran out of data before them) are smoothed with prev_bits.
int ecgmm_jpeg_smooth(const int16_t* coef, const int16_t* q16, int blocks_y,
                      int blocks_x, int height_in_blocks, int width_in_blocks,
                      int v_samp, int imcu_rows, const int32_t* bits,
                      const int32_t* prev_bits, int last_good,
                      int16_t* out) {
  std::memcpy(out, coef, size_t(blocks_y) * blocks_x * 64 * sizeof(int16_t));
  const uint16_t* q = reinterpret_cast<const uint16_t*>(q16);
  const int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9],
                Q02 = q[2], Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
  auto dc = [&](int64_t row, int64_t col) {
    return int(coef[(row * blocks_x + col) * 64]);
  };
  // an estimate num / (Q << 8), rounded, its magnitude below 1 << Al
  auto estimate = [](int64_t num, int64_t qv, int al) {
    int pred;
    if (num >= 0) {
      pred = int(((qv << 7) + num) / (qv << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = int(((qv << 7) - num) / (qv << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    return int16_t(pred);
  };
  const int64_t last_col = width_in_blocks - 1;
  for (int o = 0; o < imcu_rows; ++o) {
    const int32_t* coef_bits = o > last_good ? prev_bits : bits;
    bool change_dc = true;
    for (int k = 1; k <= 9; ++k) change_dc = change_dc && coef_bits[k] == -1;
    int block_rows = v_samp;
    if (o == imcu_rows - 1) {
      block_rows = height_in_blocks % v_samp;
      if (block_rows == 0) block_rows = v_samp;
    }
    // libjpeg counts the image's block rows with this iMCU row's count
    const int64_t image_block_rows = int64_t(block_rows) * imcu_rows;
    for (int b = 0; b < block_rows; ++b) {
      const int64_t ibr = int64_t(o) * block_rows + b;
      const int64_t cur = int64_t(o) * v_samp + b;
      const int64_t prev = ibr > 0 ? cur - 1 : cur;
      const int64_t pprev = ibr > 1 ? cur - 2 : prev;
      const int64_t next = ibr < image_block_rows - 1 ? cur + 1 : cur;
      const int64_t nnext = ibr < image_block_rows - 2 ? cur + 2 : next;
      const int64_t rows[5] = {pprev, prev, cur, next, nnext};
      for (int64_t col = 0; col <= last_col; ++col) {
        int16_t* w = out + (cur * blocks_x + col) * 64;
        // the 5x5 DC neighbourhood, DC01..DC25 row by row, the columns
        // past the image's edges repeating its edge column
        int dcv[26];
        for (int r = 0; r < 5; ++r)
          for (int k = 0; k < 5; ++k)
            dcv[1 + 5 * r + k] =
                dc(rows[r], std::min(std::max(col + k - 2, int64_t(0)),
                                     last_col));
        const int DC01 = dcv[1], DC02 = dcv[2], DC03 = dcv[3], DC04 = dcv[4],
                  DC05 = dcv[5], DC06 = dcv[6], DC07 = dcv[7], DC08 = dcv[8],
                  DC09 = dcv[9], DC10 = dcv[10], DC11 = dcv[11],
                  DC12 = dcv[12], DC13 = dcv[13], DC14 = dcv[14],
                  DC15 = dcv[15], DC16 = dcv[16], DC17 = dcv[17],
                  DC18 = dcv[18], DC19 = dcv[19], DC20 = dcv[20],
                  DC21 = dcv[21], DC22 = dcv[22], DC23 = dcv[23],
                  DC24 = dcv[24], DC25 = dcv[25];
        int al;
        if ((al = coef_bits[1]) != 0 && w[1] == 0) {  // AC01
          const int64_t num = Q00 * (change_dc ?
              (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
               13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
               3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
               DC21 - DC22 + DC24 + DC25) :
              (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          w[1] = estimate(num, Q01, al);
        }
        if ((al = coef_bits[2]) != 0 && w[8] == 0) {  // AC10
          const int64_t num = Q00 * (change_dc ?
              (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
               13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
               13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
               3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
              (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          w[8] = estimate(num, Q10, al);
        }
        if ((al = coef_bits[3]) != 0 && w[16] == 0) {  // AC20
          const int64_t num = Q00 * (change_dc ?
              (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
               14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 +
               DC23) :
              (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
          w[16] = estimate(num, Q20, al);
        }
        if ((al = coef_bits[4]) != 0 && w[9] == 0) {  // AC11
          const int64_t num = Q00 * (change_dc ?
              (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
               DC21 - DC25) :
              (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
               DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
          w[9] = estimate(num, Q11, al);
        }
        if ((al = coef_bits[5]) != 0 && w[2] == 0) {  // AC02
          const int64_t num = Q00 * (change_dc ?
              (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
               14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
               2 * DC19) :
              (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
          w[2] = estimate(num, Q02, al);
        }
        if (change_dc) {
          if ((al = coef_bits[6]) != 0 && w[3] == 0)  // AC03
            w[3] = estimate(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 -
                                   DC19), Q03, al);
          if ((al = coef_bits[7]) != 0 && w[10] == 0)  // AC12
            w[10] = estimate(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 +
                                    3 * DC18 - DC19), Q12, al);
          if ((al = coef_bits[8]) != 0 && w[17] == 0)  // AC21
            w[17] = estimate(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 +
                                    DC17 - DC19), Q21, al);
          if ((al = coef_bits[9]) != 0 && w[24] == 0)  // AC30
            w[24] = estimate(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 -
                                    2 * DC18 - DC19), Q30, al);
          const int64_t num = Q00 *
              (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
               6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
               8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
               6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
               2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
          w[0] = estimate(num, Q00, 0);  // the DC, unclamped
        }
      }
    }
  }
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

// A plain PNM block's samples (PpmPlainDecoder._decode_blocks after its
// comments are taken out): the whitespace-separated tokens of `s`, each
// written to `values` (at most `cap`). Stops at the first token that is
// not 1 to 10 decimal digits, whose offset goes to state[0] (else -1),
// the Python side then reading the block as Pillow does; state[1] is
// where a last token that runs to the end of the block begins (else n),
// which the block after it completes. Returns the number written.
int64_t ecgmm_pnm_plain(const uint8_t* s, int64_t n, int64_t* values,
                        int64_t cap, int64_t* state) {
  auto space = [](uint8_t c) {
    return c == ' ' || (c >= '\t' && c <= '\r');
  };
  int64_t count = 0, i = 0;
  state[0] = -1;
  state[1] = n;
  while (i < n) {
    while (i < n && space(s[i])) ++i;
    if (i >= n) break;
    int64_t j = i;
    while (j < n && !space(s[j])) ++j;
    if (j == n) {  // a token the block may cut
      state[1] = i;
      break;
    }
    if (j - i > 10 || count >= cap) {
      state[0] = i;
      break;
    }
    int64_t v = 0;
    for (int64_t k = i; k < j; ++k) {
      if (s[k] < '0' || s[k] > '9') {
        state[0] = i;
        return count;
      }
      v = v * 10 + (s[k] - '0');
    }
    values[count++] = v;
    i = j;
  }
  return count;
}

}  // extern "C"
