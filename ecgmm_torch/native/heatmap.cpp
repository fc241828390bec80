// Host kernels of the Grad-CAM heatmap of the serving response (port of
// ecgmm_tpu/native/heatmap.cpp):
//
//  * ecgmm_cam_overlay: the bilinear CAM upsample (Pillow's triangle-filter
//    coefficients in double, the horizontal pass stored as float32, as
//    Image.resize(BILINEAR) does on mode-"F" images) fused with the jet
//    blend, in the float32 expressions of explain/gradcam.overlay_heatmap.
//    The library is built with -ffp-contract=off, so the two products of
//    the blend stay separate roundings, as in numpy.
//
//  * ecgmm_png_encode_sub: a complete PNG writer: the Sub row filter and
//    a band-parallel deflate in the style of pigz's independent mode. The
//    filtered scanlines are split into row bands; each band is deflated
//    as a raw stream ending in Z_FULL_FLUSH (byte-aligned, dictionary
//    reset, so independently compressed bands concatenate into one valid
//    deflate stream), the last band ends with Z_FINISH, and the zlib
//    wrapper's Adler-32 is stitched from per-band checksums with
//    adler32_combine. Any PNG decoder sees one ordinary IDAT stream.
//
// Plain C interface, loaded with ctypes (ecgmm_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

template <typename F>
void parallel_rows(int64_t n_rows, F&& fn) {
  unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  unsigned n_threads = std::min<unsigned>(std::min<int64_t>(hw, n_rows), 8u);
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

// Pillow's bilinear tap table for one axis (upscale or downscale): for
// output index i, source taps [lo, hi) with normalized triangle weights.
// This reproduces Pillow's coefficient computation for the BILINEAR
// filter (support 1.0, filterscale = max(1, in/out), weights renormalized
// over in-range taps), which serve/request.resize_bilinear_f32 copies.
struct TapTable {
  std::vector<int> lo, n;
  std::vector<double> w;  // per output index: n[i] weights at w[i*max_n..]
  int max_n;
};

TapTable build_taps(int64_t in, int64_t out) {
  TapTable t;
  double scale = static_cast<double>(in) / static_cast<double>(out);
  double filterscale = std::max(scale, 1.0);
  double support = 1.0 * filterscale;  // triangle filter support
  t.max_n = static_cast<int>(std::ceil(support) * 2 + 1);
  t.lo.resize(out);
  t.n.resize(out);
  t.w.assign(static_cast<size_t>(out) * t.max_n, 0.0);
  for (int64_t i = 0; i < out; ++i) {
    double center = (i + 0.5) * scale;
    int64_t xmin = static_cast<int64_t>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int64_t xmax = static_cast<int64_t>(center + support + 0.5);
    if (xmax > in) xmax = in;
    double sum = 0.0;
    int k = 0;
    // Pillow multiplies by the precomputed reciprocal rather than dividing
    double inv_fs = 1.0 / filterscale;
    for (int64_t x = xmin; x < xmax; ++x) {
      double arg = (x + 0.5 - center) * inv_fs;
      double wv = (arg < 0 ? -arg : arg) < 1.0 ? 1.0 - std::abs(arg) : 0.0;
      t.w[i * t.max_n + k] = wv;
      sum += wv;
      ++k;
    }
    if (sum > 0.0)
      for (int j = 0; j < k; ++j) t.w[i * t.max_n + j] /= sum;
    t.lo[i] = static_cast<int>(xmin);
    t.n[i] = k;
  }
  return t;
}

}  // namespace

extern "C" {

// Fused CAM bilinear upsample + jet-LUT alpha blend.
//   img:  [h, w, 3] uint8 C-contiguous
//   cam:  [ch, cw] float32 (any resolution; typically 7x7)
//   lut:  [256, 3] uint8 colormap
//   out:  [h, w, 3] uint8
// alpha / one_minus_alpha are passed separately so the blend uses the
// exact float32 constants numpy derives ((1 - alpha) computed in Python
// double then rounded once to float32).
void ecgmm_cam_overlay(const uint8_t* img, int64_t h, int64_t w,
                       const float* cam, int64_t ch, int64_t cw,
                       float alpha, float one_minus_alpha,
                       const uint8_t* lut, uint8_t* out) {
  TapTable tx = build_taps(cw, w);
  TapTable ty = build_taps(ch, h);
  // Horizontal pass once for every cam row (ch is tiny — do it up front).
  // Pillow's two-pass resample stores the horizontal intermediate as a
  // float32 image (double accumulate, float store) — match that rounding
  // so the final pixels are bit-identical to Image.resize(BILINEAR).
  std::vector<float> hrow(static_cast<size_t>(ch) * w);
  for (int64_t cy = 0; cy < ch; ++cy) {
    const float* src = cam + cy * cw;
    float* dst = hrow.data() + cy * w;
    for (int64_t x = 0; x < w; ++x) {
      double acc = 0.0;
      const double* wp = tx.w.data() + x * tx.max_n;
      int lo = tx.lo[x], n = tx.n[x];
      for (int k = 0; k < n; ++k) acc += wp[k] * src[lo + k];
      dst[x] = static_cast<float>(acc);
    }
  }
  parallel_rows(h, [&](int64_t r0, int64_t r1) {
    for (int64_t y = r0; y < r1; ++y) {
      const double* wp = ty.w.data() + y * ty.max_n;
      int lo = ty.lo[y], n = ty.n[y];
      const uint8_t* ip = img + y * w * 3;
      uint8_t* op = out + y * w * 3;
      for (int64_t x = 0; x < w; ++x) {
        double acc = 0.0;
        for (int k = 0; k < n; ++k) acc += wp[k] * hrow[(lo + k) * w + x];
        // match numpy: clip(float32(cam) * 255.0f, 0, 255) -> trunc u8
        float camf = static_cast<float>(acc);
        float scaled = camf * 255.0f;
        if (scaled < 0.0f) scaled = 0.0f;
        if (scaled > 255.0f) scaled = 255.0f;
        const uint8_t* heat = lut + static_cast<uint8_t>(scaled) * 3;
        for (int c = 0; c < 3; ++c) {
          // numpy computes each product separately in float32; the
          // library's -ffp-contract=off keeps them unfused here
          float v = one_minus_alpha * static_cast<float>(ip[x * 3 + c]);
          float hv = alpha * static_cast<float>(heat[c]);
          op[x * 3 + c] = static_cast<uint8_t>(v + hv);
        }
      }
    }
  });
}

// Complete RGB8 PNG encode with Sub row filtering and band-parallel
// deflate. Returns 0 on success, -1 if out_cap is too small, -2 on a
// zlib error. out_len receives the PNG byte count.
int ecgmm_png_encode_sub(const uint8_t* rgb, int64_t h, int64_t w,
                         int level, uint8_t* out, int64_t out_cap,
                         int64_t* out_len) {
  const int64_t rowbytes = 1 + 3 * w;
  unsigned hw_threads = std::max(1u, std::thread::hardware_concurrency());
  int n_bands = static_cast<int>(std::min<int64_t>(
      std::min<unsigned>(hw_threads, 8u), std::max<int64_t>(h / 16, 1)));
  std::vector<int64_t> band_lo(n_bands + 1);
  for (int b = 0; b <= n_bands; ++b) band_lo[b] = h * b / n_bands;

  struct Band {
    std::vector<uint8_t> comp;
    size_t comp_len = 0;
    uint64_t adler = 0;
    int64_t raw_len = 0;
    int err = 0;
  };
  std::vector<Band> bands(n_bands);
  std::vector<std::thread> threads;
  threads.reserve(n_bands);
  for (int b = 0; b < n_bands; ++b) {
    threads.emplace_back([&, b] {
      Band& bd = bands[b];
      int64_t r0 = band_lo[b], r1 = band_lo[b + 1];
      int64_t nraw = (r1 - r0) * rowbytes;
      std::vector<uint8_t> filt(static_cast<size_t>(nraw));
      for (int64_t y = r0; y < r1; ++y) {
        const uint8_t* src = rgb + y * w * 3;
        uint8_t* dst = filt.data() + (y - r0) * rowbytes;
        dst[0] = 1;  // Sub filter
        dst[1] = src[0];
        dst[2] = src[1];
        dst[3] = src[2];
        for (int64_t i = 3; i < 3 * w; ++i)
          dst[1 + i] = static_cast<uint8_t>(src[i] - src[i - 3]);
      }
      bd.raw_len = nraw;
      bd.adler = adler32(adler32(0L, Z_NULL, 0), filt.data(),
                         static_cast<uInt>(nraw));
      z_stream zs;
      std::memset(&zs, 0, sizeof(zs));
      if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                       Z_DEFAULT_STRATEGY) != Z_OK) {
        bd.err = 1;
        return;
      }
      bd.comp.resize(deflateBound(&zs, static_cast<uLong>(nraw)) + 16);
      zs.next_in = filt.data();
      zs.avail_in = static_cast<uInt>(nraw);
      zs.next_out = bd.comp.data();
      zs.avail_out = static_cast<uInt>(bd.comp.size());
      int flush = (b == n_bands - 1) ? Z_FINISH : Z_FULL_FLUSH;
      int rc = deflate(&zs, flush);
      if ((flush == Z_FINISH && rc != Z_STREAM_END) ||
          (flush != Z_FINISH && rc != Z_OK) || zs.avail_in != 0) {
        bd.err = 1;
        deflateEnd(&zs);
        return;
      }
      bd.comp_len = bd.comp.size() - zs.avail_out;
      deflateEnd(&zs);
    });
  }
  for (auto& th : threads) th.join();
  for (auto& bd : bands)
    if (bd.err) return -2;

  size_t idat_len = 2;  // zlib header
  uint64_t adler = adler32(0L, Z_NULL, 0);
  for (auto& bd : bands) {
    idat_len += bd.comp_len;
    adler = adler32_combine(static_cast<uLong>(adler),
                            static_cast<uLong>(bd.adler),
                            static_cast<z_off_t>(bd.raw_len));
  }
  idat_len += 4;  // adler32 trailer
  size_t total = 8 + (12 + 13) + (12 + idat_len) + 12;
  if (static_cast<int64_t>(total) > out_cap) return -1;

  auto put32 = [](uint8_t* p, uint32_t v) {
    p[0] = static_cast<uint8_t>(v >> 24);
    p[1] = static_cast<uint8_t>(v >> 16);
    p[2] = static_cast<uint8_t>(v >> 8);
    p[3] = static_cast<uint8_t>(v);
  };
  uint8_t* p = out;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                 '\n'};
  std::memcpy(p, sig, 8);
  p += 8;
  // IHDR
  put32(p, 13);
  std::memcpy(p + 4, "IHDR", 4);
  put32(p + 8, static_cast<uint32_t>(w));
  put32(p + 12, static_cast<uint32_t>(h));
  p[16] = 8;   // bit depth
  p[17] = 2;   // color type RGB
  p[18] = 0;   // compression
  p[19] = 0;   // filter method
  p[20] = 0;   // no interlace
  put32(p + 21, static_cast<uint32_t>(
                    crc32(crc32(0L, Z_NULL, 0), p + 4, 17)));
  p += 25;
  // IDAT
  put32(p, static_cast<uint32_t>(idat_len));
  std::memcpy(p + 4, "IDAT", 4);
  uint8_t* d = p + 8;
  d[0] = 0x78;  // CMF: deflate, 32k window
  d[1] = 0x01;  // FLG: fastest, (0x7801 % 31) == 0
  d += 2;
  for (auto& bd : bands) {
    std::memcpy(d, bd.comp.data(), bd.comp_len);
    d += bd.comp_len;
  }
  put32(d, static_cast<uint32_t>(adler));
  d += 4;
  uLong crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, p + 4, static_cast<uInt>(4 + idat_len));
  put32(d, static_cast<uint32_t>(crc));
  p = d + 4;
  // IEND
  put32(p, 0);
  std::memcpy(p + 4, "IEND", 4);
  put32(p + 8, static_cast<uint32_t>(
                   crc32(crc32(0L, Z_NULL, 0), p + 4, 4)));
  p += 12;
  *out_len = static_cast<int64_t>(p - out);
  return 0;
}

}  // extern "C"
