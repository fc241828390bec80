// Pillow's bilinear and bicubic resizes of an 8-bit image, bit for bit
// (`Image.fromarray(img).resize((ow, oh), Image.Resampling.BILINEAR)`, the
// call the JAX serving request makes to bring the strip to the model's
// 224x224, and `resize((ow, oh))`, whose default filter is BICUBIC, the
// digitizer envelope's downscale). Pillow's Resample.c: per axis,
// `precompute_coeffs` gives each output sample its source taps and the
// filter's weights (triangle of support 1, or the cubic of a = -0.5 and
// support 2; in double, the
// filter's support widened by the downscale factor, renormalized over
// the taps inside the image), `normalize_coeffs_8bpc` turns them into
// 22-bit fixed point, and the horizontal pass runs first (over only the
// rows the vertical pass reads), each sum starting at half a unit and
// clipped to [0, 255] after the shift. An axis whose size does not change
// is not resampled. ecgmm_torch/serve/request.resize_bilinear_u8 is the
// same algorithm in numpy, kept as the plain version.
//
// Plain C interface, loaded with ctypes (ecgmm_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

struct Coeffs {
  int ksize;
  std::vector<int64_t> xmin, n;
  std::vector<int32_t> k;  // out_size x ksize, 22-bit fixed point
};

// Pillow's filters: bilinear (support 1) and bicubic (a = -0.5, support 2)
double bilinear(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

double bicubic(double x) {
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

Coeffs precompute(int64_t in_size, int64_t out_size, bool cubic) {
  Coeffs c;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = (cubic ? 2.0 : 1.0) * filterscale;
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.xmin.resize(out_size);
  c.n.resize(out_size);
  c.k.assign(static_cast<size_t>(out_size) * c.ksize, 0);
  std::vector<double> kk(c.ksize);
  for (int64_t xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    const double ss = 1.0 / filterscale;
    int64_t xmin = static_cast<int64_t>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int64_t xmax = static_cast<int64_t>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int64_t x = 0; x < xmax; ++x) {
      const double arg = (x + xmin - center + 0.5) * ss;
      const double w = cubic ? bicubic(arg) : bilinear(arg);
      kk[x] = w;
      ww += w;
    }
    for (int64_t x = 0; x < xmax; ++x) {
      if (ww != 0.0) kk[x] /= ww;
      const double v = kk[x] * (1 << kPrecisionBits);
      c.k[xx * c.ksize + x] = static_cast<int32_t>(v < 0 ? -0.5 + v : 0.5 + v);
    }
    c.xmin[xx] = xmin;
    c.n[xx] = xmax;
  }
  return c;
}

inline uint8_t clip8(int32_t ss) {
  const int32_t v = ss >> kPrecisionBits;
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

template <typename F>
void parallel_rows(int64_t n_rows, F&& fn) {
  unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  unsigned n_threads = static_cast<unsigned>(
      std::min<int64_t>(std::min<unsigned>(hw, 8u), n_rows / 16));
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

int resize_u8(const uint8_t* img, int64_t h, int64_t w, int c, int64_t oh,
              int64_t ow, uint8_t* out, bool cubic) {
  const bool need_h = ow != w, need_v = oh != h;
  if (!need_h && !need_v) {
    std::memcpy(out, img, static_cast<size_t>(h * w * c));
    return 0;
  }
  const Coeffs cv = precompute(h, oh, cubic);
  // the rows the vertical pass reads (all of them when it does not run)
  const int64_t y_first = need_v ? cv.xmin[0] : 0;
  const int64_t y_last = need_v ? cv.xmin[oh - 1] + cv.n[oh - 1] : h;
  const uint8_t* src = img + y_first * w * c;
  std::vector<uint8_t> tmp;
  if (need_h) {
    const Coeffs ch = precompute(w, ow, cubic);
    uint8_t* dst = out;
    if (need_v) {
      tmp.resize(static_cast<size_t>((y_last - y_first) * ow * c));
      dst = tmp.data();
    }
    parallel_rows(y_last - y_first, [&](int64_t r0, int64_t r1) {
      for (int64_t y = r0; y < r1; ++y) {
        const uint8_t* row = src + y * w * c;
        uint8_t* orow = dst + y * ow * c;
        for (int64_t xx = 0; xx < ow; ++xx) {
          const int32_t* k = ch.k.data() + xx * ch.ksize;
          const uint8_t* px = row + ch.xmin[xx] * c;
          for (int ci = 0; ci < c; ++ci) {
            int32_t ss = 1 << (kPrecisionBits - 1);
            for (int64_t x = 0; x < ch.n[xx]; ++x)
              ss += static_cast<int32_t>(px[x * c + ci]) * k[x];
            orow[xx * c + ci] = clip8(ss);
          }
        }
      }
    });
    if (!need_v) return 0;
    src = tmp.data();
  }
  const int64_t sw = need_h ? ow : w;
  parallel_rows(oh, [&](int64_t r0, int64_t r1) {
    for (int64_t yy = r0; yy < r1; ++yy) {
      const int32_t* k = cv.k.data() + yy * cv.ksize;
      const uint8_t* base = src + (cv.xmin[yy] - y_first) * sw * c;
      uint8_t* orow = out + yy * sw * c;
      for (int64_t j = 0; j < sw * c; ++j) {
        int32_t ss = 1 << (kPrecisionBits - 1);
        for (int64_t y = 0; y < cv.n[yy]; ++y)
          ss += static_cast<int32_t>(base[y * sw * c + j]) * k[y];
        orow[j] = clip8(ss);
      }
    }
  });
  return 0;
}

}  // namespace

extern "C" {

// img: [h, w, c] uint8 row-major; out: [oh, ow, c] uint8. Returns 0.
int ecgmm_resize_bilinear_u8(const uint8_t* img, int64_t h, int64_t w,
                             int c, int64_t oh, int64_t ow, uint8_t* out) {
  return resize_u8(img, h, w, c, oh, ow, out, false);
}

int ecgmm_resize_bicubic_u8(const uint8_t* img, int64_t h, int64_t w, int c,
                            int64_t oh, int64_t ow, uint8_t* out) {
  return resize_u8(img, h, w, c, oh, ow, out, true);
}

}  // extern "C"
