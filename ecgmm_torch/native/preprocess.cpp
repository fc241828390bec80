// Host kernels of the hospital signal filter (port of
// ecgmm_tpu/native/preprocess.cpp): moving-average baseline removal with
// numpy's 'same' alignment and scipy's zero-phase filtfilt (odd extension
// of 3 * n_coef samples, steady-state initial conditions), in float64,
// threaded across rows. The serving request and the training data path
// (ecgmm_torch/data/preprocess.py) both call it, so train and serve share
// one filter.
//
// Plain C interface, loaded with ctypes (ecgmm_torch/native/__init__.py).
// All functions operate on row-major [n_signals, n_samples] float64
// buffers.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Parallel-for over rows with hardware-concurrency threads.
template <typename F>
void parallel_rows(int64_t n_rows, F&& fn) {
  unsigned n_threads = std::max(1u, std::thread::hardware_concurrency());
  if (n_rows < static_cast<int64_t>(n_threads) * 2) {
    for (int64_t i = 0; i < n_rows; ++i) fn(i);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  std::int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (unsigned t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n_rows, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([lo, hi, &fn] {
      for (int64_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

// numpy convolve(x, ones(w)/w, 'same'): same[i] = mean of
// x[i - (w-1-(w-1)/2) .. i + (w-1)/2]  (see data/preprocess.py notes).
void baseline_one(const double* x, double* out, int64_t n, int w) {
  const int lo_off = w - 1 - (w - 1) / 2;  // elements to the left
  const int hi_off = (w - 1) / 2;          // elements to the right
  // prefix sums for O(n) sliding mean
  std::vector<double> ps(n + 1, 0.0);
  for (int64_t i = 0; i < n; ++i) ps[i + 1] = ps[i] + x[i];
  const double inv_w = 1.0 / w;
  for (int64_t i = 0; i < n; ++i) {
    int64_t a = std::max<int64_t>(0, i - lo_off);
    int64_t b = std::min<int64_t>(n, i + hi_off + 1);
    double baseline = (ps[b] - ps[a]) * inv_w;  // zero-padded edges
    out[i] = x[i] - baseline;
  }
}

// Direct-form-II-transposed IIR, a[0]==1, nb==na==n_coef.
void lfilter_one(const double* b, const double* a, int n_coef,
                 const double* x, double* y, int64_t n, double* d /*n_coef-1*/) {
  const int m = n_coef - 1;
  for (int64_t t = 0; t < n; ++t) {
    double xt = x[t];
    double yt = b[0] * xt + d[0];
    for (int i = 0; i < m - 1; ++i) {
      d[i] = b[i + 1] * xt + d[i + 1] - a[i + 1] * yt;
    }
    d[m - 1] = b[m] * xt - a[m] * yt;
    y[t] = yt;
  }
}

// scipy filtfilt (method='pad', padtype='odd',
// padlen=3*max(len(a),len(b))) on one row.
void filtfilt_one(const double* b, const double* a, const double* zi,
                  int n_coef, const double* x, double* out, int64_t n) {
  const int padlen = 3 * n_coef;
  const int64_t ext_n = n + 2 * padlen;
  std::vector<double> ext(ext_n), tmp(ext_n), d(n_coef - 1);

  // odd extension
  for (int i = 0; i < padlen; ++i)
    ext[i] = 2.0 * x[0] - x[padlen - i];
  std::memcpy(ext.data() + padlen, x, n * sizeof(double));
  for (int i = 0; i < padlen; ++i)
    ext[padlen + n + i] = 2.0 * x[n - 1] - x[n - 2 - i];

  // forward pass, state scaled by first sample
  for (int i = 0; i < n_coef - 1; ++i) d[i] = zi[i] * ext[0];
  lfilter_one(b, a, n_coef, ext.data(), tmp.data(), ext_n, d.data());

  // backward pass on reversed forward output
  std::reverse(tmp.begin(), tmp.end());
  for (int i = 0; i < n_coef - 1; ++i) d[i] = zi[i] * tmp[0];
  lfilter_one(b, a, n_coef, tmp.data(), ext.data(), ext_n, d.data());
  std::reverse(ext.begin(), ext.end());

  std::memcpy(out, ext.data() + padlen, n * sizeof(double));
}

}  // namespace

extern "C" {

// signal - moving_average(signal, w), batched.
void ecgmm_remove_baseline(const double* x, double* out, int64_t n_rows,
                           int64_t n_samples, int window) {
  parallel_rows(n_rows, [&](int64_t i) {
    baseline_one(x + i * n_samples, out + i * n_samples, n_samples, window);
  });
}

// Batched zero-phase IIR (scipy.signal.filtfilt defaults).
void ecgmm_filtfilt(const double* b, const double* a, const double* zi,
                    int n_coef, const double* x, double* out,
                    int64_t n_rows, int64_t n_samples) {
  parallel_rows(n_rows, [&](int64_t i) {
    filtfilt_one(b, a, zi, n_coef, x + i * n_samples, out + i * n_samples,
                 n_samples);
  });
}

// Fused hospital pipeline (dataset.py:91-95): baseline removal then
// low-pass filtfilt, one pass per row, threaded.
void ecgmm_preprocess_hospital(const double* b, const double* a,
                               const double* zi, int n_coef, int window,
                               const double* x, double* out, int64_t n_rows,
                               int64_t n_samples) {
  parallel_rows(n_rows, [&](int64_t i) {
    std::vector<double> base(n_samples);
    baseline_one(x + i * n_samples, base.data(), n_samples, window);
    filtfilt_one(b, a, zi, n_coef, base.data(), out + i * n_samples,
                 n_samples);
  });
}

}  // extern "C"
