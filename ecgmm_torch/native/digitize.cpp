// Host kernels of the strip digitizer (port of
// ecgmm_tpu/native/digitize.cpp; ecgmm_torch/serve/digitize.py dispatches
// to them). The numpy digitizer holds the interpreter lock across many
// small passes, so concurrent requests on the threaded HTTP server
// serialize on it. These kernels fuse its expensive sweeps: the
// relative-darkness map (channel max, grayscale closing, normalisation)
// with its column and row maxima, the per-column weighted trace sums and
// the gridness map, each a threaded pass that runs with the lock released
// (ctypes drops it for the call).
//
// Numerics match the numpy path exactly where the math is
// order-independent (the darkness map, the gridness map and the maxima
// are the same float32 expressions; max is order-free) and to float
// tolerance where the accumulation order differs (the centroid's weighted
// sums run in float64 here, numpy's pairwise in float32). The ink-floor
// percentile stays in Python, so the `valid` mask is threshold-bit-exact.
// The library is built with -ffp-contract=off, so no float expression
// here becomes a fused multiply-add.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Parallel-for over [0, n) index blocks with hardware threads. `grain`
// keeps block boundaries aligned (pass the closing window so each
// thread owns whole block-rows of the tile grid).
template <typename F>
void parallel_blocks(int64_t n, int64_t grain, F&& fn) {
  unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  unsigned n_threads = std::min(hw, 8u);
  int64_t n_grains = (n + grain - 1) / grain;
  if (n_grains < 2 || n_threads < 2) {
    fn(0, n);
    return;
  }
  if (static_cast<int64_t>(n_threads) > n_grains)
    n_threads = static_cast<unsigned>(n_grains);
  int64_t per = (n_grains + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (unsigned t = 0; t < n_threads; ++t) {
    int64_t lo = static_cast<int64_t>(t) * per * grain;
    int64_t hi = std::min(n, lo + per * grain);
    if (lo >= hi) break;
    threads.emplace_back([lo, hi, &fn] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

// Channel max (uint8) for rows [r0, r1): paper is bright in all
// channels, the light-red grid stays bright in R, the trace is dark in
// all — so max-over-channels suppresses the grid (digitize.py
// darkness_map).
void channel_max_rows(const uint8_t* img, int64_t w, int c, int64_t r0,
                      int64_t r1, uint8_t* bright) {
  if (c == 1) {
    std::memcpy(bright + r0 * w, img + r0 * w,
                static_cast<size_t>((r1 - r0) * w));
    return;
  }
  for (int64_t i = r0; i < r1; ++i) {
    const uint8_t* row = img + i * w * c;
    uint8_t* out = bright + i * w;
    if (c == 3) {  // the common case; fixed stride vectorizes
      for (int64_t j = 0; j < w; ++j)
        out[j] = std::max(std::max(row[3 * j], row[3 * j + 1]),
                          row[3 * j + 2]);
    } else {
      for (int64_t j = 0; j < w; ++j) {
        const uint8_t* px = row + j * c;
        uint8_t m = px[0];
        for (int k = 1; k < c; ++k) m = std::max(m, px[k]);
        out[j] = m;
      }
    }
  }
}

}  // namespace

extern "C" {

// Fused darkness map + per-column and per-row maxima.
//
//   img      uint8 [h, w, c] row-major (c = 1 grayscale or >= 3 RGB[A];
//            only the first 3 channels participate, matching numpy's
//            max over the RGB planes — callers pass c <= 3)
//   rel      float32 [h, w] out: relative ink darkness in [0, 1]
//   col_max  float32 [w] out: per-column max of rel (order-free, exact)
//   row_max  float32 [h] out: per-row max of rel (the crop ink veto's
//            reduction — emitting it here removes a full-frame
//            GIL-held numpy pass per scene photo); may be null
//
// Matches digitize.py darkness_map(image, bg_window) bit-for-bit:
// bright = channel max; paper = grayscale closing (bg_window block max,
// then min over 2x2 groups of blocks, edge-padded exactly like the
// numpy np.pad(..., 'edge') path) clamped to >= 1; rel =
// clip((paper - bright) / paper, 0, 1) evaluated in float32.
void ecgmm_digitize_darkness(const uint8_t* img, int64_t h, int64_t w,
                             int c, int bg_window, float* rel,
                             float* col_max, float* row_max) {
  const int64_t bw = bg_window;
  const int64_t hb = (h + bw - 1) / bw;   // tile-grid rows
  const int64_t wb = (w + bw - 1) / bw;   // tile-grid cols
  std::vector<uint8_t> bright(static_cast<size_t>(h) * w);
  std::vector<uint8_t> blocks(static_cast<size_t>(hb) * wb, 0);

  // Pass 1 (threaded over whole tile-rows): channel max + block max.
  parallel_blocks(h, bw, [&](int64_t r0, int64_t r1) {
    channel_max_rows(img, w, c, r0, r1, bright.data());
    for (int64_t bi = r0 / bw; bi < (r1 + bw - 1) / bw; ++bi) {
      int64_t i0 = bi * bw, i1 = std::min(h, i0 + bw);
      uint8_t* brow = blocks.data() + bi * wb;
      for (int64_t i = i0; i < i1; ++i) {
        const uint8_t* src = bright.data() + i * w;
        for (int64_t bj = 0; bj < wb; ++bj) {
          int64_t j0 = bj * bw, j1 = std::min(w, j0 + bw);
          uint8_t m = brow[bj];
          for (int64_t j = j0; j < j1; ++j) m = std::max(m, src[j]);
          brow[bj] = m;
        }
      }
    }
  });

  // Closing on the tiny tile grid: edge-pad to even dims, min over
  // non-overlapping 2x2 groups (numpy _closing).
  const int64_t ch = (hb + 1) / 2, cw = (wb + 1) / 2;
  std::vector<float> closed(static_cast<size_t>(ch) * cw);
  for (int64_t ci = 0; ci < ch; ++ci) {
    int64_t i0 = 2 * ci, i1 = std::min(hb - 1, i0 + 1);
    for (int64_t cj = 0; cj < cw; ++cj) {
      int64_t j0 = 2 * cj, j1 = std::min(wb - 1, j0 + 1);
      uint8_t m = std::min(
          std::min(blocks[i0 * wb + j0], blocks[i0 * wb + j1]),
          std::min(blocks[i1 * wb + j0], blocks[i1 * wb + j1]));
      closed[ci * cw + cj] = std::max(static_cast<float>(m), 1.0f);
    }
  }

  // Pass 2 (threaded over row bands aligned to the upsample period):
  // rel = clip((paper - bright) / paper, 0, 1) + per-band column maxima.
  unsigned hw_threads = std::max(1u, std::thread::hardware_concurrency());
  unsigned max_bands = std::min(hw_threads, 8u);
  std::vector<std::vector<float>> band_max(
      max_bands, std::vector<float>(static_cast<size_t>(w), 0.0f));
  const int64_t period = 2 * bw;  // one closing cell spans 2*bw rows
  std::vector<std::thread> threads;
  int64_t n_cells = (h + period - 1) / period;
  unsigned n_bands =
      std::min<int64_t>(max_bands, std::max<int64_t>(1, n_cells));
  int64_t cells_per = (n_cells + n_bands - 1) / n_bands;
  for (unsigned t = 0; t < n_bands; ++t) {
    int64_t r0 = static_cast<int64_t>(t) * cells_per * period;
    int64_t r1 = std::min(h, r0 + cells_per * period);
    if (r0 >= r1) break;
    float* cmax = band_max[t].data();
    threads.emplace_back([&, r0, r1, cmax] {
      for (int64_t i = r0; i < r1; ++i) {
        const float* prow = closed.data() + (i / period) * cw;
        const uint8_t* brow = bright.data() + i * w;
        float* orow = rel + i * w;
        float rmax = 0.0f;
        // one closing cell spans `period` columns — hoist the paper
        // value and reciprocal per cell so the inner loop is a flat
        // fused multiply/clamp the compiler can vectorize
        // (true division, not reciprocal-multiply: the rel map is
        // bit-exact against numpy's float32 `(paper - bright) / paper`)
        for (int64_t jb = 0; jb < w; jb += period) {
          const float paper = prow[jb / period];
          const int64_t je = std::min(w, jb + period);
          for (int64_t j = jb; j < je; ++j) {
            float r = (paper - static_cast<float>(brow[j])) / paper;
            r = std::min(1.0f, std::max(0.0f, r));
            orow[j] = r;
            cmax[j] = std::max(cmax[j], r);
            rmax = std::max(rmax, r);
          }
        }
        // bands own disjoint row ranges: no contention on row_max
        if (row_max != nullptr) row_max[i] = rmax;
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int64_t j = 0; j < w; ++j) {
    float m = 0.0f;
    for (unsigned t = 0; t < n_bands; ++t)
      m = std::max(m, band_max[t][j]);
    col_max[j] = m;
  }
}

// Per-column darkness-weighted sums (the hot h×w sweep of digitize.py
// extract_trace): for each column j,
//   weights = rel where rel >= thr[j] else 0   (float32 compare — the
//             caller computes thr with numpy's own float32 promotion,
//             so the inclusion set is bit-identical to the numpy path)
//   wsum[j] = sum(weights)                     (float64 accumulate)
//   wrow[j] = sum(weights * row_index)
// The caller (Python) derives valid/centroid from these — O(w) work —
// keeping every comparison in numpy semantics.
void ecgmm_trace_sums(const float* rel, int64_t h, int64_t w,
                      const float* thr, double* wsum, double* wrow) {
  parallel_blocks(w, 256, [&](int64_t c0, int64_t c1) {
    int64_t n = c1 - c0;
    for (int64_t j = 0; j < n; ++j) {
      wsum[c0 + j] = 0.0;
      wrow[c0 + j] = 0.0;
    }
    for (int64_t i = 0; i < h; ++i) {
      const float* row = rel + i * w + c0;
      const double di = static_cast<double>(i);
      double* ws = wsum + c0;
      double* wr = wrow + c0;
      for (int64_t j = 0; j < n; ++j) {
        float v = row[j];
        if (v >= thr[c0 + j]) {
          ws[j] += static_cast<double>(v);
          wr[j] += di * static_cast<double>(v);
        }
      }
    }
  });
}

// Fused gridness map (digitize.py _grid_analysis / gridness_map): from
// a uint8 RGB[A] image, compute — optionally 2x2-max-pooled — redness
// (R - max(G, B), int16) and brightness (max channel) maps, then the
// local-contrast gridness
//   g        = max(redness, 0) as float32
//   base     = bg_window-tile block MIN of g, upsampled
//   contrast = max(g - base, 0)
//   paper    = grayscale closing of brightness (block max, 2x2 block
//              min), clamped >= 1
//   out      = 255 * contrast / paper
// bit-exactly as the numpy path evaluates it (same float32 ops; the
// pooling is a max, order-free). `pool` is 1 or 2; pooled dims are
// floor(h/pool) x floor(w/pool) (numpy _pool2_max crops to even).
// bright_out receives the pooled brightness for the caller's
// paper-fallback box search.
void ecgmm_gridness(const uint8_t* img, int64_t h, int64_t w, int c,
                    int pool, int bg_window, float* g_out,
                    uint8_t* bright_out) {
  const int64_t hp = h / pool, wp = w / pool;
  const int64_t bw = bg_window;
  const int64_t hb = (hp + bw - 1) / bw, wb = (wp + bw - 1) / bw;

  // Pass A (threaded over whole tile-rows of the pooled grid): pooled
  // redness -> g_out, pooled brightness -> bright_out, plus per-tile
  // block MIN of g and block MAX of brightness.
  std::vector<float> base(static_cast<size_t>(hb) * wb, 3.4e38f);
  std::vector<uint8_t> bmax(static_cast<size_t>(hb) * wb, 0);
  parallel_blocks(hp, bw, [&](int64_t r0, int64_t r1) {
    for (int64_t i = r0; i < r1; ++i) {
      float* grow = g_out + i * wp;
      uint8_t* brow = bright_out + i * wp;
      for (int p = 0; p < pool; ++p) {
        const uint8_t* src = img + (i * pool + p) * w * c;
        for (int64_t j = 0; j < wp; ++j) {
          int red = -255;
          int bri = 0;
          for (int q = 0; q < pool; ++q) {
            const uint8_t* px = src + (j * pool + q) * c;
            int r = px[0];
            int gb = px[1];
            for (int k = 2; k < (c < 3 ? c : 3); ++k)
              gb = std::max(gb, static_cast<int>(px[k]));
            red = std::max(red, r - gb);
            bri = std::max({bri, r, gb});
          }
          if (p == 0) {
            grow[j] = static_cast<float>(std::max(red, 0));
            brow[j] = static_cast<uint8_t>(bri);
          } else {
            grow[j] = std::max(
                grow[j], static_cast<float>(std::max(red, 0)));
            brow[j] = std::max(brow[j], static_cast<uint8_t>(bri));
          }
        }
      }
      // fold this pooled row into its tile-grid row
      const int64_t bi = i / bw;
      float* baserow = base.data() + bi * wb;
      uint8_t* bmaxrow = bmax.data() + bi * wb;
      for (int64_t bj = 0; bj < wb; ++bj) {
        int64_t j0 = bj * bw, j1 = std::min(wp, j0 + bw);
        float mn = baserow[bj];
        uint8_t mx = bmaxrow[bj];
        for (int64_t j = j0; j < j1; ++j) {
          mn = std::min(mn, grow[j]);
          mx = std::max(mx, brow[j]);
        }
        baserow[bj] = mn;
        bmaxrow[bj] = mx;
      }
    }
  });

  // Closing of brightness on the tiny tile grid (edge-pad, 2x2 min).
  const int64_t ch = (hb + 1) / 2, cw = (wb + 1) / 2;
  std::vector<float> paper(static_cast<size_t>(ch) * cw);
  for (int64_t ci = 0; ci < ch; ++ci) {
    int64_t i0 = 2 * ci, i1 = std::min(hb - 1, i0 + 1);
    for (int64_t cj = 0; cj < cw; ++cj) {
      int64_t j0 = 2 * cj, j1 = std::min(wb - 1, j0 + 1);
      uint8_t m = std::min(
          std::min(bmax[i0 * wb + j0], bmax[i0 * wb + j1]),
          std::min(bmax[i1 * wb + j0], bmax[i1 * wb + j1]));
      paper[ci * cw + cj] = std::max(static_cast<float>(m), 1.0f);
    }
  }

  // Pass B (threaded): out = 255 * max(g - base, 0) / paper, with the
  // per-cell constants hoisted (the numpy path evaluates
  // `255.0f * contrast / paper` left-associatively — match it).
  const int64_t period = 2 * bw;
  parallel_blocks(hp, period, [&](int64_t r0, int64_t r1) {
    for (int64_t i = r0; i < r1; ++i) {
      const float* baserow = base.data() + (i / bw) * wb;
      const float* prow = paper.data() + (i / period) * cw;
      float* grow = g_out + i * wp;
      for (int64_t jb = 0; jb < wp; jb += bw) {
        const float b0 = baserow[jb / bw];
        const float p0 = prow[jb / period];
        const int64_t je = std::min(wp, jb + bw);
        for (int64_t j = jb; j < je; ++j) {
          float contrast = std::max(grow[j] - b0, 0.0f);
          grow[j] = 255.0f * contrast / p0;
        }
      }
    }
  });
}

// Per-column maxima of a float32 [h, w] map (for callers that already
// hold a darkness map and only need extract_trace).
void ecgmm_colmax(const float* rel, int64_t h, int64_t w,
                  float* col_max) {
  parallel_blocks(w, 256, [&](int64_t c0, int64_t c1) {
    for (int64_t j = c0; j < c1; ++j) col_max[j] = 0.0f;
    for (int64_t i = 0; i < h; ++i) {
      const float* row = rel + i * w;
      for (int64_t j = c0; j < c1; ++j)
        col_max[j] = std::max(col_max[j], row[j]);
    }
  });
}

}  // extern "C"
