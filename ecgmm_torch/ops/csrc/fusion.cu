// AttentionFusion head for Hopper: softmax-weighted concat + row LayerNorm,
// forward and backward.
//
// Replaces the TPU kernel `fused_attention_fusion`
// (ecgmm_tpu/ops/pallas_fusion.py:61-127):
//   sw  = softmax(w[0:3])
//   f   = concat(sw0 * img, sw1 * sig, sw2 * clin)            (B, D) f32
//   out = (f - mean(f)) * rsqrt(var(f) + eps) * scale + bias  biased var
// and the VJP of the reference expression that its custom_vjp takes
// (:136-142), in closed form. Per row, with x = concat(img, sig, clin),
// xh = (f - mu) * rstd and the cotangents go (B, D) and gsw (3,):
//   dxh = go * scale
//   df  = rstd * (dxh - mean(dxh) - xh * mean(dxh * xh)),  dx_k = sw_k * df
//   dscale = sum_b go * xh,  dbias = sum_b go,
//   dsw_k = sum_b sum_{chunk k} df * x + gsw_k,
//   dweights = sw * (dsw - sum_j sw_j dsw_j).
//
// Bound: bytes. Each row is read once and written once (~9 flops per
// element forward, ~16 backward); at the serving shapes (D = 672, B <= 32)
// the whole op is a few tens of kilobytes, so what a launch costs is its
// latency: the number of dependent steps, not the bandwidth.
//
// Design. A row is cut into slots of 128 elements of one chunk; lane l
// holds elements 4(32j + l) .. +3 of slot j with one 16-byte load where the
// chunk allows it (`vec`: width and offset multiples of 4 floats, pointers
// 16-byte aligned; 512, 128, 32 and 256 all do), else elements
// 128j + 32c + l, c = 0..3, with coalesced element loads. W warps share a
// row, each taking a contiguous run of its slots, and a block holds R
// rows (the wrapper, `ecgmm_torch/ops/fusion.py`, picks both:
// `warps_per_row`, `rows_per_block`). One warp alone runs a whole row's
// instructions in series and holds the row in up to 240 registers a
// thread, which measured the slowest at every batch from 1 to 4096 rows
// (PERF.md); so a block is one row split over W warps, one slot
// each up to B = 256 and fewer warps as B grows. Each reduction is a warp
// shuffle tree plus, where W > 1, one exchange of the warps' totals
// through shared memory behind one block barrier, added in warp order.
// Where W = 1 (rows of few slots at large B, or rows in shared memory), R
// rows per block and no block barrier. Where D <= 1024 a lane keeps its
// slots in registers (the kernels are instantiated for 1, 2, 3, 6 and 10
// slots per warp, so that few slots are computed for nothing); wider rows
// go in the warp's own slice of shared memory, one warp per row (the
// wrapper checks D against 12288). The soft
// weights are computed by every warp in the order of torch.softmax's warp
// kernel, so they agree to the bit. The forward takes the two-pass mean
// and centred variance of the Pallas body and, where autograd will need
// them, writes each row's (mu, rstd) to a (B, 2) residual. The rows
// backward reads that residual instead of recomputing, takes mean(dxh) and
// mean(dxh * xh) in one reduction, writes only the input gradients that
// are needed (a null pointer skips a chunk) and, where `weights` needs a
// gradient, the row's three dsw partial sums. With frozen parameters, as
// on the serving path, the backward is one launch.
// Where a parameter needs a gradient a second launch sums the columns:
// a grid of 32-column tiles x G row groups, G blocks of one tile forming a
// thread-block cluster (G = 1: a plain block). Each block's 8 warps take
// the group's rows in turn, the warps' sums are added in warp order, and
// the blocks' sums go to rank 0 through distributed shared memory and are
// added in rank order. The dsw partials are summed the same way, by the
// blocks of tile 0. No atomics: a relaunch gives the same bits.
//
// The fold axis (the CV fold program, `ecgmm_torch/train/cv_parallel.py`):
// F folds of B rows each, every fold with its own parameters (weights
// (F, 3), scale and bias (F, D)) and its own soft weights (F, 3). The fold
// is the grid's y index of all three kernels: fold f's blocks read and
// write rows f*B .. f*B + B-1 and fold f's parameters, and the parameter
// kernel sums only fold f's rows into fold f's gradients, in the same
// fixed order as one fold alone. All F folds are one launch of each
// kernel; the entry points without the fold axis are the same kernels at
// F = 1.
//
// Plain C interface (bound with ctypes): every entry point launches on the
// given stream, never synchronises, allocates nothing, and returns a CUDA
// error code (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRegSlots = 10;   // slots a row keeps in registers (D <= 1024)
constexpr int kSlotElems = 128;  // elements of a row in one slot of a warp
constexpr int kMaxWarps = 8;     // warps per block of the row kernels
constexpr int kParamWarps = 8;
constexpr int kParamCols = 32;   // columns per tile of the parameter kernel
constexpr int kMaxGroups = 8;    // row groups: a portable cluster size
constexpr int kMaxSmem = 232448;  // the opt-in limit of a block on sm_90
constexpr int kMaxDevices = 64;

struct SoftWeights {
    float s[3];
};

__device__ __forceinline__ SoftWeights soft_weights(
    const float* __restrict__ logits) {
    const float l0 = logits[0], l1 = logits[1], l2 = logits[2];
    const float m = fmaxf(l0, fmaxf(l1, l2));
    const float e0 = expf(l0 - m), e1 = expf(l1 - m), e2 = expf(l2 - m);
    // summed and divided in the order of torch.softmax's warp kernel for a
    // 3-wide row (lanes 0+2, then +1), so the soft weights agree to the bit
    const float sum = (e0 + e2) + e1;
    return {{e0 / sum, e1 / sum, e2 / sum}};
}

template <typename T>
__device__ __forceinline__ T pick(int k, T a, T b, T c) {
    return k == 0 ? a : (k == 1 ? b : c);
}

// the three chunks of a row: widths, offsets in the concatenated row, the
// first slot of each (start[3] = slots per row) and the 16-byte bit mask.
// A kernel parameter: indexed through pick, never by a runtime index,
// which would copy it to local memory.
struct Layout {
    int w[3];
    int off[3];
    int start[4];
    int vec;
    int D;
    __device__ __forceinline__ int width(int k) const {
        return pick(k, w[0], w[1], w[2]);
    }
    __device__ __forceinline__ int offset(int k) const {
        return pick(k, off[0], off[1], off[2]);
    }
};

__device__ __forceinline__ float warp_sum(float v) {
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float& comp(float4& v, int c) {
    return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// slot q of the row: its chunk, its index in the chunk, the width it is
// read and written with (0 where the slot is not this warp's: nothing is
// loaded, stored or summed) and its access kind
struct Slot {
    int k, j, w;
    bool vec;
};

__device__ __forceinline__ Slot slot_of(const Layout& L, int q, bool mine) {
    const int k = q < L.start[1] ? 0 : (q < L.start[2] ? 1 : 2);
    return {k, q - pick(k, 0, L.start[1], L.start[2]), mine ? L.width(k) : 0,
            ((L.vec >> k) & 1) != 0};
}

// index within its chunk of component c of lane `lane`'s part of slot j
__device__ __forceinline__ int elem(bool vec, int j, int lane, int c) {
    return vec ? 4 * (32 * j + lane) + c : kSlotElems * j + 32 * c + lane;
}

// slot j of a chunk row of width w at p; zeros past the row's end
__device__ __forceinline__ float4 load_slot(const float* __restrict__ p,
                                            int w, bool vec, int j,
                                            int lane) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (vec) {
        if (elem(true, j, lane, 0) < w)
            v = __ldg(reinterpret_cast<const float4*>(p) + 32 * j + lane);
        return v;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int e = elem(false, j, lane, c);
        if (e < w) comp(v, c) = __ldg(p + e);
    }
    return v;
}

__device__ __forceinline__ void store_slot(float* __restrict__ p, int w,
                                           bool vec, int j, int lane,
                                           float4 v) {
    if (vec) {
        if (elem(true, j, lane, 0) < w)
            reinterpret_cast<float4*>(p)[32 * j + lane] = v;
        return;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int e = elem(false, j, lane, c);
        if (e < w) p[e] = comp(v, c);
    }
}

// This warp's share of the block: its row b, its rank among the W warps
// of the row and its run of slots [q0, q0 + cnt) of the row's n
struct Part {
    int b, rank, q0, cnt;
};

__device__ __forceinline__ Part part_of(int n, int W) {
    const int warp = threadIdx.x >> 5;
    const int per = (n + W - 1) / W;
    Part p;
    p.b = blockIdx.x * ((blockDim.x >> 5) / W) + warp / W;
    p.rank = warp % W;
    p.q0 = p.rank * per;
    p.cnt = min(per, n - p.q0);
    return p;
}

// A warp's slots of one row: registers (kSlots > 0) or the lane's places
// in its warp's slice of shared memory (kSlots == 0)
template <int kSlots>
struct RowBuf {
    float4 reg[kSlots > 0 ? kSlots : 1];
    float4* sm;
    __device__ __forceinline__ float4& operator[](int i) {
        if constexpr (kSlots > 0) {
            return reg[i];
        } else {
            return sm[i * 32 + (threadIdx.x & 31)];
        }
    }
};

// f(i) for the warp's slots i < cnt. In registers the loop is unrolled
// over all kSlots with no branch, so that the loads of every slot issue
// together: a slot past the warp's run has width 0 (`slot_of`).
template <int kSlots, typename F>
__device__ __forceinline__ void for_slots(int cnt, F&& f) {
    if constexpr (kSlots > 0) {
#pragma unroll
        for (int i = 0; i < kSlots; ++i) f(i);
    } else {
        for (int i = 0; i < cnt; ++i) f(i);
    }
}

// v[0..N) summed over the row: each warp's shuffle tree, then, where W > 1
// warps share the row (one row per block), their totals through `red` in
// warp order behind one block barrier, so that every warp holds the same
// bits. Each call site has its own `red`: no second barrier.
template <int N>
__device__ __forceinline__ void row_sums(float (&v)[N],
                                         float (&red)[N][kMaxWarps], int W,
                                         int rank) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
    if (W == 1) return;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int k = 0; k < N; ++k) red[k][rank] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < N; ++k) {
        float t = 0.0f;
        for (int w = 0; w < W; ++w) t += red[k][w];
        v[k] = t;
    }
}

// W: warps per row (W > 1 only with one row per block and kSlots > 0).
// shared memory (kSlots == 0): one row of f per warp
template <int kSlots>
__global__ void __launch_bounds__(32 * kMaxWarps)
fusion_fwd(const float* __restrict__ img, const float* __restrict__ sig,
           const float* __restrict__ clin, const float* __restrict__ logits,
           const float* __restrict__ scale, const float* __restrict__ bias,
           float* __restrict__ out, float* __restrict__ sw_out,
           float* __restrict__ stats, int B, Layout L, int W, float eps) {
    extern __shared__ float4 smem[];
    __shared__ float red_mu[1][kMaxWarps], red_sq[1][kMaxWarps];
    const size_t fold = blockIdx.y;  // fold f's rows and parameters
    img += fold * B * L.w[0];
    sig += fold * B * L.w[1];
    clin += fold * B * L.w[2];
    logits += 3 * fold;
    scale += fold * L.D;
    bias += fold * L.D;
    out += fold * B * L.D;
    sw_out += 3 * fold;
    if (stats != nullptr) stats += 2 * fold * B;
    const int lane = threadIdx.x & 31;
    const int n = L.start[3];
    const Part p = part_of(n, W);
    if (p.b >= B) return;  // a whole block where W > 1 (one row per block)
    const int b = p.b;
    const float* row0 = img + (size_t)b * L.w[0];
    const float* row1 = sig + (size_t)b * L.w[1];
    const float* row2 = clin + (size_t)b * L.w[2];
    RowBuf<kSlots> f;
    f.sm = smem + (size_t)(threadIdx.x >> 5) * n * 32;
    // in registers, scale and bias are loaded with the row: one round trip
    // to memory before the reductions instead of two
    float4 sc[kSlots > 0 ? kSlots : 1], bi[kSlots > 0 ? kSlots : 1];
    for_slots<kSlots>(p.cnt, [&](int i) {
        const Slot s = slot_of(L, p.q0 + i, i < p.cnt);
        f[i] = load_slot(pick(s.k, row0, row1, row2), s.w, s.vec, s.j, lane);
        if constexpr (kSlots > 0) {
            const int off = L.offset(s.k);
            sc[i] = load_slot(scale + off, s.w, s.vec, s.j, lane);
            bi[i] = load_slot(bias + off, s.w, s.vec, s.j, lane);
        }
    });
    const SoftWeights sw = soft_weights(logits);
    if (b == 0 && p.rank == 0 && lane == 0) {
        sw_out[0] = sw.s[0];
        sw_out[1] = sw.s[1];
        sw_out[2] = sw.s[2];
    }

    float acc[1] = {0.0f};
    for_slots<kSlots>(p.cnt, [&](int i) {
        const int k = slot_of(L, p.q0 + i, i < p.cnt).k;
        const float wk = pick(k, sw.s[0], sw.s[1], sw.s[2]);
        float4 v = f[i];
        v.x *= wk;
        v.y *= wk;
        v.z *= wk;
        v.w *= wk;
        f[i] = v;
        acc[0] += (v.x + v.y) + (v.z + v.w);  // zeros past the row's end
    });
    row_sums(acc, red_mu, W, p.rank);
    const float inv_d = 1.0f / (float)L.D;
    const float mu = acc[0] * inv_d;

    float sq[1] = {0.0f};
    for_slots<kSlots>(p.cnt, [&](int i) {
        const Slot s = slot_of(L, p.q0 + i, i < p.cnt);
        float4 v = f[i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            if (elem(s.vec, s.j, lane, c) < s.w) {
                const float d = comp(v, c) - mu;
                sq[0] += d * d;
            }
        }
    });
    row_sums(sq, red_sq, W, p.rank);
    const float rstd = rsqrtf(sq[0] * inv_d + eps);
    if (stats != nullptr && p.rank == 0 && lane == 0) {
        stats[2 * (size_t)b] = mu;
        stats[2 * (size_t)b + 1] = rstd;
    }

    float* orow = out + (size_t)b * L.D;
    for_slots<kSlots>(p.cnt, [&](int i) {
        const Slot s = slot_of(L, p.q0 + i, i < p.cnt);
        const int off = L.offset(s.k);
        float4 scv, biv;
        if constexpr (kSlots > 0) {
            scv = sc[i];
            biv = bi[i];
        } else {
            scv = load_slot(scale + off, s.w, s.vec, s.j, lane);
            biv = load_slot(bias + off, s.w, s.vec, s.j, lane);
        }
        float4 v = f[i];
        float4 o;
#pragma unroll
        for (int c = 0; c < 4; ++c)
            comp(o, c) = (comp(v, c) - mu) * rstd * comp(scv, c)
                         + comp(biv, c);
        store_slot(orow + off, s.w, s.vec, s.j, lane, o);
    });
}

// W as in fusion_fwd. shared memory (kSlots == 0): per warp, a row of x,
// then a row of dxh. d_img, d_sig, d_clin and dsw_part (B, 3) may each be
// null.
template <int kSlots>
__global__ void __launch_bounds__(32 * kMaxWarps)
fusion_bwd_rows(const float* __restrict__ img, const float* __restrict__ sig,
                const float* __restrict__ clin,
                const float* __restrict__ logits,
                const float* __restrict__ scale,
                const float* __restrict__ go,
                const float* __restrict__ stats, float* __restrict__ d_img,
                float* __restrict__ d_sig, float* __restrict__ d_clin,
                float* __restrict__ dsw_part, int B, Layout L, int W) {
    extern __shared__ float4 smem[];
    __shared__ float red_d[2][kMaxWarps], red_p[3][kMaxWarps];
    const size_t fold = blockIdx.y;  // fold f's rows and parameters
    img += fold * B * L.w[0];
    sig += fold * B * L.w[1];
    clin += fold * B * L.w[2];
    logits += 3 * fold;
    scale += fold * L.D;
    go += fold * B * L.D;
    stats += 2 * fold * B;
    if (d_img != nullptr) d_img += fold * B * L.w[0];
    if (d_sig != nullptr) d_sig += fold * B * L.w[1];
    if (d_clin != nullptr) d_clin += fold * B * L.w[2];
    if (dsw_part != nullptr) dsw_part += 3 * fold * B;
    const int lane = threadIdx.x & 31;
    const int n = L.start[3];
    const Part p = part_of(n, W);
    if (p.b >= B) return;  // a whole block where W > 1 (one row per block)
    const int b = p.b;
    const SoftWeights sw = soft_weights(logits);
    const float mu = stats[2 * (size_t)b];
    const float rstd = stats[2 * (size_t)b + 1];
    const float* row0 = img + (size_t)b * L.w[0];
    const float* row1 = sig + (size_t)b * L.w[1];
    const float* row2 = clin + (size_t)b * L.w[2];
    const float* grow = go + (size_t)b * L.D;
    RowBuf<kSlots> x, dxh;
    x.sm = smem + (size_t)(threadIdx.x >> 5) * 2 * n * 32;
    dxh.sm = x.sm + (size_t)n * 32;

    // mean(dxh) and mean(dxh * xh); past the row's end x = dxh = 0, which
    // adds nothing
    float sums[2] = {0.0f, 0.0f};
    for_slots<kSlots>(p.cnt, [&](int i) {
        const Slot s = slot_of(L, p.q0 + i, i < p.cnt);
        const int off = L.offset(s.k);
        const float wk = pick(s.k, sw.s[0], sw.s[1], sw.s[2]);
        float4 xv = load_slot(pick(s.k, row0, row1, row2), s.w, s.vec, s.j,
                              lane);
        float4 gv = load_slot(grow + off, s.w, s.vec, s.j, lane);
        float4 sv = load_slot(scale + off, s.w, s.vec, s.j, lane);
        float4 dv;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            comp(dv, c) = comp(gv, c) * comp(sv, c);
            const float xh = (wk * comp(xv, c) - mu) * rstd;
            sums[0] += comp(dv, c);
            sums[1] += comp(dv, c) * xh;
        }
        x[i] = xv;
        dxh[i] = dv;
    });
    row_sums(sums, red_d, W, p.rank);
    const float inv_d = 1.0f / (float)L.D;
    const float mean_d = sums[0] * inv_d;
    const float mean_dx = sums[1] * inv_d;

    float part[3] = {0.0f, 0.0f, 0.0f};  // sum over chunk k of df * x
    for_slots<kSlots>(p.cnt, [&](int i) {
        const Slot s = slot_of(L, p.q0 + i, i < p.cnt);
        const float wk = pick(s.k, sw.s[0], sw.s[1], sw.s[2]);
        float4 xv = x[i];
        float4 dv = dxh[i];
        float4 dx;
        float q = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const float xh = (wk * comp(xv, c) - mu) * rstd;
            const float df = rstd * (comp(dv, c) - mean_d - xh * mean_dx);
            comp(dx, c) = wk * df;
            q += df * comp(xv, c);
        }
        if (s.k == 0) {
            part[0] += q;
        } else if (s.k == 1) {
            part[1] += q;
        } else {
            part[2] += q;
        }
        float* dst = pick(s.k, d_img, d_sig, d_clin);
        if (dst != nullptr)
            store_slot(dst + (size_t)b * L.width(s.k), s.w, s.vec, s.j, lane,
                       dx);
    });
    if (dsw_part == nullptr) return;
    row_sums(part, red_p, W, p.rank);
    if (p.rank == 0 && lane == 0) {
        dsw_part[3 * (size_t)b] = part[0];
        dsw_part[3 * (size_t)b + 1] = part[1];
        dsw_part[3 * (size_t)b + 2] = part[2];
    }
}

// the first half of a split cluster barrier (see se.cu): its wait, before
// the first remote store, guarantees that every peer block has started
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__host__ __device__ __forceinline__ int row_begin(int B, int G, int g) {
    return (int)(((long long)B * g) / G);
}

constexpr int kPart = 2 * kParamCols + 3;  // a block's sums: ds, db, dsw

// Block (tile t, group g): columns [32t, 32t + 32) over the rows of group
// g; the G blocks of a tile form a cluster (kCluster) whose rank 0 adds
// the groups in rank order. Tile 0 also sums the dsw partials. Null
// outputs are skipped.
template <bool kCluster>
__global__ void __launch_bounds__(32 * kParamWarps)
fusion_bwd_params(const float* __restrict__ img,
                  const float* __restrict__ sig,
                  const float* __restrict__ clin,
                  const float* __restrict__ logits,
                  const float* __restrict__ go,
                  const float* __restrict__ gsw,
                  const float* __restrict__ stats,
                  const float* __restrict__ dsw_part,
                  float* __restrict__ d_logits, float* __restrict__ d_scale,
                  float* __restrict__ d_bias, int B, int G, Layout L) {
    __shared__ float red[kParamWarps][kPart];
    __shared__ float part[kMaxGroups][kPart];  // rank 0's: every group's sums
    if constexpr (kCluster) cluster_arrive_relaxed();
    const size_t fold = blockIdx.y;  // fold f's rows and parameters
    img += fold * B * L.w[0];
    sig += fold * B * L.w[1];
    clin += fold * B * L.w[2];
    logits += 3 * fold;
    go += fold * B * L.D;
    if (gsw != nullptr) gsw += 3 * fold;
    stats += 2 * fold * B;
    if (dsw_part != nullptr) dsw_part += 3 * fold * B;
    if (d_logits != nullptr) d_logits += 3 * fold;
    if (d_scale != nullptr) d_scale += fold * L.D;
    if (d_bias != nullptr) d_bias += fold * L.D;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int rank = kCluster ? (int)cg::this_cluster().block_rank() : 0;
    const int tile = blockIdx.x / G;
    const SoftWeights sw = soft_weights(logits);
    const int D = L.D;
    const int i = tile * kParamCols + lane;
    const bool cols = (d_scale != nullptr || d_bias != nullptr) && i < D;
    const int k = i < L.off[1] ? 0 : (i < L.off[2] ? 1 : 2);
    const int width = L.width(k);
    const float* xc = pick(k, img, sig, clin) + (i - L.offset(k));
    const float wk = pick(k, sw.s[0], sw.s[1], sw.s[2]);
    const bool dsw = d_logits != nullptr && tile == 0 && lane < 3;

    float ds = 0.0f, db = 0.0f, pw = 0.0f;
    const int r1 = row_begin(B, G, rank + 1);
    for (int bb = row_begin(B, G, rank) + warp; bb < r1; bb += kParamWarps) {
        if (cols) {
            const float g = go[(size_t)bb * D + i];
            const float mu = stats[2 * (size_t)bb];
            const float rstd = stats[2 * (size_t)bb + 1];
            ds += g * ((wk * xc[(size_t)bb * width] - mu) * rstd);
            db += g;
        }
        if (dsw) pw += dsw_part[3 * (size_t)bb + lane];
    }
    red[warp][lane] = ds;
    red[warp][kParamCols + lane] = db;
    if (lane < 3) red[warp][2 * kParamCols + lane] = pw;
    __syncthreads();
    float a = 0.0f, c = 0.0f, p = 0.0f;
    if (warp == 0) {
        for (int w = 0; w < kParamWarps; ++w) {
            a += red[w][lane];
            c += red[w][kParamCols + lane];
            if (lane < 3) p += red[w][2 * kParamCols + lane];
        }
    }
    if constexpr (kCluster) {
        cg::cluster_group cluster = cg::this_cluster();
        cluster_wait();
        if (warp == 0) {
            float* dst = cluster.map_shared_rank(&part[0][0], 0) + rank * kPart;
            dst[lane] = a;
            dst[kParamCols + lane] = c;
            if (lane < 3) dst[2 * kParamCols + lane] = p;
        }
        cluster.sync();  // rank 0 now holds every group's sums
        if (rank != 0) return;
        if (warp == 0) {
            a = c = p = 0.0f;
            for (int g = 0; g < G; ++g) {
                a += part[g][lane];
                c += part[g][kParamCols + lane];
                if (lane < 3) p += part[g][2 * kParamCols + lane];
            }
        }
    }
    if (warp != 0) return;
    if (i < D) {
        if (d_scale != nullptr) d_scale[i] = a;
        if (d_bias != nullptr) d_bias[i] = c;
    }
    if (tile != 0 || d_logits == nullptr) return;
    const float p0 = __shfl_sync(0xffffffffu, p, 0);
    const float p1 = __shfl_sync(0xffffffffu, p, 1);
    const float p2 = __shfl_sync(0xffffffffu, p, 2);
    if (lane == 0) {
        float dsv[3] = {p0, p1, p2};
        if (gsw != nullptr)
            for (int j = 0; j < 3; ++j) dsv[j] += gsw[j];
        const float dot =
            sw.s[0] * dsv[0] + sw.s[1] * dsv[1] + sw.s[2] * dsv[2];
        for (int j = 0; j < 3; ++j) d_logits[j] = sw.s[j] * (dsv[j] - dot);
    }
}

Layout make_layout(int D0, int D1, int D2, int vec) {
    Layout L;
    L.w[0] = D0, L.w[1] = D1, L.w[2] = D2;
    L.off[0] = 0, L.off[1] = D0, L.off[2] = D0 + D1;
    L.start[0] = 0;
    for (int k = 0; k < 3; ++k)
        L.start[k + 1] = L.start[k] + (L.w[k] + kSlotElems - 1) / kSlotElems;
    L.vec = vec;
    L.D = D0 + D1 + D2;
    return L;
}

// bytes of dynamic shared memory of a row-kernel block: none in registers,
// else `arrays` rows of slots per warp
size_t row_smem(const Layout& L, int rows, int regs, int arrays) {
    return regs ? 0 : (size_t)rows * arrays * L.start[3] * 32 * 16;
}

// rows per block, warps per row: at most kMaxWarps warps a block; W > 1
// only with one row per block in registers, and no warp without a slot
bool bad_rows(const Layout& L, int rows, int W, int regs, size_t smem) {
    return rows < 1 || W < 1 || rows * W > kMaxWarps
           || (W > 1 && (rows != 1 || !regs)) || W > L.start[3]
           || (regs && L.start[3] > kRegSlots) || smem > (size_t)kMaxSmem;
}

// the registers instantiation for the slots of one warp of a row of n
// slots split over W warps: the smallest of 1, 2, 3, 6, 10 that holds them
int reg_slots(int n, int W) {
    const int per = (n + W - 1) / W;
    return per <= 1 ? 1 : per <= 2 ? 2 : per <= 3 ? 3 : per <= 6 ? 6
                                                                 : kRegSlots;
}

struct FwdArgs {
    const float *img, *sig, *clin, *logits, *scale, *bias;
    float *out, *sw_out, *stats;
    int B;
    Layout L;
    int W;
    float eps;
    int F;
};

template <int kSlots>
void fwd(dim3 grid, dim3 block, size_t smem, cudaStream_t s,
         const FwdArgs& a) {
    fusion_fwd<kSlots><<<grid, block, smem, s>>>(
        a.img, a.sig, a.clin, a.logits, a.scale, a.bias, a.out, a.sw_out,
        a.stats, a.B, a.L, a.W, a.eps);
}

struct BwdArgs {
    const float *img, *sig, *clin, *logits, *scale, *go, *stats;
    float *d_img, *d_sig, *d_clin, *dsw_part;
    int B;
    Layout L;
    int W;
    int F;
};

template <int kSlots>
void bwd(dim3 grid, dim3 block, size_t smem, cudaStream_t s,
         const BwdArgs& a) {
    fusion_bwd_rows<kSlots><<<grid, block, smem, s>>>(
        a.img, a.sig, a.clin, a.logits, a.scale, a.go, a.stats, a.d_img,
        a.d_sig, a.d_clin, a.dsw_part, a.B, a.L, a.W);
}

// one launch of a row kernel (`launch` is fwd or bwd) on B rows of each of
// F folds (grid y): registers where `regs`, else shared memory (opted into
// once per device)
template <typename Args>
cudaError_t launch_rows(void (*const launch[6])(dim3, dim3, size_t,
                                                 cudaStream_t, const Args&),
                        const void* smem_kernel, bool (&done)[kMaxDevices],
                        int rows, int regs, size_t smem, cudaStream_t s,
                        const Args& a) {
    const dim3 grid((unsigned)((a.B + rows - 1) / rows), (unsigned)a.F);
    const dim3 block((unsigned)(32 * rows * a.W));
    if (regs) {
        switch (reg_slots(a.L.start[3], a.W)) {
            case 1: launch[1](grid, block, 0, s, a); break;
            case 2: launch[2](grid, block, 0, s, a); break;
            case 3: launch[3](grid, block, 0, s, a); break;
            case 6: launch[4](grid, block, 0, s, a); break;
            default: launch[5](grid, block, 0, s, a); break;
        }
    } else {
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        if (dev >= kMaxDevices || !done[dev]) {
            err = cudaFuncSetAttribute(
                smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                kMaxSmem);
            if (err != cudaSuccess) return err;
            if (dev < kMaxDevices) done[dev] = true;
        }
        launch[0](grid, block, smem, s, a);
    }
    return cudaGetLastError();
}

int fusion_forward(const void* img, const void* sig, const void* clin,
                   const void* logits, const void* scale, const void* bias,
                   void* out, void* sw_out, void* stats, int B, int D0,
                   int D1, int D2, int rows, int W, int regs, int vec,
                   float eps, int F, void* stream) {
    const Layout L = make_layout(D0, D1, D2, vec);
    const size_t smem = row_smem(L, rows, regs, 1);
    if (B < 1 || F < 1 || F > 65535 || bad_rows(L, rows, W, regs, smem))
        return (int)cudaErrorInvalidValue;
    const FwdArgs a = {
        static_cast<const float*>(img), static_cast<const float*>(sig),
        static_cast<const float*>(clin), static_cast<const float*>(logits),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<float*>(out), static_cast<float*>(sw_out),
        static_cast<float*>(stats), B, L, W, eps, F};
    static void (*const launch[6])(dim3, dim3, size_t, cudaStream_t,
                                   const FwdArgs&) = {
        fwd<0>, fwd<1>, fwd<2>, fwd<3>, fwd<6>, fwd<kRegSlots>};
    static bool done[kMaxDevices] = {};
    return (int)launch_rows<FwdArgs>(
        launch, (const void*)fusion_fwd<0>, done, rows, regs, smem,
        static_cast<cudaStream_t>(stream), a);
}

int fusion_backward(const void* img, const void* sig, const void* clin,
                    const void* logits, const void* scale, const void* go,
                    const void* gsw, const void* stats, void* d_img,
                    void* d_sig, void* d_clin, void* d_logits, void* d_scale,
                    void* d_bias, void* dsw_part, int B, int D0, int D1,
                    int D2, int rows, int W, int regs, int vec, int groups,
                    int F, void* stream) {
    const Layout L = make_layout(D0, D1, D2, vec);
    const size_t smem = row_smem(L, rows, regs, 2);
    if (B < 0 || F < 1 || F > 65535 || bad_rows(L, rows, W, regs, smem)
        || groups < 1
        || groups > kMaxGroups || (d_logits != nullptr && dsw_part == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* x0 = static_cast<const float*>(img);
    const float* x1 = static_cast<const float*>(sig);
    const float* x2 = static_cast<const float*>(clin);
    const float* lg = static_cast<const float*>(logits);
    const float* st = static_cast<const float*>(stats);
    const float* g = static_cast<const float*>(go);
    float* part = static_cast<float*>(dsw_part);
    if (B > 0 && (d_img != nullptr || d_sig != nullptr || d_clin != nullptr
                  || part != nullptr)) {
        const BwdArgs a = {
            x0, x1, x2, lg, static_cast<const float*>(scale), g, st,
            static_cast<float*>(d_img), static_cast<float*>(d_sig),
            static_cast<float*>(d_clin), part, B, L, W, F};
        static void (*const launch[6])(dim3, dim3, size_t, cudaStream_t,
                                       const BwdArgs&) = {
            bwd<0>, bwd<1>, bwd<2>, bwd<3>, bwd<6>, bwd<kRegSlots>};
        static bool done[kMaxDevices] = {};
        const cudaError_t err = launch_rows<BwdArgs>(
            launch, (const void*)fusion_bwd_rows<0>, done, rows, regs, smem,
            s, a);
        if (err != cudaSuccess) return (int)err;
    }
    if (d_logits == nullptr && d_scale == nullptr && d_bias == nullptr)
        return 0;
    const int tiles = (d_scale != nullptr || d_bias != nullptr)
                          ? (L.D + kParamCols - 1) / kParamCols
                          : 1;
    const float* gs = static_cast<const float*>(gsw);
    float* dl = static_cast<float*>(d_logits);
    float* dsc = static_cast<float*>(d_scale);
    float* dbi = static_cast<float*>(d_bias);
    if (groups == 1) {
        fusion_bwd_params<false><<<dim3((unsigned)tiles, (unsigned)F),
                                   32 * kParamWarps, 0, s>>>(
            x0, x1, x2, lg, g, gs, st, part, dl, dsc, dbi, B, 1, L);
        return (int)cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(tiles * groups), (unsigned)F, 1);
    cfg.blockDim = dim3(32 * kParamWarps, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)groups;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, fusion_bwd_params<true>, x0,
                                         x1, x2, lg, g, gs, st,
                                         (const float*)part, dl, dsc, dbi, B,
                                         groups, L);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

// stats: (B, 2) f32 (mu, rstd) per row, or null (not needed). rows: rows
// per block; W: warps per row (W > 1 only with rows = 1 and regs); regs:
// the row in registers (else in shared memory); vec: bit k set where chunk
// k takes 16-byte accesses.
extern "C" int ecgmm_attention_fusion_forward(
    const void* img, const void* sig, const void* clin, const void* logits,
    const void* scale, const void* bias, void* out, void* sw_out,
    void* stats, int B, int D0, int D1, int D2, int rows, int W, int regs,
    int vec, float eps, void* stream) {
    return fusion_forward(img, sig, clin, logits, scale, bias, out, sw_out,
                          stats, B, D0, D1, D2, rows, W, regs, vec, eps, 1,
                          stream);
}

// stats: the forward's (B, 2) residual. d_img, d_sig, d_clin: null where
// the input needs no gradient; d_logits, d_scale, d_bias likewise, and
// where none of them is wanted the backward is one launch. dsw_part: a
// (B, 3) f32 scratch where d_logits is wanted, else null. gsw may be null
// (no cotangent on the soft weights). rows, W, regs and vec as in the
// forward; groups: row groups G of the parameter kernel, 1..8.
extern "C" int ecgmm_attention_fusion_backward(
    const void* img, const void* sig, const void* clin, const void* logits,
    const void* scale, const void* go, const void* gsw, const void* stats,
    void* d_img, void* d_sig, void* d_clin, void* d_logits, void* d_scale,
    void* d_bias, void* dsw_part, int B, int D0, int D1, int D2, int rows,
    int W, int regs, int vec, int groups, void* stream) {
    return fusion_backward(img, sig, clin, logits, scale, go, gsw, stats,
                           d_img, d_sig, d_clin, d_logits, d_scale, d_bias,
                           dsw_part, B, D0, D1, D2, rows, W, regs, vec,
                           groups, 1, stream);
}

// The fold axis: B rows in each of F folds. img, sig, clin, out, stats,
// the input gradients and dsw_part hold the F folds' rows in turn (F*B
// rows); logits, sw_out, gsw and d_logits are (F, 3), scale, bias,
// d_scale and d_bias (F, D). groups: row groups of one fold's B rows.
extern "C" int ecgmm_attention_fusion_fold_forward(
    const void* img, const void* sig, const void* clin, const void* logits,
    const void* scale, const void* bias, void* out, void* sw_out,
    void* stats, int B, int D0, int D1, int D2, int rows, int W, int regs,
    int vec, float eps, int F, void* stream) {
    return fusion_forward(img, sig, clin, logits, scale, bias, out, sw_out,
                          stats, B, D0, D1, D2, rows, W, regs, vec, eps, F,
                          stream);
}

extern "C" int ecgmm_attention_fusion_fold_backward(
    const void* img, const void* sig, const void* clin, const void* logits,
    const void* scale, const void* go, const void* gsw, const void* stats,
    void* d_img, void* d_sig, void* d_clin, void* d_logits, void* d_scale,
    void* d_bias, void* dsw_part, int B, int D0, int D1, int D2, int rows,
    int W, int regs, int vec, int groups, int F, void* stream) {
    return fusion_backward(img, sig, clin, logits, scale, go, gsw, stats,
                           d_img, d_sig, d_clin, d_logits, d_scale, d_bias,
                           dsw_part, B, D0, D1, D2, rows, W, regs, vec,
                           groups, F, stream);
}
