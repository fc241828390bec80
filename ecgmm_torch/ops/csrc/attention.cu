// Multi-head self-attention for Hopper, float32 on the CUDA cores, with
// flax's broadcast dropout on the softmax: a fused backward, and the one
// pass the forward adds to the unfused one.
//
// Replaces no TPU kernel: the JAX package computes flax's
// `MultiHeadDotProductAttention` (ecgmm_tpu/models/transformer1d.py:36)
// with XLA's products, outside any Pallas kernel. Its port
// (`ecgmm_torch/models/layers.MultiHeadSelfAttention`) wrote the
// (B, H, T, T) scores, their softmax and the dropped weights to device
// memory: at the `physionet_transformer` step (B = 8, H = 4, T = 3000,
// head 32) each is 1.15 GB, some 15 passes over them a layer, forward and
// backward, and the step was paced by those bytes, not by arithmetic.
//
// For one (b, h), with q, k, v the (T, 32) rows of the projections,
// c = 1 / (1 - p) and keep the (T, T) mask shared by every (b, h):
//   S   = (q * scale) k^T,  P = softmax_rows(S)
//   out = (P o keep * c) v                          written as (B, T, H*32)
//   lse = log2 sum_j exp(S_ij)                       (B, H, T), base-2 units
// and the backward, with dO the output's gradient:
//   Di  = rowsum(dO o out)_i                       = sum_j Pd_ij dPd_ij
//   Pd  = P o keep * c,  dPd = dO v^T
//   dS  = P o (dPd o keep * c - D)
//   dv  = Pd^T dO,  dk = dS^T (q * scale),  dq = scale * dS k.
// The backward writes nothing of size T x T: S and P live in registers,
// tile by tile, recomputed from lse. The forward is the unfused one
// (`ops/attention.exact_forward`), whose bits the training steps are held
// to: cuBLAS's two products around one pass over the scores that gives
// torch's softmax to the bit, dropped, and lse (attention_softmax_drop,
// for T in 2049..9216, where torch's softmax gives a row one block of
// 1024 threads, and T a multiple of 4; other lengths take the unfused
// path).
//
// Bound: float32 FMAs (TF32 is off: the configuration trains in float32).
// A layer at (8, 4, 3000, 32) needs 2 x 18.4 GFLOP forward and 5 x 18.4
// backward; at 67 TFLOP/s that is 0.55 + 1.37 ms, while its bytes (q, k,
// v, out, their gradients, 1.1 MB of mask bits) take tens of microseconds.
// The forward is bound by bytes: the scores written, read and
// overwritten by their dropped softmax, and read again, 4.6 GB a layer.
// The backward below recomputes S and dPd once more for dq (7 x 18.4
// GFLOP instead of 5) to stay free of atomics: a relaunch gives the same
// bits. attention_softmax_drop is bound by bytes: the scores read and
// overwritten once, 2.3 GB a layer, 0.69 ms at 3.35 TB/s.
//
// Design. Both backward kernels give each lane pair two rows of one side
// and stream the other side through shared memory, so that the lanes of
// a warp read the same bytes at once (a broadcast: no bank conflicts). A
// lane holds one half of the head's 32 dims of both rows, so a 16-byte
// broadcast load feeds 8 FMAs, and a dot product is the lane's half plus
// its partner's, one shuffle. No block barrier inside a tile.
//  - dq: the pair holds q, dO and dq of two query rows and first takes Di
//    from dO and out; then K and V tiles of 64 keys, double-buffered in
//    shared memory by cp.async, stream past; each lane forms its own
//    row's S, P, dPd and dS in registers and hands the partner dS. Keys
//    past T are zeros and not summed; rows past T are computed and not
//    stored.
//  - dk and dv: the pair holds k, v, dk and dv of two keys, and
//    both lanes form P and dS of both (no shuffle between a key's dS and
//    its FMAs); tiles of BQ query rows (q, dO, lse, D and the mask words of
//    the block's keys) stream through shared memory.
// The k projection's bias gets a gradient that is zero exactly (a softmax
// row ignores a shift common to its scores): what a backward gives it is
// rounding noise, near Adam's eps (1e-8) at this model's scale, which Adam
// turns into updates of up to the learning rate. The unfused path's noise
// is the size of one float32 rounding of each dS row's sum, and this
// backward matches it: the dq kernel forms S and dPd exactly as the dk
// kernel does, term for term, and hands it D' = sum_j P dPd' / sum_j P of
// those same numbers, summed in double (dsum). With D = rowsum(dO o out),
// or with D' summed in float over T terms, the noise was 3 and 15 times
// the unfused path's.
// The keep mask comes as bits, row i's keys in ceil(T / 32) words, bit j
// of word w for key 32w + j: 1.1 MB at T = 3000, read from L2. A warp of
// the dk/dv kernel holds 32 consecutive keys, so a query's word is one
// broadcast.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int HD = 32;        // head size, the one instantiated
constexpr int HALF = HD / 2;  // the dims a lane holds
constexpr int BC = 64;        // keys of a K/V tile in shared memory
constexpr int DQ_NT = 128;    // threads (query rows) of a dq block
constexpr int KV_NT = 64;     // threads (keys) of a dk/dv block
constexpr int BQ = 32;        // query rows of a dk/dv tile
constexpr int DQ_UNROLL = 2;  // keys of the dq kernel's loop unrolled
constexpr int KV_UNROLL = 1;  // queries of the dk/dv kernel's loop unrolled
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    int n = valid ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
    asm volatile("cp.async.wait_group 1;\n" ::);
}

// 2^x by the SFU, one instruction (exp2f adds a range reduction for
// results below 2^-126, which the softmax never needs: they round to 0
// against its sum of at least 1)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// Rows j0 .. j0 + BC - 1 of k and v (row stride ld floats) into sk and sv,
// [BC][HD] each; rows at or past T are zeros.
template <int NT>
__device__ __forceinline__ void load_kv(float* sk, float* sv, const float* k,
                                        const float* v, int ld, int j0,
                                        int T) {
    constexpr int V4 = HD / 4;
    for (int idx = threadIdx.x; idx < BC * V4; idx += NT) {
        int r = idx / V4, c = (idx % V4) * 4;
        int j = j0 + r;
        bool ok = j < T;
        size_t off = static_cast<size_t>(ok ? j : 0) * ld + c;
        cp_async16(sk + r * HD + c, k + off, ok);
        cp_async16(sv + r * HD + c, v + off, ok);
    }
}

// The mask bits of row `row` for keys j0 .. j0 + 63 (j0 a multiple of
// 64), key j0 + j at bit j: all ones where there is no mask, zeros past
// the row's last word.
__device__ __forceinline__ unsigned long long tile_bits(
    const uint32_t* bits, int row, int j0, int T, int W) {
    if (bits == nullptr) return ~0ull;
    int w0 = j0 >> 5;
    const uint32_t* r = bits + static_cast<size_t>(row < T ? row : 0) * W;
    unsigned long long hi = w0 + 1 < W ? __ldg(r + w0 + 1) : 0u;
    return __ldg(r + w0) | (hi << 32);
}

// One half of the head's dot product, d ascending in one FMA chain. S and
// dPd are such a half of the lane's own plus the partner lane's half, so
// that both backward kernels form the same numbers.
__device__ __forceinline__ float half_dot(const float* a, const float* b) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HALF; ++d) s = fmaf(a[d], b[d], s);
    return s;
}

// own + the partner lane's `theirs` (the partner's half of this lane's
// own row or key: lanes hold their own row first, the partner's second)
__device__ __forceinline__ float join(float own, float theirs) {
    return own + __shfl_xor_sync(FULL, theirs, 1);
}

__device__ __forceinline__ float partner(float x) {
    return __shfl_xor_sync(FULL, x, 1);
}

__device__ __forceinline__ void load_half(float* dst, const float* src,
                                          float scale = 1.f) {
#pragma unroll
    for (int d4 = 0; d4 < HALF / 4; ++d4) {
        float4 x = reinterpret_cast<const float4*>(src)[d4];
        dst[4 * d4] = x.x * scale;
        dst[4 * d4 + 1] = x.y * scale;
        dst[4 * d4 + 2] = x.z * scale;
        dst[4 * d4 + 3] = x.w * scale;
    }
}

__device__ __forceinline__ void store_half(float* dst, const float* src,
                                           float scale) {
#pragma unroll
    for (int d4 = 0; d4 < HALF / 4; ++d4)
        reinterpret_cast<float4*>(dst)[d4] = make_float4(
            src[4 * d4] * scale, src[4 * d4 + 1] * scale,
            src[4 * d4 + 2] * scale, src[4 * d4 + 3] * scale);
}

// Lanes 2u and 2u + 1 of a block hold rows (or keys) base + 2u and
// base + 2u + 1, each lane one half of the head (lane & 1) and its own
// row base + 2u + (lane & 1) first.
struct Pair {
    int half, off, own, other;
    __device__ Pair(int base) {
        half = threadIdx.x & 1;
        off = half * HALF;
        own = base + (threadIdx.x & ~1) + half;
        other = own ^ 1;
    }
};

// grid (ceil(T / DQ_NT), B * H): a lane pair holds two query rows (q, dO,
// dq). Writes dq and dsum (B, H, T): for each row
// sum_j P_ij dPd'_ij / sum_j P_ij, dPd' = dPd o keep c, from the same P and
// dPd (bit for bit) that attention_backward_dkdv forms, so that the rows of
// its dS sum to zero but for rounding. This kernel's own dS takes
// D = rowsum(dO o out).
__global__ void __launch_bounds__(DQ_NT)
attention_backward_dq(const float* __restrict__ q_in,
                      const float* __restrict__ k_in,
                      const float* __restrict__ v_in, int ld,
                      const uint32_t* __restrict__ bits,
                      const float* __restrict__ out,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      float* __restrict__ dsum, float* __restrict__ dq_out,
                      int T, int H, float scale, float drop_scale) {
    __shared__ __align__(16) float sk[2][BC * HD];
    __shared__ __align__(16) float sv[2][BC * HD];
    const int D = H * HD, W = (T + 31) >> 5;
    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const size_t base = static_cast<size_t>(b) * T * ld + h * HD;
    const float* qb = q_in + base;
    const float* kb = k_in + base;
    const float* vb = v_in + base;
    const Pair lane(blockIdx.x * DQ_NT);
    const int rows[2] = {lane.own, lane.other};

    float q[2][HALF], g[2][HALF], dq[2][HALF], part[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
        const int r = min(rows[m], T - 1);
        const size_t orow = (static_cast<size_t>(b) * T + r) * D + h * HD
            + lane.off;
        float o[HALF];
        load_half(q[m], qb + static_cast<size_t>(r) * ld + lane.off);
        load_half(g[m], dout + orow);
        load_half(o, out + orow);
        part[m] = half_dot(g[m], o);
#pragma unroll
        for (int d = 0; d < HALF; ++d) dq[m][d] = 0.f;
    }
    const float di = join(part[0], part[1]);
    const float l2 = lse[static_cast<size_t>(bh) * T + min(lane.own, T - 1)];
    // summed in double: D' must be the sum of these very terms to within
    // one rounding, or dS' keeps a row sum of the size of a float sum's
    // error over T terms
    double pg = 0.0, psum = 0.0;

    const int tiles = (T + BC - 1) / BC;
    load_kv<DQ_NT>(sk[0], sv[0], kb, vb, ld, 0, T);
    cp_async_commit();
    for (int t = 0; t < tiles; ++t) {
        const int j0 = t * BC;
        if (t + 1 < tiles)
            load_kv<DQ_NT>(sk[(t + 1) & 1], sv[(t + 1) & 1], kb, vb, ld,
                           j0 + BC, T);
        cp_async_commit();
        const unsigned long long w = tile_bits(bits, lane.own, j0, T, W);
        cp_async_wait_prior();
        __syncthreads();
        const float* k = sk[t & 1] + lane.off;
        const float* v = sv[t & 1] + lane.off;
        const int n = min(T - j0, BC);
        float dqt[2][HALF];  // the tile's part, then added
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int d = 0; d < HALF; ++d) dqt[m][d] = 0.f;
#pragma unroll DQ_UNROLL
        for (int jj = 0; jj < n; ++jj) {
            float kk[HALF], vv[HALF];
            load_half(kk, k + jj * HD);
            load_half(vv, v + jj * HD);
            const float s = join(half_dot(q[0], kk), half_dot(q[1], kk));
            const float dpd = join(half_dot(g[0], vv), half_dot(g[1], vv));
            const float p = ex2(fmaf(s * scale, LOG2E, -l2));
            const float dp = (w >> jj) & 1ull ? dpd * drop_scale : 0.f;
            pg += static_cast<double>(p) * dp;
            psum += p;
            const float ds = p * (dp - di), ds1 = partner(ds);
#pragma unroll
            for (int d = 0; d < HALF; ++d) {
                dqt[0][d] = fmaf(ds, kk[d], dqt[0][d]);
                dqt[1][d] = fmaf(ds1, kk[d], dqt[1][d]);
            }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int d = 0; d < HALF; ++d) dq[m][d] += dqt[m][d];
        __syncthreads();
    }
    if (lane.own < T)
        dsum[static_cast<size_t>(bh) * T + lane.own] =
            static_cast<float>(pg / psum);
#pragma unroll
    for (int m = 0; m < 2; ++m)
        if (rows[m] < T)
            store_half(dq_out + (static_cast<size_t>(b) * T + rows[m]) * D
                       + h * HD + lane.off, dq[m], scale);
}

// grid (ceil(T / KV_NT), B * H): a lane pair holds two keys (k, v, dk,
// dv); tiles of BQ query rows (q, dO, lse, dsum and the mask words of the
// block's keys) stream through shared memory. Reads dsum from
// attention_backward_dq; writes dk and dv.
__global__ void __launch_bounds__(KV_NT)
attention_backward_dkdv(const float* __restrict__ q_in,
                        const float* __restrict__ k_in,
                        const float* __restrict__ v_in, int ld,
                        const uint32_t* __restrict__ bits,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        float* __restrict__ dk_out,
                        float* __restrict__ dv_out, int T, int H,
                        float scale, float drop_scale) {
    constexpr int WARPS = KV_NT / 32;
    __shared__ __align__(16) float sq[2][BQ * HD];
    __shared__ __align__(16) float sg[2][BQ * HD];
    __shared__ float sl[2][BQ];
    __shared__ float sd[2][BQ];
    __shared__ uint32_t sw[2][BQ * WARPS];
    const int D = H * HD, W = (T + 31) >> 5;
    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const size_t base = static_cast<size_t>(b) * T * ld + h * HD;
    const float* qb = q_in + base;
    const float* gb = dout + static_cast<size_t>(b) * T * D + h * HD;
    const float* lb = lse + static_cast<size_t>(bh) * T;
    const float* db = dsum + static_cast<size_t>(bh) * T;
    const Pair lane(blockIdx.x * KV_NT);
    const int keys[2] = {lane.own, lane.other};
    const int bit = threadIdx.x & 31;  // the own key's bit in its word
    const int warp = threadIdx.x >> 5;
    const int word0 = blockIdx.x * WARPS;  // the block's first mask word

    float k[2][HALF], v[2][HALF], dk[2][HALF], dv[2][HALF];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
        const size_t off = base + static_cast<size_t>(min(keys[m], T - 1)) * ld
            + lane.off;
        load_half(k[m], k_in + off);
        load_half(v[m], v_in + off);
#pragma unroll
        for (int d = 0; d < HALF; ++d) dk[m][d] = dv[m][d] = 0.f;
    }

    auto load = [&](int buf, int i0) {
        constexpr int V4 = HD / 4;
        for (int idx = threadIdx.x; idx < BQ * V4; idx += KV_NT) {
            int r = idx / V4, c = (idx % V4) * 4;
            int i = i0 + r;
            bool ok = i < T;
            int ii = ok ? i : 0;
            cp_async16(sq[buf] + r * HD + c,
                       qb + static_cast<size_t>(ii) * ld + c, ok);
            cp_async16(sg[buf] + r * HD + c,
                       gb + static_cast<size_t>(ii) * D + c, ok);
        }
        for (int idx = threadIdx.x; idx < BQ; idx += KV_NT) {
            int i = i0 + idx;
            bool ok = i < T;
            cp_async4(sl[buf] + idx, lb + (ok ? i : 0), ok);
            cp_async4(sd[buf] + idx, db + (ok ? i : 0), ok);
        }
        if (bits != nullptr) {
            for (int idx = threadIdx.x; idx < BQ * WARPS; idx += KV_NT) {
                int r = idx / WARPS, wi = word0 + idx % WARPS;
                int i = i0 + r;
                bool ok = i < T && wi < W;
                cp_async4(sw[buf] + idx,
                          bits + (ok ? static_cast<size_t>(i) * W + wi : 0),
                          ok);
            }
        }
    };

    const int tiles = (T + BQ - 1) / BQ;
    load(0, 0);
    cp_async_commit();
    for (int t = 0; t < tiles; ++t) {
        const int i0 = t * BQ;
        if (t + 1 < tiles) load((t + 1) & 1, i0 + BQ);
        cp_async_commit();
        cp_async_wait_prior();
        __syncthreads();
        const float* q = sq[t & 1] + lane.off;
        const float* g = sg[t & 1] + lane.off;
        const float* ls = sl[t & 1];
        const float* dsm = sd[t & 1];
        const uint32_t* ws = sw[t & 1];
        const int n = min(T - i0, BQ);
#pragma unroll KV_UNROLL
        for (int ii = 0; ii < n; ++ii) {
            float qi[HALF], gi[HALF];
            load_half(qi, q + ii * HD);
            load_half(gi, g + ii * HD);
            const float ps[2] = {half_dot(qi, k[0]), half_dot(qi, k[1])};
            const float pp[2] = {half_dot(gi, v[0]), half_dot(gi, v[1])};
            const uint32_t word =
                bits == nullptr ? FULL : ws[ii * WARPS + warp];
            const float l2 = ls[ii], di = dsm[ii];
            // both lanes take both keys' P and dS, so that no shuffle
            // stands between a key's dS and its FMAs (the partner holds
            // this lane's other key as its own)
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                const float s = join(ps[m], ps[1 - m]);
                const float dpd = join(pp[m], pp[1 - m]);
                const float p = ex2(fmaf(s * scale, LOG2E, -l2));
                const bool kept = (word >> (bit ^ m)) & 1u;
                const float dp = kept ? dpd * drop_scale : 0.f;
                const float pd = kept ? p * drop_scale : 0.f;
                const float ds = p * (dp - di);
#pragma unroll
                for (int d = 0; d < HALF; ++d) {
                    dv[m][d] = fmaf(pd, gi[d], dv[m][d]);
                    dk[m][d] = fmaf(ds, qi[d], dk[m][d]);
                }
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
        if (keys[m] >= T) continue;
        const size_t off = (static_cast<size_t>(b) * T + keys[m]) * D
            + h * HD + lane.off;
        store_half(dk_out + off, dk[m], scale);
        store_half(dv_out + off, dv[m], 1.f);
    }
}

// One warp per mask word: keep (T, T) float32, 0 or 1 -> bits (T, W).
__global__ void attention_pack_keep(const float* __restrict__ keep,
                                    uint32_t* __restrict__ bits, int T,
                                    int W) {
    const long long wid =
        (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (wid >= static_cast<long long>(T) * W) return;  // a whole warp
    const int i = static_cast<int>(wid / W), w = static_cast<int>(wid % W);
    const int j = w * 32 + lane;
    const float x = j < T ? keep[static_cast<size_t>(i) * T + j] : 0.f;
    const unsigned m = __ballot_sync(FULL, x != 0.f);
    if (lane == 0) bits[wid] = m;
}

// torch's softmax of a row of more than 2048 scores, bit for bit, with the
// dropout and the row's log-sum-exp, in place: one block a row of the
// forward's scores (B H T, T), T a multiple of 4. torch 2.11
// (cunn_SoftMaxForwardReg) gives such a row a block of SM_VNT = 1024
// threads, thread v holding keys v + 1024 r; the block's max; each
// thread's sum of expf(s - max) in r order; the sums of each warp's 32
// threads by shuffles down (16, 8, 4, 2, 1) and then those of the 32 warps
// alike; and expf(s - max) / sum. The max is exact in any order, the sum
// is not. Here thread t of SM_NT = 256 reads keys 4t .. 4t + 3 (+ 1024 r)
// as float4, so it holds torch's threads 4t .. 4t + 3, whose warp is
// t / 8: their sums 16, 8 and 4 threads apart are shuffles 4, 2 and 1
// lanes apart, those 2 and 1 apart the thread's own; the warps' sums then
// go as torch's. So the weights, and the product with v after them, are
// the unfused path's to the bit, with torch 2.11 (the card tests and
// chip_smoke.py check it against torch.softmax). The weights of dropped
// keys are 0, the kept ones times c, as attn * (keep / (1 - p)) gives
// them; lse in base 2: max log2(e) + log2(sum).
constexpr int SM_VNT = 1024;  // threads of torch's block
constexpr int SM_NT = 256;    // threads of this kernel's block

template <int R>
__global__ void __launch_bounds__(SM_NT)
attention_softmax_drop(float* __restrict__ attn,
                       const uint32_t* __restrict__ bits,
                       float* __restrict__ lse, int T, float drop_scale) {
    __shared__ float red[SM_VNT / 32];
    __shared__ float total;
    const size_t row = blockIdx.x;
    float* a = attn + row * T;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint32_t* w = bits == nullptr
        ? nullptr : bits + (row % T) * ((T + 31) >> 5);
    float4 x[R];
    float mx = -FLT_MAX;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int j = r * SM_VNT + 4 * threadIdx.x;
        if (j < T) {
            x[r] = *reinterpret_cast<const float4*>(a + j);
            mx = fmaxf(mx, fmaxf(fmaxf(x[r].x, x[r].y),
                                 fmaxf(x[r].z, x[r].w)));
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    mx = red[0];
#pragma unroll
    for (int i = 1; i < SM_NT / 32; ++i) mx = fmaxf(mx, red[i]);
    __syncthreads();  // red is reused below
    float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int j = r * SM_VNT + 4 * threadIdx.x;
        if (j < T) {
            x[r].x = expf(x[r].x - mx);
            x[r].y = expf(x[r].y - mx);
            x[r].z = expf(x[r].z - mx);
            x[r].w = expf(x[r].w - mx);
            p0 = p0 + x[r].x;
            p1 = p1 + x[r].y;
            p2 = p2 + x[r].z;
            p3 = p3 + x[r].w;
        }
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
        p0 = p0 + __shfl_down_sync(FULL, p0, o);
        p1 = p1 + __shfl_down_sync(FULL, p1, o);
        p2 = p2 + __shfl_down_sync(FULL, p2, o);
        p3 = p3 + __shfl_down_sync(FULL, p3, o);
    }
    if ((lane & 7) == 0) red[threadIdx.x >> 3] = (p0 + p2) + (p1 + p3);
    __syncthreads();
    if (warp == 0) {
        float v = red[lane];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(FULL, v, o);
        if (lane == 0) total = v;
    }
    __syncthreads();
    const float sum = total;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int j = r * SM_VNT + 4 * threadIdx.x;
        if (j < T) {
            float4 y = make_float4(x[r].x / sum, x[r].y / sum, x[r].z / sum,
                                   x[r].w / sum);
            if (w != nullptr) {
                const uint32_t m = w[j >> 5] >> (j & 31);
                y.x = m & 1u ? y.x * drop_scale : 0.f;
                y.y = m & 2u ? y.y * drop_scale : 0.f;
                y.z = m & 4u ? y.z * drop_scale : 0.f;
                y.w = m & 8u ? y.w * drop_scale : 0.f;
            }
            *reinterpret_cast<float4*>(a + j) = y;
        }
    }
    if (threadIdx.x == 0) lse[row] = mx * LOG2E + log2f(sum);
}

template <int R>
int launch_softmax_drop(float* attn, const uint32_t* bits, float* lse,
                        int rows, int T, float drop_scale,
                        cudaStream_t stream) {
    attention_softmax_drop<R><<<rows, SM_NT, 0, stream>>>(attn, bits, lse, T,
                                                          drop_scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keep: (T, T) float32 of 0 and 1, contiguous; bits: (T, ceil(T / 32))
// 32-bit words.
extern "C" int ecgmm_attention_pack_keep(const void* keep, void* bits, int T,
                                         void* stream) {
    const int W = (T + 31) / 32;
    const long long warps = static_cast<long long>(T) * W;
    const int blocks = static_cast<int>((warps * 32 + 255) / 256);
    attention_pack_keep<<<blocks, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(keep), static_cast<uint32_t*>(bits), T, W);
    return static_cast<int>(cudaGetLastError());
}

// q, k, v: (B, T, H 32) float32 rows ld floats apart (the projections);
// bits: the keep mask's words or null (no dropout); out: the forward's
// output (B, T, H 32)
// and dout its gradient, both contiguous; lse: (B, H, T) in base 2; dsum:
// (B, H, T) scratch; dq, dk, dv: (B, T, H 32) contiguous, every element
// written.
extern "C" int ecgmm_attention_backward(const void* q, const void* k,
                                        const void* v, const void* bits,
                                        const void* out, const void* dout,
                                        const void* lse, void* dsum, void* dq,
                                        void* dk, void* dv, int B, int T,
                                        int H, int ld, float scale,
                                        float drop_scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    const uint32_t* m = static_cast<const uint32_t*>(bits);
    attention_backward_dq<<<dim3((T + DQ_NT - 1) / DQ_NT, B * H), DQ_NT, 0,
                            s>>>(
        qf, kf, vf, ld, m, static_cast<const float*>(out),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<float*>(dsum), static_cast<float*>(dq), T, H, scale,
        drop_scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_backward_dkdv<<<dim3((T + KV_NT - 1) / KV_NT, B * H), KV_NT, 0,
                              s>>>(
        qf, kf, vf, ld, m, static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(dsum),
        static_cast<float*>(dk), static_cast<float*>(dv), T, H, scale,
        drop_scale);
    return static_cast<int>(cudaGetLastError());
}

// attn: the forward's (B H T, T) scores, contiguous, 2048 < T
// <= 9216 and T a multiple of 4, overwritten by torch's softmax of them,
// dropped; bits: the keep mask's words or null (no dropout); lse: (B H T)
// out.
extern "C" int ecgmm_attention_softmax_drop(void* attn, const void* bits,
                                            void* lse, int rows, int T,
                                            float drop_scale, void* stream) {
    float* a = static_cast<float*>(attn);
    const uint32_t* m = static_cast<const uint32_t*>(bits);
    float* l = static_cast<float*>(lse);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (T % 4) return static_cast<int>(cudaErrorInvalidValue);
    switch ((T + SM_VNT - 1) / SM_VNT) {
        case 3: return launch_softmax_drop<3>(a, m, l, rows, T, drop_scale, s);
        case 4: return launch_softmax_drop<4>(a, m, l, rows, T, drop_scale, s);
        case 5: return launch_softmax_drop<5>(a, m, l, rows, T, drop_scale, s);
        case 6: return launch_softmax_drop<6>(a, m, l, rows, T, drop_scale, s);
        case 7: return launch_softmax_drop<7>(a, m, l, rows, T, drop_scale, s);
        case 8: return launch_softmax_drop<8>(a, m, l, rows, T, drop_scale, s);
        case 9: return launch_softmax_drop<9>(a, m, l, rows, T, drop_scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
