// Squeeze-and-Excitation gate (1-D) for Hopper, x laid out (B, C, T):
// forward and backward.
//
// Replaces the TPU kernel `fused_se` (ecgmm_tpu/ops/pallas_se.py:59-115)
// and the VJP of `reference_se` that its custom_vjp takes (:110-112):
//   m   = mean_T(x)                          (B, C) f32
//   z1  = m . W1^T + b1,   h = relu(z1)      (B, R) f32
//   s   = sigmoid(h . W2^T + b2)             (B, C) f32
//   out = x * s[:, :, None]                  x's dtype
// and, for the cotangent g of out,
//   ds  = sum_T g*x,   dz2 = ds*s*(1-s),   dh = dz2 . W2,
//   dz1 = dh*[z1 > 0], dm = dz1 . W1,      dx = g*s + dm/T,
//   dW2 = sum_b dz2 (x) h, db2 = sum_b dz2, dW1 = sum_b dz1 (x) m,
//   db1 = sum_b dz1.
// Weights are in torch Linear layout: W1 (R, C), W2 (C, R).
//
// Bound: bytes. The forward must read x and write out (2*B*C*T elements),
// the backward read x and g and write dx (3*B*C*T). The two dense layers
// are 2*C*R multiply-adds per sample (8K at C=256): far too little work
// for wgmma, so tensor cores play no part.
//
// Design: a thread-block cluster of K blocks per sample (grid B*K,
// launched with cudaLaunchKernelEx). Block k of a cluster owns channels
// [k*C/K, (k+1)*C/K); in the (B, C, T) layout its slab is one contiguous
// run of (C/K)*T elements, which it loads once into shared memory: with
// 16-byte vector loads where the slab's size and the pointers are
// multiples of 16 bytes (the wrapper decides and passes `vec`), else with
// coalesced element loads. A channel's squeeze is then local to its block.
// Only the C channel means (forward) or the C values of dz2 (backward)
// cross blocks: each block pushes its own into every peer's shared memory
// through distributed shared memory, then one cluster barrier. Every block
// then runs the R-wide dense layer over all C values in the same fixed
// order, so all blocks hold the same bits, finishes its own channels and
// writes its slab from shared memory. The pushes are the only accesses to
// a peer's shared memory: the barrier's release/acquire makes them
// visible, and no block touches a peer after it, so a block may exit
// without a second barrier. (A split barrier, arrived at on entry and
// waited on before the first push, makes sure every peer has started.)
// The wrapper (`ecgmm_torch/ops/se.py`, `cluster_size`) picks K: enough blocks
// to spread a small batch over the card's 132 SMs, and a slab that fits in
// the 227 KB a block may use (`smem_bytes` there mirrors the layouts
// below).
//
// The forward is one launch and also stores the f32 means and gate, which
// the backward reads. The backward is the cluster kernel (x and g read
// once, dx written once; it also stores the per-sample dz2, dz1 and h)
// plus, where a weight needs a gradient, a small kernel that sums those
// over the batch in a fixed order. There are no atomics, so a relaunch
// gives the same bits.
//
// Plain C interface (bound with ctypes): every entry point launches on the
// given stream, never synchronises, allocates nothing, and returns a CUDA
// error code (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kParamThreads = 256;
constexpr int kMaxSmem = 232448;  // the opt-in limit of a block on sm_90
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
    return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
    return __float2bfloat16(v);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
    return (n + 15) & ~size_t(15);
}

// The first half of a split cluster barrier: arrive without ordering any
// memory. Its wait, before the first remote store, guarantees that every
// peer block has started, and so that its shared memory exists.
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Copy n contiguous elements from device to shared memory, all threads of
// the block; four 16-byte loads in flight per thread on the vector path.
template <typename T>
__device__ __forceinline__ void load_slab(const T* __restrict__ src,
                                          T* __restrict__ dst, int n,
                                          int vec) {
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    if (vec) {
        const int4* s4 = reinterpret_cast<const int4*>(src);
        int4* d4 = reinterpret_cast<int4*>(dst);
        const int n4 = (int)(n * sizeof(T) / 16);
        int i = tid;
        for (; i + 3 * nt < n4; i += 4 * nt) {
            const int4 a = __ldg(s4 + i);
            const int4 b = __ldg(s4 + i + nt);
            const int4 c = __ldg(s4 + i + 2 * nt);
            const int4 d = __ldg(s4 + i + 3 * nt);
            d4[i] = a;
            d4[i + nt] = b;
            d4[i + 2 * nt] = c;
            d4[i + 3 * nt] = d;
        }
        for (; i < n4; i += nt) d4[i] = __ldg(s4 + i);
    } else {
        for (int i = tid; i < n; i += nt) dst[i] = src[i];
    }
}

// z[j] = b1[j] + sum_c m[c] * W1[j, c] for all R rows, one warp per row,
// lanes striding over c, then a fixed shuffle tree: the same bits in every
// block and in the forward and the backward.
template <typename T>
__device__ __forceinline__ void layer1(const float* __restrict__ m,
                                       const T* __restrict__ w1,
                                       const T* __restrict__ b1,
                                       float* __restrict__ z, int C, int R) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    for (int j = warp; j < R; j += n_warps) {
        const T* wrow = w1 + (size_t)j * C;
        float s = 0.0f;
        for (int c = lane; c < C; c += 32) s += m[c] * to_f32(wrow[c]);
        s = warp_sum(s);
        if (lane == 0) z[j] = s + to_f32(b1[j]);
    }
}

// Push vals[0:cpb), this block's channels [c0, c0 + cpb) of a C-wide
// array at `arr`, into the same place in every other block's shared memory.
__device__ __forceinline__ void push_to_peers(cg::cluster_group& cluster,
                                              float* arr, int c0, int cpb) {
    const int K = (int)cluster.num_blocks();
    const int me = (int)cluster.block_rank();
    for (int i = threadIdx.x; i < K * cpb; i += blockDim.x) {
        const int peer = i / cpb;
        if (peer == me) continue;
        const int c = c0 + i % cpb;
        cluster.map_shared_rank(arr, peer)[c] = arr[c];
    }
}

// Forward. Shared memory: m_all[C], z[R], gate[cpb] (f32), then the slab.
template <typename T>
__global__ void __launch_bounds__(kThreads)
se_fwd(const T* __restrict__ x, const T* __restrict__ w1,
       const T* __restrict__ b1, const T* __restrict__ w2,
       const T* __restrict__ b2, float* __restrict__ mean_out,
       float* __restrict__ gate_out, T* __restrict__ out, int C, int Tlen,
       int R, int vec) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster_arrive_relaxed();
    extern __shared__ __align__(16) unsigned char smem[];
    const int K = (int)cluster.num_blocks();
    const int cpb = C / K;
    const int c0 = (int)cluster.block_rank() * cpb;
    const int b = blockIdx.x / K;
    const int n = cpb * Tlen;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    float* m_all = reinterpret_cast<float*>(smem);
    float* z = m_all + C;
    float* gate = z + R;
    T* tile = reinterpret_cast<T*>(smem + align16(4 * (size_t)(C + R + cpb)));
    const size_t base = ((size_t)b * C + c0) * Tlen;

    load_slab(x + base, tile, n, vec);
    __syncthreads();

    // squeeze: one warp per channel row of the slab
    const float inv_t = 1.0f / (float)Tlen;
    for (int cl = warp; cl < cpb; cl += n_warps) {
        const T* row = tile + cl * Tlen;
        float s = 0.0f;
        for (int t = lane; t < Tlen; t += 32) s += to_f32(row[t]);
        s = warp_sum(s);
        if (lane == 0) m_all[c0 + cl] = s * inv_t;
    }
    __syncthreads();
    cluster_wait();
    push_to_peers(cluster, m_all, c0, cpb);
    cluster.sync();  // every block now holds all C means

    layer1(m_all, w1, b1, z, C, R);
    __syncthreads();
    for (int cl = threadIdx.x; cl < cpb; cl += blockDim.x) {
        const int c = c0 + cl;
        const T* wrow = w2 + (size_t)c * R;
        float s = to_f32(b2[c]);
        for (int j = 0; j < R; ++j) s += fmaxf(z[j], 0.0f) * to_f32(wrow[j]);
        const float g = 1.0f / (1.0f + expf(-s));
        gate[cl] = g;
        mean_out[(size_t)b * C + c] = m_all[c];
        gate_out[(size_t)b * C + c] = g;
    }
    __syncthreads();

    T* ob = out + base;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
        ob[i] = from_f32<T>(to_f32(tile[i]) * gate[i / Tlen]);
}

// Backward, cluster part. Shared memory: m[C], dz2_all[C], z[R], dz1[R],
// s[cpb], dmt[cpb] (f32), then the x slab and the g slab. dx and the
// scratch pointers may be null (nothing needs them).
template <typename T>
__global__ void __launch_bounds__(kThreads)
se_bwd(const T* __restrict__ x, const T* __restrict__ g,
       const T* __restrict__ w1, const T* __restrict__ b1,
       const T* __restrict__ w2, const float* __restrict__ mean,
       const float* __restrict__ gate, T* __restrict__ dx,
       float* __restrict__ dz2_out, float* __restrict__ dz1_out,
       float* __restrict__ h_out, int C, int Tlen, int R, int vec) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster_arrive_relaxed();
    extern __shared__ __align__(16) unsigned char smem[];
    const int K = (int)cluster.num_blocks();
    const int cpb = C / K;
    const int c0 = (int)cluster.block_rank() * cpb;
    const int b = blockIdx.x / K;
    const int n = cpb * Tlen;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    float* m = reinterpret_cast<float*>(smem);
    float* dz2_all = m + C;
    float* z = dz2_all + C;
    float* dz1 = z + R;
    float* s = dz1 + R;
    float* dmt = s + cpb;
    const size_t slab = align16((size_t)n * sizeof(T));
    T* tx = reinterpret_cast<T*>(smem + align16(8 * (size_t)(C + R + cpb)));
    T* tg = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(tx) + slab);
    const size_t base = ((size_t)b * C + c0) * Tlen;

    load_slab(x + base, tx, n, vec);
    load_slab(g + base, tg, n, vec);
    for (int c = threadIdx.x; c < C; c += blockDim.x)
        m[c] = mean[(size_t)b * C + c];
    for (int cl = threadIdx.x; cl < cpb; cl += blockDim.x)
        s[cl] = gate[(size_t)b * C + c0 + cl];
    __syncthreads();

    layer1(m, w1, b1, z, C, R);  // the forward's z1, to the bit
    for (int cl = warp; cl < cpb; cl += n_warps) {
        const T* xr = tx + cl * Tlen;
        const T* gr = tg + cl * Tlen;
        float ds = 0.0f;
        for (int t = lane; t < Tlen; t += 32)
            ds += to_f32(gr[t]) * to_f32(xr[t]);
        ds = warp_sum(ds);
        if (lane == 0) {
            const float sv = s[cl];
            dz2_all[c0 + cl] = ds * sv * (1.0f - sv);
        }
    }
    __syncthreads();
    cluster_wait();
    push_to_peers(cluster, dz2_all, c0, cpb);
    cluster.sync();  // every block now holds all C values of dz2

    // dh[j] = sum_c W2[c, j] dz2[c], one warp per j; dz1 = dh * [z1 > 0]
    for (int j = warp; j < R; j += n_warps) {
        float dh = 0.0f;
        for (int c = lane; c < C; c += 32)
            dh += to_f32(w2[(size_t)c * R + j]) * dz2_all[c];
        dh = warp_sum(dh);
        if (lane == 0) dz1[j] = z[j] > 0.0f ? dh : 0.0f;
    }
    __syncthreads();
    const float t_len = (float)Tlen;
    for (int cl = threadIdx.x; cl < cpb; cl += blockDim.x) {
        const int c = c0 + cl;
        float dm = 0.0f;
        for (int j = 0; j < R; ++j) dm += to_f32(w1[(size_t)j * C + c]) * dz1[j];
        dmt[cl] = dm / t_len;
        if (dz2_out != nullptr) dz2_out[(size_t)b * C + c] = dz2_all[c];
    }
    if (h_out != nullptr && c0 == 0) {
        for (int j = threadIdx.x; j < R; j += blockDim.x) {
            dz1_out[(size_t)b * R + j] = dz1[j];
            h_out[(size_t)b * R + j] = fmaxf(z[j], 0.0f);
        }
    }
    if (dx == nullptr) return;
    __syncthreads();
    T* db = dx + base;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int cl = i / Tlen;
        db[i] = from_f32<T>(to_f32(tg[i]) * s[cl] + dmt[cl]);
    }
}

// Backward, weight part: each output element sums its per-sample terms
// over b = 0, 1, ..., B-1 in that order. Outputs are laid out one after
// another (dW1 R*C, db1 R, dW2 C*R, db2 C); a null output is skipped.
template <typename T>
__global__ void __launch_bounds__(kParamThreads)
se_bwd_params(const float* __restrict__ dz2, const float* __restrict__ dz1,
              const float* __restrict__ h, const float* __restrict__ mean,
              T* __restrict__ dw1, T* __restrict__ db1, T* __restrict__ dw2,
              T* __restrict__ db2, int B, int C, int R) {
    const int n_w = R * C;
    const int total = 2 * n_w + R + C;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += gridDim.x * blockDim.x) {
        float acc = 0.0f;
        if (i < n_w) {  // dW1[j, c] = sum_b dz1[b, j] m[b, c]
            if (dw1 == nullptr) continue;
            const int j = i / C, c = i % C;
            for (int bb = 0; bb < B; ++bb)
                acc += dz1[(size_t)bb * R + j] * mean[(size_t)bb * C + c];
            dw1[i] = from_f32<T>(acc);
        } else if (i < n_w + R) {  // db1[j] = sum_b dz1[b, j]
            if (db1 == nullptr) continue;
            const int j = i - n_w;
            for (int bb = 0; bb < B; ++bb) acc += dz1[(size_t)bb * R + j];
            db1[j] = from_f32<T>(acc);
        } else if (i < 2 * n_w + R) {  // dW2[c, j] = sum_b dz2[b, c] h[b, j]
            if (dw2 == nullptr) continue;
            const int k = i - n_w - R;
            const int c = k / R, j = k % R;
            for (int bb = 0; bb < B; ++bb)
                acc += dz2[(size_t)bb * C + c] * h[(size_t)bb * R + j];
            dw2[k] = from_f32<T>(acc);
        } else {  // db2[c] = sum_b dz2[b, c]
            if (db2 == nullptr) continue;
            const int c = i - 2 * n_w - R;
            for (int bb = 0; bb < B; ++bb) acc += dz2[(size_t)bb * C + c];
            db2[c] = from_f32<T>(acc);
        }
    }
}

// Let `kernel` take up to the opt-in shared memory and clusters of 16
// blocks; once per device.
template <typename Kernel>
cudaError_t configure(Kernel kernel, bool (&done)[kMaxDevices]) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices && done[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
    return err;
}

cudaLaunchConfig_t cluster_config(int B, int K, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(B * K), 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

bool bad_split(int C, int K, size_t smem) {
    return K < 1 || K > 16 || C % K != 0 || smem > (size_t)kMaxSmem;
}

template <typename T>
int se_forward(const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, void* mean, void* gate, void* out, int B,
               int C, int Tlen, int R, int K, int vec, cudaStream_t stream) {
    static bool done[kMaxDevices] = {};
    const int cpb = C / K;
    const size_t smem = align16(4 * (size_t)(C + R + cpb))
                        + align16((size_t)cpb * Tlen * sizeof(T));
    if (bad_split(C, K, smem)) return (int)cudaErrorInvalidValue;
    cudaError_t err = configure(se_fwd<T>, done);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(B, K, smem, stream, attr);
    err = cudaLaunchKernelEx(
        &cfg, se_fwd<T>, static_cast<const T*>(x), static_cast<const T*>(w1),
        static_cast<const T*>(b1), static_cast<const T*>(w2),
        static_cast<const T*>(b2), static_cast<float*>(mean),
        static_cast<float*>(gate), static_cast<T*>(out), C, Tlen, R, vec);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// scratch: f32 dz2 (B, C), dz1 (B, R), h (B, R) one after another, or null
// when no weight needs a gradient (then the weight outputs are null too).
template <typename T>
int se_backward(const void* x, const void* g, const void* w1, const void* b1,
                const void* w2, const void* mean, const void* gate, void* dx,
                void* dw1, void* db1, void* dw2, void* db2, void* scratch,
                int B, int C, int Tlen, int R, int K, int vec,
                cudaStream_t stream) {
    static bool done[kMaxDevices] = {};
    const int cpb = C / K;
    const size_t smem = align16(8 * (size_t)(C + R + cpb))
                        + 2 * align16((size_t)cpb * Tlen * sizeof(T));
    if (bad_split(C, K, smem)) return (int)cudaErrorInvalidValue;
    cudaError_t err = configure(se_bwd<T>, done);
    if (err != cudaSuccess) return (int)err;
    float* dz2 = static_cast<float*>(scratch);
    float* dz1 = dz2 == nullptr ? nullptr : dz2 + (size_t)B * C;
    float* h = dz1 == nullptr ? nullptr : dz1 + (size_t)B * R;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(B, K, smem, stream, attr);
    err = cudaLaunchKernelEx(
        &cfg, se_bwd<T>, static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<const T*>(w1), static_cast<const T*>(b1),
        static_cast<const T*>(w2), static_cast<const float*>(mean),
        static_cast<const float*>(gate), static_cast<T*>(dx), dz2, dz1, h, C,
        Tlen, R, vec);
    if (err != cudaSuccess) return (int)err;
    err = cudaGetLastError();
    if (err != cudaSuccess || scratch == nullptr) return (int)err;
    const int total = 2 * R * C + R + C;
    const int blocks = (total + kParamThreads - 1) / kParamThreads;
    se_bwd_params<T><<<blocks, kParamThreads, 0, stream>>>(
        dz2, dz1, h, static_cast<const float*>(mean), static_cast<T*>(dw1),
        static_cast<T*>(db1), static_cast<T*>(dw2), static_cast<T*>(db2), B,
        C, R);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ecgmm_se_forward_f32(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* mean, void* gate,
                                    void* out, int B, int C, int Tlen, int R,
                                    int K, int vec, void* stream) {
    return se_forward<float>(x, w1, b1, w2, b2, mean, gate, out, B, C, Tlen,
                             R, K, vec, static_cast<cudaStream_t>(stream));
}

extern "C" int ecgmm_se_forward_bf16(const void* x, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, void* mean, void* gate,
                                     void* out, int B, int C, int Tlen, int R,
                                     int K, int vec, void* stream) {
    return se_forward<__nv_bfloat16>(x, w1, b1, w2, b2, mean, gate, out, B,
                                     C, Tlen, R, K, vec,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" int ecgmm_se_backward_f32(
    const void* x, const void* g, const void* w1, const void* b1,
    const void* w2, const void* mean, const void* gate, void* dx, void* dw1,
    void* db1, void* dw2, void* db2, void* scratch, int B, int C, int Tlen,
    int R, int K, int vec, void* stream) {
    return se_backward<float>(x, g, w1, b1, w2, mean, gate, dx, dw1, db1, dw2,
                              db2, scratch, B, C, Tlen, R, K, vec,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int ecgmm_se_backward_bf16(
    const void* x, const void* g, const void* w1, const void* b1,
    const void* w2, const void* mean, const void* gate, void* dx, void* dw1,
    void* db1, void* dw2, void* db2, void* scratch, int B, int C, int Tlen,
    int R, int K, int vec, void* stream) {
    return se_backward<__nv_bfloat16>(x, g, w1, b1, w2, mean, gate, dx, dw1,
                                      db1, dw2, db2, scratch, B, C, Tlen, R,
                                      K, vec,
                                      static_cast<cudaStream_t>(stream));
}
