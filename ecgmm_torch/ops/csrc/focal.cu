// Masked focal loss for Hopper: forward and backward, one launch each.
//
// Replaces the TPU kernel `fused_focal_loss`
// (ecgmm_tpu/ops/pallas_losses.py:43-78) and the VJP of `reference_focal`
// that its custom_vjp takes (:92-99). Per row
//   ce   = logsumexp(logits) - logit[label],  pt = exp(-ce),  u = 1 - pt
//   t    = alpha * u^gamma * ce
// and the loss L = sum(t * mask) / den with den = max(sum(mask), 1), a
// 0-d f32 tensor. The Pallas kernel emitted the per-row terms and left
// both sums to XLA, because Mosaic could not carry a sum across grid
// steps; here both sums are taken inside the kernel. For the cotangent g:
//   dt/dce  = alpha * (u^gamma + gamma * u^(gamma-1) * pt * ce)
//   dlogits = g * mask / den * dt/dce * (softmax(logits) - onehot(label))
//   dmask   = g * (t - L * h) / den
// where h, the derivative of max(s, 1) at s = sum(mask), is 1 above 1, 0.5
// at 1 (a tie splits as jnp.maximum's VJP does) and 0 below. gamma = 0
// drops the second term of dt/dce, as torch's pow backward does.
//
// Bound: launch latency. On the training path the logits are (B, C) with
// B <= 64 and C <= 4, about a kilobyte in all; even at (65536, 2) the
// inputs are ~1.3 MB, under half a microsecond at the card's memory rate.
//
// Design. The wrapper (`ecgmm_torch/ops/losses.py`) splits the rows into K
// contiguous ranges, one per block (`cluster_size`: K = 1 for the small
// batches of training, 16 where the logits hold more than 2048 values). A
// thread walks the rows r0 + tid, r0 + tid + blockDim, ... of its block's
// range, so neighbouring threads read neighbouring rows and the loads
// coalesce; with two classes a row is one 8-byte load (`vec`). Forward:
// each thread keeps two f32 partial sums (term and mask), the block
// reduces them with warp shuffles
// and a fixed pass over the warps, and with K > 1 the blocks form one
// thread-block cluster: every block pushes its two sums into block 0's
// shared memory (distributed shared memory), one cluster barrier, and
// block 0 adds them in rank order. The kernel writes the loss and the
// 2-float residual (sum of terms, sum of mask) that the backward reads, so
// the backward needs no host sync and no second reduction. Backward: the
// same split of contiguous row ranges, over as many plain blocks as the
// rows fill (`backward_blocks`: a row's gradients need no other row, so
// no cluster); each thread recomputes its rows' softmax from the logits
// (B*C floats, cheaper than storing them) and writes dlogits, and dmask
// only where it is asked for (a null pointer skips it). No atomics: the
// same inputs give the same bits on every launch.
//
// A label outside [0, C) contributes a zero label logit (and no one-hot
// entry in the backward), as the Pallas kernel's one-hot does. gamma is a
// float, applied with powf.
//
// Plain C interface (bound with ctypes): every entry point launches on the
// given stream, never synchronises, allocates nothing, and returns a CUDA
// error code (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;
constexpr int kMaxGrid = 65535;  // blocks of the backward

// the first half of a split cluster barrier (see se.cu): its wait, before
// the first remote store, guarantees that block 0 has started
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

// rows [row_begin(B, K, k), row_begin(B, K, k + 1)) belong to block k
__host__ __device__ __forceinline__ int row_begin(int B, int K, int k) {
    return (int)(((long long)B * k) / K);
}

// One row's logits: the whole row from registers where C == 2 and `vec`,
// else read from device memory
struct Row {
    float v0, v1;
    const float* p;
    int C;
    bool two;
    __device__ __forceinline__ float at(int c) const {
        return two ? (c == 0 ? v0 : v1) : p[c];
    }
};

__device__ __forceinline__ Row load_row(const float* __restrict__ logits,
                                        int i, int C, int vec) {
    Row r;
    r.C = C;
    r.p = logits + (size_t)i * C;
    r.two = vec != 0;
    if (r.two) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(logits) + i);
        r.v0 = v.x;
        r.v1 = v.y;
    } else {
        r.v0 = r.v1 = 0.0f;
    }
    return r;
}

struct Stats {
    float m, z, ce, pt;
};

// max, sum of exp and ce, in the same order in both kernels
__device__ __forceinline__ Stats row_stats(const Row& r, long long y) {
    float m = r.at(0);
    for (int c = 1; c < r.C; ++c) m = fmaxf(m, r.at(c));
    float z = 0.0f;
    for (int c = 0; c < r.C; ++c) z += expf(r.at(c) - m);
    const float logz = logf(z) + m;
    const float ll = (y >= 0 && y < r.C) ? r.at((int)y) : 0.0f;
    const float ce = logz - ll;
    return {m, z, ce, expf(-ce)};
}

template <typename L, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
focal_fwd(const float* __restrict__ logits, const L* __restrict__ labels,
          const float* __restrict__ mask, float* __restrict__ out,
          float* __restrict__ res, int B, int C, float alpha, float gamma,
          int vec) {
    __shared__ float red[2 * (kMaxThreads / 32)];
    __shared__ float part[2 * kMaxCluster];  // block 0's: the blocks' sums
    if (kCluster) cluster_arrive_relaxed();
    const int K = gridDim.x;
    const int rank = blockIdx.x;
    const int tid = threadIdx.x;
    const int r1 = row_begin(B, K, rank + 1);
    float term = 0.0f;
    float msum = 0.0f;
    for (int i = row_begin(B, K, rank) + tid; i < r1; i += blockDim.x) {
        const Row r = load_row(logits, i, C, vec);
        const Stats s = row_stats(r, (long long)labels[i]);
        const float mk = mask[i];
        term += alpha * powf(1.0f - s.pt, gamma) * s.ce * mk;
        msum += mk;
    }
    term = warp_sum(term);
    msum = warp_sum(msum);
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (lane == 0) {
        red[2 * warp] = term;
        red[2 * warp + 1] = msum;
    }
    __syncthreads();
    if (tid == 0) {
        term = msum = 0.0f;
        for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
            term += red[2 * w];
            msum += red[2 * w + 1];
        }
    }
    if (kCluster) {
        cg::cluster_group cluster = cg::this_cluster();
        cluster_wait();
        if (tid == 0) {
            float* dst = cluster.map_shared_rank(part, 0);
            dst[2 * rank] = term;
            dst[2 * rank + 1] = msum;
        }
        cluster.sync();  // block 0 now holds every block's sums
        if (rank != 0 || tid != 0) return;
        term = msum = 0.0f;
        for (int k = 0; k < K; ++k) {
            term += part[2 * k];
            msum += part[2 * k + 1];
        }
    } else if (tid != 0) {
        return;
    }
    res[0] = term;
    res[1] = msum;
    out[0] = term / fmaxf(msum, 1.0f);
}

template <typename L>
__global__ void __launch_bounds__(kMaxThreads)
focal_bwd(const float* __restrict__ logits, const L* __restrict__ labels,
          const float* __restrict__ mask, const float* __restrict__ res,
          const float* __restrict__ grad, float* __restrict__ dlogits,
          float* __restrict__ dmask, int B, int C, float alpha, float gamma,
          int vec) {
    const int K = gridDim.x;
    const int rank = blockIdx.x;
    const float g = grad[0];
    const float msum = res[1];
    const float den = fmaxf(msum, 1.0f);
    const float loss = res[0] / den;  // the forward's value, to the bit
    const float h = msum > 1.0f ? 1.0f : (msum == 1.0f ? 0.5f : 0.0f);
    const int r1 = row_begin(B, K, rank + 1);
    for (int i = row_begin(B, K, rank) + threadIdx.x; i < r1;
         i += blockDim.x) {
        const Row r = load_row(logits, i, C, vec);
        const long long y = (long long)labels[i];
        const Stats s = row_stats(r, y);
        const float u = 1.0f - s.pt;
        const float ug = powf(u, gamma);
        const float mk = mask[i];
        if (dmask != nullptr)
            dmask[i] = g * (alpha * ug * s.ce - loss * h) / den;
        if (dlogits == nullptr) continue;
        float dtdce = ug;
        if (gamma != 0.0f)
            dtdce += gamma * powf(u, gamma - 1.0f) * s.pt * s.ce;
        const float coef = g * mk / den * (alpha * dtdce);
        const float inv_z = 1.0f / s.z;
        if (r.two) {
            float2 d;
            d.x = coef * (expf(r.v0 - s.m) * inv_z - (y == 0 ? 1.0f : 0.0f));
            d.y = coef * (expf(r.v1 - s.m) * inv_z - (y == 1 ? 1.0f : 0.0f));
            reinterpret_cast<float2*>(dlogits)[i] = d;
        } else {
            float* drow = dlogits + (size_t)i * C;
            for (int c = 0; c < C; ++c)
                drow[c] = coef * (expf(r.at(c) - s.m) * inv_z
                                  - (y == c ? 1.0f : 0.0f));
        }
    }
}

// Let the cluster kernel take clusters of 16 blocks; once per device.
template <typename Kernel>
cudaError_t configure(Kernel kernel, bool (&done)[kMaxDevices]) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices && done[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
    return err;
}

bool bad_launch(int B, int C, int K, int max_k, int threads, int vec) {
    return B < 0 || C < 1 || K < 1 || K > max_k || threads < 32
           || threads > kMaxThreads || threads % 32 != 0 || (vec && C != 2);
}

template <typename L>
int focal_forward(const void* logits, const void* labels, const void* mask,
                  void* out, void* res, int B, int C, int K, int threads,
                  int vec, float alpha, float gamma, cudaStream_t stream) {
    if (bad_launch(B, C, K, kMaxCluster, threads, vec))
        return (int)cudaErrorInvalidValue;
    const float* lg = static_cast<const float*>(logits);
    const L* lb = static_cast<const L*>(labels);
    const float* mk = static_cast<const float*>(mask);
    float* o = static_cast<float*>(out);
    float* r = static_cast<float*>(res);
    if (K == 1) {
        focal_fwd<L, false><<<1, threads, 0, stream>>>(
            lg, lb, mk, o, r, B, C, alpha, gamma, vec);
        return (int)cudaGetLastError();
    }
    static bool done[kMaxDevices] = {};
    cudaError_t err = configure(focal_fwd<L, true>, done);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)K, 1, 1);
    cfg.blockDim = dim3((unsigned)threads, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, focal_fwd<L, true>, lg, lb, mk, o, r, B, C,
                             alpha, gamma, vec);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <typename L>
int focal_backward(const void* logits, const void* labels, const void* mask,
                   const void* res, const void* grad, void* dlogits,
                   void* dmask, int B, int C, int K, int threads, int vec,
                   float alpha, float gamma, cudaStream_t stream) {
    if (bad_launch(B, C, K, kMaxGrid, threads, vec))
        return (int)cudaErrorInvalidValue;
    focal_bwd<L><<<K, threads, 0, stream>>>(
        static_cast<const float*>(logits), static_cast<const L*>(labels),
        static_cast<const float*>(mask), static_cast<const float*>(res),
        static_cast<const float*>(grad), static_cast<float*>(dlogits),
        static_cast<float*>(dmask), B, C, alpha, gamma, vec);
    return (int)cudaGetLastError();
}

}  // namespace

// out: the 0-d loss; res: 2 floats, sum(term) and sum(mask). K blocks
// (a cluster where K > 1) of `threads` threads; vec: a row is one 8-byte
// load (C == 2, logits 8-byte aligned).
extern "C" int ecgmm_focal_loss_forward_i32(
    const void* logits, const void* labels, const void* mask, void* out,
    void* res, int B, int C, int K, int threads, int vec, float alpha,
    float gamma, void* stream) {
    return focal_forward<int32_t>(logits, labels, mask, out, res, B, C, K,
                                  threads, vec, alpha, gamma,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int ecgmm_focal_loss_forward_i64(
    const void* logits, const void* labels, const void* mask, void* out,
    void* res, int B, int C, int K, int threads, int vec, float alpha,
    float gamma, void* stream) {
    return focal_forward<int64_t>(logits, labels, mask, out, res, B, C, K,
                                  threads, vec, alpha, gamma,
                                  static_cast<cudaStream_t>(stream));
}

// res: the forward's residual; grad: the 0-d cotangent. dlogits (B, C) and
// dmask (B,) may each be null (not needed). K plain blocks of `threads`
// threads, each a contiguous range of rows; vec as in the forward.
extern "C" int ecgmm_focal_loss_backward_i32(
    const void* logits, const void* labels, const void* mask,
    const void* res, const void* grad, void* dlogits, void* dmask, int B,
    int C, int K, int threads, int vec, float alpha, float gamma,
    void* stream) {
    return focal_backward<int32_t>(logits, labels, mask, res, grad, dlogits,
                                   dmask, B, C, K, threads, vec, alpha, gamma,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int ecgmm_focal_loss_backward_i64(
    const void* logits, const void* labels, const void* mask,
    const void* res, const void* grad, void* dlogits, void* dmask, int B,
    int C, int K, int threads, int vec, float alpha, float gamma,
    void* stream) {
    return focal_backward<int64_t>(logits, labels, mask, res, grad, dlogits,
                                   dmask, B, C, K, threads, vec, alpha, gamma,
                                   static_cast<cudaStream_t>(stream));
}
