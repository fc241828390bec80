// Squeeze-and-Excitation gate (1-D) for Hopper, x laid out (B, C, T).
//
// Replaces the TPU kernel `fused_se` (ecgmm_tpu/ops/pallas_se.py:59-115):
//   g   = sigmoid(relu(mean_T(x) . W1^T + b1) . W2^T + b2)     (B, C) f32
//   out = x * g[:, :, None]                                    x's dtype
//
// Bound: bytes. The op reads x once for the squeeze, once more for the
// scale, and writes out once; the two dense layers are C*C/8 flops per
// sample. Design: two kernels.
//   se_gate   - one block per sample. Each warp reduces whole channel
//               rows (contiguous in T, so loads coalesce) in f32 with warp
//               shuffles; the means land in shared memory, and the block
//               then runs both dense layers from shared memory and writes
//               the f32 gate.
//   se_scale  - elementwise out = x * g, grid-stride over B*C*T.
// The second read of x usually hits L2 (a sample is at most ~160 KB in
// f32 on the serving path). A single-pass kernel that keeps the (C, T)
// tile in shared memory is a later optimisation.
//
// Plain C interface (bound with ctypes): every entry point launches on the
// given stream, never synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

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

constexpr int kGateThreads = 512;

// shared memory: mean[C] followed by hidden[R], both f32
template <typename T>
__global__ void se_gate(const T* __restrict__ x, const T* __restrict__ w1,
                        const T* __restrict__ b1, const T* __restrict__ w2,
                        const T* __restrict__ b2, float* __restrict__ gate,
                        int C, int Tlen, int R) {
    extern __shared__ float smem[];
    float* mean = smem;
    float* hidden = smem + C;
    const int b = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    const T* xb = x + (size_t)b * C * Tlen;
    const float inv_t = 1.0f / (float)Tlen;

    // squeeze: one warp per channel row
    for (int c = warp; c < C; c += n_warps) {
        const T* row = xb + (size_t)c * Tlen;
        float s = 0.0f;
        for (int t = lane; t < Tlen; t += 32) s += to_f32(row[t]);
        for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) mean[c] = s * inv_t;
    }
    __syncthreads();

    // excite, layer 1: hidden[j] = relu(b1[j] + sum_c mean[c] * W1[j, c])
    for (int j = warp; j < R; j += n_warps) {
        const T* wrow = w1 + (size_t)j * C;
        float s = 0.0f;
        for (int c = lane; c < C; c += 32) s += mean[c] * to_f32(wrow[c]);
        for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) hidden[j] = fmaxf(s + to_f32(b1[j]), 0.0f);
    }
    __syncthreads();

    // layer 2: gate[c] = sigmoid(b2[c] + sum_j hidden[j] * W2[c, j])
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        const T* wrow = w2 + (size_t)c * R;
        float s = to_f32(b2[c]);
        for (int j = 0; j < R; ++j) s += hidden[j] * to_f32(wrow[j]);
        gate[(size_t)b * C + c] = 1.0f / (1.0f + expf(-s));
    }
}

template <typename T>
__global__ void se_scale(const T* __restrict__ x,
                         const float* __restrict__ gate, T* __restrict__ out,
                         long long n, int Tlen) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        out[i] = from_f32<T>(to_f32(x[i]) * gate[i / Tlen]);
    }
}

template <typename T>
int se_forward(const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, float* gate, void* out, int B, int C, int Tlen,
               int R, cudaStream_t stream) {
    const size_t smem = (size_t)(C + R) * sizeof(float);
    se_gate<T><<<B, kGateThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w1),
        static_cast<const T*>(b1), static_cast<const T*>(w2),
        static_cast<const T*>(b2), gate, C, Tlen, R);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long n = (long long)B * C * Tlen;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132LL * 32) blocks = 132LL * 32;
    se_scale<T><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(x), gate, static_cast<T*>(out), n, Tlen);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ecgmm_se_forward_f32(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* gate, void* out,
                                    int B, int C, int Tlen, int R,
                                    void* stream) {
    return se_forward<float>(x, w1, b1, w2, b2, static_cast<float*>(gate),
                             out, B, C, Tlen, R,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int ecgmm_se_forward_bf16(const void* x, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, void* gate, void* out,
                                     int B, int C, int Tlen, int R,
                                     void* stream) {
    return se_forward<__nv_bfloat16>(x, w1, b1, w2, b2,
                                     static_cast<float*>(gate), out, B, C,
                                     Tlen, R,
                                     static_cast<cudaStream_t>(stream));
}
