// AttentionFusion head for Hopper: softmax-weighted concat + row LayerNorm.
//
// Replaces the TPU kernel `fused_attention_fusion`
// (ecgmm_tpu/ops/pallas_fusion.py:61-127):
//   sw  = softmax(w[0:3])
//   f   = concat(sw0 * img, sw1 * sig, sw2 * clin)            (B, D) f32
//   out = (f - mean(f)) * rsqrt(var(f) + eps) * scale + bias  biased var
//
// Bound: bytes. Each row is read once and written once (~8 flops per
// element). Design: one block per row. Every thread computes the 3-way
// softmax from the logits in device memory (no host round trip); the block
// copies its scaled row into shared memory in one pass over the three
// chunks, then takes a two-pass mean and centred variance in f32 from
// shared memory (the same arithmetic as the Pallas body), and writes the
// normalised row. Any chunk widths work; D is bounded only by shared
// memory (the wrapper checks it).
//
// Plain C interface (bound with ctypes): launches on the given stream,
// never synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_sum(float v, float* red) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float total = 0.0f;
    const int n_warps = blockDim.x >> 5;
    for (int i = 0; i < n_warps; ++i) total += red[i];
    __syncthreads();  // red is reused by the next reduction
    return total;
}

// shared memory: row[D] f32
__global__ void attention_fusion_fwd(
    const float* __restrict__ img, const float* __restrict__ sig,
    const float* __restrict__ clin, const float* __restrict__ logits,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, float* __restrict__ sw_out, int D0, int D1,
    int D2, float eps) {
    extern __shared__ float row[];
    __shared__ float red[32];
    const int b = blockIdx.x;
    const int D = D0 + D1 + D2;

    const float l0 = logits[0], l1 = logits[1], l2 = logits[2];
    const float m = fmaxf(l0, fmaxf(l1, l2));
    const float e0 = expf(l0 - m), e1 = expf(l1 - m), e2 = expf(l2 - m);
    // summed and divided in the order of torch.softmax's warp kernel for a
    // 3-wide row (lanes 0+2, then +1), so the soft weights agree to the bit
    const float sum = (e0 + e2) + e1;
    const float s0 = e0 / sum, s1 = e1 / sum, s2 = e2 / sum;
    if (b == 0 && threadIdx.x == 0) {
        sw_out[0] = s0;
        sw_out[1] = s1;
        sw_out[2] = s2;
    }

    const float* ib = img + (size_t)b * D0;
    const float* sb = sig + (size_t)b * D1;
    const float* cb = clin + (size_t)b * D2;
    float acc = 0.0f;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
        float v;
        if (i < D0) {
            v = s0 * ib[i];
        } else if (i < D0 + D1) {
            v = s1 * sb[i - D0];
        } else {
            v = s2 * cb[i - D0 - D1];
        }
        row[i] = v;
        acc += v;
    }
    const float mu = block_sum(acc, red) / (float)D;

    float sq = 0.0f;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
        const float c = row[i] - mu;
        sq += c * c;
    }
    const float rstd = rsqrtf(block_sum(sq, red) / (float)D + eps);

    float* ob = out + (size_t)b * D;
    for (int i = threadIdx.x; i < D; i += blockDim.x)
        ob[i] = (row[i] - mu) * rstd * scale[i] + bias[i];
}

}  // namespace

extern "C" int ecgmm_attention_fusion_forward(
    const void* img, const void* sig, const void* clin, const void* logits,
    const void* scale, const void* bias, void* out, void* sw_out, int B,
    int D0, int D1, int D2, float eps, void* stream) {
    const size_t smem = (size_t)(D0 + D1 + D2) * sizeof(float);
    attention_fusion_fwd<<<B, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(img), static_cast<const float*>(sig),
        static_cast<const float*>(clin), static_cast<const float*>(logits),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<float*>(out), static_cast<float*>(sw_out), D0, D1, D2,
        eps);
    return (int)cudaGetLastError();
}
