// Masked focal loss for Hopper: the whole loss in one launch.
//
// Replaces the TPU kernel `fused_focal_loss`
// (ecgmm_tpu/ops/pallas_losses.py:43-78): per row
//   ce   = logsumexp(logits) - logit[label]
//   term = alpha * (1 - exp(-ce))^gamma * ce * mask
// and returns sum(term) / max(sum(mask), 1) as a 0-d f32 tensor. The
// Pallas kernel emitted the per-row terms and left both sums to XLA,
// because Mosaic could not carry a sum across grid steps; here both sums
// are taken inside the kernel.
//
// Bound: launch latency. On the training path the logits are (B, C) with
// B <= 64 and C <= 4, about a kilobyte in all; even at (65536, 2) the
// inputs are ~1 MB, a third of a microsecond at the card's memory rate.
// Design: ONE block. Each thread walks the rows tid, tid + blockDim, ...
// in a fixed order (neighbouring threads read neighbouring rows, so the
// loads coalesce), keeping two f32 partial sums (term and mask); the
// block then reduces both in a fixed shared-memory tree. Blocks never
// race and there are no atomics, so the same inputs give a bit-identical
// loss on every launch. A multi-block reduction would only pay off far
// above the batch sizes this model trains at.
//
// A label outside [0, C) contributes a zero label logit, as the Pallas
// kernel's one-hot does. gamma is a float, applied with powf.
//
// Plain C interface (bound with ctypes): every entry point launches on the
// given stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;

template <typename L>
__global__ void __launch_bounds__(kThreads)
focal_loss(const float* __restrict__ logits, const L* __restrict__ labels,
           const float* __restrict__ mask, float* __restrict__ out, int B,
           int C, float alpha, float gamma) {
    __shared__ float s_term[kThreads];
    __shared__ float s_mask[kThreads];
    const int tid = threadIdx.x;
    float term = 0.0f;
    float msum = 0.0f;
    for (int i = tid; i < B; i += kThreads) {
        const float* row = logits + (size_t)i * C;
        float m = row[0];
        for (int c = 1; c < C; ++c) m = fmaxf(m, row[c]);
        float z = 0.0f;
        for (int c = 0; c < C; ++c) z += expf(row[c] - m);
        const float logz = logf(z) + m;
        const long long y = (long long)labels[i];
        const float ll = (y >= 0 && y < C) ? row[y] : 0.0f;
        const float ce = logz - ll;
        const float pt = expf(-ce);
        const float mk = mask[i];
        term += alpha * powf(1.0f - pt, gamma) * ce * mk;
        msum += mk;
    }
    s_term[tid] = term;
    s_mask[tid] = msum;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (tid < s) {
            s_term[tid] += s_term[tid + s];
            s_mask[tid] += s_mask[tid + s];
        }
        __syncthreads();
    }
    if (tid == 0) out[0] = s_term[0] / fmaxf(s_mask[0], 1.0f);
}

template <typename L>
int focal_forward(const void* logits, const void* labels, const void* mask,
                  void* out, int B, int C, float alpha, float gamma,
                  cudaStream_t stream) {
    focal_loss<L><<<1, kThreads, 0, stream>>>(
        static_cast<const float*>(logits), static_cast<const L*>(labels),
        static_cast<const float*>(mask), static_cast<float*>(out), B, C,
        alpha, gamma);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ecgmm_focal_loss_forward_i32(const void* logits,
                                            const void* labels,
                                            const void* mask, void* out,
                                            int B, int C, float alpha,
                                            float gamma, void* stream) {
    return focal_forward<int32_t>(logits, labels, mask, out, B, C, alpha,
                                  gamma, static_cast<cudaStream_t>(stream));
}

extern "C" int ecgmm_focal_loss_forward_i64(const void* logits,
                                            const void* labels,
                                            const void* mask, void* out,
                                            int B, int C, float alpha,
                                            float gamma, void* stream) {
    return focal_forward<int64_t>(logits, labels, mask, out, B, C, alpha,
                                  gamma, static_cast<cudaStream_t>(stream));
}
