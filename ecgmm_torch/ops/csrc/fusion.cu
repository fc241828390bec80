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
// Backward (the JAX custom_vjp differentiates the reference expression,
// pallas_fusion.py:136-142; this is its closed form). Per row, with
// x = concat(img, sig, clin), f = sw_k * x, xh = (f - mu) * rstd and the
// cotangents go (B, D) and gsw (3,):
//   dxh = go * scale
//   df  = rstd * (dxh - mean(dxh) - xh * mean(dxh * xh)),  dx_k = sw_k * df
//   dscale = sum_b go * xh,  dbias = sum_b go,
//   dsw_k = sum_b sum_{chunk k} df * x + gsw_k,
//   dweights = sw * (dsw - sum_j sw_j dsw_j).
// Bound: bytes (read x, go and scale, write the input gradients). Design:
// attention_fusion_bwd_rows, one block per row, recomputes mu and rstd
// with the forward's arithmetic (recomputing a row from shared memory is
// cheaper than storing and reloading it), takes both means of the
// backward in one block reduction, and writes the gradient of each input
// chunk that needs one (a null pointer skips a chunk). Only where a
// parameter needs a gradient does it also store the row's (mu, rstd) and
// its three dsw partial sums, and attention_fusion_bwd_params then sums
// the columns over b in a fixed order (no atomics: a relaunch gives the
// same bits). With frozen parameters, as on the serving path, the
// backward is one launch.
//
// Plain C interface (bound with ctypes): every entry point launches on the
// given stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStats = 5;  // per row: mu, rstd, dsw partials of 3 chunks

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

// N sums at once, in the order of block_sum; red holds 32 * N floats
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N], float* red) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    for (int k = 0; k < N; ++k) {
        for (int off = 16; off > 0; off >>= 1)
            v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
        if (lane == 0) red[32 * k + warp] = v[k];
    }
    __syncthreads();
    for (int k = 0; k < N; ++k) {
        float total = 0.0f;
        for (int i = 0; i < n_warps; ++i) total += red[32 * k + i];
        v[k] = total;
    }
    __syncthreads();
}

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

    const SoftWeights sw = soft_weights(logits);
    const float s0 = sw.s[0], s1 = sw.s[1], s2 = sw.s[2];
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

__device__ __forceinline__ float chunk_weight(const SoftWeights& sw, int i,
                                              int D0, int D1) {
    return i < D0 ? sw.s[0] : (i < D0 + D1 ? sw.s[1] : sw.s[2]);
}

// shared memory: x[D] f32, the row's unscaled inputs. d_img, d_sig and
// d_clin may each be null; stats (B, kStats) is null unless a parameter
// needs a gradient.
__global__ void attention_fusion_bwd_rows(
    const float* __restrict__ img, const float* __restrict__ sig,
    const float* __restrict__ clin, const float* __restrict__ logits,
    const float* __restrict__ scale, const float* __restrict__ go,
    float* __restrict__ d_img, float* __restrict__ d_sig,
    float* __restrict__ d_clin, float* __restrict__ stats, int D0, int D1,
    int D2, float eps) {
    extern __shared__ float xrow[];
    __shared__ float red[32 * 3];
    const int b = blockIdx.x;
    const int D = D0 + D1 + D2;
    const SoftWeights sw = soft_weights(logits);
    const float* ib = img + (size_t)b * D0;
    const float* sb = sig + (size_t)b * D1;
    const float* cb = clin + (size_t)b * D2;

    // mu and rstd exactly as the forward computes them
    float acc = 0.0f;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
        float v;
        if (i < D0) {
            v = ib[i];
        } else if (i < D0 + D1) {
            v = sb[i - D0];
        } else {
            v = cb[i - D0 - D1];
        }
        xrow[i] = v;
        acc += chunk_weight(sw, i, D0, D1) * v;
    }
    const float mu = block_sum(acc, red) / (float)D;
    float sq = 0.0f;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
        const float c = chunk_weight(sw, i, D0, D1) * xrow[i] - mu;
        sq += c * c;
    }
    const float rstd = rsqrtf(block_sum(sq, red) / (float)D + eps);

    // mean(dxh) and mean(dxh * xh)
    const float* gb = go + (size_t)b * D;
    float means[2] = {0.0f, 0.0f};
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
        const float xh = (chunk_weight(sw, i, D0, D1) * xrow[i] - mu) * rstd;
        const float dxh = gb[i] * scale[i];
        means[0] += dxh;
        means[1] += dxh * xh;
    }
    block_sums(means, red);
    const float mean_d = means[0] / (float)D;
    const float mean_dx = means[1] / (float)D;

    float part[3] = {0.0f, 0.0f, 0.0f};  // sum over chunk k of df * x
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
        const float w = chunk_weight(sw, i, D0, D1);
        const float xh = (w * xrow[i] - mu) * rstd;
        const float df = rstd * (gb[i] * scale[i] - mean_d - xh * mean_dx);
        if (i < D0) {
            if (d_img != nullptr) d_img[(size_t)b * D0 + i] = w * df;
            part[0] += df * xrow[i];
        } else if (i < D0 + D1) {
            if (d_sig != nullptr) d_sig[(size_t)b * D1 + i - D0] = w * df;
            part[1] += df * xrow[i];
        } else {
            if (d_clin != nullptr)
                d_clin[(size_t)b * D2 + i - D0 - D1] = w * df;
            part[2] += df * xrow[i];
        }
    }
    if (stats == nullptr) return;
    block_sums(part, red);
    if (threadIdx.x == 0) {
        float* st = stats + (size_t)b * kStats;
        st[0] = mu;
        st[1] = rstd;
        st[2] = part[0];
        st[3] = part[1];
        st[4] = part[2];
    }
}

// One thread per column: dscale and dbias summed over b = 0..B-1 in that
// order; thread 0 of block 0 also sums the dsw partials in the same order
// and applies the softmax backward. Null outputs are skipped.
__global__ void attention_fusion_bwd_params(
    const float* __restrict__ img, const float* __restrict__ sig,
    const float* __restrict__ clin, const float* __restrict__ logits,
    const float* __restrict__ go, const float* __restrict__ gsw,
    const float* __restrict__ stats, float* __restrict__ d_logits,
    float* __restrict__ d_scale, float* __restrict__ d_bias, int B, int D0,
    int D1, int D2) {
    const int D = D0 + D1 + D2;
    const SoftWeights sw = soft_weights(logits);
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < D && (d_scale != nullptr || d_bias != nullptr)) {
        const float* x;
        int width, col;
        if (i < D0) {
            x = img, width = D0, col = i;
        } else if (i < D0 + D1) {
            x = sig, width = D1, col = i - D0;
        } else {
            x = clin, width = D2, col = i - D0 - D1;
        }
        const float w = chunk_weight(sw, i, D0, D1);
        float ds = 0.0f, db = 0.0f;
        for (int bb = 0; bb < B; ++bb) {
            const float g = go[(size_t)bb * D + i];
            const float* st = stats + (size_t)bb * kStats;
            ds += g * ((w * x[(size_t)bb * width + col] - st[0]) * st[1]);
            db += g;
        }
        if (d_scale != nullptr) d_scale[i] = ds;
        if (d_bias != nullptr) d_bias[i] = db;
    }
    if (d_logits != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
        float dsw[3];
        for (int k = 0; k < 3; ++k) {
            float a = 0.0f;
            for (int bb = 0; bb < B; ++bb) a += stats[(size_t)bb * kStats + 2 + k];
            dsw[k] = a + (gsw != nullptr ? gsw[k] : 0.0f);
        }
        const float dot = sw.s[0] * dsw[0] + sw.s[1] * dsw[1] + sw.s[2] * dsw[2];
        for (int k = 0; k < 3; ++k) d_logits[k] = sw.s[k] * (dsw[k] - dot);
    }
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

// d_img, d_sig, d_clin: null where the input needs no gradient. d_logits,
// d_scale, d_bias: likewise; where any of them is wanted, stats is a
// (B, 5) f32 scratch, else null and the backward is one launch. gsw may
// be null (no cotangent on the soft weights).
extern "C" int ecgmm_attention_fusion_backward(
    const void* img, const void* sig, const void* clin, const void* logits,
    const void* scale, const void* go, const void* gsw, void* d_img,
    void* d_sig, void* d_clin, void* d_logits, void* d_scale, void* d_bias,
    void* stats, int B, int D0, int D1, int D2, float eps, void* stream) {
    const int D = D0 + D1 + D2;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (B > 0) {  // an empty batch leaves only the soft-weight cotangent
        attention_fusion_bwd_rows<<<B, kThreads, (size_t)D * sizeof(float),
                                    s>>>(
            static_cast<const float*>(img), static_cast<const float*>(sig),
            static_cast<const float*>(clin),
            static_cast<const float*>(logits),
            static_cast<const float*>(scale), static_cast<const float*>(go),
            static_cast<float*>(d_img), static_cast<float*>(d_sig),
            static_cast<float*>(d_clin), static_cast<float*>(stats), D0, D1,
            D2, eps);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || stats == nullptr) return (int)err;
    attention_fusion_bwd_params<<<(D + kThreads - 1) / kThreads, kThreads, 0,
                                  s>>>(
        static_cast<const float*>(img), static_cast<const float*>(sig),
        static_cast<const float*>(clin), static_cast<const float*>(logits),
        static_cast<const float*>(go), static_cast<const float*>(gsw),
        static_cast<const float*>(stats), static_cast<float*>(d_logits),
        static_cast<float*>(d_scale), static_cast<float*>(d_bias), B, D0, D1,
        D2);
    return (int)cudaGetLastError();
}
