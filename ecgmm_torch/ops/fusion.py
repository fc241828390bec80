"""AttentionFusion head (port of `ecgmm_tpu/ops/pallas_fusion.py`).

`fused_attention_fusion(img, sig, clin, weights, scale, bias, eps)`
returns `(out (B, D) f32, sw (3,))`: sw = softmax(weights), then a row
LayerNorm (biased variance) of concat(sw0*img, sw1*sig, sw2*clin), times
scale plus bias.

For tensors on a CUDA device the forward is the CUDA kernel
(`csrc/fusion.cu`), wrapped in a `torch.autograd.Function` whose backward
differentiates `reference_attention_fusion` (the design of the JAX
`custom_vjp`, which has no backward kernel either). For tensors on the
CPU the op is `reference_attention_fusion`. `launches` counts kernel
launches.
"""

from __future__ import annotations

import torch

from ecgmm_torch.ops import _ext

launches = 0

# the kernel keeps a row in shared memory; 48 KB without opting in
_MAX_WIDTH = 48 * 1024 // 4


def reference_attention_fusion(img, sig, clin, weights, scale, bias,
                               eps: float = 1e-6):
    """The unfused expression (ground truth for the kernel)."""
    sw = torch.softmax(weights, dim=0)
    fused = torch.cat([sw[0] * img, sw[1] * sig, sw[2] * clin], dim=-1)
    mu = fused.mean(dim=-1, keepdim=True)
    var = fused.var(dim=-1, unbiased=False, keepdim=True)
    out = (fused - mu) * torch.rsqrt(var + eps) * scale + bias
    return out, sw


def _launch(img, sig, clin, weights, scale, bias, eps):
    tensors = (img, sig, clin, weights, scale, bias)
    dev = img.device
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(
                "fused_attention_fusion: every input must be float32 on "
                f"{dev}, got {t.dtype} on {t.device}"
            )
    b = img.shape[0]
    d0, d1, d2 = img.shape[1], sig.shape[1], clin.shape[1]
    d = d0 + d1 + d2
    if sig.shape[0] != b or clin.shape[0] != b or weights.shape != (3,) \
            or scale.shape != (d,) or bias.shape != (d,):
        raise ValueError("fused_attention_fusion: inconsistent shapes")
    if d > _MAX_WIDTH:
        raise ValueError(
            f"fused_attention_fusion: width {d} exceeds {_MAX_WIDTH}"
        )
    img, sig, clin, weights, scale, bias = (t.contiguous() for t in tensors)
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    sw = torch.empty((3,), dtype=torch.float32, device=dev)
    if b == 0:
        return out, torch.softmax(weights, dim=0)
    lib = _ext.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.ecgmm_attention_fusion_forward(
            img.data_ptr(), sig.data_ptr(), clin.data_ptr(),
            weights.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), sw.data_ptr(), b, d0, d1, d2, float(eps), stream,
        )
    _ext.check(status, "ecgmm_attention_fusion_forward")
    global launches
    launches += 1
    return out, sw


def reference_backward(inputs, eps, grad_out, grad_sw):
    """Gradients of `reference_attention_fusion` w.r.t. its six inputs
    for the cotangents (grad_out, grad_sw) — the backward of the fused
    op, evaluated on whatever device the inputs lie on."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out, sw = reference_attention_fusion(*leaves, eps=eps)
        outs, grads = [out], [grad_out]
        if grad_sw is not None:
            outs.append(sw)
            grads.append(grad_sw)
        return torch.autograd.grad(outs, leaves, grads, allow_unused=True)


class _FusedAttentionFusion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, sig, clin, weights, scale, bias, eps):
        ctx.save_for_backward(img, sig, clin, weights, scale, bias)
        ctx.eps = eps
        return _launch(img, sig, clin, weights, scale, bias, eps)

    @staticmethod
    def backward(ctx, grad_out, grad_sw):
        grads = reference_backward(ctx.saved_tensors, ctx.eps, grad_out,
                                   grad_sw)
        return (*grads, None)


def fused_attention_fusion(img, sig, clin, weights, scale, bias,
                           eps: float = 1e-6):
    """AttentionFusion forward: the CUDA kernel (with the reference
    backward) for CUDA tensors, `reference_attention_fusion` for CPU
    tensors."""
    if img.device.type == "cpu":
        return reference_attention_fusion(img, sig, clin, weights, scale,
                                          bias, eps=eps)
    if img.device.type != "cuda":
        raise ValueError(
            f"fused_attention_fusion: unsupported device {img.device}"
        )
    return _FusedAttentionFusion.apply(img, sig, clin, weights, scale, bias,
                                       eps)
