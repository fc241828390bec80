"""AttentionFusion head (port of `ecgmm_tpu/ops/pallas_fusion.py`).

`fused_attention_fusion(img, sig, clin, weights, scale, bias, eps)`
returns `(out (B, D) f32, sw (3,))`: sw = softmax(weights), then a row
LayerNorm (biased variance) of concat(sw0*img, sw1*sig, sw2*clin), times
scale plus bias.

For tensors on a CUDA device the op runs the CUDA kernels
(`csrc/fusion.cu`), wrapped in a `torch.autograd.Function`: the forward
kernel, and a backward kernel that writes the gradients of the inputs
that need one, plus a column reduction where a parameter (`weights`,
`scale`, `bias`) needs one. For tensors on the CPU the op is
`reference_attention_fusion`. `launches` counts forward launches and
`backward_launches` backward calls through the kernels.

`reference_backward` (autograd of the reference, the JAX custom_vjp's
design) and `reference_fusion_backward` (the closed form the kernels
compute) are the plain versions of the backward.
"""

from __future__ import annotations

import torch

from ecgmm_torch.ops import _ext

launches = 0
backward_launches = 0

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


def _prepare(img, sig, clin, weights, scale, bias):
    """Check the inputs of the kernels; returns them contiguous."""
    tensors = (img, sig, clin, weights, scale, bias)
    dev = img.device
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(
                "fused_attention_fusion: every input must be float32 on "
                f"{dev}, got {t.dtype} on {t.device}"
            )
    b = img.shape[0]
    d = img.shape[1] + sig.shape[1] + clin.shape[1]
    if sig.shape[0] != b or clin.shape[0] != b or weights.shape != (3,) \
            or scale.shape != (d,) or bias.shape != (d,):
        raise ValueError("fused_attention_fusion: inconsistent shapes")
    if d > _MAX_WIDTH:
        raise ValueError(
            f"fused_attention_fusion: width {d} exceeds {_MAX_WIDTH}"
        )
    return tuple(t.contiguous() for t in tensors)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(img, sig, clin, weights, scale, bias, eps):
    """The forward kernel on inputs that `_prepare` returned."""
    dev = img.device
    b = img.shape[0]
    d0, d1, d2 = img.shape[1], sig.shape[1], clin.shape[1]
    out = torch.empty((b, d0 + d1 + d2), dtype=torch.float32, device=dev)
    sw = torch.empty((3,), dtype=torch.float32, device=dev)
    if b == 0:
        return out, torch.softmax(weights, dim=0)
    lib = _ext.library()
    context, stream = _ext.launch_target(dev)
    with context:
        status = lib.ecgmm_attention_fusion_forward(
            img.data_ptr(), sig.data_ptr(), clin.data_ptr(),
            weights.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), sw.data_ptr(), b, d0, d1, d2, float(eps), stream,
        )
    _ext.check(status, "ecgmm_attention_fusion_forward")
    global launches
    launches += 1
    return out, sw


def launch_backward(inputs, eps, grad_out, grad_sw, needs=(True,) * 6):
    """The backward kernels for the six inputs that `_prepare` returned
    and the cotangents (grad_out, grad_sw): gradients w.r.t. the six
    inputs, None where `needs` is False. grad_sw may be None."""
    img, sig, clin, weights, scale, _ = inputs
    dev = img.device
    b = img.shape[0]
    d0, d1, d2 = img.shape[1], sig.shape[1], clin.shape[1]
    grads = [torch.empty_like(t) if need else None
             for t, need in zip(inputs, needs)]
    # per row: mu, rstd and the three dsw partials (at least one row, so
    # that the pointer is not null)
    stats = None
    if any(needs[3:6]):
        stats = torch.empty((max(b, 1), 5), dtype=torch.float32, device=dev)
    gsw = None
    if grad_sw is not None and needs[3]:
        gsw = grad_sw.contiguous()
    go = grad_out.contiguous()
    lib = _ext.library()
    context, stream = _ext.launch_target(dev)
    with context:
        status = lib.ecgmm_attention_fusion_backward(
            img.data_ptr(), sig.data_ptr(), clin.data_ptr(),
            weights.data_ptr(), scale.data_ptr(), go.data_ptr(), _ptr(gsw),
            *map(_ptr, grads), _ptr(stats), b, d0, d1, d2, float(eps),
            stream,
        )
    _ext.check(status, "ecgmm_attention_fusion_backward")
    global backward_launches
    backward_launches += 1
    return tuple(grads)


def reference_backward(inputs, eps, grad_out, grad_sw):
    """Gradients of `reference_attention_fusion` w.r.t. its six inputs
    for the cotangents (grad_out, grad_sw), by autograd on whatever
    device the inputs lie on."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out, sw = reference_attention_fusion(*leaves, eps=eps)
        outs, grads = [out], [grad_out]
        if grad_sw is not None:
            outs.append(sw)
            grads.append(grad_sw)
        return torch.autograd.grad(outs, leaves, grads, allow_unused=True)


def reference_fusion_backward(inputs, eps, grad_out, grad_sw,
                              needs=(True,) * 6):
    """The closed form the backward kernels compute: gradients of
    `reference_attention_fusion` w.r.t. its six inputs for the cotangents
    (grad_out, grad_sw), None where `needs` is False. grad_sw may be
    None."""
    img, sig, clin, weights, scale, _ = inputs
    chunks = (img, sig, clin)
    sw = torch.softmax(weights, dim=0)
    f = torch.cat([sw[k] * chunks[k] for k in range(3)], dim=-1)
    mu = f.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(((f - mu) ** 2).mean(dim=-1, keepdim=True) + eps)
    xh = (f - mu) * rstd
    dxh = grad_out * scale
    df = rstd * (dxh - dxh.mean(dim=-1, keepdim=True)
                 - xh * (dxh * xh).mean(dim=-1, keepdim=True))
    df_k = df.split([c.shape[1] for c in chunks], dim=-1)
    dsw = torch.stack([(df_k[k] * chunks[k]).sum() for k in range(3)])
    if grad_sw is not None:
        dsw = dsw + grad_sw
    grads = (sw[0] * df_k[0], sw[1] * df_k[1], sw[2] * df_k[2],
             sw * (dsw - (sw * dsw).sum()), (grad_out * xh).sum(dim=0),
             grad_out.sum(dim=0))
    return tuple(g if need else None for g, need in zip(grads, needs))


class _FusedAttentionFusion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, sig, clin, weights, scale, bias, eps):
        inputs = _prepare(img, sig, clin, weights, scale, bias)
        ctx.save_for_backward(*inputs)
        ctx.eps = eps
        return _launch(*inputs, eps)

    @staticmethod
    def backward(ctx, grad_out, grad_sw):
        grads = launch_backward(ctx.saved_tensors, ctx.eps, grad_out,
                                grad_sw, ctx.needs_input_grad[:6])
        return (*grads, None)


def fused_attention_fusion(img, sig, clin, weights, scale, bias,
                           eps: float = 1e-6):
    """AttentionFusion: the CUDA kernels (forward and backward) for CUDA
    tensors, `reference_attention_fusion` for CPU tensors."""
    if img.device.type == "cpu":
        return reference_attention_fusion(img, sig, clin, weights, scale,
                                          bias, eps=eps)
    if img.device.type != "cuda":
        raise ValueError(
            f"fused_attention_fusion: unsupported device {img.device}"
        )
    return _FusedAttentionFusion.apply(img, sig, clin, weights, scale, bias,
                                       eps)
