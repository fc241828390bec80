"""Masked focal loss (port of `ecgmm_tpu/ops/pallas_losses.py`).

`fused_focal_loss(logits, labels, mask, alpha, gamma)` returns the 0-d
float32 `sum(alpha (1 - pt)^gamma ce mask) / max(sum(mask), 1)` with
`ce = logsumexp(logits) - logits[label]` and `pt = exp(-ce)`.

For tensors on a CUDA device the forward is the CUDA kernel
(`csrc/focal.cu`, both sums in one launch), wrapped in a
`torch.autograd.Function` whose backward differentiates `reference_focal`
with respect to the logits and the mask, as the JAX `custom_vjp` does.
For tensors on the CPU the op is `reference_focal`. `launches` counts
kernel launches.
"""

from __future__ import annotations

import torch

from ecgmm_torch.ops import _ext

launches = 0

_ENTRY = {
    torch.int32: "ecgmm_focal_loss_forward_i32",
    torch.int64: "ecgmm_focal_loss_forward_i64",
}


def reference_focal(logits, labels, mask, alpha: float = 1.0,
                    gamma: float = 2.0):
    """The unfused expression (ground truth for the kernel), in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[:, None])[:, 0]
    ce = logz - ll
    pt = torch.exp(-ce)
    per = alpha * (1.0 - pt) ** gamma * ce
    return (per * mask).sum() / mask.sum().clamp_min(1.0)


def _launch(logits, labels, mask, alpha, gamma):
    dev = logits.device
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise TypeError(
            "fused_focal_loss: logits must be (B, C) float32, got "
            f"{tuple(logits.shape)} {logits.dtype}"
        )
    b, c = logits.shape
    if c < 1:
        raise ValueError("fused_focal_loss: logits need at least one class")
    if labels.dtype not in _ENTRY or tuple(labels.shape) != (b,):
        raise TypeError(
            f"fused_focal_loss: labels must be ({b},) int32 or int64, got "
            f"{tuple(labels.shape)} {labels.dtype}"
        )
    if mask.dtype != torch.float32 or tuple(mask.shape) != (b,):
        raise TypeError(
            f"fused_focal_loss: mask must be ({b},) float32, got "
            f"{tuple(mask.shape)} {mask.dtype}"
        )
    for name, t in (("logits", logits), ("labels", labels), ("mask", mask)):
        if t.device != dev:
            raise ValueError(
                f"fused_focal_loss: {name} is on {t.device}, logits on {dev}"
            )
        if not t.is_contiguous():
            raise ValueError(f"fused_focal_loss: {name} must be contiguous")
    out = torch.empty((), dtype=torch.float32, device=dev)
    entry = _ENTRY[labels.dtype]
    lib = _ext.library()
    context, stream = _ext.launch_target(dev)
    with context:
        status = getattr(lib, entry)(
            logits.data_ptr(), labels.data_ptr(), mask.data_ptr(),
            out.data_ptr(), b, c, float(alpha), float(gamma), stream,
        )
    _ext.check(status, entry)
    global launches
    launches += 1
    return out


def reference_backward(inputs, alpha, gamma, grad):
    """Gradients of `reference_focal` w.r.t. the logits and the mask for
    the cotangent `grad` — the backward of the fused op, evaluated on
    whatever device the inputs lie on."""
    logits, labels, mask = inputs
    with torch.enable_grad():
        lg = logits.detach().requires_grad_(True)
        mk = mask.detach().requires_grad_(True)
        out = reference_focal(lg, labels, mk, alpha, gamma)
        return torch.autograd.grad(out, (lg, mk), grad)


class _FusedFocalLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, mask, alpha, gamma):
        ctx.save_for_backward(logits, labels, mask)
        ctx.alpha, ctx.gamma = alpha, gamma
        return _launch(logits, labels, mask, alpha, gamma)

    @staticmethod
    def backward(ctx, grad):
        dlogits, dmask = reference_backward(ctx.saved_tensors, ctx.alpha,
                                            ctx.gamma, grad)
        return dlogits, None, dmask, None, None


def fused_focal_loss(logits, labels, mask, alpha: float = 1.0,
                     gamma: float = 2.0):
    """Focal loss: the CUDA kernel (with the reference backward) for CUDA
    tensors, `reference_focal` for CPU tensors."""
    if logits.device.type == "cpu":
        return reference_focal(logits, labels, mask, alpha, gamma)
    if logits.device.type != "cuda":
        raise ValueError(f"fused_focal_loss: unsupported device "
                         f"{logits.device}")
    return _FusedFocalLoss.apply(logits, labels, mask, float(alpha),
                                 float(gamma))
