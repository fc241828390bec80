"""Squeeze-and-Excitation gate (port of `ecgmm_tpu/ops/pallas_se.py`).

Layout is the port's (B, C, T); the weights are in torch Linear layout,
w1 (R, C), b1 (R,), w2 (C, R), b2 (C,), with R = C // 16 (at least 1).

`fused_se` launches the CUDA kernel (`csrc/se.cu`) for tensors on a CUDA
device and evaluates `reference_se` for tensors on the CPU. On CUDA it is
forward-only and raises under autograd: the serving path never
differentiates through it.
`launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from ecgmm_torch.ops import _ext

launches = 0

_ENTRY = {
    torch.float32: "ecgmm_se_forward_f32",
    torch.bfloat16: "ecgmm_se_forward_bf16",
}


def reference_se(x, w1, b1, w2, b2):
    """Plain PyTorch SE gate, computed in x's dtype like the JAX
    `reference_se`: x * sigmoid(relu(mean_T(x) w1^T + b1) w2^T + b2)."""
    y = x.mean(dim=-1)
    y = torch.relu(y @ w1.t() + b1)
    y = torch.sigmoid(y @ w2.t() + b2)
    return x * y[:, :, None]


def fused_se(x, w1, b1, w2, b2):
    """SE gate: the CUDA kernel for CUDA tensors, `reference_se` for CPU
    tensors. The kernel reduces and runs both dense layers in f32 (the
    weights read as f32 from x's dtype) and stores in x's dtype."""
    if x.device.type == "cpu":
        return reference_se(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_se: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise NotImplementedError(
            "fused_se has no backward yet: the SE backward belongs to the "
            "signal slice (ROADMAP.md section 1)"
        )
    if x.dim() != 3:
        raise ValueError(f"fused_se: x must be (B, C, T), got {tuple(x.shape)}")
    b, c, t = x.shape
    r = w1.shape[0]
    if x.dtype not in _ENTRY:
        raise TypeError(f"fused_se: unsupported dtype {x.dtype}")
    for name, w, shape in (("w1", w1, (r, c)), ("b1", b1, (r,)),
                           ("w2", w2, (c, r)), ("b2", b2, (c,))):
        if tuple(w.shape) != shape or w.dtype != x.dtype \
                or w.device != x.device:
            raise ValueError(
                f"fused_se: {name} must be {shape} {x.dtype} on {x.device}, "
                f"got {tuple(w.shape)} {w.dtype} on {w.device}"
            )
    if not x.is_contiguous():
        raise ValueError("fused_se: x must be contiguous")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    gate = torch.empty((b, c), dtype=torch.float32, device=x.device)
    w1, b1, w2, b2 = (w.contiguous() for w in (w1, b1, w2, b2))
    lib = _ext.library()
    entry = _ENTRY[x.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = getattr(lib, entry)(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), gate.data_ptr(), out.data_ptr(), b, c, t, r,
            stream,
        )
    _ext.check(status, entry)
    global launches
    launches += 1
    return out
