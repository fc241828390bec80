"""Multi-head self-attention with flax's broadcast dropout through the
kernels of `csrc/attention.cu` (no TPU kernel: the JAX package leaves
flax's attention to XLA's products).

`fused_self_attention(q, k, v, heads, keep, p)` takes the three
projections (B, T, D) float32 on a CUDA device (D = heads x 32) and the
keep mask (1, 1, T, T) or None, and returns (B, T, D):

    out = (softmax(q / sqrt(32) k^T) o keep / (1 - p)) v

per head, the heads side by side, as `layers.MultiHeadSelfAttention`
computes it before its output projection. The mask is drawn by the
caller exactly as the unfused path draws it (`BroadcastDropout.draw_keep`,
so the dropout generator's stream is the same either way), packed into
bits by a kernel (`pack_keep`, (T, ceil(T / 32)) words) and read as bits.

The forward is the unfused one to the bit (`exact_forward`): cuBLAS's
q k^T; one kernel that gives torch's softmax of the scores to the bit,
dropped, and each row's log-sum-exp (`softmax_drop`, in place, for T in
`SOFTMAX_T` and a multiple of 4); cuBLAS's product with v. Where autograd
runs the backward it keeps only q, k, v, the output, the log-sum-exp and
the bits, and the backward is the fused kernel pair, which recomputes
the scores from the log-sum-exp and writes no (B, H, T, T) tensor. The
forward keeps the unfused path's bits because the training steps are
held to a reference that computes it so: a forward that rounds otherwise
moves ReLU inputs within rounding of zero across it downstream, and the
first gradient then differs by more than the float32 rounding of the
same forward would.

`reference_self_attention` is the plain version (the unfused
expression); `reference_backward` is a plain model of what the backward
kernels compute (the keep bits, the scores recomputed from the saved
log-sum-exp, D = rowsum(dO o out) for dq and D' for dk);
`reference_softmax_drop`, `reference_pack_keep` and `unpack_keep` the
plain versions of the rest.

`unfused_reason` decides, from the input and the module alone, which
calls take these kernels: CUDA, float32 without autocast, head size 32,
T in `SOFTMAX_T` and a multiple of 4, no mask handed in (`Dropout.keep`,
the CV fold program), not under a functorch transform (`vmap`) and not
while `_ext.tracing()` routes to the `torch.library` operators.
Counters: `launches` (forwards through the kernels), `backward_launches`
(fused backwards) and `fallbacks` (calls of `MultiHeadSelfAttention` on
a CUDA device that took the unfused path).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ecgmm_torch.ops import _ext

launches = 0
backward_launches = 0
fallbacks = 0

HEAD_DIM = 32  # the head size the kernels are built for
BLOCK_KEYS = 64  # keys of a tile in the kernels and in the plain models
# the lengths at which torch's softmax (and so `softmax_drop`, for T a
# multiple of 4) gives a row one block of 1024 threads (torch 2.11's
# `cunn_SoftMaxForwardReg`)
SOFTMAX_T = (2049, 9216)
LOG2E = 1.4426950408889634


def takes_length(t: int) -> bool:
    """Whether `softmax_drop`, and so the kernels, take sequences of t."""
    return SOFTMAX_T[0] <= t <= SOFTMAX_T[1] and t % 4 == 0


def unfused_reason(x: torch.Tensor, attn) -> Optional[str]:
    """Why `attn` (a `layers.MultiHeadSelfAttention`) takes the unfused
    path on input x (B, T, D), or None where it takes the kernels."""
    params = (attn.in_proj_weight, attn.in_proj_bias)
    if _ext.tracing():
        return "tracing"
    if any(torch._C._functorch.is_functorch_wrapped_tensor(t)
           for t in (x,) + params):
        return "functorch"
    if attn.dropout.keep is not None:
        return "keep"
    if any(t.dtype != torch.float32 for t in (x,) + params) \
            or torch.is_autocast_enabled("cuda"):
        return "dtype"
    if x.dim() != 3 or x.shape[-1] != HEAD_DIM * attn.nhead:
        return "head_dim"
    if not takes_length(x.shape[1]):
        return "length"
    if x.device.type != "cuda":
        return "device"
    return None


def drop_scale(p: float) -> float:
    """1 / (1 - p) in float32, as `keep / (1.0 - p)` computes it."""
    return float(np.float32(1.0) / np.float32(1.0 - p))


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, H hd) -> (B, H, T, hd)."""
    b, t, d = x.shape
    return x.view(b, t, heads, d // heads).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, hd) -> (B, T, H hd)."""
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def reference_self_attention(q, k, v, heads: int,
                             keep: Optional[torch.Tensor], p: float):
    """The unfused expression of `MultiHeadSelfAttention` between its
    projections: (B, T, D)."""
    qh, kh, vh = (_heads(x, heads) for x in (q, k, v))
    scores = torch.matmul(qh / math.sqrt(qh.shape[-1]), kh.transpose(-1, -2))
    attn = torch.softmax(scores, dim=-1)
    if keep is not None:
        attn = attn * (keep / (1.0 - p))
    return _merge(torch.matmul(attn, vh))


def reference_pack_keep(keep: torch.Tensor) -> torch.Tensor:
    """A (T, T) (or (1, 1, T, T)) mask of 0 and 1 as (T, ceil(T / 32))
    int32 words: bit j of word w is key 32 w + j."""
    t = keep.shape[-1]
    w = -(-t // 32)
    kept = torch.zeros((t, w * 32), dtype=torch.int64, device=keep.device)
    kept[:, :t] = (keep.reshape(t, t) != 0).to(torch.int64)
    shifts = torch.arange(32, device=keep.device, dtype=torch.int64)
    words = (kept.view(t, w, 32) << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_keep(bits: torch.Tensor, t: int) -> torch.Tensor:
    """The (T, T) float32 mask of 0 and 1 of `pack_keep`'s words."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int32)
    kept = (bits[..., None] >> shifts) & 1
    return kept.reshape(bits.shape[0], -1)[:, :t].to(torch.float32)


def reference_softmax_drop(scores: torch.Tensor,
                           bits: Optional[torch.Tensor], c: float):
    """The plain version of `softmax_drop`: scores (B, H, T, T) replaced in
    place by torch's softmax of them, times c where the key is kept and 0
    where not (the softmax alone without bits); each row's log-sum-exp in
    base 2 (B, H, T)."""
    lse = torch.logsumexp(scores, -1) * LOG2E
    attn = torch.softmax(scores, dim=-1)
    if bits is not None:
        attn = attn * (unpack_keep(bits, scores.shape[-1]) * c)
    scores.copy_(attn)
    return lse


def reference_backward(q, k, v, heads: int, bits: Optional[torch.Tensor],
                       c: float, out: torch.Tensor, lse: torch.Tensor,
                       dout: torch.Tensor, block: int = BLOCK_KEYS):
    """The backward as the kernels compute it, key tile by key tile, with
    S = q k^T / sqrt(hd), P = exp2(S log2(e) - lse), dPd' = dO v^T o keep c:
    dq = dS k / sqrt(hd) with dS = P o (dPd' - D), D = rowsum(dO o out);
    dv = (P o keep c)^T dO and dk = dS'^T q / sqrt(hd) with
    dS' = P o (dPd' - D'), D' = rowsum(P o dPd') / rowsum(P) summed in
    float64, whose rows sum to zero but for rounding. Returns (dq, dk, dv),
    (B, T, D) each."""
    qh, kh, vh = (_heads(x, heads) for x in (q, k, v))
    t, hd = qh.shape[2:]
    scale = 1.0 / math.sqrt(hd)
    g = _heads(dout, heads)
    dsum = (g * _heads(out, heads)).sum(-1)
    keep = None if bits is None else unpack_keep(bits, t)

    def tile(j0):
        kj, vj = kh[:, :, j0:j0 + block], vh[:, :, j0:j0 + block]
        p = torch.exp2(torch.matmul(qh, kj.transpose(-1, -2)) * scale * LOG2E
                       - lse[..., None])
        dpd = torch.matmul(g, vj.transpose(-1, -2)) * c
        pd = p * c
        if keep is not None:
            pd, dpd = pd * keep[:, j0:j0 + block], dpd * keep[:, j0:j0 + block]
        return kj, p, pd, dpd

    dq = torch.zeros_like(qh)
    pg = psum = 0.0  # in float64, as the kernel sums them
    for j0 in range(0, t, block):
        kj, p, _, dpd = tile(j0)
        dq = dq + torch.matmul(p * (dpd - dsum[..., None]), kj)
        pg = pg + (p.double() * dpd).sum(-1)
        psum = psum + p.double().sum(-1)
    dsum2 = (pg / psum).to(qh.dtype)
    dk, dv = [], []
    for j0 in range(0, t, block):
        _, p, pd, dpd = tile(j0)
        dv.append(torch.matmul(pd.transpose(-1, -2), g))
        dk.append(torch.matmul((p * (dpd - dsum2[..., None])).transpose(
            -1, -2), qh * scale))
    return (_merge(dq * scale), _merge(torch.cat(dk, 2)),
            _merge(torch.cat(dv, 2)))


def pack_keep(keep: torch.Tensor) -> torch.Tensor:
    """`reference_pack_keep` by the packing kernel for a CUDA mask (a
    float32 (1, 1, T, T) or (T, T) of 0 and 1), by itself on the CPU."""
    if keep.device.type != "cuda":
        return reference_pack_keep(keep)
    t = keep.shape[-1]
    if keep.dtype != torch.float32 or keep.numel() != t * t:
        raise ValueError(f"pack_keep: a float32 (T, T) mask, got "
                         f"{keep.dtype} {tuple(keep.shape)}")
    keep = keep.contiguous()
    bits = torch.empty((t, -(-t // 32)), dtype=torch.int32,
                       device=keep.device)
    if t == 0:
        return bits
    context, stream = _ext.launch_target(keep.device)
    with context:
        status = _ext.library().ecgmm_attention_pack_keep(
            keep.data_ptr(), bits.data_ptr(), t, stream)
    _ext.check(status, "ecgmm_attention_pack_keep")
    return bits


def _check(q, k, v, heads: int, bits: Optional[torch.Tensor]):
    """(B, T, H) of the kernels' inputs, checked: q, k, v contiguous,
    16-byte aligned float32 (B, T, 32 H) on one CUDA device; the bits
    contiguous int32 (T, ceil(T / 32)) there."""
    shape = q.shape
    for x in (q, k, v):
        if x.dim() != 3 or x.shape != shape or x.dtype != torch.float32 \
                or x.device != q.device or x.device.type != "cuda" \
                or not x.is_contiguous() or x.data_ptr() % 16 \
                or shape[-1] != HEAD_DIM * heads:
            raise ValueError(
                "fused_self_attention: q, k and v must be contiguous, "
                f"16-byte aligned float32 (B, T, {HEAD_DIM * heads}) on one "
                f"CUDA device, got {x.dtype} {tuple(x.shape)} on {x.device}")
    b, t, _ = shape
    if b * heads > 65535:
        raise ValueError(f"fused_self_attention: B x H = {b * heads} "
                         "exceeds the grid's 65535")
    if bits is not None and (bits.dtype != torch.int32
                             or bits.device != q.device
                             or not bits.is_contiguous()
                             or bits.shape != (t, -(-t // 32))):
        raise ValueError("fused_self_attention: the mask bits must be "
                         f"contiguous int32 ({t}, {-(-t // 32)}) on "
                         f"{q.device}")
    return b, t, heads


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_backward(q, k, v, heads, bits, c, out, lse, dout):
    """The two backward kernels: (dq, dk, dv)."""
    b, t, h = _check(q, k, v, heads, bits)
    dout = dout.contiguous()
    if dout.data_ptr() % 16:  # the kernels read rows as float4
        dout = dout.clone()
    grads = tuple(torch.empty_like(q) for _ in range(3))
    if b * t:
        dsum = torch.empty_like(lse)
        context, stream = _ext.launch_target(q.device)
        with context:
            status = _ext.library().ecgmm_attention_backward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bits),
                out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                dsum.data_ptr(), *(g.data_ptr() for g in grads), b, t, h,
                h * HEAD_DIM, 1.0 / math.sqrt(HEAD_DIM), c, stream)
        _ext.check(status, "ecgmm_attention_backward")
    _ext.count(__name__, "backward_launches")
    return grads


def _launch_softmax_drop(scores, bits, c):
    """`softmax_drop` in place on the exact forward's scores (B, H, T, T),
    contiguous, T in `SOFTMAX_T` and a multiple of 4: the log-sum-exp
    (B, H, T)."""
    b, h, t, _ = scores.shape
    if not takes_length(t):
        raise ValueError(f"softmax_drop: T = {t} is not a multiple of 4 "
                         f"in {SOFTMAX_T}")
    lse = scores.new_empty((b, h, t))
    if scores.numel():
        context, stream = _ext.launch_target(scores.device)
        with context:
            status = _ext.library().ecgmm_attention_softmax_drop(
                scores.data_ptr(), _ptr(bits), lse.data_ptr(), b * h * t, t,
                c, stream)
        _ext.check(status, "ecgmm_attention_softmax_drop")
    return lse


def exact_forward(q, k, v, heads: int, bits: Optional[torch.Tensor],
                  c: float):
    """The unfused forward, product for product: cuBLAS's q k^T,
    `softmax_drop` (torch's softmax, the dropout and the rows' log-sum-exp
    in one pass), cuBLAS's product with v: (out (B, T, D), lse
    (B, H, T))."""
    qh, kh, vh = (_heads(x, heads) for x in (q, k, v))
    scores = torch.matmul(qh / math.sqrt(qh.shape[-1]),
                          kh.transpose(-1, -2)).contiguous()
    lse = _launch_softmax_drop(scores, bits, c)
    _ext.count(__name__, "launches")
    return _merge(torch.matmul(scores, vh)), lse


class _FusedSelfAttention(torch.autograd.Function):
    """`exact_forward` and the fused backward: (out, lse), lse not
    differentiable; the backward takes q, k, v, the bits, out and lse and
    returns (dq, dk, dv)."""

    @staticmethod
    def forward(q, k, v, bits, heads, c):
        return exact_forward(q, k, v, heads, bits, c)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, bits, heads, c = inputs
        ctx.heads, ctx.c = heads, c
        ctx.save_for_backward(q, k, v, bits, *output)
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, grad_out, _):
        q, k, v, bits, out, lse = ctx.saved_tensors
        return (*_launch_backward(q, k, v, ctx.heads, bits, ctx.c, out, lse,
                                  grad_out), None, None, None)


def fused_self_attention(q, k, v, heads: int, keep: Optional[torch.Tensor],
                         p: float):
    """softmax(q k^T / sqrt(32)) o keep / (1 - p), times v, per head:
    (B, T, D) from the projections q, k, v (B, T, D); keep (1, 1, T, T) or
    None (eval, or p = 0). `exact_forward`, and with autograd the fused
    backward."""
    bits = None if keep is None else pack_keep(keep)
    c = 1.0 if keep is None else drop_scale(p)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FusedSelfAttention.apply(q, k, v, bits, heads, c)[0]
    return exact_forward(q, k, v, heads, bits, c)[0]
