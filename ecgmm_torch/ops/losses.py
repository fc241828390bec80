"""Masked focal loss (port of `ecgmm_tpu/ops/pallas_losses.py`).

`fused_focal_loss(logits, labels, mask, alpha, gamma)` returns the 0-d
float32 `sum(alpha (1 - pt)^gamma ce mask) / max(sum(mask), 1)` with
`ce = logsumexp(logits) - logits[label]` and `pt = exp(-ce)`.

For tensors on a CUDA device the op runs the CUDA kernels
(`csrc/focal.cu`), wrapped in a `torch.autograd.Function`: the forward
takes both sums in one launch (one block, or a thread-block cluster where
B is large, `cluster_size`) and keeps them as a 2-float residual; the
backward is one launch that writes dlogits, and dmask only where the mask
needs a gradient. For tensors on the CPU the op is `reference_focal`.
`launches` counts forward launches and `backward_launches` backward
launches.

`reference_backward` (autograd of `reference_focal`, the JAX custom_vjp's
design) and `reference_focal_backward` (the closed form the backward
kernel computes) are the plain versions of the backward.

Under `torch.func.vmap` (the CV fold program, `train/cv_parallel.py`) the
op takes the fold axis: F folds of (B, C) logits give (F,) losses, one
launch of the forward kernel for all F (`_FoldFocalLoss`, the fold
entry points of `csrc/focal.cu`), and one of the backward from an (F,)
cotangent. `fold_launches` and `fold_backward_launches` count those;
`reference_fold_focal` (a loop over folds of `reference_focal`) is their
plain version.
"""

from __future__ import annotations

import torch

from ecgmm_torch.ops import _ext

launches = 0
backward_launches = 0
fold_launches = 0
fold_backward_launches = 0

MAX_CLUSTER = 16  # blocks per cluster, with non-portable sizes allowed
# logits elements up to which the forward runs on one block; above, on a
# cluster of MAX_CLUSTER blocks: the crossover measured on the card
# (chip_smoke.py's cluster sweep, PERF.md)
BLOCK_ELEMS = 2048
MAX_THREADS = 512

_FORWARD = {
    torch.int32: "ecgmm_focal_loss_forward_i32",
    torch.int64: "ecgmm_focal_loss_forward_i64",
}
_BACKWARD = {
    torch.int32: "ecgmm_focal_loss_backward_i32",
    torch.int64: "ecgmm_focal_loss_backward_i64",
}
_FOLD_FORWARD = {
    torch.int32: "ecgmm_focal_loss_fold_forward_i32",
    torch.int64: "ecgmm_focal_loss_fold_forward_i64",
}
_FOLD_BACKWARD = {
    torch.int32: "ecgmm_focal_loss_fold_backward_i32",
    torch.int64: "ecgmm_focal_loss_fold_backward_i64",
}


def _denominator(mask):
    """max(sum(mask), 1), whose VJP splits a tie as `jnp.maximum`'s does:
    at sum(mask) == 1 each side takes half the gradient."""
    s = mask.sum()
    return torch.maximum(s, s.new_ones(()))


def reference_focal(logits, labels, mask, alpha: float = 1.0,
                    gamma: float = 2.0):
    """The unfused expression (ground truth for the kernel), in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[:, None])[:, 0]
    ce = logz - ll
    pt = torch.exp(-ce)
    per = alpha * (1.0 - pt) ** gamma * ce
    return (per * mask).sum() / _denominator(mask)


def cluster_size(b: int, c: int) -> int:
    """Blocks K of the forward: 1 while the logits hold at most
    BLOCK_ELEMS elements, else MAX_CLUSTER (on the card, from 2048 rows
    of two classes up, 16 blocks were the fastest or within 0.13 µs of
    it)."""
    return 1 if b * c <= BLOCK_ELEMS else MAX_CLUSTER


def block_threads(b: int, k: int) -> int:
    """Threads per block: one per row of the block's share, rounded up to
    whole warps, at most MAX_THREADS (a thread then walks several
    rows)."""
    rows = -(-b // k)
    return max(32, min(MAX_THREADS, -(-rows // 32) * 32))


def backward_blocks(b: int) -> int:
    """Blocks of the backward, which needs no cluster (each row's
    gradients are its own): one row per thread in blocks of up to
    MAX_THREADS threads."""
    return max(1, -(-b // MAX_THREADS))


def vector_rows(c: int, ptr: int) -> bool:
    """Whether a row is one 8-byte load: two classes and 8-byte aligned
    logits (and dlogits, allocated fresh)."""
    return c == 2 and ptr % 8 == 0


def _check(logits, labels, mask):
    dev = logits.device
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise TypeError(
            "fused_focal_loss: logits must be (B, C) float32, got "
            f"{tuple(logits.shape)} {logits.dtype}"
        )
    b, c = logits.shape
    if c < 1:
        raise ValueError("fused_focal_loss: logits need at least one class")
    if labels.dtype not in _FORWARD or tuple(labels.shape) != (b,):
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


def _fold_rows(b: int, folds: int) -> int:
    if folds < 1 or b % folds:
        raise ValueError(f"fused_focal_loss: {b} rows do not split into "
                         f"{folds} folds")
    return b // folds


def _launch(logits, labels, mask, alpha, gamma, k=None, folds=None):
    """The forward kernel: returns the 0-d loss and the residual (2,) f32,
    sum(term) and sum(mask). `k` overrides `cluster_size` (for timing).
    With `folds` = F the rows are F folds of B each (the fold entry point,
    one launch): the loss is (F,) and the residual (F, 2)."""
    _check(logits, labels, mask)
    b, c = logits.shape
    dev = logits.device
    if folds is None:
        out = torch.empty((), dtype=torch.float32, device=dev)
        res = torch.empty((2,), dtype=torch.float32, device=dev)
        entry, extra, counter = _FORWARD[labels.dtype], (), "launches"
    else:
        b = _fold_rows(b, folds)
        out = torch.empty((folds,), dtype=torch.float32, device=dev)
        res = torch.empty((folds, 2), dtype=torch.float32, device=dev)
        entry, extra = _FOLD_FORWARD[labels.dtype], (folds,)
        counter = "fold_launches"
    k = cluster_size(b, c) if k is None else k
    lib = _ext.library()
    context, stream = _ext.launch_target(dev)
    with context:
        status = getattr(lib, entry)(
            logits.data_ptr(), labels.data_ptr(), mask.data_ptr(),
            out.data_ptr(), res.data_ptr(), b, c, k, block_threads(b, k),
            int(vector_rows(c, logits.data_ptr())), float(alpha),
            float(gamma), *extra, stream,
        )
    _ext.check(status, entry)
    _ext.count(__name__, counter)
    return out, res


def launch_backward(inputs, res, alpha, gamma, grad, needs=(True, True),
                    folds=None):
    """The backward kernel for the saved (logits, labels, mask), the
    forward's residual and the 0-d cotangent `grad`: (dlogits, dmask),
    None where `needs` is False. One launch, or none if nothing is
    needed. With `folds` = F: F folds of B rows, the (F, 2) residual and
    an (F,) cotangent (the fold entry point, one launch)."""
    logits, labels, mask = inputs
    b, c = logits.shape
    dlogits = torch.empty_like(logits) if needs[0] else None
    dmask = torch.empty_like(mask) if needs[1] else None
    if not any(needs) or b == 0:
        return dlogits, dmask
    grad = grad.to(torch.float32).contiguous()
    if folds is None:
        entry, extra = _BACKWARD[labels.dtype], ()
        counter = "backward_launches"
    else:
        b = _fold_rows(b, folds)
        entry, extra = _FOLD_BACKWARD[labels.dtype], (folds,)
        counter = "fold_backward_launches"
    k = backward_blocks(b)
    lib = _ext.library()
    context, stream = _ext.launch_target(logits.device)
    with context:
        status = getattr(lib, entry)(
            logits.data_ptr(), labels.data_ptr(), mask.data_ptr(),
            res.data_ptr(), grad.data_ptr(),
            None if dlogits is None else dlogits.data_ptr(),
            None if dmask is None else dmask.data_ptr(), b, c, k,
            block_threads(b, k), int(vector_rows(c, logits.data_ptr())),
            float(alpha), float(gamma), *extra, stream,
        )
    _ext.check(status, entry)
    _ext.count(__name__, counter)
    return dlogits, dmask


def reference_backward(inputs, alpha, gamma, grad):
    """Gradients of `reference_focal` w.r.t. the logits and the mask for
    the cotangent `grad`, by autograd on whatever device the inputs lie
    on."""
    logits, labels, mask = inputs
    with torch.enable_grad():
        lg = logits.detach().requires_grad_(True)
        mk = mask.detach().requires_grad_(True)
        out = reference_focal(lg, labels, mk, alpha, gamma)
        return torch.autograd.grad(out, (lg, mk), grad)


def reference_focal_backward(inputs, alpha, gamma, grad, needs=(True, True)):
    """The closed form the backward kernel computes: (dlogits, dmask) of
    `reference_focal` for the cotangent `grad`, None where `needs` is
    False. Per row, with p = softmax(logits), u = 1 - pt and
    t = alpha u^gamma ce:
      dt/dce  = alpha (u^gamma + gamma u^(gamma-1) pt ce)
      dlogits = g mask / den * dt/dce * (p - onehot(label))
      dmask   = g (t - L h) / den
    with den = max(sum(mask), 1), L the loss and h the derivative of the
    max: 1 above 1, 0.5 at 1, 0 below. gamma = 0 drops the second term of
    dt/dce, as torch's pow backward does, so that it never forms 0 * inf."""
    logits, labels, mask = inputs
    logits = logits.float()
    g = grad.float()
    lab = labels.long()[:, None]
    p = torch.softmax(logits, dim=-1)
    ce = torch.logsumexp(logits, dim=-1) - logits.gather(-1, lab)[:, 0]
    pt = torch.exp(-ce)
    u = 1.0 - pt
    t = alpha * u ** gamma * ce
    dtdce = u ** gamma
    if gamma != 0:
        dtdce = dtdce + gamma * u ** (gamma - 1) * pt * ce
    dtdce = alpha * dtdce
    s = mask.sum()
    den = _denominator(mask)
    dlogits = dmask = None
    if needs[0]:
        onehot = torch.zeros_like(logits).scatter_(-1, lab, 1.0)
        dlogits = (g * mask / den * dtdce)[:, None] * (p - onehot)
    if needs[1]:
        h = torch.where(s > 1, 1.0, torch.where(s == 1, 0.5, 0.0))
        loss = (t * mask).sum() / den
        dmask = g * (t - loss * h) / den
    return dlogits, dmask


def reference_fold_focal(logits, labels, mask, alpha: float = 1.0,
                         gamma: float = 2.0):
    """The plain version of the fold-axis forward: (F*B, C) logits of F
    folds, labels and mask (F*B,), F the mask's leading size when it is
    given as (F, B); returns the (F,) losses, a loop over folds of
    `reference_focal`."""
    f = mask.shape[0]
    rows = logits.reshape(f, -1, logits.shape[-1])
    lab = labels.reshape(f, -1)
    m = mask.reshape(f, -1)
    return torch.stack([reference_focal(rows[i], lab[i], m[i], alpha, gamma)
                        for i in range(f)])


def reference_fold_focal_backward(inputs, alpha, gamma, grad,
                                  needs=(True, True)):
    """The plain version of the fold-axis backward: (dlogits, dmask) of F
    folds for the (F,) cotangent `grad`, a loop over folds of
    `reference_focal_backward`."""
    logits, labels, mask = inputs
    f = grad.shape[0]
    rows = logits.reshape(f, -1, logits.shape[-1])
    lab, m = labels.reshape(f, -1), mask.reshape(f, -1)
    parts = [reference_focal_backward((rows[i], lab[i], m[i]), alpha, gamma,
                                      grad[i], needs) for i in range(f)]
    return tuple(None if not need else torch.cat([p[j] for p in parts])
                 for j, need in enumerate(needs))


class _FusedFocalLoss(torch.autograd.Function):
    """The kernels on one (B, C) batch: (loss, residual), the residual
    not differentiable. Under `vmap` the fold axis (`_FoldFocalLoss`)."""

    @staticmethod
    def forward(logits, labels, mask, alpha, gamma):
        return _launch(logits, labels, mask, alpha, gamma)

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, labels, mask, alpha, gamma = inputs
        ctx.save_for_backward(logits, labels, mask, output[1])
        ctx.mark_non_differentiable(output[1])
        # the residual's cotangent stays None: no kernel fills zeros for it
        ctx.set_materialize_grads(False)
        ctx.alpha, ctx.gamma = alpha, gamma

    @staticmethod
    def backward(ctx, grad, _):
        logits, labels, mask, res = ctx.saved_tensors
        needs = ctx.needs_input_grad
        dlogits, dmask = launch_backward(
            (logits, labels, mask), res, ctx.alpha, ctx.gamma, grad,
            (needs[0], needs[2]))
        return dlogits, None, dmask, None, None

    @staticmethod
    def vmap(info, in_dims, logits, labels, mask, alpha, gamma):
        n = info.batch_size
        lg, lb, mk = (_ext.batch_first(t, d, n) for t, d in
                      zip((logits, labels, mask), in_dims[:3]))
        out, res = _FoldFocalLoss.apply(
            lg.reshape(-1, lg.shape[-1]).contiguous(),
            lb.reshape(-1).contiguous(), mk.reshape(-1).contiguous(),
            n, alpha, gamma)
        return (out, res), (0, 0)


class _FoldFocalLoss(torch.autograd.Function):
    """The fold-axis kernels: (F*B, C) logits of F folds, their labels
    and mask, give the (F,) losses and the (F, 2) residual in one launch,
    and the backward for an (F,) cotangent in one more."""

    @staticmethod
    def forward(logits, labels, mask, folds, alpha, gamma):
        return _launch(logits, labels, mask, alpha, gamma, folds=folds)

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, labels, mask, folds, alpha, gamma = inputs
        ctx.save_for_backward(logits, labels, mask, output[1])
        ctx.mark_non_differentiable(output[1])
        ctx.set_materialize_grads(False)
        ctx.folds, ctx.alpha, ctx.gamma = folds, alpha, gamma

    @staticmethod
    def backward(ctx, grad, _):
        logits, labels, mask, res = ctx.saved_tensors
        needs = ctx.needs_input_grad
        dlogits, dmask = launch_backward(
            (logits, labels, mask), res, ctx.alpha, ctx.gamma, grad,
            (needs[0], needs[2]), folds=ctx.folds)
        return dlogits, None, dmask, None, None, None


def fused_focal_loss(logits, labels, mask, alpha: float = 1.0,
                     gamma: float = 2.0):
    """Focal loss: the CUDA kernels (forward and backward) for CUDA
    tensors, `reference_focal` for CPU tensors. Under `torch.func.vmap`
    on CUDA tensors, one launch of the fold-axis kernel for all folds."""
    if logits.device.type == "cpu":
        return reference_focal(logits, labels, mask, alpha, gamma)
    if logits.device.type != "cuda":
        raise ValueError(f"fused_focal_loss: unsupported device "
                         f"{logits.device}")
    return _FusedFocalLoss.apply(logits, labels, mask, float(alpha),
                                 float(gamma))[0]
