"""Squeeze-and-Excitation gate (port of `ecgmm_tpu/ops/pallas_se.py`).

Layout is the port's (B, C, T); the weights are in torch Linear layout,
w1 (R, C), b1 (R,), w2 (C, R), b2 (C,), with R = C // 16 (at least 1).

`fused_se` launches the CUDA kernels (`csrc/se.cu`) for tensors on a CUDA
device, wrapped in a `torch.autograd.Function`: the forward is one
cluster kernel, which also keeps the f32 channel means and gate, and the
backward is a cluster kernel plus, where a weight needs a gradient, a
batch reduction. For tensors on the CPU it evaluates `reference_se`.
`launches` counts forward launches and `backward_launches` backward
calls through the kernels.

`reference_backward` (autograd of `reference_se`) and
`reference_se_backward` (the closed form the kernels compute) are the
plain versions of the backward.

Under `torch.func.vmap` (the CV fold program, `train/cv_parallel.py`)
the op takes a fold axis. With the weights shared by every fold (a
frozen encoder) the folds fold into the batch: one launch of the kernels
above. With per-fold weights, w1 (F, R, C) and so on, `_FoldSE` launches
the fold-axis kernels: all F folds in one launch, forward and backward,
the weight gradients summed per fold. `fold_launches` and
`fold_backward_launches` count those; `reference_fold_se` and
`reference_fold_se_backward` (loops over folds) are their plain
versions.
"""

from __future__ import annotations

import torch

from ecgmm_torch.ops import _ext

launches = 0
backward_launches = 0
fold_launches = 0
fold_backward_launches = 0

N_SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232448  # bytes of shared memory a block may opt into on sm_90
MAX_CLUSTER = 16  # blocks per cluster, with non-portable sizes allowed

_FORWARD = {
    torch.float32: "ecgmm_se_forward_f32",
    torch.bfloat16: "ecgmm_se_forward_bf16",
}
_BACKWARD = {
    torch.float32: "ecgmm_se_backward_f32",
    torch.bfloat16: "ecgmm_se_backward_bf16",
}
_FOLD_FORWARD = {
    torch.float32: "ecgmm_se_fold_forward_f32",
    torch.bfloat16: "ecgmm_se_fold_forward_bf16",
}
_FOLD_BACKWARD = {
    torch.float32: "ecgmm_se_fold_backward_f32",
    torch.bfloat16: "ecgmm_se_fold_backward_bf16",
}


def reference_se(x, w1, b1, w2, b2):
    """Plain PyTorch SE gate, computed in x's dtype like the JAX
    `reference_se`: x * sigmoid(relu(mean_T(x) w1^T + b1) w2^T + b2)."""
    y = x.mean(dim=-1)
    y = torch.relu(y @ w1.t() + b1)
    y = torch.sigmoid(y @ w2.t() + b2)
    return x * y[:, :, None]


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def smem_bytes(c: int, t: int, r: int, k: int, esize: int,
               backward: bool = False) -> int:
    """Dynamic shared memory of one block of the cluster kernel that
    splits C channels over k blocks (the layouts of `csrc/se.cu`): f32
    scratch of C + R + C/k values and one slab of (C/k)*T elements, both
    doubled in the backward (which holds x and the cotangent)."""
    n = 2 if backward else 1
    cpb = c // k
    return _align16(4 * n * (c + r + cpb)) + n * _align16(cpb * t * esize)


def cluster_size(b: int, c: int, t: int, r: int, esize: int,
                 backward: bool = False) -> int:
    """Blocks per sample K: the largest power of two up to 16 that divides
    C and keeps B*K within the card's SMs (1 once B >= 132), then doubled
    while one block's slab does not fit in shared memory. Raises
    ValueError for a shape that does not fit at any K."""
    k = 1
    while 2 * k <= MAX_CLUSTER and c % (2 * k) == 0 and b * 2 * k <= N_SMS:
        k *= 2
    while smem_bytes(c, t, r, k, esize, backward) > MAX_SMEM:
        if 2 * k > MAX_CLUSTER or c % (2 * k):
            raise ValueError(
                f"fused_se: a (C={c}, T={t}) sample of {esize}-byte elements "
                f"needs more than {MAX_SMEM} bytes of shared memory per block "
                f"at every cluster size up to {MAX_CLUSTER} that divides C"
            )
        k *= 2
    return k


def vector_loads(c: int, t: int, k: int, esize: int, *ptrs: int) -> bool:
    """Whether the kernel loads its slabs with 16-byte vectors: the slab
    ((C/k)*T elements) and every base pointer are multiples of 16 bytes,
    so every slab starts on a 16-byte boundary. Otherwise it loads element
    by element."""
    return (c // k) * t * esize % 16 == 0 and all(p % 16 == 0 for p in ptrs)


def _launch(x, w1, b1, w2, b2, folds=None):
    """The forward kernel: returns out and the saved state (2, B, C) f32,
    the channel means and the gate. With `folds` = F, x holds F folds of
    B/F samples and each weight has a leading fold axis (the fold entry
    point: one launch)."""
    if x.dim() != 3:
        raise ValueError(f"fused_se: x must be (B, C, T), got {tuple(x.shape)}")
    b, c, t = x.shape
    lead = () if folds is None else (folds,)
    r = w1.shape[-2]
    if x.dtype not in _FORWARD:
        raise TypeError(f"fused_se: unsupported dtype {x.dtype}")
    if folds is not None and (folds < 1 or b % folds):
        raise ValueError(f"fused_se: {b} samples do not split into {folds} "
                         "folds")
    for name, w, shape in (("w1", w1, lead + (r, c)), ("b1", b1, lead + (r,)),
                           ("w2", w2, lead + (c, r)),
                           ("b2", b2, lead + (c,))):
        if tuple(w.shape) != shape or w.dtype != x.dtype \
                or w.device != x.device:
            raise ValueError(
                f"fused_se: {name} must be {shape} {x.dtype} on {x.device}, "
                f"got {tuple(w.shape)} {w.dtype} on {w.device}"
            )
    if not x.is_contiguous():
        raise ValueError("fused_se: x must be contiguous")
    out = torch.empty_like(x)
    state = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out, state
    esize = x.element_size()
    k = cluster_size(b, c, t, r, esize)
    w1, b1, w2, b2 = (w.contiguous() for w in (w1, b1, w2, b2))
    lib = _ext.library()
    if folds is None:
        entry, bf, extra, counter = _FORWARD[x.dtype], b, (), "launches"
    else:
        entry, bf, extra = _FOLD_FORWARD[x.dtype], b // folds, (folds,)
        counter = "fold_launches"
    context, stream = _ext.launch_target(x.device)
    with context:
        status = getattr(lib, entry)(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), state[0].data_ptr(), state[1].data_ptr(),
            out.data_ptr(), bf, c, t, r, k,
            int(vector_loads(c, t, k, esize, x.data_ptr())), *extra, stream,
        )
    _ext.check(status, entry)
    _ext.count(__name__, counter)
    return out, state


def launch_backward(x, w1, b1, w2, state, grad, needs=(True,) * 5,
                    folds=None):
    """The backward kernels for the saved x, w1, b1, w2 and forward state
    and the cotangent `grad`: gradients w.r.t. (x, w1, b1, w2, b2), None
    where `needs` is False. With `folds` = F (the fold entry point) the
    weights and their gradients have a leading fold axis, each fold's
    summed over its own B/F samples."""
    b, c, t = x.shape
    r = w1.shape[-2]
    lead = () if folds is None else (folds,)
    grad, w1, b1, w2 = (a.contiguous() for a in (grad, w1, b1, w2))
    dx = torch.empty_like(x) if needs[0] else None
    dws = [torch.empty(lead + shape, dtype=x.dtype, device=x.device) if need
           else None
           for shape, need in zip(((r, c), (r,), (c, r), (c,)), needs[1:])]
    scratch = None
    if any(needs[1:]):
        scratch = torch.empty(b * (c + 2 * r), dtype=torch.float32,
                              device=x.device)
    if x.numel() == 0:
        return (dx.zero_() if dx is not None else None,
                *(d.zero_() if d is not None else None for d in dws))
    esize = x.element_size()
    k = cluster_size(b, c, t, r, esize, backward=True)

    def ptr(a):
        return None if a is None else a.data_ptr()

    lib = _ext.library()
    if folds is None:
        entry, bf, extra = _BACKWARD[x.dtype], b, ()
        counter = "backward_launches"
    else:
        entry, bf, extra = _FOLD_BACKWARD[x.dtype], b // folds, (folds,)
        counter = "fold_backward_launches"
    context, stream = _ext.launch_target(x.device)
    with context:
        status = getattr(lib, entry)(
            x.data_ptr(), grad.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), state[0].data_ptr(), state[1].data_ptr(), ptr(dx),
            *map(ptr, dws), ptr(scratch), bf, c, t, r, k,
            int(vector_loads(c, t, k, esize, x.data_ptr(), grad.data_ptr())),
            *extra, stream,
        )
    _ext.check(status, entry)
    _ext.count(__name__, counter)
    return (dx, *dws)


def reference_backward(inputs, grad):
    """Gradients of `reference_se` w.r.t. (x, w1, b1, w2, b2) for the
    cotangent `grad`, by autograd on whatever device the inputs lie on."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = reference_se(*leaves)
        return torch.autograd.grad(out, leaves, grad)


def reference_se_backward(inputs, grad):
    """The closed form the backward kernels compute, in f32 and cast back
    to each input's dtype: gradients of `reference_se` w.r.t. (x, w1, b1,
    w2, b2) for the cotangent `grad`."""
    x, w1, b1, w2, b2 = (a.float() for a in inputs)
    g = grad.float()
    m = x.mean(dim=-1)
    z1 = m @ w1.t() + b1
    h = torch.relu(z1)
    s = torch.sigmoid(h @ w2.t() + b2)
    dz2 = (g * x).sum(dim=-1) * s * (1.0 - s)
    dz1 = (dz2 @ w2) * (z1 > 0)
    dm = dz1 @ w1
    dx = g * s[:, :, None] + (dm / x.shape[-1])[:, :, None]
    grads = (dx, dz1.t() @ m, dz1.sum(0), dz2.t() @ h, dz2.sum(0))
    return tuple(d.to(a.dtype) for d, a in zip(grads, inputs))


def reference_fold_se(x, w1, b1, w2, b2):
    """The plain version of the fold-axis forward: x (F*B, C, T), the
    weights with a leading fold axis F; a loop over folds of
    `reference_se`."""
    f = w1.shape[0]
    xs = x.reshape(f, -1, *x.shape[1:])
    return torch.cat([reference_se(xs[i], w1[i], b1[i], w2[i], b2[i])
                      for i in range(f)])


def reference_fold_se_backward(inputs, grad):
    """The plain version of the fold-axis backward: gradients w.r.t. (x,
    w1, b1, w2, b2) of F folds, each weight's summed over its fold; a loop
    over folds of `reference_se_backward`."""
    x, w1, b1, w2, b2 = inputs
    f = w1.shape[0]
    xs, gs = x.reshape(f, -1, *x.shape[1:]), grad.reshape(f, -1,
                                                         *x.shape[1:])
    parts = [reference_se_backward((xs[i], w1[i], b1[i], w2[i], b2[i]),
                                   gs[i]) for i in range(f)]
    return (torch.cat([p[0] for p in parts]),
            *(torch.stack([p[j] for p in parts]) for j in range(1, 5)))


class _FusedSE(torch.autograd.Function):
    """The kernels on one (B, C, T) batch: (out, state), the saved
    (2, B, C) f32 means and gate not differentiable. Under `vmap` the fold
    axis: shared weights fold into the batch, per-fold ones take
    `_FoldSE`."""

    @staticmethod
    def forward(x, w1, b1, w2, b2):
        return _launch(x, w1, b1, w2, b2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w1, b1, w2, _ = inputs
        ctx.save_for_backward(x, w1, b1, w2, output[1])
        ctx.mark_non_differentiable(output[1])
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, grad, _):
        return launch_backward(*ctx.saved_tensors, grad,
                               ctx.needs_input_grad)

    @staticmethod
    def vmap(info, in_dims, x, w1, b1, w2, b2):
        n = info.batch_size
        x = _ext.batch_first(x, in_dims[0], n)
        shape = x.shape
        rows = x.reshape(-1, *shape[2:]).contiguous()
        if all(d is None for d in in_dims[1:]):
            out, state = _FusedSE.apply(rows, w1, b1, w2, b2)
        else:
            ws = [_ext.batch_first(w, d, n)
                  for w, d in zip((w1, b1, w2, b2), in_dims[1:])]
            out, state = _FoldSE.apply(rows, *ws)
        return ((out.view(shape), state.view(2, n, shape[1], shape[2])),
                (0, 1))


class _FoldSE(torch.autograd.Function):
    """The fold-axis kernels: x (F*B, C, T) of F folds and per-fold
    weights (F, ...) give (out, state) in one launch; the backward is one
    launch plus, where a weight needs a gradient, one per-fold reduction."""

    @staticmethod
    def forward(x, w1, b1, w2, b2):
        return _launch(x, w1, b1, w2, b2, folds=w1.shape[0])

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w1, b1, w2, _ = inputs
        ctx.save_for_backward(x, w1, b1, w2, output[1])
        ctx.mark_non_differentiable(output[1])
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, grad, _):
        x, w1, b1, w2, state = ctx.saved_tensors
        return launch_backward(x, w1, b1, w2, state, grad,
                               ctx.needs_input_grad, folds=w1.shape[0])


def reference_se_state(x, w1, b1, w2, b2):
    """The plain version of the forward's saved state: (2, B, C) f32, the
    channel means and the gate."""
    x, w1, b1, w2, b2 = (a.float() for a in (x, w1, b1, w2, b2))
    m = x.mean(dim=-1)
    s = torch.sigmoid(torch.relu(m @ w1.t() + b1) @ w2.t() + b2)
    return torch.stack([m, s])


# -- the torch.library operators (the traced serving program) -------------

@torch.library.custom_op("ecgmm::fused_se", mutates_args=(),
                         device_types="cpu")
def se_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
          w2: torch.Tensor, b2: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """`ecgmm::fused_se` -> (out, state): on the CPU the plain versions
    (`reference_se`, `reference_se_state`), on CUDA the forward kernel."""
    return (reference_se(x, w1, b1, w2, b2),
            reference_se_state(x, w1, b1, w2, b2))


@se_op.register_kernel("cuda")
def _se_op_cuda(x, w1, b1, w2, b2):
    return _launch(x.contiguous(), w1, b1, w2, b2)


@se_op.register_fake
def _se_op_fake(x, w1, b1, w2, b2):
    return (torch.empty_like(x),
            x.new_empty((2, x.shape[0], x.shape[1]), dtype=torch.float32))


@torch.library.custom_op("ecgmm::fused_se_backward", mutates_args=(),
                         device_types="cpu")
def se_backward_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, state: torch.Tensor,
                   grad: torch.Tensor, needs: list[bool]
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor, torch.Tensor]:
    """`ecgmm::fused_se_backward` -> gradients w.r.t. (x, w1, b1, w2, b2),
    a (0,) tensor where `needs` is False: on the CPU the closed form
    (`reference_se_backward`), on CUDA the backward kernels."""
    grads = reference_se_backward((x, w1, b1, w2, b2), grad)
    return tuple(g if n else _ext.unneeded_grad(x)
                 for g, n in zip(grads, needs))


@se_backward_op.register_kernel("cuda")
def _se_backward_op_cuda(x, w1, b1, w2, b2, state, grad, needs):
    grads = launch_backward(x.contiguous(), w1, b1, w2, state, grad,
                            tuple(needs))
    return tuple(_ext.unneeded_grad(x) if g is None else g for g in grads)


@se_backward_op.register_fake
def _se_backward_op_fake(x, w1, b1, w2, b2, state, grad, needs):
    return tuple(torch.empty_like(a) if n else _ext.unneeded_grad(x)
                 for a, n in zip((x, w1, b1, w2, b2), needs))


def _se_op_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs, output[1])


def _se_op_backward(ctx, grad, _):
    needs = list(ctx.needs_input_grad[:5])
    grads = se_backward_op(*ctx.saved_tensors, grad, needs)
    return tuple(g if n else None for g, n in zip(grads, needs))


se_op.register_autograd(_se_op_backward, setup_context=_se_op_setup)


def fused_se(x, w1, b1, w2, b2):
    """SE gate: the CUDA kernels (forward and backward) for CUDA tensors,
    `reference_se` for CPU tensors. The kernels reduce and run both dense
    layers in f32 (the weights read as f32 from x's dtype) and store in
    x's dtype. Under `torch.func.vmap` on CUDA tensors, one launch for all
    folds (`_FusedSE.vmap`). Inside `ecgmm_torch.ops.tracing_ops()` it
    calls the `ecgmm::fused_se` operator instead, on either device."""
    if _ext.tracing():
        return se_op(x, w1, b1, w2, b2)[0]
    if x.device.type == "cpu":
        return reference_se(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_se: unsupported device {x.device}")
    return _FusedSE.apply(x, w1, b1, w2, b2)[0]
