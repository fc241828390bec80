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
"""

from __future__ import annotations

import torch

from ecgmm_torch.ops import _ext

launches = 0
backward_launches = 0

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


def _launch(x, w1, b1, w2, b2):
    """The forward kernel: returns out and the saved state (2, B, C) f32,
    the channel means and the gate."""
    if x.dim() != 3:
        raise ValueError(f"fused_se: x must be (B, C, T), got {tuple(x.shape)}")
    b, c, t = x.shape
    r = w1.shape[0]
    if x.dtype not in _FORWARD:
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
    state = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out, state
    esize = x.element_size()
    k = cluster_size(b, c, t, r, esize)
    w1, b1, w2, b2 = (w.contiguous() for w in (w1, b1, w2, b2))
    lib = _ext.library()
    entry = _FORWARD[x.dtype]
    context, stream = _ext.launch_target(x.device)
    with context:
        status = getattr(lib, entry)(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), state[0].data_ptr(), state[1].data_ptr(),
            out.data_ptr(), b, c, t, r, k,
            int(vector_loads(c, t, k, esize, x.data_ptr())), stream,
        )
    _ext.check(status, entry)
    global launches
    launches += 1
    return out, state


def launch_backward(x, w1, b1, w2, state, grad, needs=(True,) * 5):
    """The backward kernels for the saved x, w1, b1, w2 and forward state
    and the cotangent `grad`: gradients w.r.t. (x, w1, b1, w2, b2), None
    where `needs` is False."""
    b, c, t = x.shape
    r = w1.shape[0]
    grad, w1, b1, w2 = (a.contiguous() for a in (grad, w1, b1, w2))
    dx = torch.empty_like(x) if needs[0] else None
    dws = [torch.empty(shape, dtype=x.dtype, device=x.device) if need
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
    entry = _BACKWARD[x.dtype]
    context, stream = _ext.launch_target(x.device)
    with context:
        status = getattr(lib, entry)(
            x.data_ptr(), grad.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), state[0].data_ptr(), state[1].data_ptr(), ptr(dx),
            *map(ptr, dws), ptr(scratch), b, c, t, r, k,
            int(vector_loads(c, t, k, esize, x.data_ptr(), grad.data_ptr())),
            stream,
        )
    _ext.check(status, entry)
    global backward_launches
    backward_launches += 1
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


class _FusedSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        out, state = _launch(x, w1, b1, w2, b2)
        ctx.save_for_backward(x, w1, b1, w2, state)
        return out

    @staticmethod
    def backward(ctx, grad):
        return launch_backward(*ctx.saved_tensors, grad,
                               ctx.needs_input_grad)


def fused_se(x, w1, b1, w2, b2):
    """SE gate: the CUDA kernels (forward and backward) for CUDA tensors,
    `reference_se` for CPU tensors. The kernels reduce and run both dense
    layers in f32 (the weights read as f32 from x's dtype) and store in
    x's dtype."""
    if x.device.type == "cpu":
        return reference_se(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_se: unsupported device {x.device}")
    return _FusedSE.apply(x, w1, b1, w2, b2)
