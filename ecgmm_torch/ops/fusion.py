"""AttentionFusion head (port of `ecgmm_tpu/ops/pallas_fusion.py`).

`fused_attention_fusion(img, sig, clin, weights, scale, bias, eps)`
returns `(out (B, D) f32, sw (3,))`: sw = softmax(weights), then a row
LayerNorm (biased variance) of concat(sw0*img, sw1*sig, sw2*clin), times
scale plus bias.

For tensors on a CUDA device the op runs the CUDA kernels
(`csrc/fusion.cu`), wrapped in a `torch.autograd.Function`: the forward
kernel (a row per block of up to 8 warps, fewer as the batch grows),
which also keeps each row's (mu, rstd) where autograd will need them,
and a backward kernel of the same layout that
writes the gradients of the inputs that need one, plus a column reduction
where a parameter (`weights`, `scale`, `bias`) needs one. For tensors on
the CPU the op is `reference_attention_fusion`. `launches` counts forward
launches and `backward_launches` backward calls through the kernels.

`reference_backward` (autograd of the reference, the JAX custom_vjp's
design) and `reference_fusion_backward` (the closed form the kernels
compute) are the plain versions of the backward; `reference_fusion_stats`
is the plain version of the forward's (mu, rstd) residual.

The kernels' shapes are pure functions of the shape here:
`warps_per_row`, `rows_per_block` (both through `layout`),
`in_registers`, `smem_bytes`, `vector_chunks` and `param_groups`.
"""

from __future__ import annotations

import torch

from ecgmm_torch.ops import _ext

launches = 0
backward_launches = 0

N_SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232448  # bytes of shared memory a block may opt into on sm_90
MAX_ROWS = 8  # rows (one warp each) per block of the row kernels
MAX_WARPS = 8  # warps sharing one row (one row per block)
# (batches up to B rows, slots of a row per warp), and the slots per warp
# of larger batches: the fastest split at each batch of chip_smoke.py's
# fusion layout sweep (D = 672, six slots: 6 warps a row up to B = 256, 3
# at 1024, 2 at 4096; one warp a row was the slowest at every batch;
# PERF.md)
SLOTS_PER_WARP = ((256, 1), (1024, 2))
WIDE_SLOTS_PER_WARP = 3
REG_WIDTH = 1024  # rows up to this width stay in registers
SLOT = 128  # elements of a row that one slot of a warp covers
MAX_GROUPS = 8  # row groups of the parameter kernel: a portable cluster
GROUP_ROWS = 32  # rows one block of the parameter kernel takes at most
# the widest row: one row per block of the shared-memory backward, which
# keeps two rows (x and dxh) per warp, fits in MAX_SMEM
_MAX_WIDTH = 48 * 1024 // 4


def row_slots(dims) -> int:
    """Slots of 128 elements of one chunk that a row takes."""
    return sum(-(-w // SLOT) for w in dims)


def in_registers(dims) -> bool:
    """Whether a lane keeps its part of a row in registers (D <= 1024)
    rather than in its warp's slice of shared memory."""
    return sum(dims) <= REG_WIDTH


def smem_bytes(dims, rows: int, backward: bool = False) -> int:
    """Dynamic shared memory of a block of `rows` warps: none where the
    row is in registers, else per warp one row of slots (16 bytes per
    lane per slot), two in the backward (x and dxh)."""
    if in_registers(dims):
        return 0
    return rows * (2 if backward else 1) * row_slots(dims) * 32 * 16


def rows_per_block(b: int, dims, backward: bool = False) -> int:
    """Rows (warps) per block of the row kernels: the smallest power of
    two up to MAX_ROWS that keeps the blocks within the card's SMs, so
    that a batch spreads over the SMs first, then halved while a block's
    shared memory does not fit."""
    rows = 1
    while 2 * rows <= MAX_ROWS and -(-b // rows) > N_SMS:
        rows *= 2
    while rows > 1 and smem_bytes(dims, rows, backward) > MAX_SMEM:
        rows //= 2
    return rows


def warps_per_row(b: int, dims) -> int:
    """Warps W that share one row of the row kernels (one row per block
    where W > 1): where the row stays in registers, enough warps that each
    takes at most the slots SLOTS_PER_WARP gives for the batch, up to
    MAX_WARPS; rows in shared memory take one warp each."""
    if not in_registers(dims):
        return 1
    per = next((p for rows, p in SLOTS_PER_WARP if b <= rows),
               WIDE_SLOTS_PER_WARP)
    return min(-(-row_slots(dims) // per), MAX_WARPS)


def layout(b: int, dims, backward: bool = False, warps=None):
    """(rows per block, warps per row) of the row kernels: `warps`
    overrides `warps_per_row` (for timing); where several warps share a
    row, a block holds one row."""
    w = warps_per_row(b, dims) if warps is None else warps
    return (1 if w > 1 else rows_per_block(b, dims, backward)), w


def vector_chunks(dims, *ptrs: int) -> int:
    """Bit k set where chunk k of the row takes 16-byte accesses: its
    width and its offset in the row are multiples of 4 floats, so is the
    row width D, and every pointer is 16-byte aligned."""
    aligned = sum(dims) % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    mask, off = 0, 0
    for k, w in enumerate(dims):
        if aligned and w % 4 == 0 and off % 4 == 0:
            mask |= 1 << k
        off += w
    return mask


def param_groups(b: int) -> int:
    """Row groups G of the parameter backward (the cluster size): enough
    that a block takes at most GROUP_ROWS rows, at most MAX_GROUPS."""
    return max(1, min(MAX_GROUPS, -(-b // GROUP_ROWS)))


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


def _launch(img, sig, clin, weights, scale, bias, eps, keep_stats=False,
            warps=None):
    """The forward kernel on inputs that `_prepare` returned: (out, sw,
    stats), stats the (B, 2) f32 (mu, rstd) of each row where
    `keep_stats`, else None. `warps` overrides `warps_per_row`."""
    dev = img.device
    b = img.shape[0]
    dims = (img.shape[1], sig.shape[1], clin.shape[1])
    out = torch.empty((b, sum(dims)), dtype=torch.float32, device=dev)
    sw = torch.empty((3,), dtype=torch.float32, device=dev)
    stats = None
    if keep_stats:
        stats = torch.empty((b, 2), dtype=torch.float32, device=dev)
    if b == 0:
        return out, torch.softmax(weights, dim=0), stats
    rows, w = layout(b, dims, warps=warps)
    vec = vector_chunks(dims, img.data_ptr(), sig.data_ptr(),
                        clin.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                        out.data_ptr())
    lib = _ext.library()
    context, stream = _ext.launch_target(dev)
    with context:
        status = lib.ecgmm_attention_fusion_forward(
            img.data_ptr(), sig.data_ptr(), clin.data_ptr(),
            weights.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), sw.data_ptr(), _ptr(stats), b, *dims, rows, w,
            int(in_registers(dims)), vec, float(eps), stream,
        )
    _ext.check(status, "ecgmm_attention_fusion_forward")
    global launches
    launches += 1
    return out, sw, stats


def launch_backward(inputs, stats, grad_out, grad_sw, needs=(True,) * 6,
                    warps=None):
    """The backward kernels for the six inputs that `_prepare` returned,
    the forward's (B, 2) stats and the cotangents (grad_out, grad_sw):
    gradients w.r.t. the six inputs, None where `needs` is False. grad_sw
    may be None. `warps` overrides `warps_per_row`."""
    img, sig, clin, weights, scale, _ = inputs
    dev = img.device
    b = img.shape[0]
    dims = (img.shape[1], sig.shape[1], clin.shape[1])
    grads = [torch.empty_like(t) if need else None
             for t, need in zip(inputs, needs)]
    # per row, the three dsw partial sums (at least one row, so that the
    # pointer is not null)
    dsw_part = None
    if needs[3]:
        dsw_part = torch.empty((max(b, 1), 3), dtype=torch.float32,
                               device=dev)
    gsw = None
    if grad_sw is not None and needs[3]:
        gsw = grad_sw.contiguous()
    go = grad_out.contiguous()
    rows, w = layout(b, dims, backward=True, warps=warps)
    vec = vector_chunks(dims, img.data_ptr(), sig.data_ptr(),
                        clin.data_ptr(), scale.data_ptr(), go.data_ptr(),
                        *(g.data_ptr() for g in grads[:3] if g is not None))
    lib = _ext.library()
    context, stream = _ext.launch_target(dev)
    with context:
        status = lib.ecgmm_attention_fusion_backward(
            img.data_ptr(), sig.data_ptr(), clin.data_ptr(),
            weights.data_ptr(), scale.data_ptr(), go.data_ptr(), _ptr(gsw),
            _ptr(stats), *map(_ptr, grads), _ptr(dsw_part), b, *dims, rows,
            w, int(in_registers(dims)), vec, param_groups(b), stream,
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


def reference_fusion_stats(img, sig, clin, weights, eps: float = 1e-6):
    """The plain version of the forward's residual: (B, 2) f32, each
    row's mean and rsqrt(biased variance + eps) of the scaled concat."""
    sw = torch.softmax(weights, dim=0)
    f = torch.cat([sw[0] * img, sw[1] * sig, sw[2] * clin], dim=-1)
    mu = f.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(((f - mu) ** 2).mean(dim=-1, keepdim=True) + eps)
    return torch.cat([mu, rstd], dim=-1)


def reference_fusion_backward(inputs, eps, grad_out, grad_sw,
                              needs=(True,) * 6, stats=None):
    """The closed form the backward kernels compute: gradients of
    `reference_attention_fusion` w.r.t. its six inputs for the cotangents
    (grad_out, grad_sw), None where `needs` is False. grad_sw may be
    None. `stats`, the forward's saved (B, 2) (mu, rstd), is taken where
    given (as the kernels take it), else recomputed
    (`reference_fusion_stats`)."""
    img, sig, clin, weights, scale, _ = inputs
    chunks = (img, sig, clin)
    sw = torch.softmax(weights, dim=0)
    f = torch.cat([sw[k] * chunks[k] for k in range(3)], dim=-1)
    if stats is None:
        stats = reference_fusion_stats(img, sig, clin, weights, eps)
    mu, rstd = stats[:, :1], stats[:, 1:]
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
    # `keep`: autograd will run the backward (grad mode on and an input
    # that requires a gradient), so the forward keeps (mu, rstd); inside
    # forward, grad mode is always off and needs_input_grad ignores it
    @staticmethod
    def forward(ctx, img, sig, clin, weights, scale, bias, eps, keep):
        inputs = _prepare(img, sig, clin, weights, scale, bias)
        out, sw, stats = _launch(*inputs, eps, keep_stats=keep)
        if keep:
            ctx.save_for_backward(*inputs, stats)
        return out, sw

    @staticmethod
    def backward(ctx, grad_out, grad_sw):
        *inputs, stats = ctx.saved_tensors
        grads = launch_backward(inputs, stats, grad_out, grad_sw,
                                ctx.needs_input_grad[:6])
        return (*grads, None, None)


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
    return _through_kernels(img, sig, clin, weights, scale, bias, eps)


def _through_kernels(img, sig, clin, weights, scale, bias, eps):
    """`_FusedAttentionFusion` on the six inputs, keeping (mu, rstd) only
    where autograd will run the backward."""
    tensors = (img, sig, clin, weights, scale, bias)
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    return _FusedAttentionFusion.apply(*tensors, eps, keep)
