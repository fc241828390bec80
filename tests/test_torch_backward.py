"""The closed-form backwards of the port's SE gate and attention-fusion
head, the SE kernel's cluster sizing and the fusion kernels' layout, on
the CPU.

`se.reference_se_backward` and `fusion.reference_fusion_backward` are the
plain versions of the CUDA backward kernels (`ecgmm_torch/ops/csrc/`):
the same formulas in the kernels' order of work. Here they are held
against `jax.vjp` of the JAX package's `reference_se` and
`reference_attention_fusion` (the functions its custom_vjps
differentiate) and against the port's autograd `reference_backward`; the
kernels are held against them on the card by chip_smoke.py.

Bars: SE gradients rtol 1e-5 and atol 1e-5 of each gradient's largest
component (each is a sum over T or B of float32 products), bf16 5e-2;
fusion rtol 1e-5 / atol 1e-4, `weights` against its largest component
(the bars of tests/test_pallas_ops.py and tests/test_torch_ops.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecgmm_tpu.ops.pallas_fusion import (
    reference_attention_fusion as jax_ref_fusion,
)
from ecgmm_tpu.ops.pallas_se import reference_se as jax_ref_se
from ecgmm_torch.ops import fusion, se

torch.set_num_threads(2)

SE_NAMES = ("x", "w1", "b1", "w2", "b2")
FUSION_NAMES = ("img", "sig", "clin", "weights", "scale", "bias")


def _close_to_largest(got, want, rel, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _se_case(rng, b, t, c, scale=0.1):
    """Inputs and a cotangent in the JAX layout: x (B, T, C), kernels
    (in, out)."""
    r = max(1, c // 16)
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    ws = [(rng.normal(size=s) * scale).astype(np.float32)
          for s in ((c, r), (r,), (r, c), (c,))]
    g = rng.normal(size=(b, t, c)).astype(np.float32)
    return [x] + ws, g


def _se_to_port(args, g, dtype):
    """JAX layout -> port layout (B, C, T) and torch Linear (out, in)."""
    x, w1, b1, w2, b2 = args
    port = [x.transpose(0, 2, 1), w1.T, b1, w2.T, b2]
    return ([torch.from_numpy(a.copy()).to(dtype) for a in port],
            torch.from_numpy(g.transpose(0, 2, 1).copy()).to(dtype))


def _se_to_jax(grads):
    """Port-layout gradients -> the JAX layout, as float32 numpy."""
    dx, dw1, db1, dw2, db2 = (np.asarray(a.float()) for a in grads)
    return [dx.transpose(0, 2, 1), dw1.T, db1, dw2.T, db2]


@pytest.mark.parametrize("b,t,c", [(4, 160, 64), (3, 37, 16), (2, 155, 256)])
def test_se_closed_form_backward_matches_jax_vjp(rng, b, t, c):
    args, g = _se_case(rng, b, t, c)
    _, vjp = jax.vjp(jax_ref_se, *map(jnp.asarray, args))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    inputs, grad = _se_to_port(args, g, torch.float32)
    closed = se.reference_se_backward(inputs, grad)
    auto = se.reference_backward(inputs, grad)
    for name, gc, ga, gj in zip(SE_NAMES, _se_to_jax(closed),
                                _se_to_jax(auto), want):
        _close_to_largest(gc, gj, 1e-5, f"{name} vs jax.vjp")
        _close_to_largest(gc, ga, 1e-5, f"{name} vs autograd")


def test_se_closed_form_backward_bf16(rng):
    """bf16 inputs: the closed form computes in f32 and returns bf16, as
    the kernel stores; held against jax.vjp in bf16 and autograd in
    bf16."""
    args, g = _se_case(rng, 8, 40, 16, scale=0.3)
    args = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
            for a in args]
    g = np.asarray(jnp.asarray(g, jnp.bfloat16), np.float32)
    _, vjp = jax.vjp(jax_ref_se,
                     *(jnp.asarray(a, jnp.bfloat16) for a in args))
    want = [np.asarray(a, np.float32)
            for a in vjp(jnp.asarray(g, jnp.bfloat16))]
    inputs, grad = _se_to_port(args, g, torch.bfloat16)
    closed = se.reference_se_backward(inputs, grad)
    assert all(d.dtype == torch.bfloat16 for d in closed)
    auto = se.reference_backward(inputs, grad)
    for name, gc, ga, gj in zip(SE_NAMES, _se_to_jax(closed),
                                _se_to_jax(auto), want):
        _close_to_largest(gc, gj, 5e-2, f"{name} vs jax.vjp")
        _close_to_largest(gc, ga, 5e-2, f"{name} vs autograd")


def test_se_backward_through_the_cpu_path_matches_closed_form(rng):
    """On the CPU `fused_se` is `reference_se` under autograd; its
    gradients equal the closed form the kernels compute."""
    args, g = _se_case(rng, 2, 50, 32)
    inputs, grad = _se_to_port(args, g, torch.float32)
    leaves = [a.clone().requires_grad_(True) for a in inputs]
    before = (se.launches, se.backward_launches)
    out = se.fused_se(*leaves)
    got = torch.autograd.grad(out, leaves, grad)
    assert (se.launches, se.backward_launches) == before
    for name, a, want in zip(SE_NAMES, got,
                             se.reference_se_backward(inputs, grad)):
        _close_to_largest(a.numpy(), want.numpy(), 1e-5, name)


# (B, C, T, dtype bytes) -> (forward K, backward K): B=1 serving, B=16
# ptbxl_af, B=8 physionet_multi, B=256 large batches, the R=1 edge shape
@pytest.mark.parametrize("b,c,t,esize,k_fwd,k_bwd", [
    (1, 64, 619, 4, 16, 16), (1, 128, 310, 4, 16, 16),
    (1, 256, 155, 4, 16, 16), (16, 64, 619, 4, 8, 8),
    (16, 256, 155, 4, 8, 8), (8, 64, 750, 4, 16, 16),
    (8, 256, 188, 4, 16, 16), (256, 64, 619, 4, 1, 2),
    (256, 256, 155, 2, 1, 1), (256, 256, 155, 4, 1, 2),
    (1, 16, 37, 4, 16, 16), (256, 16, 37, 4, 1, 1), (66, 64, 619, 4, 2, 2),
    (67, 64, 619, 4, 1, 2), (3, 12, 100, 4, 4, 4), (5, 7, 100, 4, 1, 1),
])
def test_se_cluster_size(b, c, t, esize, k_fwd, k_bwd):
    r = max(1, c // 16)
    for backward, want in ((False, k_fwd), (True, k_bwd)):
        k = se.cluster_size(b, c, t, r, esize, backward)
        assert k == want
        assert c % k == 0 and 1 <= k <= se.MAX_CLUSTER
        assert se.smem_bytes(c, t, r, k, esize, backward) <= se.MAX_SMEM
        # the slab did not fit at half the size, or K is the spreading
        # choice
        if k > 1 and b * k > se.N_SMS:
            assert se.smem_bytes(c, t, r, k // 2, esize,
                                 backward) > se.MAX_SMEM


def test_se_smem_bytes_layout():
    """f32 scratch of C + R + C/K values and one slab, both doubled in the
    backward, each padded to 16 bytes."""
    assert se.smem_bytes(64, 619, 4, 16, 4) == 4 * (64 + 4 + 4) + 4 * 619 * 4
    assert se.smem_bytes(64, 619, 4, 16, 4, backward=True) == \
        8 * (64 + 4 + 4) + 2 * 4 * 619 * 4
    # 16 channels of 37 bf16 values: 1184 bytes; scratch 4 * 33 -> 144
    assert se.smem_bytes(16, 37, 1, 1, 2) == 144 + 1184
    assert se.smem_bytes(16, 37, 1, 16, 4) == 80 + 160


@pytest.mark.parametrize("b,c,t,r", [(1, 16, 200_000, 1),
                                     (1, 3, 30_000, 1)])
def test_se_cluster_size_raises_where_nothing_fits(b, c, t, r):
    with pytest.raises(ValueError, match="shared memory"):
        se.cluster_size(b, c, t, r, 4)


@pytest.mark.parametrize("c,t,k,esize,ptr,want", [
    (64, 619, 16, 4, 0, True),      # 4 channels of f32: 9904 bytes
    (64, 619, 8, 4, 256, True),
    (16, 37, 16, 4, 0, False),      # one channel of 37 f32: 148 bytes
    (16, 37, 1, 4, 0, True),        # 2368 bytes
    (64, 619, 16, 2, 0, False),     # 4 channels of bf16: 4952 bytes
    (256, 155, 1, 2, 0, True),
    (64, 619, 8, 4, 8, False),      # a base pointer off 16 bytes
])
def test_se_vector_loads(c, t, k, esize, ptr, want):
    assert se.vector_loads(c, t, k, esize, ptr) is want


def _fusion_case(rng, b, dims):
    d = sum(dims)
    ins = [rng.normal(size=(b, w)).astype(np.float32) for w in dims] + [
        rng.normal(size=(3,)).astype(np.float32),
        (rng.normal(size=(d,)) + 1).astype(np.float32),
        rng.normal(size=(d,)).astype(np.float32),
    ]
    go = rng.normal(size=(b, d)).astype(np.float32)
    gsw = np.asarray([0.3, -1.0, 2.0], np.float32)
    return ins, go, gsw


def _fusion_close(name, got, want):
    if name == "weights":
        _close_to_largest(got, want, 1e-5, name)
        return
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4,
                               err_msg=name)


@pytest.mark.parametrize("with_gsw", [True, False])
@pytest.mark.parametrize("dims", [(512, 128, 32), (256, 256, 256)])
def test_fusion_closed_form_backward_matches_jax_vjp(rng, dims, with_gsw):
    ins, go, gsw = _fusion_case(rng, 8, dims)
    eps = 1e-5
    _, vjp = jax.vjp(lambda *a: jax_ref_fusion(*a, eps=eps),
                     *map(jnp.asarray, ins))
    gsw_j = gsw if with_gsw else np.zeros(3, np.float32)
    want = vjp((jnp.asarray(go), jnp.asarray(gsw_j)))
    t_in = [torch.from_numpy(a) for a in ins]
    t_gsw = torch.from_numpy(gsw) if with_gsw else None
    closed = fusion.reference_fusion_backward(t_in, eps, torch.from_numpy(go),
                                              t_gsw)
    auto = fusion.reference_backward(t_in, eps, torch.from_numpy(go), t_gsw)
    for name, gc, ga, gj in zip(FUSION_NAMES, closed, auto, want):
        _fusion_close(name, gc.numpy(), np.asarray(gj))
        _fusion_close(name, gc.numpy(), ga.numpy())


# serving: SHAP differentiates the three embeddings, IG only `clin`; the
# parameters are frozen. Training a fusion head: everything.
@pytest.mark.parametrize("needs", [
    (True, True, True, False, False, False),
    (False, False, True, False, False, False),
    (False, False, False, True, True, True),
    (True, False, True, True, False, True),
])
def test_fusion_closed_form_backward_partial_needs(rng, needs):
    ins, go, gsw = _fusion_case(rng, 5, (512, 128, 32))
    eps = 1e-5
    t_in = [torch.from_numpy(a) for a in ins]
    t_go, t_gsw = torch.from_numpy(go), torch.from_numpy(gsw)
    got = fusion.reference_fusion_backward(t_in, eps, t_go, t_gsw, needs)
    _, vjp = jax.vjp(lambda *a: jax_ref_fusion(*a, eps=eps),
                     *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(go), jnp.asarray(gsw)))
    for name, need, g, gj in zip(FUSION_NAMES, needs, got, want):
        if not need:
            assert g is None, name
            continue
        _fusion_close(name, g.numpy(), np.asarray(gj))


def test_fusion_backward_through_the_cpu_path_matches_closed_form(rng):
    """On the CPU the op is the reference under autograd, with frozen
    parameters as on the serving path; the input gradients equal the
    closed form and no kernel is counted."""
    ins, go, _ = _fusion_case(rng, 4, (512, 128, 32))
    t_in = [torch.from_numpy(a) for a in ins]
    leaves = [a.clone().requires_grad_(i < 3) for i, a in enumerate(t_in)]
    before = (fusion.launches, fusion.backward_launches)
    out, _ = fusion.fused_attention_fusion(*leaves, eps=1e-5)
    got = torch.autograd.grad(out, leaves[:3], torch.from_numpy(go))
    assert (fusion.launches, fusion.backward_launches) == before
    want = fusion.reference_fusion_backward(
        t_in, 1e-5, torch.from_numpy(go), None, (True,) * 3 + (False,) * 3)
    for name, g, w in zip(FUSION_NAMES, got, want):
        _fusion_close(name, g.numpy(), w.numpy())


@pytest.mark.parametrize("grad_mode", [True, False], ids=["grad", "no_grad"])
@pytest.mark.parametrize("needs", [
    (True,) * 6,
    (True, True, True, False, False, False),
    (False, False, True, False, False, False),
    (False, False, False, True, True, True),
    (False,) * 6,
], ids=["all", "shap", "ig", "params", "none"])
def test_fusion_autograd_function_with_plain_launches(rng, monkeypatch,
                                                      needs, grad_mode):
    """The kernels' autograd.Function on CPU tensors, its two launches
    replaced by their plain versions (the kernels run only on the card):
    the forward keeps (mu, rstd) exactly where autograd will run the
    backward, and the backward hands the launch the saved stats and the
    inputs that need a gradient."""
    ins, go, gsw = _fusion_case(rng, 3, (512, 128, 32))
    eps = 1e-5
    t_in = [torch.from_numpy(a) for a in ins]
    calls = {}

    def launch(img, sig, clin, weights, scale, bias, eps_, keep_stats=False):
        calls["keep"] = keep_stats
        out, sw = fusion.reference_attention_fusion(img, sig, clin, weights,
                                                    scale, bias, eps_)
        stats = (fusion.reference_fusion_stats(img, sig, clin, weights, eps_)
                 if keep_stats else None)
        return out, sw, stats

    def launch_backward(inputs, stats, grad_out, grad_sw, needs_):
        calls["needs"] = tuple(needs_)
        assert stats.shape == (3, 2)
        return fusion.reference_fusion_backward(inputs, eps, grad_out,
                                                grad_sw, needs_, stats=stats)

    monkeypatch.setattr(fusion, "_launch", launch)
    monkeypatch.setattr(fusion, "launch_backward", launch_backward)
    leaves = [a.clone().requires_grad_(n) for a, n in zip(t_in, needs)]
    with torch.set_grad_enabled(grad_mode):
        out, sw = fusion._through_kernels(*leaves, eps)
    assert calls["keep"] == (grad_mode and any(needs))
    ref, ref_sw = fusion.reference_attention_fusion(*t_in, eps=eps)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), atol=1e-6)
    if not calls["keep"]:
        assert not out.requires_grad
        return
    wrt = [a for a in leaves if a.requires_grad]
    got = iter(torch.autograd.grad((out, sw), wrt, (torch.from_numpy(go),
                                                   torch.from_numpy(gsw))))
    assert calls["needs"] == needs
    want = fusion.reference_backward(t_in, eps, torch.from_numpy(go),
                                     torch.from_numpy(gsw))
    for name, need, w in zip(FUSION_NAMES, needs, want):
        if need:
            _fusion_close(name, next(got).numpy(), w.numpy())


@pytest.mark.parametrize("needs", [
    (True,) * 6,
    (True, True, True, False, False, False),
    (False, False, False, True, True, True),
], ids=["all", "inputs", "params"])
@pytest.mark.parametrize("dims", [(512, 128, 32), (256, 256, 256),
                                  (130, 67, 33)])
def test_fusion_closed_form_with_saved_stats_matches_jax_vjp(rng, dims,
                                                             needs):
    """The kernels' backward reads the forward's (mu, rstd) instead of
    recomputing them: the closed form given `reference_fusion_stats` is
    held against jax.vjp of the JAX reference."""
    ins, go, gsw = _fusion_case(rng, 6, dims)
    eps = 1e-5
    t_in = [torch.from_numpy(a) for a in ins]
    stats = fusion.reference_fusion_stats(*t_in[:4], eps)
    assert stats.shape == (6, 2) and stats.dtype == torch.float32
    got = fusion.reference_fusion_backward(
        t_in, eps, torch.from_numpy(go), torch.from_numpy(gsw), needs,
        stats=stats)
    _, vjp = jax.vjp(lambda *a: jax_ref_fusion(*a, eps=eps),
                     *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(go), jnp.asarray(gsw)))
    for name, need, g, gj in zip(FUSION_NAMES, needs, got, want):
        if not need:
            assert g is None, name
            continue
        _fusion_close(name, g.numpy(), np.asarray(gj))


def test_fusion_reference_stats_match_float64(rng):
    """(mu, rstd) of each row of the scaled concat, biased variance."""
    ins, _, _ = _fusion_case(rng, 5, (512, 128, 32))
    eps = 1e-6
    got = fusion.reference_fusion_stats(
        *(torch.from_numpy(a) for a in ins[:4]), eps).numpy()
    w = np.exp(ins[3].astype(np.float64))
    sw = w / w.sum()
    f = np.concatenate([sw[k] * ins[k].astype(np.float64) for k in range(3)],
                       axis=-1)
    mu = f.mean(-1)
    np.testing.assert_allclose(got[:, 0], mu, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[:, 1], 1 / np.sqrt(f.var(-1) + eps),
                               rtol=1e-5)


@pytest.mark.parametrize("b", [4, 64, 512])
def test_fusion_rounding_scale_of_the_weights_gradient(b):
    """`tools/fusion_rounding.float64_grads`, the float64 side of
    chip_smoke.py's bar for the kernels' `weights` gradient: its six
    gradients equal JAX's VJP of the reference in float64; plain float32
    autograd on the CPU lies within the bar 1e-4 + 1e-6 * S of float64;
    and a row left out of the sums moves the gradient past the bar."""
    from ecgmm_torch.tools import fusion_rounding

    jax.config.update("jax_enable_x64", True)
    try:
        ins = fusion_rounding.draw(torch.Generator().manual_seed(b), b)
        g64, s = fusion_rounding.float64_grads(ins, 1e-5)
        args = [jnp.asarray(t.double().numpy()) for t in ins]
        out, vjp = jax.vjp(
            lambda *a: jax_ref_fusion(*a, eps=1e-5)[0], *args)
        want = vjp(2 * out)
    finally:
        jax.config.update("jax_enable_x64", False)
    for name, got, w in zip(FUSION_NAMES, g64, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-9 * s, err_msg=name)
    assert s > 0 and np.isfinite(s)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    out32, _ = fusion.reference_attention_fusion(*leaves, eps=1e-5)
    g32 = torch.autograd.grad((out32 ** 2).sum(), leaves)
    bar = 1e-4 + 1e-6 * s
    assert (g32[3].double() - g64[3]).abs().max().item() <= bar
    if b > 1:
        fewer, _ = fusion_rounding.float64_grads(
            [t[:-1] for t in ins[:3]] + ins[3:], 1e-5)
        assert (fewer[3] - g64[3]).abs().max().item() > bar


# (B, D) -> rows per block of the forward and the backward: one row per
# block until the batch outgrows the 132 SMs, then doubled up to 8, then
# halved while a block's shared memory does not fit (D > 1024 only; the
# backward keeps two rows per warp)
@pytest.mark.parametrize("b,dims,fwd,bwd", [
    (1, (512, 128, 32), 1, 1), (8, (512, 128, 32), 1, 1),
    (32, (512, 128, 32), 1, 1), (16, (256, 256, 256), 1, 1),
    (132, (512, 128, 32), 1, 1), (133, (512, 128, 32), 2, 2),
    (256, (512, 128, 32), 2, 2), (256, (256, 256, 256), 2, 2),
    (1056, (512, 128, 32), 8, 8), (100000, (512, 128, 32), 8, 8),
    (4096, (4096, 4096, 4096), 4, 2), (8, (4096, 4096, 4096), 1, 1),
])
def test_fusion_rows_per_block(b, dims, fwd, bwd):
    for backward, rows in ((False, fwd), (True, bwd)):
        got = fusion.rows_per_block(b, dims, backward)
        assert got == rows
        assert 1 <= got <= fusion.MAX_ROWS and got & (got - 1) == 0
        assert fusion.smem_bytes(dims, got, backward) <= fusion.MAX_SMEM


# (B, dims) -> (rows per block, warps per row): up to 256 rows, one warp
# per slot (up to 8); up to 1024, two slots per warp; beyond, three; rows
# too wide for registers, and rows of at most three slots beyond 1024,
# take one warp per row and several rows per block
@pytest.mark.parametrize("b,dims,want", [
    (1, (512, 128, 32), (1, 6)), (8, (512, 128, 32), (1, 6)),
    (32, (512, 128, 32), (1, 6)), (16, (256, 256, 256), (1, 6)),
    (256, (256, 256, 256), (1, 6)), (257, (512, 128, 32), (1, 3)),
    (1024, (512, 128, 32), (1, 3)), (4096, (512, 128, 32), (1, 2)),
    (8, (1, 1, 1022), (1, 8)), (3, (130, 67, 33), (1, 4)),
    (2000, (64, 32, 32), (8, 1)), (8, (4096, 4096, 4096), (1, 1)),
])
def test_fusion_layout(b, dims, want):
    assert fusion.layout(b, dims) == want
    assert fusion.layout(b, dims, backward=True) == want
    rows, w = want
    assert fusion.warps_per_row(b, dims) == w
    assert rows * w <= fusion.MAX_WARPS
    assert w <= fusion.row_slots(dims)


@pytest.mark.parametrize("warps,want", [(1, (2, 1)), (2, (1, 2)),
                                        (6, (1, 6))])
def test_fusion_layout_override(warps, want):
    """The timing override: several warps per row take a block each."""
    assert fusion.layout(256, (512, 128, 32), warps=warps) == want


@pytest.mark.parametrize("dims,regs,slots", [
    ((512, 128, 32), True, 6), ((256, 256, 256), True, 6),
    ((130, 67, 33), True, 4), ((1, 1, 1022), True, 10),
    ((129, 129, 766), True, 10), ((512, 512, 1), False, 9),
    ((4096, 4096, 4096), False, 96),
])
def test_fusion_registers_or_shared_memory(dims, regs, slots):
    assert fusion.in_registers(dims) is regs
    assert fusion.row_slots(dims) == slots
    # every row that stays in registers fits the kernel's 10 slots
    if regs:
        assert slots <= 10
        assert fusion.smem_bytes(dims, 8) == 0
    else:
        assert fusion.smem_bytes(dims, 2) == 2 * slots * 512
        assert fusion.smem_bytes(dims, 2, backward=True) == 4 * slots * 512


@pytest.mark.parametrize("dims,ptrs,mask", [
    ((512, 128, 32), (0, 256), 0b111), ((256, 256, 256), (0,), 0b111),
    ((512, 128, 32), (0, 8), 0), ((130, 66, 32), (0,), 0b100),
    ((128, 130, 34), (0,), 0b001), ((128, 128, 33), (0,), 0),
    ((32, 100, 60), (16,), 0b111),
])
def test_fusion_vector_chunks(dims, ptrs, mask):
    assert fusion.vector_chunks(dims, *ptrs) == mask


@pytest.mark.parametrize("b,groups", [(0, 1), (1, 1), (16, 1), (32, 1),
                                      (33, 2), (256, 8), (4096, 8)])
def test_fusion_param_groups(b, groups):
    g = fusion.param_groups(b)
    assert g == groups and 1 <= g <= fusion.MAX_GROUPS
    assert g == fusion.MAX_GROUPS or -(-b // g) <= fusion.GROUP_ROWS
