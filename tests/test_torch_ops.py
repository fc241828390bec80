"""The port's kernel ops (`ecgmm_torch.ops`) on the CPU, held against the
JAX Pallas kernels in interpret mode and their `reference_*` expressions.

On the CPU each wrapper evaluates its plain version; the CUDA kernels are
held against the same plain versions on the card by chip_smoke.py. Bars
are those of tests/test_pallas_ops.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecgmm_tpu.ops.pallas_fusion import (
    fused_attention_fusion as jax_fused_fusion,
    reference_attention_fusion as jax_ref_fusion,
)
from ecgmm_tpu.ops.pallas_se import (
    fused_se as jax_fused_se,
    reference_se as jax_ref_se,
)
from ecgmm_torch.ops import fusion, se

torch.set_num_threads(2)


def _se_inputs(rng, b, t, c, r, scale=0.1):
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    w1 = (rng.normal(size=(c, r)) * scale).astype(np.float32)
    b1 = (rng.normal(size=(r,)) * scale).astype(np.float32)
    w2 = (rng.normal(size=(r, c)) * scale).astype(np.float32)
    b2 = (rng.normal(size=(c,)) * scale).astype(np.float32)
    return x, w1, b1, w2, b2


def _to_port(x, w1, b1, w2, b2, dtype):
    """JAX layout (B,T,C) / kernel (in,out) -> port (B,C,T) / (out,in)."""
    return (torch.from_numpy(x.transpose(0, 2, 1).copy()).to(dtype),
            torch.from_numpy(w1.T.copy()).to(dtype),
            torch.from_numpy(b1).to(dtype),
            torch.from_numpy(w2.T.copy()).to(dtype),
            torch.from_numpy(b2).to(dtype))


@pytest.mark.parametrize("b,t,c", [(4, 160, 64), (3, 37, 16), (2, 155, 256)])
def test_se_plain_matches_jax_f32(rng, b, t, c):
    r = max(1, c // 16)
    args = _se_inputs(rng, b, t, c, r)
    want_kernel = np.asarray(jax_fused_se(*map(jnp.asarray, args), True))
    want_ref = np.asarray(jax_ref_se(*map(jnp.asarray, args)))
    before = se.launches
    got = se.fused_se(*_to_port(*args, torch.float32)).numpy()
    assert se.launches == before  # the CPU path launches no kernel
    got = got.transpose(0, 2, 1)
    np.testing.assert_allclose(got, want_kernel, atol=1e-5)
    np.testing.assert_allclose(got, want_ref, atol=1e-5)


def test_se_plain_matches_jax_bf16(rng):
    b, t, c, r = 8, 40, 16, 1
    x, w1, b1, w2, b2 = _se_inputs(rng, b, t, c, r, scale=0.3)
    xb = jnp.asarray(x, jnp.bfloat16)
    ws = [jnp.asarray(a, jnp.bfloat16) for a in (w1, b1, w2, b2)]
    want = np.asarray(jax_fused_se(xb, *ws, True), np.float32)
    port_in = _to_port(np.asarray(xb, np.float32), w1, b1, w2, b2,
                       torch.bfloat16)
    got = se.fused_se(*port_in)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy().transpose(0, 2, 1), want, atol=0.05, rtol=0.05
    )
    want_ref = np.asarray(jax_ref_se(xb, *ws), np.float32)
    np.testing.assert_allclose(
        got.float().numpy().transpose(0, 2, 1), want_ref, atol=0.05,
        rtol=0.05,
    )


def _fusion_inputs(rng, b, dims):
    d = sum(dims)
    return [rng.normal(size=(b, w)).astype(np.float32) for w in dims] + [
        rng.normal(size=(3,)).astype(np.float32),
        (rng.normal(size=(d,)) + 1).astype(np.float32),
        rng.normal(size=(d,)).astype(np.float32),
    ]


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("dims", [(512, 128, 32), (256, 256, 256)])
def test_fusion_plain_matches_jax(rng, eps, dims):
    ins = _fusion_inputs(rng, 16, dims)
    j_in = [jnp.asarray(a) for a in ins]
    want, want_sw = jax_fused_fusion(*j_in, eps, True)
    want_ref, _ = jax_ref_fusion(*j_in, eps=eps)

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    before = fusion.launches
    out, sw = fusion.fused_attention_fusion(*leaves, eps=eps)
    assert fusion.launches == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_ref),
                               atol=1e-5)
    np.testing.assert_allclose(sw.detach().numpy(), np.asarray(want_sw),
                               atol=1e-7)

    def loss(*a):
        o, _ = jax_fused_fusion(*a, eps, True)
        return jnp.sum(o ** 2)

    g_jax = jax.grad(loss, argnums=tuple(range(6)))(*j_in)
    g_port = torch.autograd.grad((out ** 2).sum(), leaves)
    # the autograd.Function's backward helper, on CPU tensors
    g_helper = fusion.reference_backward(
        [t.detach() for t in leaves], eps, 2 * out.detach(), None
    )
    for gj, gp, gh in zip(g_jax, g_port, g_helper):
        np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(gh.numpy(), np.asarray(gj), rtol=1e-5,
                                   atol=1e-4)


def test_fusion_backward_helper_takes_soft_weight_cotangent(rng):
    """A cotangent on the returned soft weights reaches `weights` only,
    as the JAX custom_vjp's does."""
    ins = _fusion_inputs(rng, 4, (512, 128, 32))
    j_in = [jnp.asarray(a) for a in ins]
    g_sw = np.asarray([0.3, -1.0, 2.0], np.float32)

    def loss(*a):
        o, s = jax_fused_fusion(*a, 1e-5, True)
        return jnp.sum(o) + jnp.sum(s * g_sw)

    g_jax = jax.grad(loss, argnums=tuple(range(6)))(*j_in)
    g_port = fusion.reference_backward(
        [torch.from_numpy(a) for a in ins], 1e-5,
        torch.ones(4, 672), torch.from_numpy(g_sw),
    )
    for gj, gp in zip(g_jax, g_port):
        np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=1e-5,
                                   atol=1e-4)


def test_wrappers_reject_other_devices():
    """Only CPU tensors take the plain version; any other device either
    launches the kernel or raises — never a silent fallback."""
    x = torch.empty((1, 16, 8), device="meta")
    w = [torch.empty(s, device="meta") for s in ((1, 16), (1,), (16, 1),
                                                  (16,))]
    with pytest.raises(ValueError, match="unsupported device"):
        se.fused_se(x, *w)
    ins = [torch.empty(s, device="meta") for s in
           ((1, 4), (1, 2), (1, 2), (3,), (8,), (8,))]
    with pytest.raises(ValueError, match="unsupported device"):
        fusion.fused_attention_fusion(*ins)
