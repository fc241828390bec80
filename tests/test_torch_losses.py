"""The training slice's ops on the CPU: the port's focal loss and its
backward against the JAX Pallas kernel in interpret mode, the JAX
`reference_focal` and `train/losses.focal_loss`; the SE backward helper
against `jax.vjp` of the interpreted Pallas `fused_se`; the port's
train losses against the JAX ones.

On the CPU each wrapper evaluates its plain version; the CUDA kernels are
held against the same plain versions on the card by chip_smoke.py. Bars:
values rtol 1e-5 and gradients atol 1e-5 (the focal bars of
tests/test_pallas_ops.py); the SE gradients atol 1e-5, each a sum over T
float32 products."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecgmm_tpu.ops.pallas_losses import (
    fused_focal_loss as jax_fused_focal,
    reference_focal as jax_ref_focal,
)
from ecgmm_tpu.ops.pallas_se import fused_se as jax_fused_se
from ecgmm_tpu.train import losses as jax_losses
from ecgmm_torch.ops import losses as ops_losses, se
from ecgmm_torch.train import losses

torch.set_num_threads(2)

MASKS = {
    "ones": lambda b: np.ones(b, np.float32),
    "tail_zeros": lambda b: (np.arange(b) < b - 3).astype(np.float32),
    "all_zero": lambda b: np.zeros(b, np.float32),
}


def _focal_inputs(rng, b, c, mask_kind):
    logits = (rng.normal(size=(b, c)) * 2).astype(np.float32)
    labels = rng.integers(0, c, b).astype(np.int32)
    return logits, labels, MASKS[mask_kind](b)


@pytest.mark.parametrize("mask_kind", sorted(MASKS))
@pytest.mark.parametrize("b,c", [(16, 2), (8, 3), (13, 4)])
def test_focal_plain_matches_jax(rng, b, c, mask_kind):
    logits, labels, mask = _focal_inputs(rng, b, c, mask_kind)
    alpha, gamma = 1.0, 2.0
    j_in = (jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    want_kernel = float(jax_fused_focal(*j_in, alpha, gamma, True))
    want_ref = float(jax_ref_focal(*j_in, alpha, gamma))
    want_train = float(jax_losses.focal_loss(*j_in, alpha=alpha, gamma=gamma))

    lg = torch.from_numpy(logits).requires_grad_(True)
    mk = torch.from_numpy(mask).requires_grad_(True)
    before = ops_losses.launches
    got = ops_losses.fused_focal_loss(lg, torch.from_numpy(labels), mk,
                                      alpha, gamma)
    assert ops_losses.launches == before  # the CPU path launches no kernel
    assert got.dtype == torch.float32 and got.dim() == 0
    for want in (want_kernel, want_ref, want_train):
        np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5,
                                   atol=1e-7)

    def loss(lgj, mkj):
        return jax_fused_focal(lgj, j_in[1], mkj, alpha, gamma, True)

    g_jax = jax.grad(loss, argnums=(0, 1))(j_in[0], j_in[2])
    g_port = torch.autograd.grad(got, (lg, mk))
    # the autograd.Function's backward helper, on CPU tensors
    g_helper = ops_losses.reference_backward(
        (torch.from_numpy(logits), torch.from_numpy(labels),
         torch.from_numpy(mask)), alpha, gamma, torch.tensor(1.0))
    for gj, gp, gh in zip(g_jax, g_port, g_helper):
        np.testing.assert_allclose(gp.numpy(), np.asarray(gj), atol=1e-5)
        np.testing.assert_allclose(gh.numpy(), np.asarray(gj), atol=1e-5)


@pytest.mark.parametrize("gamma", [0.0, 1.5, 2.0])
@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
def test_train_focal_loss_any_gamma_and_label_dtype(rng, gamma, label_dtype):
    logits, labels, mask = _focal_inputs(rng, 12, 3, "tail_zeros")
    want = float(jax_losses.focal_loss(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask),
        alpha=0.5, gamma=gamma))
    fn = losses.make_loss_fn("focal", alpha=0.5, gamma=gamma)
    got = fn(torch.from_numpy(logits), torch.from_numpy(labels).to(
        label_dtype), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-7)
    # no mask means every row counts
    got_all = losses.focal_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels), None, 0.5, gamma)
    want_all = float(jax_losses.focal_loss(
        jnp.asarray(logits), jnp.asarray(labels), None, 0.5, gamma))
    np.testing.assert_allclose(float(got_all), want_all, rtol=1e-5)


@pytest.mark.parametrize("mask_kind", ["ones", "tail_zeros", "all_zero"])
def test_cross_entropy_matches_jax(rng, mask_kind):
    logits, labels, mask = _focal_inputs(rng, 10, 2, mask_kind)
    want = float(jax_losses.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)))
    got = losses.make_loss_fn("cross_entropy")(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="unknown loss"):
        losses.make_loss_fn("hinge")


@pytest.mark.parametrize("b,t,c", [(4, 160, 64), (3, 37, 16), (2, 78, 32)])
def test_se_backward_helper_matches_jax_vjp(rng, b, t, c):
    r = max(1, c // 16)
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    ws = [(rng.normal(size=s) * 0.1).astype(np.float32)
          for s in ((c, r), (r,), (r, c), (c,))]
    g = rng.normal(size=(b, t, c)).astype(np.float32)
    _, vjp = jax.vjp(functools.partial(jax_fused_se, interpret=True),
                     jnp.asarray(x), *map(jnp.asarray, ws))
    want = vjp(jnp.asarray(g))

    port_in = (torch.from_numpy(x.transpose(0, 2, 1).copy()),
               torch.from_numpy(ws[0].T.copy()), torch.from_numpy(ws[1]),
               torch.from_numpy(ws[2].T.copy()), torch.from_numpy(ws[3]))
    got = se.reference_backward(
        port_in, torch.from_numpy(g.transpose(0, 2, 1).copy()))
    # back to the JAX layouts: x (B, T, C), kernels (in, out)
    got_jax_layout = (got[0].numpy().transpose(0, 2, 1), got[1].numpy().T,
                      got[2].numpy(), got[3].numpy().T, got[4].numpy())
    for name, gj, gp in zip(("x", "w1", "b1", "w2", "b2"), want,
                            got_jax_layout):
        np.testing.assert_allclose(gp, np.asarray(gj), atol=1e-5,
                                   err_msg=name)

    # the CPU path of fused_se differentiates to the same gradients
    leaves = [a.clone().requires_grad_(True) for a in port_in]
    out = se.fused_se(*leaves)
    g_auto = torch.autograd.grad(
        out, leaves, torch.from_numpy(g.transpose(0, 2, 1).copy()))
    for ga, gh in zip(g_auto, got):
        np.testing.assert_allclose(ga.numpy(), gh.numpy(), atol=1e-6)


def test_focal_wrapper_rejects_other_devices():
    """Only CPU tensors take the plain version; any other device launches
    the kernel or raises, never a silent fallback."""
    with pytest.raises(ValueError, match="unsupported device"):
        ops_losses.fused_focal_loss(
            torch.empty((4, 2), device="meta"),
            torch.empty(4, dtype=torch.int64, device="meta"),
            torch.empty(4, device="meta"))
