"""The training slice's ops on the CPU: the port's focal loss and its
backward against the JAX Pallas kernel in interpret mode, the JAX
`reference_focal` and `train/losses.focal_loss`; the closed-form focal
backward (the plain version of the CUDA backward) against `jax.vjp`; the
focal kernel's launch shape as pure functions; the SE backward helper
against `jax.vjp` of the interpreted Pallas `fused_se`; the port's train
losses and their gradients against the JAX ones.

The mask kinds include `single` (sum(mask) = 1), where max(sum(mask), 1)
ties: JAX's VJP of `jnp.maximum` gives each side half the gradient, and
so must the port's.

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
    "single": lambda b: (np.arange(b) == 0).astype(np.float32),
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

    # both gradients against jax.grad of the Pallas kernel (its
    # custom_vjp), the JAX reference and the JAX train loss
    jax_fns = (
        lambda lgj, mkj: jax_fused_focal(lgj, j_in[1], mkj, alpha, gamma,
                                         True),
        lambda lgj, mkj: jax_ref_focal(lgj, j_in[1], mkj, alpha, gamma),
        lambda lgj, mkj: jax_losses.focal_loss(lgj, j_in[1], mkj,
                                               alpha=alpha, gamma=gamma),
    )
    g_port = torch.autograd.grad(got, (lg, mk))
    t_in = (torch.from_numpy(logits), torch.from_numpy(labels),
            torch.from_numpy(mask))
    # the autograd.Function's backward helper and the closed form, on CPU
    # tensors
    g_helper = ops_losses.reference_backward(t_in, alpha, gamma,
                                             torch.tensor(1.0))
    g_closed = ops_losses.reference_focal_backward(t_in, alpha, gamma,
                                                   torch.tensor(1.0))
    for fn in jax_fns:
        g_jax = jax.grad(fn, argnums=(0, 1))(j_in[0], j_in[2])
        for gj, gp, gh, gc in zip(g_jax, g_port, g_helper, g_closed):
            np.testing.assert_allclose(gp.numpy(), np.asarray(gj), atol=1e-5)
            np.testing.assert_allclose(gh.numpy(), np.asarray(gj), atol=1e-5)
            np.testing.assert_allclose(gc.numpy(), np.asarray(gj), atol=1e-5)


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


@pytest.mark.parametrize("mask_kind",
                         ["ones", "tail_zeros", "all_zero", "single"])
def test_cross_entropy_matches_jax(rng, mask_kind):
    logits, labels, mask = _focal_inputs(rng, 10, 2, mask_kind)
    j_lab = jnp.asarray(labels)
    want = float(jax_losses.cross_entropy(
        jnp.asarray(logits), j_lab, jnp.asarray(mask)))
    lg = torch.from_numpy(logits).requires_grad_(True)
    mk = torch.from_numpy(mask).requires_grad_(True)
    got = losses.make_loss_fn("cross_entropy")(lg, torch.from_numpy(labels),
                                               mk)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5,
                               atol=1e-7)
    g_jax = jax.grad(lambda a, m: jax_losses.cross_entropy(a, j_lab, m),
                     argnums=(0, 1))(jnp.asarray(logits), jnp.asarray(mask))
    for gj, gp in zip(g_jax, torch.autograd.grad(got, (lg, mk))):
        np.testing.assert_allclose(gp.numpy(), np.asarray(gj), atol=1e-5)
    with pytest.raises(ValueError, match="unknown loss"):
        losses.make_loss_fn("hinge")


@pytest.mark.parametrize("needs", [(True, True), (True, False)],
                         ids=["with_mask", "without_mask"])
@pytest.mark.parametrize("label_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("mask_kind", sorted(MASKS))
@pytest.mark.parametrize("gamma", [0.0, 1.5, 2.0])
def test_focal_closed_form_backward_matches_jax_vjp(rng, gamma, mask_kind,
                                                    label_dtype, needs):
    """`reference_focal_backward`, the plain version of the CUDA backward,
    against jax.vjp of the JAX `reference_focal` (the function the Pallas
    custom_vjp differentiates), for a cotangent other than 1."""
    logits, labels, mask = _focal_inputs(rng, 12, 3, mask_kind)
    labels = labels.astype(label_dtype)
    alpha, cot = 0.7, -1.3
    _, vjp = jax.vjp(
        lambda a, m: jax_ref_focal(a, jnp.asarray(labels), m, alpha, gamma),
        jnp.asarray(logits), jnp.asarray(mask))
    want = vjp(jnp.float32(cot))
    got = ops_losses.reference_focal_backward(
        (torch.from_numpy(logits), torch.from_numpy(labels),
         torch.from_numpy(mask)), alpha, gamma, torch.tensor(cot), needs)
    for need, g, w in zip(needs, got, want):
        if not need:
            assert g is None
            continue
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("mask_grad", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("mask_kind", ["tail_zeros", "single"])
def test_focal_autograd_function_with_plain_launches(rng, monkeypatch,
                                                     mask_kind, mask_grad):
    """The kernels' autograd.Function on CPU tensors, its two launches
    replaced by their plain versions (the kernels run only on the card):
    the forward's residual reaches the backward, which asks for dmask only
    where the mask needs a gradient; both gradients equal jax.grad of the
    JAX `reference_focal`."""
    logits, labels, mask = _focal_inputs(rng, 9, 3, mask_kind)
    alpha, gamma = 0.7, 1.5
    calls = {}

    def launch(lg, lb, mk, a, g, k=None):
        # the kernel's residual: sum(term * mask) and sum(mask)
        loss = ops_losses.reference_focal(lg, lb, mk, a, g)
        return loss, torch.stack([loss * mk.sum().clamp(min=1.0), mk.sum()])

    def launch_backward(inputs, res, a, g, grad, needs):
        calls["needs"] = tuple(needs)
        calls["res"] = res
        return ops_losses.reference_focal_backward(inputs, a, g, grad, needs)

    monkeypatch.setattr(ops_losses, "_launch", launch)
    monkeypatch.setattr(ops_losses, "launch_backward", launch_backward)
    lg = torch.from_numpy(logits).requires_grad_(True)
    mk = torch.from_numpy(mask).requires_grad_(mask_grad)
    out = ops_losses._FusedFocalLoss.apply(lg, torch.from_numpy(labels), mk,
                                           alpha, gamma)
    wrt = [lg, mk] if mask_grad else [lg]
    got = torch.autograd.grad(out, wrt, torch.tensor(-1.3))
    assert calls["needs"] == (True, mask_grad)
    assert calls["res"].shape == (2,)
    assert float(calls["res"][1]) == mask.sum()
    want = jax.grad(
        lambda a, m: -1.3 * jax_ref_focal(a, jnp.asarray(labels), m, alpha,
                                          gamma),
        argnums=(0, 1))(jnp.asarray(logits), jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


# (B, C) -> K: one block for the training batches (up to 2048 logits),
# a cluster of 16 blocks above
@pytest.mark.parametrize("b,c,k", [
    (16, 2, 1), (8, 3, 1), (13, 4, 1), (1, 2, 1), (0, 2, 1), (1024, 2, 1),
    (1025, 2, 16), (512, 4, 1), (683, 3, 16), (4096, 2, 16),
    (65536, 2, 16), (10 ** 6, 2, 16),
])
def test_focal_cluster_size(b, c, k):
    got = ops_losses.cluster_size(b, c)
    assert got == k and got in (1, ops_losses.MAX_CLUSTER)
    assert (got == 1) == (b * c <= ops_losses.BLOCK_ELEMS)


@pytest.mark.parametrize("b,blocks", [(0, 1), (1, 1), (16, 1), (512, 1),
                                      (513, 2), (65536, 128)])
def test_focal_backward_blocks(b, blocks):
    """One row per thread: the blocks of up to 512 threads the rows fill."""
    got = ops_losses.backward_blocks(b)
    assert got == blocks
    assert ops_losses.block_threads(b, got) * got >= b


@pytest.mark.parametrize("b,k,threads", [
    (16, 1, 32), (8, 1, 32), (0, 1, 32), (33, 1, 64), (500, 1, 512),
    (4096, 1, 512), (65536, 16, 512), (40, 2, 32),
])
def test_focal_block_threads(b, k, threads):
    assert ops_losses.block_threads(b, k) == threads


@pytest.mark.parametrize("c,ptr,want", [(2, 0, True), (2, 8, True),
                                        (2, 4, False), (3, 0, False),
                                        (4, 0, False)])
def test_focal_vector_rows(c, ptr, want):
    assert ops_losses.vector_rows(c, ptr) is want


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
