"""The fold axis of the port's three kernels and the CV splits, on the CPU.

  * `vmap` rules: each kernel's autograd Function under `torch.func.vmap`,
    its launches replaced by their plain versions (the kernels run only on
    the card), with per-fold parameters (the fold-axis Function) and with
    parameters shared by every fold (the folds folded into the batch):
    outputs and every gradient equal a loop over folds of the plain op,
    float32 atol 1e-5 (sums in another order); the fold-axis plain
    versions equal that loop too;
  * the per-fold Adam of the fold program (`cv_parallel.fold_adam_`)
    against `torch.optim.Adam` run on each fold alone, with masked steps,
    weight decay and learning rates decayed per fold: atol 1e-6 after 12
    steps (float32 rounding in another order);
  * `splits.nested_kfold` and `exhaustive_fold_pairs` against the JAX
    package's (scikit-learn's `StratifiedKFold`): equal index sets, the
    same ValueError and the same warning.
"""

import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.func import vmap

from ecgmm_tpu.data import splits as jax_splits
from ecgmm_torch.data import splits
from ecgmm_torch.ops import fusion, se
from ecgmm_torch.ops import losses as focal
from ecgmm_torch.train import cv_parallel

torch.set_num_threads(2)
F, B = 3, 4


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=atol, rtol=0)


# ------------------------------------------------------------ vmap rules

@pytest.fixture
def plain_se(monkeypatch):
    """fused_se's launches as their plain versions; the backward's b2 (the
    kernels read the saved gate instead) from `b2s`."""
    b2s = {}

    def launch(x, w1, b1, w2, b2, folds=None):
        b2s[folds] = b2.detach()
        ref = se.reference_se if folds is None else se.reference_fold_se
        return ref(x, w1, b1, w2, b2), torch.zeros(2, x.shape[0], x.shape[1])

    def launch_backward(x, w1, b1, w2, state, grad, needs, folds=None):
        ref = (se.reference_se_backward if folds is None
               else se.reference_fold_se_backward)
        grads = ref((x, w1, b1, w2, b2s[folds]), grad)
        return tuple(g if n else None for g, n in zip(grads, needs))

    monkeypatch.setattr(se, "_launch", launch)
    monkeypatch.setattr(se, "launch_backward", launch_backward)


@pytest.mark.parametrize("per_fold", [True, False],
                         ids=["fold_weights", "shared_weights"])
def test_se_under_vmap_equals_a_loop_over_folds(rng, plain_se, per_fold):
    c, t = 32, 11
    r = c // 16
    x = torch.from_numpy(rng.standard_normal((F, B, c, t), np.float32))
    lead = (F,) if per_fold else ()
    ws = [torch.from_numpy(0.3 * rng.standard_normal(lead + s, np.float32))
          for s in ((r, c), (r,), (c, r), (c,))]
    g = torch.from_numpy(rng.standard_normal((F, B, c, t), np.float32))
    leaves = [a.clone().requires_grad_(True) for a in [x] + ws]
    in_dims = (0,) + ((0 if per_fold else None),) * 4
    out = vmap(lambda *a: se._FusedSE.apply(*a)[0], in_dims=in_dims)(*leaves)
    grads = torch.autograd.grad(out, leaves, g)
    want_x, want_w = [], [torch.zeros_like(w) for w in ws]
    for f in range(F):
        lf = [x[f].clone().requires_grad_(True)] + [
            (w[f] if per_fold else w).clone().requires_grad_(True)
            for w in ws]
        o = se.reference_se(*lf)
        _close(out[f], o)
        gf = torch.autograd.grad(o, lf, g[f])
        want_x.append(gf[0])
        for k in range(4):
            if per_fold:
                want_w[k][f] = gf[k + 1]
            else:
                want_w[k] += gf[k + 1]
    _close(grads[0], torch.stack(want_x))
    for got, want in zip(grads[1:], want_w):
        _close(got, want, atol=1e-4)
    if per_fold:
        _close(se.reference_fold_se(x.reshape(F * B, c, t), *ws),
               out.reshape(F * B, c, t))


@pytest.fixture
def plain_fusion(monkeypatch):
    def launch(img, sig, clin, weights, scale, bias, eps, keep_stats=False,
               warps=None, folds=None):
        if folds is None:
            out, sw = fusion.reference_attention_fusion(
                img, sig, clin, weights, scale, bias, eps)
        else:
            out, sw = fusion.reference_fold_attention_fusion(
                img, sig, clin, weights, scale, bias, eps)
        stats = torch.zeros(img.shape[0], 2) if keep_stats else None
        return out, sw, stats

    def launch_backward(inputs, stats, grad_out, grad_sw, needs, warps=None,
                        folds=None):
        # the kernels index every input as a contiguous array
        assert all(t.is_contiguous() for t in inputs)
        if folds is None:
            return fusion.reference_fusion_backward(inputs, 1e-5, grad_out,
                                                    grad_sw, needs)
        return fusion.reference_fold_fusion_backward(inputs, 1e-5, grad_out,
                                                     grad_sw, needs)

    monkeypatch.setattr(fusion, "_launch", launch)
    monkeypatch.setattr(fusion, "launch_backward", launch_backward)


@pytest.mark.parametrize("per_fold", [True, False],
                         ids=["fold_params", "shared_params"])
def test_fusion_under_vmap_equals_a_loop_over_folds(rng, plain_fusion,
                                                     per_fold):
    dims, d = (8, 5, 3), 16
    lead = (F,) if per_fold else ()
    ins = [rng.standard_normal((F, B, w), np.float32) for w in dims] + [
        rng.standard_normal(lead + s, np.float32)
        for s in ((3,), (d,), (d,))]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    # the parameters as the fold program passes them: views into one
    # (F, P) tensor of every fold's parameters, strided across the folds
    flat = torch.cat([torch.from_numpy(a).reshape(len(a) if per_fold
                                                   else 1, -1)
                      for a in ins[3:]], -1).requires_grad_(True)
    views = torch.split(flat, [3, d, d], -1)
    params = [v if per_fold else v[0] for v in views]
    go = torch.from_numpy(rng.standard_normal((F, B, d), np.float32))

    def op(*a):
        out, sw, _ = fusion._FusedAttentionFusion.apply(*a, 1e-5, True)
        return out, sw

    in_dims = (0, 0, 0) + ((0 if per_fold else None),) * 3
    out, sw = vmap(op, in_dims=in_dims,
                   out_dims=(0, 0 if per_fold else None))(*leaves[:3],
                                                          *params)
    gsw = torch.from_numpy(rng.standard_normal(sw.shape, np.float32))
    grads = torch.autograd.grad((out, sw), leaves[:3] + [flat], (go, gsw))
    grads = list(grads[:3]) + [g if per_fold else g[0] for g in torch.split(
        grads[3], [3, d, d], -1)]
    want = [torch.zeros_like(t) for t in leaves]
    for f in range(F):
        lf = [t.detach()[f].clone().requires_grad_(True) for t in leaves[:3]]
        lf += [(t.detach()[f] if per_fold else t.detach()).clone()
               .requires_grad_(True) for t in leaves[3:]]
        o, s = fusion.reference_attention_fusion(*lf, eps=1e-5)
        _close(out[f], o)
        # shared parameters: one set of soft weights, the same every fold
        _close(sw[f] if per_fold else sw, s)
        gf = torch.autograd.grad((o, s), lf, (
            go[f], gsw[f] if per_fold else gsw / F))
        for k in range(6):
            if k < 3 or per_fold:
                want[k][f] = gf[k]
            else:
                want[k] += gf[k]
    for got, w in zip(grads, want):
        _close(got, w, atol=1e-4)


@pytest.fixture
def plain_focal(monkeypatch):
    def launch(logits, labels, mask, alpha, gamma, k=None, folds=None):
        if folds is None:
            loss = focal.reference_focal(logits, labels, mask, alpha, gamma)
            return loss, torch.zeros(2)
        return (focal.reference_fold_focal(logits, labels,
                                           mask.view(folds, -1), alpha,
                                           gamma), torch.zeros(folds, 2))

    def launch_backward(inputs, res, alpha, gamma, grad, needs, folds=None):
        if folds is None:
            return focal.reference_focal_backward(inputs, alpha, gamma, grad,
                                                  needs)
        return focal.reference_fold_focal_backward(inputs, alpha, gamma,
                                                   grad, needs)

    monkeypatch.setattr(focal, "_launch", launch)
    monkeypatch.setattr(focal, "launch_backward", launch_backward)


def test_focal_under_vmap_equals_a_loop_over_folds(rng, plain_focal):
    c = 3
    logits = torch.from_numpy(rng.standard_normal((F, B, c), np.float32))
    labels = torch.from_numpy(rng.integers(0, c, (F, B)))
    mask = torch.ones(F, B)
    mask[1, 1:] = 0.0   # the sum(mask) = 1 tie in one fold
    mask[2] = 0.0       # an all-pad fold
    lg = logits.clone().requires_grad_(True)
    mk = mask.clone().requires_grad_(True)
    out = vmap(lambda a, b, m: focal._FusedFocalLoss.apply(
        a, b, m, 0.7, 1.5)[0])(lg, labels, mk)
    g = torch.from_numpy(rng.standard_normal(F, np.float32))
    got = torch.autograd.grad(out, (lg, mk), g)
    for f in range(F):
        a = logits[f].clone().requires_grad_(True)
        m = mask[f].clone().requires_grad_(True)
        o = focal.reference_focal(a, labels[f], m, 0.7, 1.5)
        _close(out[f], o)
        ga, gm = torch.autograd.grad(o, (a, m), g[f])
        _close(got[0][f], ga)
        _close(got[1][f], gm)
    _close(focal.reference_fold_focal(logits.reshape(F * B, c),
                                      labels.reshape(-1), mask, 0.7, 1.5),
           out)


def test_fold_functions_refuse_mismatched_folds():
    """A fold launch whose rows do not split into the folds raises before
    any kernel is built (the checks precede `_ext.library`)."""
    with pytest.raises(ValueError, match="folds"):
        focal._launch(torch.zeros(5, 2), torch.zeros(5, dtype=torch.int64),
                      torch.ones(5), 1.0, 2.0, folds=2)
    with pytest.raises(ValueError, match="folds"):
        se._launch(torch.zeros(5, 16, 4), torch.zeros(2, 1, 16),
                   torch.zeros(2, 1), torch.zeros(2, 16, 1),
                   torch.zeros(2, 16), folds=2)
    with pytest.raises(ValueError, match="inconsistent"):
        fusion._prepare(*(torch.zeros(5, w) for w in (2, 2, 2)),
                        torch.zeros(2, 3), torch.zeros(2, 6),
                        torch.zeros(2, 6), folds=2)


# ------------------------------------------------------------ per-fold Adam

@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_fold_adam_equals_torch_adam_per_fold(rng, weight_decay):
    shapes, steps = [(4, 3), (5,)], 12
    p0 = [rng.standard_normal((F,) + s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal((F,) + s).astype(np.float32)
              for s in shapes] for _ in range(steps)]
    active = rng.random((steps, F)) < 0.7
    decay_at = {(3, 0), (7, 0), (5, 2)}   # (step, fold): lr / 10 before it
    flat = torch.from_numpy(np.concatenate(
        [p.reshape(F, -1) for p in p0], 1)).requires_grad_(True)
    m, v = torch.zeros_like(flat), torch.zeros_like(flat)
    n_steps, lr = np.zeros(F, np.int64), np.full(F, 1e-2)
    ref = []
    for f in range(F):
        ps = [torch.nn.Parameter(torch.from_numpy(p[f].copy())) for p in p0]
        ref.append((ps, torch.optim.Adam(ps, lr=1e-2, betas=(0.9, 0.999),
                                         eps=1e-8,
                                         weight_decay=weight_decay)))
    for i in range(steps):
        for f in range(F):
            if (i, f) in decay_at:
                lr[f] = lr[f] * 0.1
                for group in ref[f][1].param_groups:
                    group["lr"] = group["lr"] * 0.1
        flat.grad = torch.from_numpy(np.concatenate(
            [g.reshape(F, -1) for g in grads[i]], 1))
        n_steps = cv_parallel.fold_adam_(flat, m, v, n_steps, lr, active[i],
                                         weight_decay)
        for f in range(F):
            if not active[i, f]:
                continue
            ps, opt = ref[f]
            for p, g in zip(ps, grads[i]):
                p.grad = torch.from_numpy(g[f].copy())
            opt.step()
    np.testing.assert_array_equal(n_steps, active.sum(0))
    for f in range(F):
        want = torch.cat([p.detach().reshape(-1) for p in ref[f][0]])
        np.testing.assert_allclose(flat[f].detach().numpy(), want.numpy(),
                                   atol=1e-6, rtol=0)
        if not active[:, f].any():
            np.testing.assert_array_equal(m[f].numpy(), 0.0)


# ------------------------------------------------------------------ splits

def _same_splits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(6, 70), k_outer=st.integers(2, 5),
       k_inner=st.integers(2, 4), seed=st.integers(0, 2 ** 31 - 1),
       n_classes=st.integers(2, 4), skew=st.floats(0.05, 0.95))
def test_nested_kfold_equals_sklearn(n, k_outer, k_inner, seed, n_classes,
                                     skew):
    """Index sets, the ValueError (a class count below every n_splits) and
    the warning (the smallest class below n_splits) as sklearn gives them,
    over class imbalance and label values in any order."""
    r = np.random.RandomState(seed)
    p = np.full(n_classes, (1 - skew) / max(1, n_classes - 1))
    p[0] = skew
    labels = r.choice(np.arange(n_classes) * 5 + 2, size=n, p=p / p.sum())

    def run(mod):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                out = [(i, t, list(s)) for i, t, s in
                       mod.nested_kfold(labels, k_outer, k_inner, seed)]
            except ValueError as e:
                out = str(e)
        return out, sorted({str(w.message) for w in caught})

    got, got_w = run(splits)
    want, want_w = run(jax_splits)
    assert got_w == want_w
    if isinstance(want, str):
        assert got == want
        return
    assert len(got) == len(want)
    for (gi, gt, gs), (wi, wt, ws) in zip(got, want):
        assert gi == wi
        np.testing.assert_array_equal(gt, wt)
        _same_splits(gs, ws)


@pytest.mark.parametrize("n,k,seed", [(60, 10, 42), (37, 4, 0), (24, 3, 7)])
def test_exhaustive_fold_pairs_equal_jax(n, k, seed):
    labels = np.random.RandomState(seed).randint(0, 2, n)
    got = list(splits.exhaustive_fold_pairs(labels, k, seed))
    want = list(jax_splits.exhaustive_fold_pairs(labels, k, seed))
    assert [(t, v) for t, v, _ in got] == [(t, v) for t, v, _ in want]
    assert len(got) == k * (k - 1)
    _same_splits([s for _, _, s in got], [s for _, _, s in want])


def test_stratified_kfold_errors_and_warnings_match_sklearn():
    from sklearn.model_selection import StratifiedKFold

    labels = np.array([0] * 8 + [1] * 2)
    with pytest.warns(UserWarning, match="least populated class"):
        got = splits._stratified_kfold(labels, 3, 1)
    with pytest.warns(UserWarning, match="least populated class"):
        want = list(StratifiedKFold(3, shuffle=True, random_state=1).split(
            np.zeros(10), labels))
    _same_splits(got, want)
    for n_splits, n in ((5, 4), (11, 10)):
        with pytest.raises(ValueError) as e_got:
            splits._stratified_kfold(labels[:n], n_splits, 0)
        with pytest.raises(ValueError) as e_want:
            list(StratifiedKFold(n_splits, shuffle=True,
                                 random_state=0).split(np.zeros(n),
                                                       labels[:n]))
        assert str(e_got.value) == str(e_want.value)
