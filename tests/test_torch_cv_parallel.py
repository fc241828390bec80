"""The fold program of the port (`ecgmm_torch.train.cv_parallel`) against
the port's own sequential fits and against the JAX package's
`run_fold_parallel`, on the CPU at a small size (signals of 192-256
samples, images 8x16 or 16x32, 48-77 records).

Bars, those of the JAX package's tests/test_cv_parallel.py, and why:
  * per fold, the val-loss history within rtol and atol 1e-3, the best
    and stopped-at epochs equal: the folds run under `vmap` (grouped
    convolutions, batched products, a per-fold Adam on stacked tensors),
    so float32 sums go in other orders (measured ~7e-5 here);
  * best-on-test logits within 5e-3 and AUCs within 1e-3 (the drift
    compounds over the epochs' steps);
  * against JAX the port starts from JAX's initial weights with dropout
    0 on both sides (the frameworks' generators differ); against the
    port's sequential fits dropout stays live: each fold's generator
    draws the masks its sequential fit draws;
  * waves: bit-equal logits to one wave (the same ops on the same rows);
  * the fold pack against `cv._build_arrays`: signals and clinical
    features within 1e-6, images and labels equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ecgmm_tpu.config import Config as JaxConfig
from ecgmm_tpu.config import ModelConfig as JaxModelConfig
from ecgmm_tpu.config import TrainConfig as JaxTrainConfig
from ecgmm_tpu.data import synthetic as jax_synthetic
from ecgmm_tpu.models import ResNet1DSE as JaxResNet1DSE
from ecgmm_tpu.train import cv_parallel as jax_cv_parallel
from ecgmm_tpu.workloads import make_signal_task as jax_signal_task
from ecgmm_tpu.workloads.run import build_model_and_task as jax_build
from ecgmm_torch.config import Config, ModelConfig, TrainConfig
from ecgmm_torch.data import preprocess, splits, synthetic
from ecgmm_torch.tools.weights import from_jax_resnet1d_se
from ecgmm_torch.train import cv, cv_parallel
from ecgmm_torch.workloads.run import build_model_and_task

torch.set_num_threads(2)
VAL_TOL = dict(rtol=1e-3, atol=1e-3)
LOGIT_TOL = dict(rtol=5e-3, atol=5e-3)


def _signal_cfg(filters=16, dropout=0.3, **kw):
    train = dict(batch_size=16, num_epochs=8, lr=1e-3, loss="focal",
                 schedule="constant", freeze_encoders=False, patience=2,
                 plateau_patience=1)
    train.update(kw)
    return Config(name="signal_only", train=TrainConfig(**train),
                  model=ModelConfig(num_classes=2, dropout=dropout,
                                    signal_base_filters=filters))


def _fusion_cfg(signal_len=256, **kw):
    train = dict(batch_size=16, num_epochs=4, lr=1e-3, patience=2,
                 plateau_patience=1)
    train.update(kw)
    return Config(
        name="fusion", train=TrainConfig(**train),
        model=ModelConfig(dtype="float32", signal_base_filters=8),
        data=dataclasses.replace(Config().data, img_height=16, img_width=32,
                                 signal_len=signal_len))


def _inner_folds(labels, k_outer=2, k_inner=2, seed=42):
    return [s for _, _, inner in splits.nested_kfold(labels, k_outer,
                                                     k_inner, seed)
            for s in inner]


def _prepare(cohort, folds, cfg, make=build_model_and_task, **kw):
    return cv_parallel.prepare_folds(make, cohort, folds, cfg,
                                     apply_filter=kw.pop("apply_filter",
                                                         False),
                                     device="cpu", **kw)


def _sequential_fold(cfg, arrays, make=build_model_and_task):
    """cv._fold_auc's protocol on one fold's splits, history kept."""
    res, ev = cv.fit_fold(make, dict(zip(("train", "val", "test"), arrays)),
                          cfg, "cpu")
    return res, ev, cv._softmax_auc(ev.logits, ev.labels)


def _assert_fold_parity(par, pack, cfg, val_nan_folds=(), raw_arrays=None,
                        make=build_model_and_task):
    """Fold-by-fold parity of a run_fold_parallel result with the port's
    sequential fit on the same fold data (`raw_arrays(f)`: the unencoded
    splits of a cached pack)."""
    for f in range(pack.n_folds):
        arrays = (raw_arrays(f) if raw_arrays is not None
                  else pack.fold_arrays(f, "cpu"))
        res, ev, auc = _sequential_fold(cfg, arrays, make)
        seq_vhist = [h["Loss/Val"] for h in res.history]
        if f in val_nan_folds:
            assert np.all(np.isnan(seq_vhist)), f
            assert np.all(np.isnan(par.val_history[f])), f
        else:
            np.testing.assert_allclose(par.val_history[f][:len(seq_vhist)],
                                       seq_vhist, **VAL_TOL,
                                       err_msg=f"fold {f}")
        assert par.best_epochs[f] == res.best_epoch, f
        assert par.stopped_at[f] == (len(res.history) if res.stopped_early
                                     else -1), f
        np.testing.assert_allclose(par.logits[f], ev.logits, **LOGIT_TOL,
                                   err_msg=f"fold {f}")
        assert par.aucs[f] == pytest.approx(auc, abs=1e-3), f


def test_fold_parallel_matches_sequential_signal():
    """ResNet1D-SE with live dropout, early stop and plateau decay: every
    fold's history, epochs, logits and AUC equal its sequential fit's."""
    cohort = synthetic.make_cohort(n=60, signal_len=256, img_hw=(8, 16))
    cfg = _signal_cfg()
    task, state0, pack = _prepare(cohort, _inner_folds(cohort.labels), cfg)
    assert pack.images is None      # the signal model reads no images
    par = cv_parallel.run_fold_parallel(task, state0, pack, cfg.train,
                                        verbose=False)
    assert len(par.aucs) == 4
    assert any(s > 0 for s in par.stopped_at)
    _assert_fold_parity(par, pack, cfg)


def test_fold_parallel_unequal_folds_cross_batch_boundaries():
    """Train 33 against 17 rows and val 2 against 1 batches at bs 16: pad
    batches (validity 0) in the plan change nothing."""
    cohort = synthetic.make_cohort(n=77, signal_len=192, img_hw=(8, 16))
    cfg = _signal_cfg(num_epochs=5)
    r = np.arange(77)
    folds = [splits.Split(train=r[:33], val=r[33:50], test=r[50:]),
             splits.Split(train=r[60:], val=r[:33], test=r[33:60])]
    task, state0, pack = _prepare(cohort, folds, cfg)
    par = cv_parallel.run_fold_parallel(task, state0, pack, cfg.train,
                                        verbose=False)
    _assert_fold_parity(par, pack, cfg)


def test_fold_parallel_nan_val_epochs_carry_no_signal():
    """A fold whose whole val split is NaN never improves and never goes
    stale: it runs every epoch and is scored on its final state; a clean
    fold beside it is untouched by the NaN rows."""
    cohort = synthetic.make_cohort(n=48, signal_len=192, img_hw=(8, 16))
    cohort.signals[30:36] = np.nan
    r = np.arange(48)
    folds = [splits.Split(train=r[:30], val=r[30:36], test=r[36:]),
             splits.Split(train=r[:24], val=r[36:42], test=r[42:])]
    cfg = _signal_cfg(num_epochs=4)
    task, state0, pack = _prepare(cohort, folds, cfg)
    par = cv_parallel.run_fold_parallel(task, state0, pack, cfg.train,
                                        verbose=False)
    assert np.all(np.isnan(par.val_history[0]))
    assert par.stopped_at[0] == -1 and par.best_epochs[0] == -1
    assert np.all(np.isfinite(par.val_history[1]))
    _assert_fold_parity(par, pack, cfg, val_nan_folds={0})


def test_fold_parallel_fusion_cached_embeddings():
    """The fusion head over cached embeddings: each fold calibrates its
    encoders on its own train rows, so the image embeddings stack
    (F, N, D); every fold matches its sequential cached fit."""
    cohort = synthetic.make_cohort(n=48, signal_len=256, img_hw=(16, 32))
    cfg = _fusion_cfg(cache_embeddings=True)
    folds = _inner_folds(cohort.labels)
    task, state0, pack = _prepare(cohort, folds, cfg)
    assert pack.cached_embeddings and pack.images_stacked
    assert pack.images.shape == (4, 48, 512)
    par = cv_parallel.run_fold_parallel(task, state0, pack, cfg.train,
                                        verbose=False)
    n_clin = min(cfg.model.clinical_in_features, cohort.clinical.shape[1])

    def raw(f):
        s = folds[f]
        es = preprocess.Scaler.fit(cohort.signals[s.train])
        cs = preprocess.Scaler.fit(cohort.clinical[s.train, :n_clin])
        return tuple(cv._build_arrays(cohort, idx, es, cs, False, n_clin,
                                      "cpu") for idx in s)

    _assert_fold_parity(par, pack, cfg, raw_arrays=raw)


def test_fold_parallel_fusion_raw_frozen_encoders():
    """The raw fusion program: frozen encoders in train mode (per-fold
    BatchNorm buffers, the signal encoder's live dropout and the head's,
    two draws a step from each fold's generator), the fused SE folded
    into the batch, the fusion head with per-fold parameters."""
    cohort = synthetic.make_cohort(n=40, signal_len=192, img_hw=(16, 32))
    cfg = _fusion_cfg(signal_len=192, num_epochs=2)
    task, state0, pack = _prepare(cohort, _inner_folds(cohort.labels)[:2],
                                  cfg)
    par = cv_parallel.run_fold_parallel(task, state0, pack, cfg.train,
                                        verbose=False)
    program = cv_parallel.make_fold_program(task, state0, cfg.train)
    assert len(program.dropouts) == 2
    _assert_fold_parity(par, pack, cfg)


def test_fold_parallel_matches_jax_run_fold_parallel():
    """The port's fold program against JAX's on the same folds, from JAX's
    initial weights, dropout 0 on both sides."""
    cohort = synthetic.make_cohort(n=48, signal_len=192, img_hw=(8, 16))
    jcohort = jax_synthetic.make_cohort(n=48, signal_len=192,
                                        img_hw=(8, 16))
    folds = _inner_folds(cohort.labels)
    cfg = _signal_cfg(filters=8, dropout=0.0, num_epochs=4)

    def jax_make(c):
        # the JAX signal presets build ResNet1D-SE at 64 filters and
        # dropout 0.3 whatever ModelConfig says
        _, _, init_args, freeze = jax_build(c)
        model = JaxResNet1DSE(num_classes=2, base_filters=8, dropout=0.0)
        return model, jax_signal_task(model, c.train), init_args, freeze

    jcfg = JaxConfig(
        name="signal_only",
        train=JaxTrainConfig(**dataclasses.asdict(cfg.train),
                             donate_state=False),
        model=JaxModelConfig(num_classes=2))
    jtask, tx, jstate0, jpack = jax_cv_parallel.prepare_folds(
        jax_make, jcohort, folds, jcfg, mesh=None, apply_filter=False)
    want = jax_cv_parallel.run_fold_parallel(jtask, tx, jstate0, jpack,
                                             jcfg.train, mesh=None,
                                             verbose=False)
    sd = from_jax_resnet1d_se(jax.device_get(
        {"params": jstate0.params, **jstate0.model_state}))

    def make(c, device="cpu"):
        model, task, freeze = build_model_and_task(c, device)
        model.load_state_dict(sd, strict=True)
        return model, task, freeze

    task, state0, pack = _prepare(cohort, folds, cfg, make=make)
    got = cv_parallel.run_fold_parallel(task, state0, pack, cfg.train,
                                        verbose=False)
    for f in range(4):
        np.testing.assert_allclose(got.val_history[f], want.val_history[f],
                                   **VAL_TOL, err_msg=f"fold {f}")
        assert got.best_epochs[f] == want.best_epochs[f], f
        assert got.stopped_at[f] == want.stopped_at[f], f
        np.testing.assert_allclose(got.logits[f], want.logits[f],
                                   **LOGIT_TOL, err_msg=f"fold {f}")
        assert got.aucs[f] == pytest.approx(want.aucs[f], abs=1e-3), f
        np.testing.assert_array_equal(got.labels[f], want.labels[f])


def test_fold_parallel_waves_under_a_device_budget(monkeypatch, capsys):
    """A budget that fits about two folds splits the run into waves with
    the results of one wave; a budget below one fold raises."""
    cohort = synthetic.make_cohort(n=48, signal_len=128, img_hw=(8, 16))
    cfg = _signal_cfg(num_epochs=3)
    task, state0, pack = _prepare(cohort, _inner_folds(cohort.labels), cfg)
    full = cv_parallel.run_fold_parallel(task, state0, pack, cfg.train)
    shared, per_fold = cv_parallel.fold_footprint(pack, state0)
    # the byte budget alone (a budget this small would cap the rows too)
    monkeypatch.setenv("ECGMM_FOLD_PARALLEL_ROWS_CAP", "0")
    monkeypatch.setenv("ECGMM_HBM_BUDGET_BYTES",
                       str(shared + int(2.7 * per_fold)))
    waved = cv_parallel.run_fold_parallel(task, state0, pack, cfg.train)
    assert "2 waves" in capsys.readouterr().out
    assert waved.aucs == full.aucs
    for f in range(pack.n_folds):
        np.testing.assert_array_equal(waved.logits[f], full.logits[f])
        assert waved.best_epochs[f] == full.best_epochs[f]
    np.testing.assert_array_equal(waved.val_history, full.val_history)
    monkeypatch.setenv("ECGMM_HBM_BUDGET_BYTES", str(shared + 1024))
    with pytest.raises(ValueError, match="cannot fit even one fold"):
        cv_parallel.run_fold_parallel(task, state0, pack, cfg.train)


def test_fold_parallel_rejects_onecycle_before_preparing(monkeypatch):
    cohort = synthetic.make_cohort(n=40, signal_len=128, img_hw=(8, 16))
    cfg = _signal_cfg(schedule="onecycle", onecycle_peak_lr=1e-3)
    task, state0, pack = _prepare(cohort, _inner_folds(cohort.labels), cfg)
    with pytest.raises(ValueError, match="fold-parallel"):
        cv_parallel.run_fold_parallel(task, state0, pack, cfg.train)

    def no_preparation(*a, **k):
        raise AssertionError("folds prepared before the schedule check")

    monkeypatch.setattr(cv_parallel, "prepare_folds", no_preparation)
    for run in (cv.nested_cv, cv.exhaustive_cv):
        with pytest.raises(ValueError, match="fold-parallel"):
            run(build_model_and_task, cohort, cfg, apply_filter=False,
                verbose=False, fold_parallel=True, device="cpu")


def test_fold_parallel_rows_cap(monkeypatch):
    """Raw packs are capped in concurrent rows by the card's bytes per row
    (images or signals alone), cached packs and an unknown budget are not;
    ECGMM_FOLD_PARALLEL_ROWS_CAP wins, and 0 disables the cap."""
    cohort = synthetic.make_cohort(n=48, signal_len=128, img_hw=(8, 16))
    cfg = _signal_cfg(num_epochs=1)
    _, state0, pack = _prepare(cohort, _inner_folds(cohort.labels), cfg)
    big = dataclasses.replace(pack, rows=[pack.rows[i % 4]
                                          for i in range(90)])
    with_images = dataclasses.replace(
        big, images=np.zeros((48, 8, 16, 3), np.uint8))
    budget = 10 ** 12

    def wave(p):
        return cv_parallel._wave_size(p, state0, 0, budget, 16)

    assert cv_parallel._act_rows_cap(pack, 0) == 0
    img_rows = budget // cv_parallel.IMAGE_ROW_BYTES
    sig_rows = budget // cv_parallel.SIGNAL_ROW_BYTES
    assert cv_parallel._act_rows_cap(with_images, budget) == img_rows
    assert cv_parallel._act_rows_cap(big, budget) == sig_rows
    assert wave(with_images) == min(90, img_rows // 16)
    cached = dataclasses.replace(with_images, cached_embeddings=True)
    assert cv_parallel._act_rows_cap(cached, budget) == 0
    assert wave(cached) == 90
    monkeypatch.setenv("ECGMM_FOLD_PARALLEL_ROWS_CAP", "32")
    assert wave(with_images) == 2 and wave(cached) == 2
    monkeypatch.setenv("ECGMM_FOLD_PARALLEL_ROWS_CAP", "0")
    assert wave(with_images) == 90


@pytest.mark.parametrize("apply_filter", [False, True],
                         ids=["affine", "filtered"])
def test_fold_pack_matches_sequential_build_arrays(apply_filter):
    """The pack's view of a fold (a cohort gather plus the fold's affine,
    or stacked filtered signals) is what cv._build_arrays gives the
    sequential harness."""
    cohort = synthetic.make_cohort(n=32, signal_len=256, img_hw=(16, 32))
    cfg = _fusion_cfg()
    folds = _inner_folds(cohort.labels)[:2]
    n_clin = min(cfg.model.clinical_in_features, cohort.clinical.shape[1])
    _, _, pack = _prepare(cohort, folds, cfg, apply_filter=apply_filter)
    assert pack.signals_stacked == apply_filter
    for f, split in enumerate(folds):
        es = preprocess.Scaler.fit(cohort.signals[split.train])
        cs = preprocess.Scaler.fit(cohort.clinical[split.train, :n_clin])
        for got, idx in zip(pack.fold_arrays(f, "cpu"), split):
            want = cv._build_arrays(cohort, idx, es, cs, apply_filter,
                                    n_clin, "cpu")
            assert torch.equal(got.images, want.images)
            assert torch.equal(got.labels, want.labels)
            for name in ("signals", "clinical"):
                np.testing.assert_allclose(
                    getattr(got, name).numpy(), getattr(want, name).numpy(),
                    rtol=1e-6, atol=1e-6)


def test_nested_and_exhaustive_fold_parallel_match_sequential():
    """cv.nested_cv and cv.exhaustive_cv with fold_parallel=True give the
    sequential harnesses' AUCs, grouped and ordered alike."""
    cohort = synthetic.make_cohort(n=48, signal_len=192, img_hw=(8, 16))
    cfg = _signal_cfg(num_epochs=2, k_outer=2, k_inner=2)
    kw = dict(apply_filter=False, verbose=False, device="cpu")
    seq = cv.nested_cv(build_model_and_task, cohort, cfg, **kw)
    par = cv.nested_cv(build_model_and_task, cohort, cfg,
                       fold_parallel=True, **kw)
    np.testing.assert_allclose(par["outer_aucs"], seq["outer_aucs"],
                               atol=1e-3)
    seq_e = cv.exhaustive_cv(build_model_and_task, cohort, cfg, k=4,
                             max_pairs=3, **kw)
    par_e = cv.exhaustive_cv(build_model_and_task, cohort, cfg, k=4,
                             max_pairs=3, fold_parallel=True, **kw)
    assert [p[:2] for p in par_e["pairs"]] == [p[:2] for p in seq_e["pairs"]]
    np.testing.assert_allclose([p[2] for p in par_e["pairs"]],
                               [p[2] for p in seq_e["pairs"]], atol=1e-3)
