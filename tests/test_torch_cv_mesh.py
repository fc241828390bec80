"""Cross-validation over the ranks of a mesh (`train/cv_parallel.py` and
`train/cv.py` with `mesh=`) on the CPU over gloo, against
`tests/test_cv_parallel.py:259-430` and `tests/test_cv.py:29-84`.

Two ranks run once (a module-scoped fixture): the fold program with its
3 folds padded to 4 and spread over the data axis (rank 0 folds 0 and 1,
rank 1 folds 2 and a copy of 0), the nested harness with the fold program
and with sequential fits over both ranks, and a tensor-parallel mesh,
which the fold program refuses with JAX's message.

Bars, those of tests/test_cv_parallel.py (as tests/test_torch_cv_parallel
.py holds the one-process fold program): per fold the val-loss history
within rtol and atol 1e-3, the best and stopped-at epochs equal, the
best-on-test logits within 5e-3 and the AUCs within 1e-3 of the port's
sequential fits; the harnesses' AUCs within 1e-3 of the one-process
harness. The file's top-level imports hold no JAX.
"""

import numpy as np
import pytest
import torch

from ecgmm_torch.config import Config, MeshConfig, ModelConfig, TrainConfig
from ecgmm_torch.data import splits, synthetic
from ecgmm_torch.parallel import launch
from ecgmm_torch.parallel.mesh import make_mesh
from ecgmm_torch.train import cv, cv_parallel
from ecgmm_torch.workloads.run import build_model_and_task

torch.set_num_threads(2)
VAL_TOL = dict(rtol=1e-3, atol=1e-3)
LOGIT_TOL = dict(rtol=5e-3, atol=5e-3)


def _cfg(**kw):
    train = dict(batch_size=16, num_epochs=6, lr=1e-3, loss="focal",
                 schedule="constant", freeze_encoders=False, patience=2,
                 plateau_patience=1, k_outer=2, k_inner=2)
    train.update(kw)
    return Config(name="signal_only", train=TrainConfig(**train),
                  model=ModelConfig(num_classes=2, dropout=0.3,
                                    signal_base_filters=16))


def _cohort():
    return synthetic.make_cohort(n=60, signal_len=256, img_hw=(8, 16))


def _folds(cohort):
    return [s for _, _, inner in splits.nested_kfold(cohort.labels, 2, 2,
                                                     42)
            for s in inner][:3]


def rank_main(rank):
    mesh = make_mesh(MeshConfig(), "cpu")
    cohort, cfg = _cohort(), _cfg()
    task, state0, pack = cv_parallel.prepare_folds(
        build_model_and_task, cohort, _folds(cohort), cfg,
        apply_filter=False, device="cpu")
    out = {"block": cv_parallel._fold_block(pack.n_folds, mesh)}
    out["par"] = cv_parallel.run_fold_parallel(task, state0, pack,
                                               cfg.train, verbose=False,
                                               mesh=mesh)
    small = _cfg(num_epochs=2)
    kw = dict(apply_filter=False, verbose=False, device="cpu", mesh=mesh)
    out["nested_fold_parallel"] = cv.nested_cv(
        build_model_and_task, _cohort(), small, fold_parallel=True, **kw)
    out["nested_sequential"] = cv.nested_cv(
        build_model_and_task, _cohort(), small, **kw)
    tp_mesh = make_mesh(MeshConfig(n_data=1, n_model=2), "cpu")
    try:
        cv_parallel.run_fold_parallel(task, state0, pack, cfg.train,
                                      verbose=False, mesh=tp_mesh)
        out["tp_refusal"] = None
    except ValueError as e:
        out["tp_refusal"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks():
    return launch.spawn(rank_main, 2)


def test_folds_pad_over_the_data_axis(ranks):
    assert [r["block"] for r in ranks] == [[0, 1], [2, 0]]


def test_fold_parallel_on_two_ranks_matches_sequential(ranks):
    cohort, cfg = _cohort(), _cfg()
    _, _, pack = cv_parallel.prepare_folds(
        build_model_and_task, cohort, _folds(cohort), cfg,
        apply_filter=False, device="cpu")
    par = ranks[0]["par"]
    assert len(par.aucs) == pack.n_folds == 3
    assert ranks[1]["par"].aucs == par.aucs
    for f in range(pack.n_folds):
        res, ev = cv.fit_fold(build_model_and_task, dict(zip(
            ("train", "val", "test"), pack.fold_arrays(f, "cpu"))), cfg,
            "cpu")
        seq = [h["Loss/Val"] for h in res.history]
        np.testing.assert_allclose(par.val_history[f][:len(seq)], seq,
                                   **VAL_TOL, err_msg=f"fold {f}")
        assert par.best_epochs[f] == res.best_epoch, f
        assert par.stopped_at[f] == (len(res.history) if res.stopped_early
                                     else -1), f
        np.testing.assert_allclose(par.logits[f], ev.logits, **LOGIT_TOL,
                                   err_msg=f"fold {f}")
        assert par.aucs[f] == pytest.approx(
            cv._softmax_auc(ev.logits, ev.labels), abs=1e-3), f


@pytest.mark.parametrize("harness", ["nested_fold_parallel",
                                     "nested_sequential"])
def test_nested_over_the_mesh_matches_one_process(ranks, harness):
    kw = dict(apply_filter=False, verbose=False, device="cpu")
    want = cv.nested_cv(build_model_and_task, _cohort(), _cfg(num_epochs=2),
                        fold_parallel=harness == "nested_fold_parallel",
                        **kw)
    for r in ranks:
        np.testing.assert_allclose(r[harness]["outer_aucs"],
                                   want["outer_aucs"], atol=1e-3)


def test_tensor_parallel_mesh_is_refused_with_jax_message(ranks):
    from ecgmm_tpu.config import MeshConfig as JaxMeshConfig
    from ecgmm_tpu.parallel import make_mesh as jax_mesh
    from ecgmm_tpu.train.cv_parallel import _fold_axis_sharding

    with pytest.raises(ValueError) as want:
        _fold_axis_sharding(jax_mesh(JaxMeshConfig(n_data=4, n_model=2)))
    for r in ranks:
        assert r["tp_refusal"] == str(want.value)
