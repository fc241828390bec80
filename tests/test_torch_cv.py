"""The sequential CV slice of the port (`ecgmm_torch.train.cv`,
`engine.fit(keep_best=True)`, `cross_dataset_eval`, the CLI) against
the JAX package on the CPU, at a small size: ResNet1D-SE with base
filters 8 on 192-sample signals, 40-60 records, the port starting from
JAX's initial weights with dropout 0 (the frameworks' generators
differ). tests/test_torch_cv_fusion.py holds the fusion side.

Bars, and why:
  * `fit(keep_best=True)`: per-epoch losses rtol 1e-3 (the training
    bar of tests/test_torch_train.py); the best state's parameters atol
    1e-6, but the convolution biases that feed a BatchNorm, whose
    gradient is rounding noise of either sign, and the running means that
    carry them within 2 Σlr; running variances rtol and atol 1e-4, the
    counters equal;
  * fold AUCs within 1e-3 (test rows of a dozen: equal rankings);
  * harness bookkeeping (fold order, grouping, means): exact, with the
    fold fit replaced by the same function of the split on both sides;
  * `cross_dataset_eval` on one `.pth`: threshold, accuracy, F1 and AUC
    within 1e-5.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from ecgmm_tpu.config import Config as JaxConfig
from ecgmm_tpu.config import ModelConfig as JaxModelConfig
from ecgmm_tpu.config import TrainConfig as JaxTrainConfig
from ecgmm_tpu.data import synthetic as jax_synthetic
from ecgmm_tpu.models import ResNet1DSE as JaxResNet1DSE
from ecgmm_tpu.models import jit_init
from ecgmm_tpu.tools import convert_pth
from ecgmm_tpu.train import cv as jax_cv
from ecgmm_tpu.train import engine as jax_engine
from ecgmm_tpu.train import optim as jax_optim
from ecgmm_tpu.train.state import create_state as jax_create_state
from ecgmm_tpu.workloads import make_signal_task as jax_signal_task
from ecgmm_tpu.workloads.run import build_model_and_task as jax_build
from ecgmm_torch.config import Config, ModelConfig, TrainConfig
from ecgmm_torch.data import preprocess, splits, synthetic
from ecgmm_torch.data.pipeline import num_batches
from ecgmm_torch.models.resnet1d_se import ResNet1DSE
from ecgmm_torch.tools.weights import from_jax_resnet1d_se
from ecgmm_torch.train import cv, engine
from ecgmm_torch.train.checkpoint import CheckpointManager
from ecgmm_torch.train.state import create_state
from ecgmm_torch.workloads.run import build_model_and_task

torch.set_num_threads(2)
T, FILTERS = 192, 8


def _train_kw(**kw):
    out = dict(batch_size=16, num_epochs=3, lr=1e-3, loss="focal",
               schedule="constant", freeze_encoders=False, k_outer=2,
               k_inner=2, patience=2, plateau_patience=1)
    out.update(kw)
    return out


def _signal_cfgs(**kw):
    t = _train_kw(**kw)
    port = Config(name="signal_only", train=TrainConfig(**t),
                  model=ModelConfig(num_classes=2, dropout=0.0,
                                    signal_base_filters=FILTERS),
                  data=dataclasses.replace(Config().data, signal_len=T))
    jax_cfg = JaxConfig(name="signal_only",
                        train=JaxTrainConfig(**t, donate_state=False),
                        model=JaxModelConfig(num_classes=2),
                        data=dataclasses.replace(JaxConfig().data,
                                                 signal_len=T))
    return port, jax_cfg


def jax_signal_make(c):
    """JAX's signal_only build at FILTERS filters and dropout 0 (its
    presets build ResNet1D-SE at 64 filters and dropout 0.3 whatever
    ModelConfig says)."""
    _, _, init_args, freeze = jax_build(c)
    model = JaxResNet1DSE(num_classes=2, base_filters=FILTERS, dropout=0.0)
    return model, jax_signal_task(model, c.train), init_args, freeze


def _port_make(jax_make, jax_cfg, convert):
    """The port's build loading the initial weights the JAX harness draws
    (`jit_init` from PRNGKey(seed))."""
    model, _, init_args, _ = jax_make(jax_cfg)
    sd = convert(jax.device_get(jit_init(
        model, jax.random.PRNGKey(jax_cfg.train.seed), *init_args)))

    def make(c, device="cpu"):
        m, task, freeze = build_model_and_task(c, device)
        m.load_state_dict(sd, strict=True)
        return m, task, freeze

    return make


def _cohort(n=48, **kw):
    return (synthetic.make_cohort(n=n, signal_len=T, img_hw=(16, 32), **kw),
            jax_synthetic.make_cohort(n=n, signal_len=T, img_hw=(16, 32),
                                      **kw))


def _fold0(labels):
    return next(splits.nested_kfold(labels, 2, 2, 42))[2][0]


# ----------------------------------------------------- fit(keep_best=True)

def test_fit_keep_best_equals_jax():
    """A fit whose best epoch is not its last (the val rows' labels are
    flipped, so the val loss rises as the model learns): the best state
    (parameters, buffers, counters) equals JAX's `best_state`, and later
    epochs leave it as it was taken."""
    cohort, jcohort = _cohort()
    split = _fold0(cohort.labels)
    labels = cohort.labels.copy()
    labels[split.val] = 1 - labels[split.val]
    cohort = cohort._replace(labels=labels)
    jcohort = jcohort._replace(labels=labels.copy())
    cfg, jcfg = _signal_cfgs(num_epochs=3, lr=5e-4, batch_size=8,
                             patience=0, plateau_patience=0)
    n_clin = 2
    es = preprocess.Scaler.fit(cohort.signals[split.train])
    cs = preprocess.Scaler.fit(cohort.clinical[split.train, :n_clin])
    tr, va = (cv._build_arrays(cohort, idx, es, cs, False, n_clin, "cpu")
              for idx in split[:2])
    jtr, jva = (jax_cv._build_arrays(jcohort, idx, es, cs, False, n_clin)
                for idx in split[:2])
    jmodel, jtask, init_args, _ = jax_signal_make(jcfg)
    variables = jit_init(jmodel, jax.random.PRNGKey(0), *init_args)
    tx = jax_optim.make_optimizer(jcfg.train, num_batches(tr.n, 8))
    jres = jax_engine.fit(jtask, jax_create_state(
        variables, tx, jax.random.PRNGKey(0)), tx, jtr, jva, jcfg.train,
        verbose=False, keep_best=True)
    model = ResNet1DSE(num_classes=2, base_filters=FILTERS, dropout=0.0)
    model.load_state_dict(from_jax_resnet1d_se(jax.device_get(variables)))
    state = create_state(model, cfg.train, num_batches(tr.n, 8))
    task = build_model_and_task(cfg, "cpu")[1]
    res = engine.fit(task, state, tr, va, cfg.train, verbose=False,
                     keep_best=True)
    for got, want in zip(res.history, jres.history):
        for key in ("Loss/Train", "Loss/Val"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-3)
    assert res.best_epoch == jres.best_epoch < len(res.history) - 1
    best, jbest = res.best_state, jax.device_get(jres.best_state)
    assert best["epoch"] == int(jbest.epoch) == res.best_epoch + 1
    assert best["step"] == int(jbest.step)
    assert best["early_stop_counter"] == int(jbest.early_stop_counter) == 0
    assert best["best_val_loss"] == pytest.approx(
        float(jbest.best_val_loss), rel=1e-3)
    want = from_jax_resnet1d_se({"params": jbest.params,
                                 **jbest.model_state})
    sum_lr = 5e-4 * best["step"]
    conv_biases = {n + ".bias" for n, m in model.named_modules()
                   if isinstance(m, torch.nn.Conv1d)}
    errs = {}
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        errs[name] = np.abs(best["model"][name].numpy() - w.numpy()).max()
        if name.endswith("running_var"):
            np.testing.assert_allclose(best["model"][name].numpy(),
                                       w.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=name)
        elif name in conv_biases or name.endswith("running_mean"):
            # a running mean tracks the batch mean, which carries the
            # bias of the convolution before it
            assert errs[name] <= 2 * sum_lr, name
        else:
            assert errs[name] <= 1e-6, (name, errs[name])
    # the snapshot aliases nothing the later epochs updated in place
    assert not torch.equal(best["model"]["classifier.1.weight"],
                           state.model.classifier[1].weight.detach())


def test_fit_keep_best_is_none_when_no_epoch_improves():
    """Every val loss NaN: no epoch improves, `best_state` is None (JAX's
    fit gives None there too) and `cv._fold_auc` scores the final state."""
    cohort, _ = _cohort(n=40)
    cfg, _ = _signal_cfgs(num_epochs=2)
    r = np.arange(40)
    split = splits.Split(train=r[:24], val=r[24:30], test=r[30:])
    sig = cohort.signals.copy()
    sig[24:30] = np.nan
    cohort = cohort._replace(signals=sig)
    es = preprocess.Scaler.fit(sig[split.train])
    cs = preprocess.Scaler.fit(cohort.clinical[split.train, :2])
    tr, va = (cv._build_arrays(cohort, idx, es, cs, False, 2, "cpu")
              for idx in split[:2])
    model, task, _ = build_model_and_task(cfg, "cpu")
    state = create_state(model, cfg.train, 2)
    res = engine.fit(task, state, tr, va, cfg.train, verbose=False,
                     keep_best=True)
    assert res.best_state is None and res.best_epoch == -1
    assert np.isfinite(cv._fold_auc(build_model_and_task, cohort, split,
                                    cfg, False, "cpu"))


# ------------------------------------------------------------- fold AUCs

def test_fold_auc_equals_jax_signal():
    cohort, jcohort = _cohort()
    cfg, jcfg = _signal_cfgs(num_epochs=2, lr=5e-4)
    split = _fold0(cohort.labels)
    want = jax_cv._fold_auc(jax_signal_make, jcohort, split, jcfg, None,
                            False)
    make = _port_make(jax_signal_make, jcfg, from_jax_resnet1d_se)
    got = cv._fold_auc(make, cohort, split, cfg, False, "cpu")
    assert got == pytest.approx(want, abs=1e-3)


def test_fold_auc_raises_preempted(monkeypatch):
    """SIGTERM inside a fold's fit: `_fold_auc` raises `engine.Preempted`
    instead of scoring the short fold (tests/test_preemption.py's case)."""
    cohort, _ = _cohort(n=40)
    cfg, _ = _signal_cfgs(num_epochs=1, batch_size=8)
    real_fit = engine.fit

    def preempted_fit(*a, **k):
        return dataclasses.replace(real_fit(*a, **k), preempted=True)

    monkeypatch.setattr(engine, "fit", preempted_fit)
    with pytest.raises(engine.Preempted):
        cv._fold_auc(build_model_and_task, cohort,
                     splits.stratified_811(cohort.labels, 42), cfg, False,
                     "cpu")


def _fake_auc(cohort, split):
    """A fold 'AUC' that depends on the split alone; NaN for one fold."""
    v = float(np.mean(split.test) / len(cohort.labels)
              + np.mean(split.val) / 1000.0)
    return float("nan") if split.val[0] == 1 else v


def test_harnesses_group_and_average_as_jax(monkeypatch):
    """nested_cv's outer grouping and means and exhaustive_cv's pair order
    and `max_pairs`, with the fold fit replaced by one function of the
    split on both sides: the same numbers, NaN folds included."""
    cohort, jcohort = _cohort(n=60)
    cfg, jcfg = _signal_cfgs(k_outer=3, k_inner=2)
    monkeypatch.setattr(cv, "_fold_auc",
                        lambda mk, c, s, *a: _fake_auc(c, s))
    monkeypatch.setattr(jax_cv, "_fold_auc",
                        lambda mk, c, s, *a: _fake_auc(c, s))
    def same(got, want):
        assert set(got) == set(want)
        for k in want:
            g, w = got[k], want[k]
            if k == "pairs":
                assert [p[:2] for p in g] == [p[:2] for p in w]
                g, w = [p[2] for p in g], [p[2] for p in w]
            np.testing.assert_array_equal(g, w)

    got = cv.nested_cv(None, cohort, cfg, apply_filter=False, verbose=False,
                       device="cpu")
    same(got, jax_cv.nested_cv(None, jcohort, jcfg, apply_filter=False,
                               verbose=False))
    for max_pairs in (None, 5):
        got = cv.exhaustive_cv(None, cohort, cfg, k=4, apply_filter=False,
                               max_pairs=max_pairs, verbose=False,
                               device="cpu")
        same(got, jax_cv.exhaustive_cv(None, jcohort, jcfg, k=4,
                                       apply_filter=False,
                                       max_pairs=max_pairs, verbose=False))
        assert len(got["pairs"]) == (max_pairs or 12)
        assert np.isnan([p[2] for p in got["pairs"]]).any()


# ------------------------------------------------------- cross-dataset

def test_cross_dataset_eval_and_cli_equal_jax(tmp_path, capsys):
    """One reference-format `.pth` (a ResNet1D-SE state dict written by
    torch.save): JAX reads it through `convert_pth`, the port loads it
    strictly; the metrics agree, and the port's CLI prints them for
    `--pth` and for a port checkpoint (`--ckpt`)."""
    model = ResNet1DSE(num_classes=2)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    pth = tmp_path / "best.pth"
    torch.save(model.state_dict(), pth)
    length = 512
    cohort = synthetic.make_cohort(n=24, signal_len=600, img_hw=(16, 32))
    want = jax_cv.cross_dataset_eval(
        JaxResNet1DSE(num_classes=2),
        convert_pth.convert_resnet1d_se(
            convert_pth.load_torch_state_dict(str(pth))),
        cohort.signals, cohort.labels, length=length)
    loaded = ResNet1DSE(num_classes=2)
    loaded.load_state_dict(torch.load(pth, weights_only=True), strict=True)
    got = cv.cross_dataset_eval(loaded, cohort.signals, cohort.labels,
                                length=length)
    assert set(got) == set(want) == {"accuracy", "f1", "auroc",
                                     "threshold"}
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), abs=1e-5), k

    state = create_state(loaded, TrainConfig())
    CheckpointManager(str(tmp_path / "ckpt")).save("best", state)
    synth = synthetic.make_cohort(n=16, signal_len=length, img_hw=(16, 32))
    expected = cv.cross_dataset_eval(loaded, synth.signals, synth.labels,
                                     length=length)
    for flag, path in (("--pth", pth), ("--ckpt",
                                         tmp_path / "ckpt" / "best.pt")):
        cv.main(["cross", flag, str(path), "--n-synth", "16", "--length",
                 str(length), "--device", "cpu"])
        printed = json.loads(capsys.readouterr().out)
        assert printed == pytest.approx(expected, abs=1e-6), flag


@pytest.mark.parametrize("argv", [
    ["cross"],
    ["nested", "--preset", "signal_12lead"],
    ["nested", "--preset", "physionet_crnn"],
    ["exhaustive", "--max-pairs", "0"],
], ids=["no_checkpoint", "signal_12lead", "physionet_crnn", "max_pairs_0"])
def test_cli_errors_match_jax(argv, capsys):
    with pytest.raises(SystemExit) as e_jax:
        jax_cv.main(argv)
    want = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as e_port:
        cv.main(argv)
    got = capsys.readouterr().err.splitlines()[-1]
    assert e_port.value.code == e_jax.value.code == 2
    assert got.split("error: ")[1] == want.split("error: ")[1].replace(
        "ecgmm_tpu", "ecgmm_torch").replace(" — ", "; ")
