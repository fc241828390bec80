"""The signal-only training slice of the port (`ecgmm_torch.data`,
`ecgmm_torch.train`, `ecgmm_torch.workloads`) against the JAX package on
the CPU, at a small size: ResNet1D-SE with base filters 8, 256-sample
signals, dropout 0 on both sides, inputs from numpy seeds.

Bars, and why:
  * data, splits, the epoch plan and the cohort: equal (the same numpy
    draws); the filters within 1e-5 (scipy's filtfilt against the JAX
    scan, both float64, stored as float32);
  * one train step: loss rtol 1e-5; gradients atol 1e-6 (float32 sums in
    another order); the updated parameters and BatchNorm statistics atol
    1e-6, except the convolution biases: every convolution feeds a
    BatchNorm, which removes the bias, so their gradient is zero in exact
    arithmetic and rounding noise (below 1e-7) in float32 whose sign
    differs between the frameworks; Adam's first step moves each such
    bias by up to the learning rate in the noise's direction, so they are
    held to 2 * lr;
  * eval logits atol 1e-5 and the loss rtol 1e-5;
  * a 2-epoch fit: per-epoch losses rtol 1e-3, the same best epoch and
    accuracies: the convolution biases above keep drifting apart by up
    to lr per step; train-mode BatchNorm cancels them, but the eval-mode
    running means lag them, so the val loss differs by ~1e-4 relative;
  * the optimizer: the schedule rtol 1e-5 and atol 1e-10 (optax
    evaluates it in float32, a few roundings of 6e-8 each, and near the
    final value 4e-9 the cosine's float32 error of ~3e-11 dominates),
    Adam's parameters atol 1e-6 after 12 steps.
"""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from sklearn.metrics import f1_score, roc_auc_score
from sklearn.model_selection import train_test_split

from ecgmm_tpu.config import TrainConfig as JaxTrainConfig
from ecgmm_tpu.config import get_preset as jax_get_preset
from ecgmm_tpu.data import pipeline as jax_pipeline
from ecgmm_tpu.data import preprocess as jax_preprocess
from ecgmm_tpu.data import splits as jax_splits
from ecgmm_tpu.data import synthetic as jax_synthetic
from ecgmm_tpu.models import ResNet1DSE as JaxResNet1DSE
from ecgmm_tpu.tools.export_pth import export_resnet1d_se
from ecgmm_tpu.train import engine as jax_engine
from ecgmm_tpu.train import metrics as jax_metrics
from ecgmm_tpu.train import optim as jax_optim
from ecgmm_tpu.train.state import create_state as jax_create_state
from ecgmm_tpu.workloads import make_signal_task as jax_make_signal_task
from ecgmm_tpu.workloads import run as jax_run
from ecgmm_torch.config import Config, ModelConfig, TrainConfig, get_preset
from ecgmm_torch.data import pipeline, preprocess, splits, synthetic
from ecgmm_torch.models.layers import BatchNorm1d, flax_init_
from ecgmm_torch.models.resnet1d_se import ResNet1DSE
from ecgmm_torch.tools.weights import from_jax_resnet1d_se
from ecgmm_torch.train import engine, metrics
from ecgmm_torch.train.checkpoint import CheckpointManager
from ecgmm_torch.train.optim import Optimizer
from ecgmm_torch.train.state import create_state
from ecgmm_torch.workloads import run as port_run
from ecgmm_torch.workloads.tasks import make_signal_task

torch.set_num_threads(2)

T, FILTERS, BS = 256, 8, 10
TRAIN_KW = dict(batch_size=BS, num_epochs=2, loss="focal",
                schedule="onecycle", patience=0, seed=3)


# --------------------------------------------------------------------- data

@pytest.fixture(scope="module")
def cohort():
    """40 synthetic records at 500 Hz, preprocessed to T samples."""
    return synthetic.make_cohort(n=40, signal_len=2 * T, img_hw=None, seed=5)


@pytest.fixture(scope="module")
def both_data(cohort):
    """The same split materialised by both packages (JAX on its CPU
    device, the port on the CPU)."""
    split = splits.stratified_622(cohort.labels, 5)
    jdata = jax_pipeline.materialize_signal(
        cohort.signals, cohort.labels, split,
        preprocess_fn=lambda s: jax_preprocess.preprocess_ptbxl(
            jnp.asarray(s, jnp.float32), length=T))
    pdata = pipeline.materialize_signal(
        cohort.signals, cohort.labels, split,
        preprocess_fn=lambda s: preprocess.preprocess_ptbxl(s, length=T),
        device="cpu")
    return jdata, pdata


@pytest.mark.parametrize("n,seed", [(12, 0), (37, 42)])
def test_make_cohort_bit_equal(n, seed):
    want = jax_synthetic.make_cohort(n=n, signal_len=300, img_hw=(16, 32),
                                     n_clinical=3, seed=seed)
    got = synthetic.make_cohort(n=n, signal_len=300, img_hw=None,
                                n_clinical=3, seed=seed)
    for f in ("indices", "labels", "signals", "clinical",
              "clinical_columns"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert got.images is None
    with_images = synthetic.make_cohort(n=n, signal_len=300, img_hw=(16, 32),
                                        n_clinical=3, seed=seed)
    np.testing.assert_array_equal(with_images.images, want.images)


def _sk_three_way(labels, first, second, seed):
    idx = np.arange(len(labels))
    tr, tmp, _, tmp_y = train_test_split(idx, labels, test_size=first,
                                         stratify=labels, random_state=seed)
    va, te = train_test_split(tmp, test_size=second, stratify=tmp_y,
                              random_state=seed)
    return tr, va, te


@pytest.mark.parametrize("name,first,second", [
    ("stratified_811", 0.2, 0.5), ("stratified_622", 0.4, 0.5),
    ("stratified_712", 0.3, 2 / 3)])
@pytest.mark.parametrize("n,k,seed", [(50, 2, 42), (97, 3, 0), (64, 2, 7),
                                      (120, 4, 11)])
def test_splits_equal_sklearn_and_jax(name, first, second, n, k, seed):
    labels = np.random.default_rng(n * k + seed).integers(0, k, n)
    got = getattr(splits, name)(labels, seed)
    want_jax = getattr(jax_splits, name)(labels, seed)
    want_sk = _sk_three_way(labels, first, second, seed)
    for g, wj, ws in zip(got, want_jax, want_sk):
        np.testing.assert_array_equal(g, wj)
        np.testing.assert_array_equal(g, ws)


@pytest.mark.parametrize("which", ["ptbxl", "ptbxl_padded", "physionet"])
def test_preprocess_matches_jax(cohort, which):
    x = cohort.signals[:6]
    if which == "physionet":
        want = jax_preprocess.preprocess_physionet(jnp.asarray(x))
        got = preprocess.preprocess_physionet(x)
    else:
        length = T if which == "ptbxl" else 300
        want = jax_preprocess.preprocess_ptbxl(jnp.asarray(x), length=length)
        got = preprocess.preprocess_ptbxl(x, length=length)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_materialize_signal_matches_jax(both_data):
    jdata, pdata = both_data
    for name in ("train", "val", "test"):
        j, p = getattr(jdata, name), getattr(pdata, name)
        assert p.n == j.n and p.signals.dtype == torch.float32
        np.testing.assert_allclose(p.signals.numpy(), np.asarray(j.signals),
                                   atol=1e-5)
        np.testing.assert_array_equal(p.labels.numpy(), np.asarray(j.labels))
        np.testing.assert_array_equal(p.indices, j.indices)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,bs,epoch", [(24, 10, 0), (24, 8, 3), (7, 16, 1)])
def test_epoch_indices_match_jax(weighted, n, bs, epoch):
    labels = np.random.default_rng(n).integers(0, 2, n)
    w = port_run.ptbxl_sample_weights(labels, 2) if weighted else None
    kw = dict(shuffle=True, seed=42, epoch=epoch, sample_weights=w)
    got = engine.epoch_indices(n, bs, **kw)
    want = jax_engine.epoch_indices(n, bs, **kw)
    for g, wa in zip(got, want):
        np.testing.assert_array_equal(g, wa)
        assert g.dtype == wa.dtype
    assert pipeline.num_batches(n, bs) == jax_pipeline.num_batches(n, bs)


def test_load_data_matches_jax_signal_task_data():
    """The CLI's data assembly: the same records, labels and splits as the
    JAX `_signal_task_data`, for both preset families."""
    for name in ("ptbxl_af", "physionet_multi"):
        jcfg = jax_get_preset(name)
        jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(
            jcfg.data, signal_len=T))
        pcfg = get_preset(name)
        pcfg = dataclasses.replace(pcfg, data=dataclasses.replace(
            pcfg.data, signal_len=T))
        want = jax_run._signal_task_data(jcfg, "synthetic", 40)
        got = port_run.load_data(pcfg, 40, device="cpu")
        for split in ("train", "val", "test"):
            j, p = getattr(want, split), getattr(got, split)
            np.testing.assert_array_equal(p.indices, j.indices)
            np.testing.assert_array_equal(p.labels.numpy(),
                                          np.asarray(j.labels))
            np.testing.assert_allclose(p.signals.numpy(),
                                       np.asarray(j.signals), atol=1e-5)


# ---------------------------------------------------------------- optimizer

@pytest.mark.parametrize("steps,epochs", [(3, 10), (1, 1), (2, 1), (7, 3)])
def test_onecycle_schedule_equals_optax(steps, epochs):
    cfg = TrainConfig(schedule="onecycle", num_epochs=epochs,
                      onecycle_peak_lr=1e-3)
    opt = Optimizer([torch.nn.Parameter(torch.zeros(1))], cfg, steps)
    want = optax.cosine_onecycle_schedule(
        transition_steps=max(steps * epochs, 4), peak_value=1e-3)
    for k in range(max(steps * epochs, 4) + 3):
        np.testing.assert_allclose(opt.schedule(k), float(want(k)),
                                   rtol=1e-5, atol=1e-10, err_msg=str(k))
    assert opt.get_lr() is None  # as optax.adam(schedule): nothing injected


@pytest.mark.parametrize("schedule", ["constant", "onecycle"])
def test_adam_equals_optax(rng, schedule):
    jcfg = JaxTrainConfig(schedule=schedule, lr=3e-3, num_epochs=3)
    cfg = TrainConfig(schedule=schedule, lr=3e-3, num_epochs=3)
    w0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = rng.normal(size=(12, 5, 4)).astype(np.float32) * \
        np.logspace(-3, 1, 12, dtype=np.float32)[:, None, None]
    tx = jax_optim.make_optimizer(jcfg, steps_per_epoch=4)
    params = jnp.asarray(w0)
    opt_state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = Optimizer([p], cfg, steps_per_epoch=4)
    for k, g in enumerate(grads):
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g)
        opt.step(k)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                                   atol=1e-6, err_msg=str(k))


def test_scale_lr_on_constant_schedule():
    cfg = TrainConfig(schedule="constant", lr=1e-3)
    jcfg = JaxTrainConfig(schedule="constant", lr=1e-3)
    opt = Optimizer([torch.nn.Parameter(torch.zeros(2))], cfg)
    jstate = jax_optim.make_optimizer(jcfg).init(jnp.zeros(2))
    assert opt.get_lr() == pytest.approx(jax_optim.get_lr(jstate))
    opt.scale_lr(0.1)
    jstate = jax_optim.scale_lr(jstate, 0.1)
    assert opt.get_lr() == pytest.approx(jax_optim.get_lr(jstate), rel=1e-6)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        Optimizer([torch.nn.Parameter(torch.zeros(1))],
                  TrainConfig(schedule="onecycle"))


# -------------------------------------------------------------------- model

def test_batchnorm_train_mode_is_flax(rng):
    """Batch statistics normalise with the biased variance, and the
    biased variance is folded into running_var with momentum 0.1."""
    x = torch.from_numpy(rng.normal(2.0, 3.0, size=(4, 3, 5)).astype(
        np.float32))
    bn = BatchNorm1d(3).train()
    out = bn(x)
    var, mean = torch.var_mean(x, dim=(0, 2), unbiased=False)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 + 0.1 * var.numpy(), atol=1e-6)
    want = (x - mean[None, :, None]) / torch.sqrt(var[None, :, None] + 1e-5)
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(), atol=1e-5)
    # torch's own module folds the unbiased variance: a different result
    ref = torch.nn.BatchNorm1d(3).train()
    ref(x)
    assert not torch.allclose(ref.running_var, bn.running_var, atol=1e-3)


def test_flax_init_distribution():
    model = flax_init_(ResNet1DSE(2, 1, 16),
                       torch.Generator().manual_seed(0))
    w = model.layer2.conv1.weight  # fan_in 16 * 3
    std = (1.0 / 48) ** 0.5
    w = w.detach()
    assert abs(float(w.std()) - std) < 0.1 * std
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.Linear)):
            assert float(m.bias.abs().max()) == 0.0
        if isinstance(m, torch.nn.BatchNorm1d):
            assert float(m.weight.min()) == 1.0 == float(m.running_var[0])


@pytest.fixture(scope="module")
def jax_init():
    """A JAX ResNet1D-SE (dropout 0), its variables and its train config."""
    jmodel = JaxResNet1DSE(num_classes=2, base_filters=FILTERS, dropout=0.0)
    variables = jax.device_get(
        jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, T, 1))))
    return jmodel, variables


def _port_model(variables):
    model = ResNet1DSE(2, 1, FILTERS, dropout=0.0)
    model.load_state_dict(from_jax_resnet1d_se(variables), strict=True)
    return model


def test_weights_bridge_equals_jax_exporter(jax_init):
    _, variables = jax_init
    got = from_jax_resnet1d_se(variables)
    want = export_resnet1d_se(variables)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == np.asarray(v).dtype, k
        assert np.array_equal(got[k].numpy(), v), k


# --------------------------------------------------------------- train step

def _batches(data_split, bs):
    """The JAX and port batches of a fixed (unshuffled) plan, the last one
    padded with index 0 and mask 0."""
    idx, mask = engine.epoch_indices(data_split[1].n, bs, shuffle=False,
                                     seed=0, epoch=0)
    jarr, parr = data_split
    for i in range(idx.shape[0]):
        jb = jax_pipeline.Batch(
            None, jnp.take(jarr.signals, idx[i], axis=0), None,
            jnp.take(jarr.labels, idx[i], axis=0), jnp.asarray(mask[i]))
        pb = engine.gather_batch(parr, torch.from_numpy(idx[i].astype(
            np.int64)), torch.from_numpy(mask[i]))
        yield jb, pb


def test_train_step_matches_jax(jax_init, both_data):
    jmodel, variables = jax_init
    jdata, pdata = both_data
    jcfg, cfg = JaxTrainConfig(**TRAIN_KW), TrainConfig(**TRAIN_KW)
    steps = pipeline.num_batches(pdata.train.n, BS)
    tx = jax_optim.make_optimizer(jcfg, steps)
    jstate = jax_create_state(variables, tx, jax.random.PRNGKey(0))
    jtask = jax_make_signal_task(jmodel, jcfg)
    model = _port_model(variables)
    state = create_state(model, cfg, steps)
    task = make_signal_task(cfg)
    # the train split's last batch: 4 real rows and 6 pad rows of index 0
    *_, (jb, pb) = _batches((jdata.train, pdata.train), BS)
    assert float(pb.mask.sum()) < BS

    def jloss(params):
        out, _ = jtask.apply({"params": params, **jstate.model_state}, jb,
                             train=True, rngs={"dropout": jstate.rng})
        return jtask.loss(out, jb)[0]

    jgrads = jax.device_get(jax.grad(jloss)(jstate.trainable))
    jnew, jmets = jax_engine.make_train_step(jtask, tx, donate=False)(
        jstate, jb)
    mets = engine.train_step(task, state, pb)
    assert state.step == 1
    np.testing.assert_allclose(float(mets["loss"]), float(jmets["loss"]),
                               rtol=1e-5)
    assert float(mets["correct"]) == float(jmets["correct"])
    assert float(mets["count"]) == float(jmets["count"])

    want_grads = from_jax_resnet1d_se(
        {"params": jgrads, "batch_stats": variables["batch_stats"]})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   atol=1e-6, err_msg=name)

    want = from_jax_resnet1d_se(jax.device_get(
        {"params": jnew.trainable, **jnew.model_state}))
    conv_biases = {f"{n}.bias" for n, m in model.named_modules()
                   if isinstance(m, torch.nn.Conv1d)}
    lr0 = state.optimizer.schedule(0)
    for name, got in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        atol = 2 * lr0 if name in conv_biases else 1e-6
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   atol=atol, err_msg=name)
    # the biased running variance moved: pad rows entered the statistics
    assert not np.allclose(model.initial[1].running_var.numpy(), 1.0)


def test_eval_matches_jax_evaluate_scan(jax_init, both_data):
    jmodel, variables = jax_init
    jdata, pdata = both_data
    jcfg, cfg = JaxTrainConfig(**TRAIN_KW), TrainConfig(**TRAIN_KW)
    tx = jax_optim.make_optimizer(jcfg, 3)
    jstate = jax_create_state(variables, tx, jax.random.PRNGKey(0))
    jtask = jax_make_signal_task(jmodel, jcfg)
    # one train step first, so the BatchNorm running statistics matter
    jb, _ = next(_batches((jdata.train, pdata.train), BS))
    jstate, _ = jax_engine.make_train_step(jtask, tx, donate=False)(
        jstate, jb)
    model = _port_model(jax.device_get(
        {"params": jstate.trainable, **jstate.model_state}))
    state = create_state(model, cfg, 3)
    for split in ("val", "test", "train"):
        want = jax_engine.evaluate_scan(jtask, jstate, getattr(jdata, split),
                                        BS)
        got = engine.evaluate(make_signal_task(cfg), state,
                              getattr(pdata, split), BS)
        np.testing.assert_allclose(got.logits, want.logits, atol=1e-5)
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_allclose(got.loss, want.loss, rtol=1e-5)
        assert got.accuracy == want.accuracy
    empty = engine.evaluate(make_signal_task(cfg), state,
                            pdata.val._replace(
                                signals=pdata.val.signals[:0],
                                labels=pdata.val.labels[:0],
                                indices=pdata.val.indices[:0]), BS)
    assert np.isnan(empty.loss) and empty.logits.shape == (0, 2)


# ---------------------------------------------------------------------- fit

def _weights(pdata):
    return port_run.ptbxl_sample_weights(pdata.train.labels.numpy(), 2)


def test_fit_matches_jax(jax_init, both_data):
    jmodel, variables = jax_init
    jdata, pdata = both_data
    jcfg, cfg = JaxTrainConfig(**TRAIN_KW), TrainConfig(**TRAIN_KW)
    steps = pipeline.num_batches(pdata.train.n, BS)
    tx = jax_optim.make_optimizer(jcfg, steps)
    jres = jax_engine.fit(
        jax_make_signal_task(jmodel, jcfg),
        jax_create_state(variables, tx, jax.random.PRNGKey(0)), tx,
        jdata.train, jdata.val, jcfg, verbose=False,
        train_sample_weights=_weights(pdata))
    state = create_state(_port_model(variables), cfg, steps)
    res = engine.fit(make_signal_task(cfg), state, pdata.train, pdata.val,
                     cfg, verbose=False, train_sample_weights=_weights(pdata))
    assert len(res.history) == len(jres.history) == 2
    for got, want in zip(res.history, jres.history):
        for key in ("Loss/Train", "Loss/Val"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-3,
                                       err_msg=key)
        for key in ("Accuracy/Train", "Accuracy/Val"):
            assert got[key] == want[key], key
        assert "LR" not in got and "LR" not in want  # onecycle
    assert res.best_epoch == jres.best_epoch
    assert state.epoch == 2 and state.step == 2 * steps
    assert state.best_val_loss == pytest.approx(
        float(jres.state.best_val_loss), rel=1e-3)


def test_resume_equals_uninterrupted_run(jax_init, both_data, tmp_path):
    _, variables = jax_init
    _, pdata = both_data
    cfg = TrainConfig(**TRAIN_KW)
    steps = pipeline.num_batches(pdata.train.n, BS)
    task = make_signal_task(cfg)

    def fresh():
        return create_state(_port_model(variables), cfg, steps)

    whole = fresh()
    res = engine.fit(task, whole, pdata.train, pdata.val, cfg,
                     ckpt=CheckpointManager(str(tmp_path / "a")),
                     verbose=False, train_sample_weights=_weights(pdata))
    # stop after epoch 0 (same optimizer schedule), then resume
    ckpt = CheckpointManager(str(tmp_path / "b"))
    engine.fit(task, fresh(), pdata.train, pdata.val,
               dataclasses.replace(cfg, num_epochs=1), ckpt=ckpt,
               verbose=False, train_sample_weights=_weights(pdata))
    resumed = ckpt.restore("last", fresh())
    assert resumed.epoch == 1 and resumed.step == steps
    res2 = engine.fit(task, resumed, pdata.train, pdata.val, cfg, ckpt=ckpt,
                      verbose=False, train_sample_weights=_weights(pdata))
    assert res2.history[0]["Loss/Train"] == res.history[1]["Loss/Train"]
    assert res2.history[0]["Loss/Val"] == res.history[1]["Loss/Val"]
    for k, v in whole.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    for k in ("step", "epoch", "best_val_loss", "early_stop_counter",
              "lr_reduce_counter"):
        assert getattr(whole, k) == getattr(resumed, k), k
    assert torch.equal(whole.generator.get_state(),
                       resumed.generator.get_state())


def test_sigterm_finishes_epoch_and_saves_last(jax_init, both_data,
                                               tmp_path):
    _, variables = jax_init
    _, pdata = both_data
    cfg = TrainConfig(**dict(TRAIN_KW, num_epochs=3))
    base = make_signal_task(cfg)
    sent = []

    def apply(model, batch):
        if not sent:
            sent.append(1)
            os.kill(os.getpid(), signal.SIGTERM)
        return base.apply(model, batch)

    task = engine.Task(apply=apply, loss=base.loss, logits=base.logits)
    ckpt = CheckpointManager(str(tmp_path))
    before = signal.getsignal(signal.SIGTERM)
    state = create_state(_port_model(variables), cfg,
                         pipeline.num_batches(pdata.train.n, BS))
    res = engine.fit(task, state, pdata.train, pdata.val, cfg, ckpt=ckpt,
                     verbose=False)
    assert res.preempted and len(res.history) == 1
    assert ckpt.load("last")["epoch"] == 1
    assert signal.getsignal(signal.SIGTERM) == before


def test_plateau_decay_and_early_stop(jax_init, both_data, monkeypatch):
    """The JAX test's control sequence: val loss 1.0 then 2.0 forever ->
    stop after `patience` stale epochs, the LR divided by 10 every
    `plateau_patience` of them."""
    _, variables = jax_init
    _, pdata = both_data
    cfg = TrainConfig(batch_size=BS, num_epochs=12, lr=1e-3,
                      schedule="constant", patience=5, plateau_patience=2)
    seq = iter([1.0] + [2.0] * 20)

    def fake_evaluate(task, state, arrays, batch_size):
        return engine.EvalResult(next(seq), 0.5, np.zeros((0, 2)),
                                 np.zeros(0), {})

    monkeypatch.setattr(engine, "evaluate", fake_evaluate)
    state = create_state(_port_model(variables), cfg, 3)
    res = engine.fit(make_signal_task(cfg), state, pdata.train, pdata.val,
                     cfg, verbose=False)
    assert res.stopped_early and len(res.history) == 6 and res.best_epoch == 0
    lrs = [h["LR"] for h in res.history]
    # decays after the 2nd and 4th stale epochs (logged the epoch after)
    np.testing.assert_allclose(lrs, [1e-3, 1e-3, 1e-3, 1e-4, 1e-4, 1e-5],
                               rtol=1e-6)


def test_nonfinite_val_loss_carries_no_signal(jax_init, both_data,
                                              monkeypatch):
    _, variables = jax_init
    _, pdata = both_data
    cfg = TrainConfig(batch_size=BS, num_epochs=4, schedule="constant",
                      patience=2, plateau_patience=1)

    def nan_evaluate(task, state, arrays, batch_size):
        return engine.EvalResult(float("nan"), float("nan"), np.zeros((0, 2)),
                                 np.zeros(0), {})

    monkeypatch.setattr(engine, "evaluate", nan_evaluate)
    state = create_state(_port_model(variables), cfg, 3)
    res = engine.fit(make_signal_task(cfg), state, pdata.train, pdata.val,
                     cfg, verbose=False)
    assert not res.stopped_early and len(res.history) == 4
    assert res.best_epoch == -1 and state.early_stop_counter == 0
    assert state.optimizer.get_lr() == pytest.approx(cfg.lr)


# ------------------------------------------------------------------ metrics

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax_and_sklearn(seed):
    rs = np.random.default_rng(seed)
    n = 41
    labels = rs.integers(0, 2, n)
    scores = np.round(rs.random(n), 2).astype(np.float32)  # with ties
    preds = (scores >= 0.5).astype(np.int32)
    assert metrics.auroc(scores, labels) == pytest.approx(
        roc_auc_score(labels, scores), abs=1e-12)
    assert metrics.auroc(scores, labels) == pytest.approx(
        float(jax_metrics.auroc(jnp.asarray(scores), jnp.asarray(labels))),
        abs=1e-6)
    assert metrics.binary_f1(preds, labels) == pytest.approx(
        f1_score(labels, preds), abs=1e-7)
    assert metrics.find_best_threshold(labels, scores) == pytest.approx(
        jax_metrics.find_best_threshold(labels, scores), abs=1e-6)
    assert metrics.summarize_binary(scores, labels) == pytest.approx(
        jax_metrics.summarize_binary(scores, labels), abs=1e-6)
    assert np.isnan(metrics.auroc(scores, np.zeros(n, np.int64)))

    y3 = rs.integers(0, 3, n)
    probs = rs.dirichlet(np.ones(3), n).astype(np.float32)
    p3 = probs.argmax(-1)
    assert metrics.macro_f1(p3, y3, 3) == pytest.approx(
        float(jax_metrics.macro_f1(jnp.asarray(p3), jnp.asarray(y3), 3)),
        abs=1e-6)
    assert metrics.auroc_ovr_macro(probs, y3, 3) == pytest.approx(
        float(jax_metrics.auroc_ovr_macro(jnp.asarray(probs),
                                          jnp.asarray(y3), 3)), abs=1e-6)
    np.testing.assert_array_equal(metrics.confusion_matrix(p3, y3, 3),
                                  jax_metrics.confusion_matrix(p3, y3, 3))
    assert metrics.classification_report(p3, y3, 3) == \
        jax_metrics.classification_report(p3, y3, 3)


# --------------------------------------------------------------- end to end

def _small_cfg(name, tmp_path, epochs=2):
    cfg = get_preset(name)
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, signal_len=T),
        model=dataclasses.replace(cfg.model, signal_base_filters=FILTERS),
        train=dataclasses.replace(
            cfg.train, num_epochs=epochs,
            checkpoint_dir=str(tmp_path / "ckpt"),
            log_dir=str(tmp_path / "runs"),
            output_dir=str(tmp_path / "output")),
    )


@pytest.mark.parametrize("name", ["ptbxl_af", "physionet_multi"])
def test_run_end_to_end_on_cpu(name, tmp_path):
    cfg = _small_cfg(name, tmp_path)
    data = port_run.load_data(cfg, 40, device="cpu")
    result, results = port_run.run(cfg, data, run_dir=str(tmp_path / "r"),
                                   verbose=False, device="cpu")
    assert len(result.history) == 2
    assert all(np.isfinite(h["Loss/Train"]) for h in result.history)
    keys = ({"threshold", "accuracy", "f1", "auroc"} if name == "ptbxl_af"
            else {"accuracy", "f1_macro", "auroc_ovr"})
    for tag in ("best", "last"):
        assert keys | {"temperature"} <= set(results[tag])
        assert os.path.isfile(tmp_path / "output" / "r" / f"report_{tag}.txt")
    assert not list((tmp_path / "output" / "r").glob("*.png"))
    ckpt = CheckpointManager(str(tmp_path / "r"))
    for tag in ("best", "last", "calibration"):
        assert ckpt.exists(tag)
    assert set(ckpt.load("calibration")) == {"temperature_best",
                                             "temperature_last"}
    log = (tmp_path / "runs" / "r" / "metrics.jsonl").read_text()
    assert len(log.splitlines()) == 2

    # --resume continues from `last`: nothing left to train
    resumed, _ = port_run.run(cfg, data, run_dir=str(tmp_path / "r"),
                              verbose=False, resume=True, device="cpu")
    assert resumed.history == [] and resumed.state.epoch == 2


def test_run_refuses_mismatched_device_and_unported_presets(tmp_path):
    cfg = _small_cfg("ptbxl_af", tmp_path)
    data = port_run.load_data(cfg, 40, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_run.run(cfg, data, device="cuda")
    # every preset of the JAX package is ported; a name that is no preset
    # is refused, and the message names the presets
    model, _, freeze = port_run.build_model_and_task(
        Config(name="image_only"), "cpu")
    assert type(model).__name__ == "ResNet18" and freeze is None
    assert get_preset("fusion_cached").train.cache_embeddings
    assert get_preset("signal_only").train.batch_size == 8
    model, _, freeze = port_run.build_model_and_task(
        get_preset("physionet_crnn"), "cpu")
    assert type(model).__name__ == "CRNN" and freeze("bilstm.bias_hh_l0")
    assert get_preset("signal_af").train.batch_size == 8
    with pytest.raises(ValueError, match="unknown preset"):
        port_run.build_model_and_task(Config(name="physionet_lstm"), "cpu")
    with pytest.raises(KeyError, match="ptbxl_af"):
        get_preset("physionet_lstm")
    assert ModelConfig().signal_base_filters == 64
