"""Three repairs of the port against the JAX package on the CPU:

  * `TrainConfig.weight_decay`: the coupled decay g + wd * p before Adam,
    against JAX's `make_optimizer` (optax.add_decayed_weights chained
    before adam) over one and three steps under both schedules, and the
    plateau decay still reaching the learning rate through the chain;
    parameters within 1e-6 (float32 Adam in another order);
  * `TrainConfig.debug_nans`: a fit over a NaN input raises
    FloatingPointError in both packages, and the setting (JAX's
    `jax_debug_nans`; torch's anomaly detection, which the port's fit turns
    on with it) is back as it was for the next fit in the process;
  * the test report's PNGs: `confusion_{tag}.png`, and `roc_{tag}.png` for
    two classes, JAX's file set; the counts in the confusion PNG's tEXt
    chunk equal JAX's confusion matrix, and the ROC points in the ROC
    PNG's equal those JAX's report plots, to 1e-12.

Each fails on the code before the repair (TrainConfig had neither field;
the report wrote no PNG).
"""

import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import matplotlib.axes
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from ecgmm_tpu.config import TrainConfig as JaxTrainConfig
from ecgmm_tpu.data import pipeline as jax_pipeline
from ecgmm_tpu.data import splits as jax_splits
from ecgmm_tpu.models import ResNet1DSE as JaxResNet1DSE
from ecgmm_tpu.train import engine as jax_engine
from ecgmm_tpu.train import metrics as jax_metrics
from ecgmm_tpu.train import optim as jax_optim
from ecgmm_tpu.train import report as jax_report
from ecgmm_tpu.train.state import create_state as jax_create_state
from ecgmm_tpu.workloads import make_signal_task as jax_make_signal_task
from ecgmm_torch.config import TrainConfig
from ecgmm_torch.data import pipeline
from ecgmm_torch.models.resnet1d_se import ResNet1DSE
from ecgmm_torch.tools.weights import from_jax_resnet1d_se
from ecgmm_torch.train import engine
from ecgmm_torch.train.optim import Optimizer
from ecgmm_torch.train.report import test_report
from ecgmm_torch.train.state import create_state
from ecgmm_torch.workloads.tasks import make_signal_task

torch.set_num_threads(2)


# ------------------------------------------------------------ weight decay

@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("schedule", ["constant", "onecycle"])
def test_weight_decay_matches_optax_chain(schedule, steps):
    rng = np.random.default_rng(steps)
    kw = dict(schedule=schedule, lr=3e-3, num_epochs=3, weight_decay=0.5)
    w0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = rng.normal(size=(steps, 5, 4)).astype(np.float32)
    tx = jax_optim.make_optimizer(JaxTrainConfig(**kw), steps_per_epoch=4)
    params = jnp.asarray(w0)
    opt_state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = Optimizer([p], TrainConfig(**kw), steps_per_epoch=4)
    for k, g in enumerate(grads):
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g)
        opt.step(k)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                                   atol=1e-6, rtol=0, err_msg=str(k))
    # without the decay the same steps land elsewhere (Adam's first step
    # is the sign of g + wd * p, which the decay flips somewhere)
    q = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    plain = Optimizer([q], TrainConfig(**dict(kw, weight_decay=0.0)), 4)
    for k, g in enumerate(grads):
        q.grad = torch.from_numpy(g)
        plain.step(k)
    assert not torch.allclose(p, q, atol=1e-6)


def test_plateau_decay_reaches_the_rate_through_the_chain():
    kw = dict(schedule="constant", lr=1e-2, weight_decay=0.1)
    tx = jax_optim.make_optimizer(JaxTrainConfig(**kw))
    w0 = np.linspace(-1, 1, 6, dtype=np.float32)
    params = jnp.asarray(w0)
    opt_state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = Optimizer([p], TrainConfig(**kw))
    assert opt.get_lr() == pytest.approx(jax_optim.get_lr(opt_state))
    opt_state = jax_optim.scale_lr(opt_state, 0.1)
    opt.scale_lr(0.1)
    assert opt.get_lr() == pytest.approx(jax_optim.get_lr(opt_state)) \
        == pytest.approx(1e-3)
    g = np.full(6, 0.5, np.float32)
    for k in range(3):
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g.copy())
        opt.step(k)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                               atol=1e-6, rtol=0)


# -------------------------------------------------------------- debug_nans

T, BS = 64, 8


def _nan_data():
    rng = np.random.default_rng(0)
    signals = rng.normal(size=(32, T)).astype(np.float32)
    signals[:, 10] = np.nan  # in every split
    labels = np.arange(32) % 2
    split = jax_splits.stratified_811(labels, 0)
    return signals, labels, split


def test_debug_nans_stops_both_and_restores_the_setting():
    signals, labels, split = _nan_data()
    kw = dict(batch_size=BS, num_epochs=1, patience=0, seed=0,
              debug_nans=True)
    # JAX
    jmodel = JaxResNet1DSE(num_classes=2, base_filters=4, dropout=0.0)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, T, 1)))
    jdata = jax_pipeline.materialize_signal(signals, labels, split)
    jcfg = JaxTrainConfig(**kw)
    tx = jax_optim.make_optimizer(jcfg)
    assert not jax.config.jax_debug_nans
    with pytest.raises(FloatingPointError):
        jax_engine.fit(jax_make_signal_task(jmodel, jcfg),
                       jax_create_state(variables, tx,
                                        jax.random.PRNGKey(0)),
                       tx, jdata.train, jdata.val, jcfg, verbose=False)
    assert not jax.config.jax_debug_nans
    # the port
    data = pipeline.materialize_signal(signals, labels, split, device="cpu")
    cfg = TrainConfig(**kw)

    def port_fit(cfg):
        model = ResNet1DSE(2, 1, 4, dropout=0.0)
        model.load_state_dict(from_jax_resnet1d_se(jax.device_get(
            variables)), strict=True)
        return engine.fit(make_signal_task(cfg), create_state(model, cfg),
                          data.train, data.val, cfg, verbose=False)

    assert not torch.is_anomaly_enabled()
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        port_fit(cfg)
    assert not torch.is_anomaly_enabled()
    # a later fit without the field runs through the NaN, as JAX's does
    res = port_fit(TrainConfig(**dict(kw, debug_nans=False)))
    assert np.isnan(res.history[0]["Loss/Train"])


def test_debug_nans_names_a_non_finite_gradient():
    """A finite loss whose gradient is not (the slope of sqrt at 0 times
    0): the fit raises FloatingPointError, and the setting is restored,
    off or on."""
    signals, labels, split = _nan_data()
    data = pipeline.materialize_signal(np.nan_to_num(signals), labels, split,
                                       device="cpu")
    cfg = TrainConfig(batch_size=BS, num_epochs=1, patience=0,
                      debug_nans=True)
    state = create_state(ResNet1DSE(2, 1, 4, dropout=0.0), cfg)
    task = make_signal_task(cfg)
    weight = next(state.model.parameters())

    def loss(outputs, batch):
        value, mets = task.loss(outputs, batch)
        return value + torch.sqrt(weight.abs() * 0).sum(), mets

    bad = engine.Task(apply=task.apply, loss=loss, logits=task.logits)
    with pytest.raises(FloatingPointError):
        engine.fit(bad, state, data.train, data.val, cfg, verbose=False)
    assert not torch.is_anomaly_enabled()
    # a caller's own setting survives a fit too
    torch.autograd.set_detect_anomaly(True)
    try:
        with pytest.raises(FloatingPointError):
            engine.fit(bad, state, data.train, data.val, cfg, verbose=False)
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)


# -------------------------------------------------------------- report PNGs

def _text_chunks(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    out, pos = {}, 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == \
            zlib.crc32(kind + body)
        if kind == b"tEXt":
            key, value = body.split(b"\0", 1)
            out[key.decode()] = value.decode("latin-1")
        pos += 12 + n
    return out


@pytest.mark.parametrize("classes,search", [(2, False), (2, True), (3, False)])
def test_report_pngs_match_jax(tmp_path, monkeypatch, classes, search):
    rng = np.random.default_rng(classes)
    n = 41
    logits = rng.normal(size=(n, classes)).astype(np.float32)
    logits[5] = logits[6]  # a tie in the scores
    labels = rng.integers(0, classes, n)
    plotted = []
    real_plot = matplotlib.axes.Axes.plot
    monkeypatch.setattr(matplotlib.axes.Axes, "plot", lambda ax, *a, **k: (
        plotted.append(a), real_plot(ax, *a, **k))[1])
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jax_report.test_report(logits, labels, jdir, "best",
                                  threshold_search=search)
    got = test_report(logits, labels, pdir, "best", threshold_search=search)
    assert got.keys() == want.keys()
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    names = (["Normal", "Abnormal"] + ["class2"])[:classes]
    text = _text_chunks(os.path.join(pdir, "confusion_best.png"))
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    preds = ((probs[:, 1] >= want.get("threshold", 0.5)).astype(np.int32)
             if classes == 2 else probs.argmax(-1))
    assert json.loads(text["counts"]) == jax_metrics.confusion_matrix(
        preds, labels, classes).tolist()
    assert json.loads(text["class_names"]) == names
    img = np.asarray(Image.open(os.path.join(pdir, "confusion_best.png")))
    assert img.shape == (64 * classes, 64 * classes, 3)
    if classes == 2:
        roc = _text_chunks(os.path.join(pdir, "roc_best.png"))
        fpr, tpr = plotted[0]
        np.testing.assert_allclose(json.loads(roc["fpr"]), fpr, rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(json.loads(roc["tpr"]), tpr, rtol=0,
                                   atol=1e-12)
        assert np.asarray(Image.open(os.path.join(
            pdir, "roc_best.png"))).shape == (256, 256, 3)
