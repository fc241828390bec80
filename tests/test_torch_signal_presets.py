"""The remaining signal presets of the port (`signal_af`, `signal_arr`,
`signal_12lead`, `physionet_crnn`, `physionet_transformer`) against the
JAX package on the CPU: the presets, the manual splits, the data of each
preset, train steps against JAX's engine and `run()` end to end, at a
small size (signals of 256 samples for the ResNet1D-SE with base filters
8, spectrograms of 512-sample signals for the full-width CRNN, the
full-width Transformer at `seq_len` 64), inputs from numpy seeds.

Bars, and why:
  * presets, splits, labels, split indices: equal (the same numbers);
  * signals within 1e-5 (scipy's float64 filters against JAX's, stored
    as float32); spectrograms of them within 1e-5 (log1p of magnitudes
    that carry the signals' 1e-5);
  * three train steps from one state on the same batches, dropout 0 on
    both sides: the loss rtol 1e-5 at every step (float32 sums in other
    orders; 1.3e-6 seen); every gradient within 1e-4 of its tensor's
    largest component (3.2e-5 seen: the CRNN's 2-element output bias);
    the parameters after each Adam update within 0.1 of the sum of the
    learning rates so far, with at most 1 element in 2000 off by more
    than 1e-6 (Adam's update is lr * m / sqrt(v): an element whose
    gradient lies near float32 noise turns); the parameters whose
    gradient is zero in exact arithmetic are held to 2 * sum(lr),
    because Adam moves them by about lr in the direction of the noise:
    the biases of the convolutions that feed a BatchNorm (it removes
    them) and the attention's key bias (the softmax over the keys
    removes it); BatchNorm running means within 1e-5 + 2 * sum(lr) (a
    drifting bias shifts the batch mean after it), running variances
    rtol 1e-5 with atol 1e-6. The LSTM's second bias of each gate stays
    bit-equal to 0.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecgmm_tpu.config import PRESETS as JAX_PRESETS
from ecgmm_tpu.config import get_preset as jax_get_preset
from ecgmm_tpu.data import pipeline as jax_pipeline
from ecgmm_tpu.data import preprocess as jax_preprocess
from ecgmm_tpu.data import splits as jax_splits
from ecgmm_tpu.models import CRNN as JaxCRNN
from ecgmm_tpu.models import ECGTransformer1D as JaxTransformer1D
from ecgmm_tpu.models import ResNet1DSE as JaxResNet1DSE
from ecgmm_tpu.models import transformer1d as jax_transformer1d
from ecgmm_tpu.train import engine as jax_engine
from ecgmm_tpu.train import optim as jax_optim
from ecgmm_tpu.train.state import create_state as jax_create_state
from ecgmm_tpu.workloads import run as jax_run
from ecgmm_tpu.workloads.tasks import make_signal_task as jax_signal_task
from ecgmm_tpu.workloads.tasks import \
    make_spectrogram_task as jax_spectrogram_task
from ecgmm_torch.config import PRESETS, Config, get_preset
from ecgmm_torch.data import preprocess, splits
from ecgmm_torch.models.layers import Dropout
from ecgmm_torch.tools.weights import (from_jax_crnn, from_jax_resnet1d_se,
                                       from_jax_transformer1d)
from ecgmm_torch.train import engine
from ecgmm_torch.train.checkpoint import CheckpointManager
from ecgmm_torch.train.state import create_state
from ecgmm_torch.workloads import run as port_run

torch.set_num_threads(2)

NEW_PRESETS = ("signal_af", "signal_arr", "signal_12lead", "physionet_crnn",
               "physionet_transformer")
# signal length of each preset in these tests, and the ResNet's filters
SMALL_T = {"signal_af": 256, "signal_arr": 256, "signal_12lead": 256,
           "physionet_crnn": 512, "physionet_transformer": 64}
FILTERS = 8


def _small(cfg, t=None, **train):
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data,
                                      signal_len=t or SMALL_T[cfg.name]),
        train=dataclasses.replace(cfg.train, **train))


# ----------------------------------------------------------------- presets

@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_preset_equals_jax(name):
    """Every JAX preset exists in the port with the same values in every
    field the port has."""
    got, want = get_preset(name), jax_get_preset(name)
    assert got.name == want.name == name
    for part in ("data", "model", "train"):
        g = dataclasses.asdict(getattr(got, part))
        w = dataclasses.asdict(getattr(want, part))
        assert {k: g[k] for k in g} == {k: w[k] for k in g}, part
    assert sorted(PRESETS) == sorted(JAX_PRESETS)


def test_unknown_preset_names_the_presets():
    with pytest.raises(KeyError, match="physionet_transformer"):
        get_preset("transformer")
    with pytest.raises(ValueError, match="unknown preset"):
        port_run.build_model_and_task(Config(name="transformer"), "cpu")


# ------------------------------------------------------------------ splits

@pytest.mark.parametrize("n,n_pos,seed", [(60, 6, 42), (96, 6, 42),
                                          (40, 6, 3), (150, 9, 0),
                                          (12, 1, 7)])
def test_manual_af_split_matches_jax(n, n_pos, seed):
    labels = np.zeros(n, np.int64)
    labels[np.random.default_rng(n).choice(n, n_pos, replace=False)] = 1
    got = splits.manual_af_split(labels, seed)
    want = jax_splits.manual_af_split(labels, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert labels[got.train].sum() == min(2, n_pos)
    assert labels[got.val].sum() == 0
    assert sorted(np.concatenate(got).tolist()) == list(range(n))


def test_manual_split_matches_jax():
    got = splits.manual_split(20, [7, 3, 11], [0, 19])
    want = jax_splits.manual_split(20, [7, 3, 11], [0, 19])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="overlap"):
        splits.manual_split(10, [1, 2], [2, 3])


# -------------------------------------------------------------------- data

@pytest.mark.parametrize("shape", [(0, 256), (3, 12, 256), (0, 12, 256)])
def test_preprocess_hospital_matches_jax(shape):
    """The hospital filter over the last axis, for 12 leads too, and an
    empty split stays empty (signal_af's val split at 60 records)."""
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got = preprocess.preprocess_hospital(x)
    want = np.asarray(jax_preprocess.preprocess_hospital(jnp.asarray(x)))
    assert got.shape == want.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name,n", [(p, 48) for p in NEW_PRESETS]
                         + [("signal_af", 96)])
def test_load_data_matches_jax(name, n):
    jcfg = _small(jax_get_preset(name))
    want = jax_run.load_data(jcfg, "synthetic", n)
    got = port_run.load_data(_small(get_preset(name)), n, device="cpu")
    for split in ("train", "val", "test"):
        j, p = getattr(want, split), getattr(got, split)
        np.testing.assert_array_equal(p.indices, j.indices)
        np.testing.assert_array_equal(p.labels.numpy(), np.asarray(j.labels))
        assert p.signals.dtype == torch.float32
        assert tuple(p.signals.shape) == np.shape(j.signals)
        np.testing.assert_allclose(p.signals.numpy(), np.asarray(j.signals),
                                   atol=1e-5, err_msg=split)
    if name == "signal_af":
        pos = [int(getattr(got, s).labels.sum()) for s in
               ("train", "val", "test")]
        assert pos == [2, 0, 4]
        assert got.val.n == (22 if n == 96 else 0)
    if name == "signal_12lead":
        assert got.train.signals.shape[1:] == (12, 256)
    if name == "physionet_crnn":
        assert got.train.signals.shape[1:] == (33, 17)


# -------------------------------------------------------------- train steps

def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


def _jax_model(name, t):
    if name == "physionet_crnn":
        return JaxCRNN(num_classes=2, dropout=0.0), jax_spectrogram_task, \
            from_jax_crnn, lambda x: x
    if name == "physionet_transformer":
        return (JaxTransformer1D(num_classes=2, seq_len=t, dropout=0.0),
                jax_signal_task, from_jax_transformer1d,
                lambda x: x[..., None])
    return (JaxResNet1DSE(num_classes=2, input_channels=12,
                          base_filters=FILTERS, dropout=0.0),
            jax_signal_task, from_jax_resnet1d_se,
            lambda x: jnp.swapaxes(x, 1, 2))


def _zero_gradient_entries(model):
    """State-dict names (and, for the attention's packed bias, the slice)
    of the parameters whose gradient is zero in exact arithmetic."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d)) and (
                name.endswith("block.0") or name.startswith(
                    ("initial.", "layer")) and "se" not in name):
            out[f"{name}.bias"] = slice(None)
        if hasattr(m, "in_proj_bias"):
            d = m.in_proj_bias.shape[0] // 3
            out[f"{name}.in_proj_bias"] = slice(d, 2 * d)  # the key bias
    return out


@pytest.mark.parametrize("name", ["physionet_crnn", "physionet_transformer",
                                  "signal_12lead"])
def test_three_train_steps_match_jax(name, monkeypatch):
    """Three steps of the preset's model, optimizer and schedule from one
    state (the JAX model's init, carried across) over the first epoch's
    shuffled batch plan; the port's model, task and frozen set come from
    `build_model_and_task`, as `run()` takes them."""
    class NoDropout(jax_transformer1d.PostLNEncoderLayer):
        dropout: float = 0.0

    monkeypatch.setattr(jax_transformer1d, "PostLNEncoderLayer", NoDropout)
    t_len = SMALL_T[name]
    jcfg = _small(jax_get_preset(name))
    pcfg = _small(get_preset(name))
    pcfg = dataclasses.replace(pcfg, model=dataclasses.replace(
        pcfg.model, signal_base_filters=FILTERS))
    jdata = jax_run.load_data(jcfg, "synthetic", 48).train
    pdata = port_run.load_data(pcfg, 48, device="cpu").train
    t = jcfg.train
    jmodel, jtask_fn, bridge, to_input = _jax_model(name, t_len)
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), to_input(jnp.asarray(jdata.signals[:1]))))
    steps = jax_pipeline.num_batches(pdata.n, t.batch_size)
    tx = jax_optim.make_optimizer(t, steps)
    jstate = jax_create_state(variables, tx, jax.random.PRNGKey(0))
    jtask = jtask_fn(jmodel, t)
    jstep = jax_engine.make_train_step(jtask, tx, donate=False)

    @jax.jit
    def jgrad(params, model_state, rng, batch):
        def loss(params):
            out, _ = jtask.apply({"params": params, **model_state}, batch,
                                 train=True, rngs={"dropout": rng})
            return jtask.loss(out, batch)[0]
        return jax.grad(loss)(params)

    model, task, freeze = port_run.build_model_and_task(pcfg, "cpu")
    model.load_state_dict(bridge(variables), strict=True)
    state = create_state(_no_dropout(model), pcfg.train, steps,
                         freeze=freeze)
    idx, mask = engine.epoch_indices(pdata.n, t.batch_size, shuffle=True,
                                     seed=t.seed, epoch=0)
    assert idx.shape[0] >= 3
    zero_grad = _zero_gradient_entries(model)
    assert zero_grad  # every model here has such a parameter
    lr = (state.optimizer.schedule if state.optimizer.schedule
          else (lambda k: t.lr))
    for i in range(3):
        jb = jax_pipeline.Batch(
            None, jnp.take(jdata.signals, idx[i], axis=0), None,
            jnp.take(jdata.labels, idx[i], axis=0), jnp.asarray(mask[i]))
        pb = engine.gather_batch(pdata, torch.from_numpy(
            idx[i].astype(np.int64)), torch.from_numpy(mask[i]))
        jgrads = jax.device_get(jgrad(jstate.trainable, jstate.model_state,
                                      jstate.rng, jb))
        jstate, jmets = jstep(jstate, jb)
        mets = engine.train_step(task, state, pb)
        np.testing.assert_allclose(float(mets["loss"]), float(jmets["loss"]),
                                   rtol=1e-5, err_msg=f"step {i + 1}")

        want_grads = bridge({"params": jgrads,
                             **jax.device_get(jstate.model_state)})
        for pname, p in model.named_parameters():
            if pname.startswith("bilstm.bias_hh_"):
                assert p.grad is None and not p.requires_grad, pname
                continue
            g, w = p.grad.clone(), want_grads[pname].clone()
            if pname in zero_grad:  # held by the parameter bar below
                g[zero_grad[pname]] = w[zero_grad[pname]] = 0.0
            assert float((g - w).abs().max()) <= 1e-4 * float(
                w.abs().max()), f"step {i + 1} gradient {pname}"

        sum_lr = sum(lr(k) for k in range(i + 1))
        want = bridge(jax.device_get({"params": jstate.trainable,
                                      **jstate.model_state}))
        n_off = n_all = 0
        for sname, got in model.state_dict().items():
            w = want[sname]
            if sname.endswith("num_batches_tracked"):
                continue
            if sname.startswith("bilstm.bias_hh_"):
                assert float(got.abs().max()) == 0.0, sname
                continue
            diff = (got - w).abs()
            where = f"step {i + 1} {sname}"
            if sname.endswith("running_mean"):
                assert float(diff.max()) <= 1e-5 + 2 * sum_lr, where
            elif sname.endswith("running_var"):
                np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=where)
            else:
                if sname in zero_grad:
                    part = diff[zero_grad[sname]]
                    assert float(part.max()) <= 2 * sum_lr, where
                    diff[zero_grad[sname]] = 0.0
                assert float(diff.max()) <= 0.1 * sum_lr, where
                n_off += int((diff > 1e-6).sum())
                n_all += diff.numel()
        assert n_off <= n_all // 2000, (i, n_off, n_all)


def test_lstm_keeps_one_trained_bias_per_gate():
    """The CRNN's `bias_hh_*` stays in the state dict under its reference
    name, requires no gradient and is not among Adam's tensors; were it
    trained, Adam would move the sum of the two biases twice as far as
    JAX moves its one bias."""
    cfg = get_preset("physionet_crnn")
    model, task, freeze = port_run.build_model_and_task(cfg, "cpu")
    names = [n for n in model.state_dict() if n.startswith("bilstm.bias")]
    assert len(names) == 12  # 3 layers x 2 directions x (ih, hh)
    state = create_state(model, cfg.train, 4, freeze=freeze)
    in_adam = {id(p) for g in state.optimizer.adam.param_groups
               for p in g["params"]}
    for n, p in model.named_parameters():
        hh = n.startswith("bilstm.bias_hh_")
        assert (id(p) in in_adam) != hh and p.requires_grad != hh, n

    spec = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 33, 17)).astype(np.float32))
    labels = torch.tensor([0, 1, 1, 0])
    batch = engine.Batch(None, spec, None, labels, torch.ones(4))

    def summed_bias_move(freeze):
        m, task, _ = port_run.build_model_and_task(cfg, "cpu")
        st = create_state(_no_dropout(m), cfg.train, 4, freeze=freeze)
        before = m.bilstm.bias_ih_l0 + m.bilstm.bias_hh_l0
        engine.train_step(task, st, batch)
        after = m.bilstm.bias_ih_l0 + m.bilstm.bias_hh_l0
        return (after - before).detach().abs()

    one, both = summed_bias_move(freeze), summed_bias_move(None)
    moved = one > 0.5 * cfg.train.lr
    assert moved.sum() > 100
    torch.testing.assert_close(both[moved], 2 * one[moved], rtol=1e-3,
                               atol=0)


# --------------------------------------------------------------- end to end

def _run_cfg(name, tmp_path, epochs=1):
    cfg = get_preset(name)
    cfg = _small(cfg, t=512 if name != "physionet_transformer" else 128,
                 num_epochs=epochs, batch_size=8,
                 checkpoint_dir=str(tmp_path / "ckpt"),
                 log_dir=str(tmp_path / "runs"),
                 output_dir=str(tmp_path / "out"))
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, signal_base_filters=FILTERS))


@pytest.mark.parametrize("name", NEW_PRESETS)
def test_run_one_epoch_on_cpu(name, tmp_path):
    """One epoch through `run()` at a shrunk size, as
    tests/test_workloads.py runs the JAX presets: a finite loss, both
    reports with `accuracy`, checkpoints that restore."""
    cfg = _run_cfg(name, tmp_path)
    data = port_run.load_data(cfg, 48, device="cpu")
    result, reports = port_run.run(cfg, data, run_dir=str(tmp_path / "r"),
                                   verbose=False, device="cpu")
    assert len(result.history) == 1
    assert np.isfinite(result.history[0]["Loss/Train"])
    for tag in ("best", "last"):
        assert "accuracy" in reports[tag]
        assert os.path.isfile(tmp_path / "out" / "r" / f"report_{tag}.txt")
    model, task, freeze = port_run.build_model_and_task(cfg, "cpu")
    st = CheckpointManager(str(tmp_path / "r")).restore(
        "last", create_state(model, cfg.train, 4, freeze=freeze))
    assert st.epoch == 1
    for k, v in st.model.state_dict().items():
        assert torch.equal(v, result.state.model.state_dict()[k]), k


def test_cli_trains_a_new_preset(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_run, "get_preset",
                        lambda name: _run_cfg(name, tmp_path))
    port_run.main(["--preset", "physionet_crnn", "--device", "cpu",
                   "--epochs", "1", "--n-synth", "48", "--run-dir",
                   "checkpoints/c"])
    for path in ("checkpoints/c/best.pt", "checkpoints/c/last.pt",
                 "out/c/report_best.txt", "out/c/report_last.txt"):
        assert (tmp_path / path).is_file(), path


@pytest.mark.parametrize("n", [60, 96])
def test_signal_af_degenerate_split_behaves_as_jax(n, tmp_path):
    """signal_af's val split holds no positive (none at all at 60 records)
    and test only positives: the port's history, best epoch, report keys
    and NaNs (AUROC of one class) follow JAX's run on the same data."""
    pcfg = _run_cfg("signal_af", tmp_path / "p", epochs=2)
    jcfg = jax_get_preset("signal_af")
    jcfg = dataclasses.replace(
        jcfg, data=dataclasses.replace(jcfg.data, signal_len=512),
        train=dataclasses.replace(
            jcfg.train, num_epochs=2, batch_size=8,
            checkpoint_dir=str(tmp_path / "j" / "ckpt"),
            log_dir=str(tmp_path / "j" / "runs"),
            output_dir=str(tmp_path / "j" / "out")))
    jres, jrep = jax_run.run(jcfg, jax_run.load_data(jcfg, "synthetic", n),
                             run_dir=str(tmp_path / "j" / "r"),
                             verbose=False)
    pres, prep = port_run.run(pcfg, port_run.load_data(pcfg, n, device="cpu"),
                              run_dir=str(tmp_path / "p" / "r"),
                              verbose=False, device="cpu")
    assert len(pres.history) == len(jres.history) == 2
    for got, want in zip(pres.history, jres.history):
        assert math.isnan(got["Loss/Val"]) == math.isnan(want["Loss/Val"])
        assert math.isnan(got["Accuracy/Val"]) == math.isnan(
            want["Accuracy/Val"])
    if n == 60:
        assert pres.best_epoch == jres.best_epoch == -1
    else:
        assert pres.best_epoch >= 0 and jres.best_epoch >= 0
    for tag in ("best", "last"):
        assert set(prep[tag]) == set(jrep[tag]), tag
        for k, v in jrep[tag].items():
            assert math.isnan(prep[tag][k]) == math.isnan(v), (tag, k)
    assert math.isnan(prep["last"]["auroc"])
    assert ("temperature" in prep["last"]) == (n == 96)
