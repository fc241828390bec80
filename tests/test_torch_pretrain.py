"""The staged pretraining pipeline of the port (`image_only`,
`signal_only`, the clinical probe, `workloads/pretrain.py`), TabNet's
sparsemax tie and the runs' float32 (TF32 off), against the JAX package
on the CPU at a small size: images 32x32, signals of 256 samples,
ResNet1D-SE base filters 16, float32, inputs from numpy seeds.

Bars, and why:
  * the sparsemax gradient at a tie: 1e-6 (a few float32 operations);
    torch.clamp's VJP would give the whole cotangent to the tied element,
    jnp.maximum's gives it half, so the old form fails by ~0.5;
  * ResNet-18 steps (the first backward through it): the first loss
    rtol 1e-4, the first step's gradients within 1e-3 of each tensor's
    largest component (measured 4e-5), the BatchNorm buffers rtol and
    atol 1e-4: at 32x32 the last stage normalises 8 values a channel, and
    flax takes the batch variance as E[x^2] - E[x]^2, so the forward
    carries ~1e-5 relative noise that the backward sums over the batch
    (the bars of tests/test_torch_fusion_train.py). The parameters after
    the first step are within 1e-6 but for Adam's turned elements (at
    most 1 in 2000, measured 82 of 11.2M); after the second, Adam divides
    the moments of two such gradients, and an element whose gradients are
    small against their 2e-5 relative noise moves up to 2 sum(lr) apart
    (a tenth of the elements by more than 1e-6 at lr 1e-4): from then on
    only 2 sum(lr) holds, with the loss (rtol 1e-3) and the buffers;
  * clinical-probe steps (TabNet's first backward): the same, with the
    gradients within 1e-3 of the largest component where ghost BN cuts
    the batch into chunks of 4 and 2 rows (flax's fast variance over 2
    rows reaches 4.3e-5, ROADMAP.md section 3);
  * warm starts: bit-equal (copies).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecgmm_tpu.config import TrainConfig as JaxTrainConfig
from ecgmm_tpu.config import get_preset as jax_get_preset
from ecgmm_tpu.data import pipeline as jax_pipeline
from ecgmm_tpu.models import ECGMultimodalModel as JaxFusion
from ecgmm_tpu.models import ResNet18 as JaxResNet18
from ecgmm_tpu.models import ResNet1DSE as JaxResNet1DSE
from ecgmm_tpu.models.clinical import ClinicalMLPEncoder as JaxMLP
from ecgmm_tpu.models.clinical import TabNetEncoder as JaxTabNet
from ecgmm_tpu.models.clinical import sparsemax as jax_sparsemax
from ecgmm_tpu.config import ModelConfig as JaxModelConfig
from ecgmm_tpu.train import engine as jax_engine
from ecgmm_tpu.train import optim as jax_optim
from ecgmm_tpu.train.state import create_state as jax_create_state
from ecgmm_tpu.workloads import run as jax_run
from ecgmm_tpu.workloads.pretrain import \
    warm_start_fusion as jax_warm_start
from ecgmm_tpu.workloads.tasks import make_clinical_task as jax_clin_task
from ecgmm_tpu.workloads.tasks import make_image_task as jax_image_task
from ecgmm_torch.config import ModelConfig, TrainConfig, get_preset
from ecgmm_torch.data import pipeline
from ecgmm_torch.models import (ECGMultimodalModel, ResNet18, ResNet1DSE,
                                TabNetEncoder, sparsemax)
from ecgmm_torch.models.clinical import ClinicalMLPEncoder
from ecgmm_torch.models.layers import flax_init_
from ecgmm_torch.tools.weights import (from_jax_clinical_probe,
                                       from_jax_resnet18,
                                       from_jax_resnet1d_se,
                                       from_jax_variables, load_partial)
from ecgmm_torch.train import engine
from ecgmm_torch.train.checkpoint import CheckpointManager
from ecgmm_torch.train.state import create_state
from ecgmm_torch.workloads import pretrain
from ecgmm_torch.workloads import run as port_run
from ecgmm_torch.workloads import tasks

torch.set_num_threads(2)

HW, T, FILTERS, SEED = (32, 32), 256, 16, 5


def _variables_of(model, *shapes, seed=0):
    """Seeded variables of a flax model without compiling its init: the
    tree's shapes from `jax.eval_shape`, each kernel lecun-normal (as
    flax's default) times 1 + 0.1 noise, BatchNorm variances exp(0.2
    noise), scales 1 + 0.1 noise, every other leaf 0.1 noise."""
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          *(jnp.ones(s) for s in shapes))
    rng = np.random.default_rng(seed + 7)

    def fill(path, leaf):
        name = path[-1].key
        noise = rng.normal(size=leaf.shape).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            std = np.sqrt(1.0 / fan_in)
            return (rng.normal(size=leaf.shape) * std).astype(np.float32) \
                * (1 + 0.1 * noise)
        if name == "var":
            return np.exp(0.2 * noise)
        if name in ("scale", "weights"):
            return 1 + 0.1 * noise
        return 0.1 * noise

    return jax.tree_util.tree_map_with_path(fill, tree)


def _close_to_largest(got, want, rel, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rel * float(np.abs(want).max()) + 1e-12,
                               err_msg=name)


# ------------------------------------------------------------ repaired faults

@pytest.mark.parametrize("a", [0.5, -1.25, 3.0])
def test_sparsemax_tie_gradient_matches_jax(a):
    """z = [a, a - 1] puts z2 exactly on tau (the support is {1}), where
    jnp.maximum's VJP gives each side half of the cotangent; the second
    row has no tie. Value and VJP against jax.vjp of JAX's sparsemax."""
    z = np.asarray([[a, a - 1.0], [0.3, -0.2]], np.float32)
    cot = np.asarray([[0.3, 1.0], [0.7, -0.4]], np.float32)
    want, vjp = jax.vjp(jax_sparsemax, jnp.asarray(z))
    (want_grad,) = vjp(jnp.asarray(cot))
    zt = torch.from_numpy(z).requires_grad_(True)
    got = sparsemax(zt)
    (grad,) = torch.autograd.grad(got, zt, torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               atol=1e-6)
    if a == 0.5:  # the case worked out by hand: [[-0.5, 0.5]]
        np.testing.assert_allclose(grad[0].numpy(), [-0.5, 0.5], atol=1e-6)


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _small(cfg, tmp_path, epochs=1):
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, signal_len=T, img_height=HW[0],
                                 img_width=HW[1]),
        model=dataclasses.replace(cfg.model, signal_base_filters=FILTERS),
        train=dataclasses.replace(
            cfg.train, num_epochs=epochs,
            checkpoint_dir=str(tmp_path / "ckpt"),
            log_dir=str(tmp_path / "runs"),
            output_dir=str(tmp_path / "output")))


@pytest.mark.parametrize("entry", ["run", "run_pipeline"])
def test_runs_turn_tf32_off_and_restore_it(entry, tmp_path, monkeypatch):
    """Inside `run()` and `run_pipeline()` both TF32 flags read False (read
    from a task's apply); afterwards they are what they were, also where
    the run raises."""
    seen = []

    def spying(make_task):
        def make(*args):
            task = make_task(*args)
            inner = task.apply

            def apply(model, batch):
                seen.append(_flags())
                if fail:
                    raise RuntimeError("stop")
                return inner(model, batch)

            return dataclasses.replace(task, apply=apply)
        return make

    if entry == "run":
        monkeypatch.setattr(port_run, "make_signal_task",
                            spying(tasks.make_signal_task))
        cfg = _small(get_preset("signal_only"), tmp_path)

        def call():
            return port_run.run(cfg, data, run_dir=str(tmp_path / "r"),
                                verbose=False, device="cpu")
    else:
        monkeypatch.setattr(pretrain, "make_image_task",
                            spying(tasks.make_image_task))
        cfg = _small(get_preset("fusion"), tmp_path)

        def call():
            return pretrain.run_pipeline(cfg, data, str(tmp_path / "p"),
                                         stage_epochs=1, verbose=False,
                                         device="cpu")
    data = port_run.load_data(cfg, "synthetic", 30, device="cpu")
    saved = _flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for fail in (False, True):
            seen.clear()
            if fail:
                with pytest.raises(RuntimeError, match="stop"):
                    call()
            else:
                call()
            assert seen and set(seen) == {(False, False)}
            assert _flags() == (True, True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ------------------------------------------------------------ stage steps

def _adam_checks(model, want, init, trainable, sum_lr, first, bn_fed):
    """Trainable parameters within 2 sum(lr) of `want`, and after the first
    step within 1e-6 but for Adam's turned elements (at most 1 in 2000);
    everything else (BatchNorm buffers) rtol and atol 1e-4."""
    n_off = n_all = 0
    for name, got in model.state_dict().items():
        w = want[name]
        if name.endswith("num_batches_tracked"):
            continue
        if name not in trainable:
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=name)
            assert not torch.equal(got, init[name]), name  # a buffer moved
            continue
        diff = (got - w).abs()
        assert float(diff.max()) <= 2 * sum_lr + 1e-7, name
        if name not in bn_fed:
            n_off += int((diff > 1e-6).sum())
            n_all += diff.numel()
    assert not first or n_off <= n_all // 2000, (n_off, n_all)


def _steps(jtask, jvars, bridge, model, task, cfg, batches, bn_fed=()):
    """Two steps of the JAX task and of the port's from the same weights:
    loss (rtol 1e-4 first, 1e-3 then), the first step's gradients, the
    parameters and buffers after each step. `bn_fed` names biases that
    feed a BatchNorm: their gradient is 0 in exact arithmetic and float32
    noise of either sign in each framework, so it is held to 1e-6 of the
    largest gradient of the model, and Adam moves each of their elements
    by up to lr either way (2 sum(lr), as ROADMAP.md section 3 holds
    convolution biases)."""
    jcfg = JaxTrainConfig(lr=cfg.lr)
    tx = jax_optim.make_optimizer(jcfg, len(batches))
    jstate = jax_create_state(jvars, tx, jax.random.PRNGKey(0))
    jstep = jax_engine.make_train_step(jtask, tx, donate=False)
    model.load_state_dict(bridge(jvars), strict=True)
    init = {k: t.clone() for k, t in model.state_dict().items()}
    state = create_state(model, cfg, len(batches))
    # the TabNet's shared GLU Linears are registered under every
    # transformer: each name of them is a trainable entry
    trainable = {n for n, _ in model.named_parameters(
        remove_duplicate=False)}
    for i, (jb, pb) in enumerate(batches):
        if i == 0:
            def jloss(params):
                out, _ = jtask.apply({"params": params,
                                      **jstate.model_state}, jb, train=True,
                                     rngs={"dropout": jstate.rng})
                return jtask.loss(out, jb)[0]

            jgrads = bridge({**jvars, "params": jax.device_get(jax.jit(
                jax.grad(jloss))(jstate.trainable))})
        jstate, jmets = jstep(jstate, jb)
        mets = engine.train_step(task, state, pb)
        np.testing.assert_allclose(float(mets["loss"]), float(jmets["loss"]),
                                   rtol=1e-4 if i == 0 else 1e-3)
        assert set(mets) - {"loss", "correct", "count"} == \
            set(jmets) - {"loss", "correct", "count"}
        if i == 0:
            top = max(float(p.grad.abs().max())
                      for p in model.parameters())
            for name, p in model.named_parameters():
                if name in bn_fed:
                    assert float(p.grad.abs().max()) <= 1e-6 * top, name
                    continue
                _close_to_largest(p.grad.numpy(), jgrads[name].numpy(),
                                  1e-3, name)
        want = bridge({"params": jstate.trainable, **jstate.model_state})
        _adam_checks(model, want, init, trainable, (i + 1) * cfg.lr, i == 0,
                     bn_fed)
    return mets


def _batch_pair(b, images=None, signals=None, clinical=None, seed=0):
    labels = np.arange(b) % 2
    mask = np.ones(b, np.float32)
    mask[-2:] = 0.0  # two pad rows
    nchw = (None if images is None else torch.from_numpy(
        np.ascontiguousarray(images.transpose(0, 3, 1, 2))))
    jb = jax_pipeline.Batch(
        *(None if a is None else jnp.asarray(a)
          for a in (images, signals, clinical, labels, mask)))
    pb = pipeline.Batch(
        nchw, *(None if a is None else torch.from_numpy(a)
                for a in (signals, clinical, labels, mask)))
    return jb, pb


def test_image_only_steps_match_jax():
    """Two `image_only` steps (ResNet18 with 2 classes, float32, CE,
    constant Adam 1e-4; uint8 images raw) against JAX's `make_image_task`:
    ResNet-18's first backward."""
    jmodel = JaxResNet18(num_classes=2)
    jvars = _variables_of(jmodel, (1,) + HW + (3,))
    rng = np.random.default_rng(1)
    batches = [_batch_pair(8, images=rng.integers(
        0, 256, (8,) + HW + (3,), dtype=np.uint8)) for _ in range(2)]
    cfg = get_preset("image_only").train
    _steps(jax_image_task(jmodel, JaxTrainConfig(lr=cfg.lr)), jvars,
           from_jax_resnet18, ResNet18(num_classes=2),
           tasks.make_image_task(cfg), cfg, batches)


@pytest.mark.parametrize("kind,vbs", [("tabnet", 128), ("tabnet", 4),
                                      ("mlp", 128)],
                         ids=["tabnet", "tabnet-ghost-bn", "mlp"])
def test_clinical_probe_steps_match_jax(kind, vbs):
    """Two clinical-probe steps (the encoder plus a linear probe, CE +
    1e-3 m_loss, m_loss a metric) against JAX's `make_clinical_task`:
    TabNet's first backward, plain and with ghost BN over chunks of
    4-4-2 rows (batch 10), and the MLP's (dropout 0 on both sides)."""
    n_feat = 2 if kind == "tabnet" else 24
    if kind == "tabnet":
        jenc = JaxTabNet(out_dim=32, virtual_batch_size=vbs)
        enc = TabNetEncoder(n_feat, out_dim=32, virtual_batch_size=vbs)
    else:
        jenc = JaxMLP(out_dim=32, dropout=0.0)
        enc = ClinicalMLPEncoder(n_feat, out_dim=32, dropout=0.0)
    cfg = TrainConfig(lr=1e-3)
    jtask, jprobe = jax_clin_task(jenc, JaxTrainConfig(lr=1e-3), 2)
    jvars = _variables_of(jprobe, (1, n_feat))
    task, probe = tasks.make_clinical_task(enc, cfg, 2)
    assert set(probe.state_dict()) == set(from_jax_clinical_probe(jvars))
    rng = np.random.default_rng(2)
    batches = [_batch_pair(10, clinical=(rng.normal(size=(10, n_feat))
                                         * 2).astype(np.float32))
               for _ in range(2)]
    mets = _steps(jtask, jvars, from_jax_clinical_probe, probe, task, cfg,
                  batches, bn_fed=("encoder.0.bias",) if kind == "mlp"
                  else ())
    assert ("m_loss" in mets) and (float(mets["m_loss"]) > 0) == (
        kind == "tabnet")


# ------------------------------------------------------------ warm start

def test_load_partial_filters():
    target = {"a.w": torch.zeros(2, 3), "a.b": torch.zeros(3),
              "fc.w": torch.zeros(2), "n": torch.zeros((), dtype=torch.int64)}
    source = {"a.w": torch.ones(2, 3, dtype=torch.float64),
              "a.b": torch.ones(4), "fc.w": torch.ones(2),
              "n": torch.tensor(7), "extra": torch.ones(1)}
    merged, skipped = load_partial(target, source, exclude_prefixes=("fc.",))
    assert sorted(skipped) == ["a.b", "extra", "fc.w"]
    assert torch.equal(merged["a.w"], torch.ones(2, 3))
    assert merged["a.w"].dtype == torch.float32
    assert torch.equal(merged["a.b"], torch.zeros(3))
    assert torch.equal(merged["fc.w"], torch.zeros(2))
    assert int(merged["n"]) == 7 and set(merged) == set(target)
    assert torch.equal(target["a.w"], torch.zeros(2, 3))  # not in place


@functools.lru_cache(maxsize=None)
def _stage_variables():
    """A small fusion model's, an image stage's and a TabNet probe's
    variables, made once for the warm-start tests."""
    fv = _variables_of(JaxFusion(cfg=JaxModelConfig(
        dtype="float32", signal_base_filters=FILTERS)), (1,) + HW + (3,),
        (1, T), (1, 2), seed=1)
    iv = _variables_of(JaxResNet18(num_classes=2), (1,) + HW + (3,), seed=2)
    _, jprobe = jax_clin_task(JaxTabNet(out_dim=32), JaxTrainConfig(), 2)
    return fv, iv, _variables_of(jprobe, (1, 2), seed=4)


@pytest.mark.parametrize("signal_filters", [FILTERS, 8],
                         ids=["same-width", "signal-width-mismatch"])
def test_warm_start_fusion_matches_jax(signal_filters):
    """`warm_start_fusion` over the port's state dicts against JAX's
    `warm_start_fusion` over the same stage variables: every tensor of
    the result bit-equal. The filtered tensors (image `fc`, signal
    `classifier.4`, clinical `tabnet.final_mapping`) keep the fusion
    model's, BatchNorm buffers travel, and a signal stage of another width
    is skipped tensor by tensor where the shapes differ."""
    mcfg = dict(dtype="float32", signal_base_filters=FILTERS)
    fv, iv, pv = _stage_variables()
    sv = _variables_of(
        JaxResNet1DSE(num_classes=2, base_filters=signal_filters),
        (1, T, 1), seed=3)
    cv = {col: tree["encoder"] for col, tree in pv.items()}
    want = from_jax_variables(jax.device_get(jax_warm_start(fv, iv, sv, cv)))

    fusion_sd = from_jax_variables(fv)
    clinical_sd = {k[len("encoder."):]: t
                   for k, t in from_jax_clinical_probe(pv).items()
                   if k.startswith("encoder.")}
    got = pretrain.warm_start_fusion(fusion_sd, from_jax_resnet18(iv),
                                     from_jax_resnet1d_se(sv), clinical_sd)
    assert set(got) == set(want)
    for k, t in want.items():
        assert torch.equal(got[k], t), k
    ECGMultimodalModel(ModelConfig(**mcfg)).load_state_dict(got,
                                                            strict=True)
    for k in ("image_encoder.fc.weight", "signal_encoder.classifier.4.bias",
              "clinical_encoder.tabnet.final_mapping.weight"):
        assert torch.equal(got[k], fusion_sd[k]), k
    assert torch.equal(got["image_encoder.bn1.running_var"],
                       from_jax_resnet18(iv)["bn1.running_var"])
    same = torch.equal(got["signal_encoder.layer1.conv1.weight"],
                       fusion_sd["signal_encoder.layer1.conv1.weight"])
    assert same == (signal_filters != FILTERS)


# ------------------------------------------------------------ entry points

@pytest.mark.parametrize("name", ["fusion_cached", "image_only",
                                  "signal_only"])
def test_presets_match_jax(name):
    """The new presets' train and model settings equal JAX's, field by
    field where the port has the field."""
    got, want = get_preset(name), jax_get_preset(name)
    assert got.name == want.name
    for part in ("train", "model", "data"):
        g, w = getattr(got, part), getattr(want, part)
        for f in dataclasses.fields(g):
            assert getattr(g, f.name) == getattr(w, f.name), (part, f.name)


@pytest.mark.parametrize("name", ["image_only", "signal_only"])
def test_stage_presets_load_the_trimodal_cohort_and_run(name, tmp_path):
    """`image_only` and `signal_only` train on the trimodal cohort (JAX's
    `load_data`, as neither is one of its signal families) and run to the
    test reports through `run()`."""
    cfg = _small(get_preset(name), tmp_path, epochs=2)
    jcfg = dataclasses.replace(
        jax_get_preset(name),
        data=dataclasses.replace(jax_get_preset(name).data, signal_len=T,
                                 img_height=HW[0], img_width=HW[1]))
    want = jax_run.load_data(jcfg, "synthetic", 30)
    data = port_run.load_data(cfg, "synthetic", 30, device="cpu")
    for split in ("train", "val", "test"):
        j, p = getattr(want, split), getattr(data, split)
        np.testing.assert_array_equal(p.indices, j.indices)
        np.testing.assert_array_equal(
            p.images.numpy(), np.asarray(j.images).transpose(0, 3, 1, 2))
        np.testing.assert_allclose(p.signals.numpy(), np.asarray(j.signals),
                                   atol=1e-5)
    model, _, freeze = port_run.build_model_and_task(cfg, "cpu")
    assert freeze is None and isinstance(
        model, ResNet18 if name == "image_only" else ResNet1DSE)
    result, results = port_run.run(cfg, data, run_dir=str(tmp_path / "r"),
                                   verbose=False, device="cpu")
    assert len(result.history) == 2
    assert all(np.isfinite(h["Loss/Train"]) for h in result.history)
    keys = {"accuracy", "f1", "auroc", "temperature"}
    if name == "signal_only":  # focal: the threshold search
        keys.add("threshold")
    assert keys <= set(results["best"]) and keys <= set(results["last"])


def _stage_best(run_dir, stage):
    return CheckpointManager(os.path.join(run_dir, stage)).load(
        "best")["model"]


@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
def test_run_pipeline_end_to_end(cached, tmp_path):
    """image -> signal -> clinical -> fusion on the CPU: each stage writes
    its checkpoints; the fusion stage's frozen encoder weights equal each
    stage's best under the three filters, the filtered tensors keep the
    fusion init; the test split is evaluated (cached: over its cached
    embeddings)."""
    cfg = _small(get_preset("fusion"), tmp_path)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, cache_embeddings=cached))
    data = port_run.load_data(cfg, "synthetic", 40, device="cpu")
    run_dir = str(tmp_path / "p")
    result, ev = pretrain.run_pipeline(cfg, data, run_dir, stage_epochs=1,
                                       verbose=False, device="cpu")
    assert len(result.history) == 1 and np.isfinite(ev.loss)
    assert ev.logits.shape == (data.test.n, 2)
    model = result.state.model
    sd = model.state_dict()
    init = flax_init_(ECGMultimodalModel(cfg.model),
                      torch.Generator().manual_seed(cfg.train.seed))
    init_sd = init.state_dict()
    for stage, prefix, sub, excluded in (
            ("image_only", "image_encoder.", "", "fc."),
            ("signal_only", "signal_encoder.", "", "classifier.4."),
            ("clinical", "clinical_encoder.", "encoder.",
             "tabnet.final_mapping.")):
        best = _stage_best(run_dir, stage)
        for name, p in model.named_parameters():
            if not name.startswith(prefix):
                continue
            assert not p.requires_grad, name
            key = name[len(prefix):]
            if key.startswith(excluded):
                assert torch.equal(p.detach(), init_sd[name]), name
            else:
                assert torch.equal(p.detach(), best[sub + key]), name
    assert sd["image_encoder.fc.weight"].shape == (512, 512)
    if cached:  # the encoders were calibrated: their buffers moved
        best = _stage_best(run_dir, "image_only")
        assert not torch.equal(sd["image_encoder.bn1.running_mean"],
                               best["bn1.running_mean"])
    assert CheckpointManager(os.path.join(run_dir, "fusion")).exists("last")


def test_pretrain_cli(tmp_path, monkeypatch):
    """`python -m ecgmm_torch.workloads.pretrain --device cpu
    --cache-embeddings` runs the four stages and prints the test accuracy
    (here at the small size); without --device it trains on the card, and
    raises where there is none."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(pretrain, "get_preset",
                        lambda name: _small(get_preset(name), tmp_path))
    pretrain.main(["--device", "cpu", "--epochs", "1", "--n-synth", "30",
                   "--cache-embeddings", "--run-dir", "pipe"])
    for stage in ("image_only", "signal_only", "clinical", "fusion"):
        assert (tmp_path / "pipe" / stage / "last.pt").is_file(), stage
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            pretrain.main(["--epochs", "1", "--n-synth", "30"])


def test_warm_start_filters_name_the_reference_layers():
    """The filters are JAX's (`fc`, `head_out`, `final_mapping`) in the
    port's names: each names exactly the tensors of that layer."""
    filters = {b: f[1][0] for b, f in pretrain.WARM_START_FILTERS.items()}
    model = ECGMultimodalModel(ModelConfig())
    for branch, prefix in filters.items():
        enc = getattr(model, f"{branch}_encoder")
        hit = [k for k in enc.state_dict() if k.startswith(prefix)]
        assert hit and all(k.split(".")[-1] in ("weight", "bias")
                           for k in hit), (branch, hit)
    assert [k for k in model.image_encoder.state_dict()
            if k.startswith("fc.")] == ["fc.weight", "fc.bias"]
