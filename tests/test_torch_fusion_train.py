"""The fusion-training slice of the port (`fusion` and
`fusion_modal_balance`) against the JAX package on the CPU, at a small
size: images 32x64, signals of 512 samples, ResNet1D-SE base filters 16,
float32, B=10, inputs from numpy seeds. Dropout is 0 on both sides: the
JAX model's signal encoder keeps its own dropout of 0.3 and its MLP
clinical encoder one of 0.3, which `ModelConfig` cannot reach, so the
JAX classes are replaced in `ecgmm_tpu.models.fusion` by partials with
dropout 0 for this module; the port sets p = 0 on its `Dropout` modules.

Bars, and why:
  * data, splits, images and clinical columns: equal (the same numpy
    draws and float32 arithmetic); the filtered signals within 1e-5
    (scipy's filtfilt against the JAX package's, both float64, stored as
    float32);
  * train-mode forwards: atol 1e-4 on outputs of size ~4 (1e-4 relative
    to the largest component for ResNet-18): at these sizes the image
    encoder's last BatchNorms see 20 values a channel, and normalising
    them carries the float32 rounding of 20 convolutions, summed in
    another order, to ~1e-5 relative (measured 3.1e-5 on 3.9). TabNet:
    atol 1e-4 where ghost BN cuts the batch (chunks of 2-4 rows), else
    1e-5: flax takes the batch variance as E[x^2] - E[x]^2
    (`use_fast_variance`), the port in two passes, and over 2 rows the
    cancellation reaches 4.3e-5 (2.4e-6 with flax's two-pass variance);
    the MLP 1e-5;
  * BatchNorm running statistics (values of order 1): rtol 1e-4, atol
    1e-4, the batch statistics of that noise folded in at momentum 0.1
    (0.02 for ghost BN) per step (measured up to 2.7e-5 after three
    steps);
  * train steps: the loss of the first step rtol 1e-4 (the forward's
    noise), of later steps rtol 1e-3, var_loss (a difference of
    variances of order 1) and the soft weights atol 1e-4 beside; the
    first step's gradients within
    1e-3 of each tensor's largest component (each sums the embeddings'
    1e-5 noise over the batch, where terms cancel: measured 1.9e-4 for
    `image_norm.weight`); the trainable parameters
    after each step within 1e-6, except that Adam's first update moves
    an element by lr * g / (|g| + eps), about lr whatever |g|, so an
    element whose gradient lies within the two frameworks' float32 noise
    of zero moves either way: at most 1 element in 2000 (measured: up to
    18 of 90443 after three steps) may differ, and by at most 2 * sum(lr);
    the later losses carry those elements; frozen parameters equal their
    initial values bit for bit on both sides.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecgmm_tpu.config import Config as JaxConfig
from ecgmm_tpu.config import ModelConfig as JaxModelConfig
from ecgmm_tpu.config import TrainConfig as JaxTrainConfig
from ecgmm_tpu.config import get_preset as jax_get_preset
from ecgmm_tpu.data import pipeline as jax_pipeline
from ecgmm_tpu.data import synthetic as jax_synthetic
from ecgmm_tpu.models import fusion as jax_fusion
from ecgmm_tpu.models.clinical import ClinicalMLPEncoder as JaxMLP
from ecgmm_tpu.models.clinical import TabNetEncoder as JaxTabNet
from ecgmm_tpu.models.resnet1d_se import ResNet1DSE as JaxResNet1DSE
from ecgmm_tpu.tools.export_pth import (export_fusion_canonical,
                                        export_fusion_modal_balance)
from ecgmm_tpu.train import engine as jax_engine
from ecgmm_tpu.train import optim as jax_optim
from ecgmm_tpu.train.state import create_state as jax_create_state
from ecgmm_tpu.train.state import encoder_freeze_predicate as jax_freeze
from ecgmm_tpu.utils.tree import flatten_path_dict, merge_params
from ecgmm_tpu.workloads import make_fusion_task as jax_make_fusion_task
from ecgmm_tpu.workloads import run as jax_run
from ecgmm_tpu.workloads.tasks import _fusion_loss as jax_fusion_loss
from ecgmm_torch.config import Config, ModelConfig, TrainConfig, get_preset
from ecgmm_torch.data import pipeline, synthetic
from ecgmm_torch.models import ECGMultimodalModel
from ecgmm_torch.models.fusion import FusionOutput, _chunk_variance_loss
from ecgmm_torch.models.layers import BatchNorm1d, BatchNorm2d, Dropout
from ecgmm_torch.tools.weights import from_jax_variables
from ecgmm_torch.train import engine
from ecgmm_torch.train.checkpoint import CheckpointManager
from ecgmm_torch.train.state import create_state, encoder_freeze_predicate
from ecgmm_torch.workloads import run as port_run
from ecgmm_torch.workloads.tasks import make_fusion_task

torch.set_num_threads(2)

HW, T, FILTERS, BS, SEED = (32, 64), 512, 16, 10, 5
VARIANTS = ("canonical", "modal_balance")
MASK_KINDS = ("ones", "some_zero", "all_zero", "single")


@pytest.fixture(scope="module", autouse=True)
def jax_encoders_without_dropout():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fusion, "ResNet1DSE",
                   functools.partial(JaxResNet1DSE, dropout=0.0))
        mp.setattr(jax_fusion, "ClinicalMLPEncoder",
                   functools.partial(JaxMLP, dropout=0.0))
        yield


def _jax_vbs(monkeypatch, vbs):
    monkeypatch.setattr(jax_fusion, "TabNetEncoder",
                        functools.partial(JaxTabNet, virtual_batch_size=vbs))


def _model_configs(variant):
    small = dict(dtype="float32", signal_base_filters=FILTERS, dropout=0.0)
    if variant == "canonical":
        return JaxModelConfig(**small), ModelConfig(**small)
    return (dataclasses.replace(JaxModelConfig.modal_balance(), **small),
            dataclasses.replace(ModelConfig.modal_balance(), **small))


def _perturbed(tree, rng):
    """Every leaf with seeded noise: kernels and BN variances scaled (so
    activations keep their size), every other leaf shifted."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _perturbed(v, rng)
            continue
        a = np.asarray(v, np.float32)
        noise = rng.normal(size=a.shape).astype(np.float32)
        if k == "var":
            out[k] = a * np.exp(0.2 * noise)
        elif k == "kernel":
            out[k] = a * (1 + 0.1 * noise)
        else:
            out[k] = a + 0.1 * noise
    return out


@pytest.fixture(scope="module")
def jax_models():
    """variant -> (JAX model, its perturbed variables)."""
    out = {}
    for variant in VARIANTS:
        jcfg, _ = _model_configs(variant)
        jmodel = jax_fusion.ECGMultimodalModel(cfg=jcfg)
        variables = jax.jit(jmodel.init)(
            jax.random.PRNGKey(0), jnp.ones((1,) + HW + (3,)),
            jnp.ones((1, T)), jnp.ones((1, jcfg.clinical_in_features)))
        out[variant] = (jmodel, _perturbed(jax.device_get(variables),
                                           np.random.default_rng(7)))
    return out


def _port_model(variant, variables, vbs=128):
    model = ECGMultimodalModel(_model_configs(variant)[1])
    model.load_state_dict(from_jax_variables(variables), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
        if hasattr(m, "virtual_batch_size"):
            m.virtual_batch_size = vbs
    return model


def _port_sd(variables):
    return from_jax_variables(jax.device_get(variables))


def _assert_stats(model, want, prefix=""):
    """Every running mean and variance under `prefix` against `want`."""
    n = 0
    for name, got in model.state_dict().items():
        if name.startswith(prefix) and "running_" in name:
            np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=name)
            n += 1
    assert n > 0


def _inputs(n_clinical, b=BS, seed=3):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(b,) + HW + (3,), dtype=np.uint8)
    sig = rng.normal(size=(b, T)).astype(np.float32)
    clin = rng.normal(size=(b, n_clinical)).astype(np.float32)
    return img, sig, clin


def _nchw(img):
    return torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))


# ------------------------------------------------------------ repaired faults

def _mask(kind, b, rng):
    if kind == "ones":
        return np.ones(b, np.float32)
    if kind == "all_zero":
        return np.zeros(b, np.float32)
    if kind == "single":  # sum(mask) == 1: max(sum(mask), 1) ties
        return (np.arange(b) == b // 2).astype(np.float32)
    mask = (rng.random(b) < 0.6).astype(np.float32)
    mask[[0, -1]] = (1.0, 0.0)
    return mask


@pytest.mark.parametrize("kind", MASK_KINDS)
def test_chunk_variance_loss_mask_gradient_matches_jax(kind):
    """The regulariser's value and its VJP w.r.t. the three embeddings and
    the mask, for a cotangent other than 1, against jax.vjp: at
    sum(mask) == 1 jnp.maximum's VJP gives each side half."""
    rng = np.random.default_rng(11)
    ins = [rng.normal(size=(7, w)).astype(np.float32) * (1 + w / 4)
           for w in (6, 5, 3)] + [_mask(kind, 7, rng)]
    want, vjp = jax.vjp(jax_fusion._chunk_variance_loss,
                        *map(jnp.asarray, ins))
    want_grads = vjp(jnp.float32(-1.3))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    got = _chunk_variance_loss(*leaves)
    grads = torch.autograd.grad(got, leaves, torch.tensor(-1.3))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for name, g, w in zip(("img", "sig", "clin", "mask"), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6, err_msg=name)


def _tiny_state(seed, variables):
    """The canonical model with the head's dropout live (the config's p
    0.3) and the signal encoder's off, frozen encoders, Adam at lr
    1e-2."""
    model = ECGMultimodalModel(dataclasses.replace(
        _model_configs("canonical")[1], dropout=0.3))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model.signal_encoder.classifier[3].p = 0.0
    cfg = TrainConfig(batch_size=BS, lr=1e-2, seed=seed)
    return create_state(model, cfg, 3, freeze=encoder_freeze_predicate)


def test_head_dropout_draws_from_the_state_generator(jax_models, tmp_path):
    """Two steps from one seed are bit-equal, another seed gives other
    parameters, and a state restored after the first step takes the same
    second step: the head's dropout draws from the train state's
    generator, not from torch's global one."""
    _, variables = jax_models["canonical"]
    img, sig, clin = _inputs(2)
    batch = pipeline.Batch(_nchw(img), torch.from_numpy(sig),
                           torch.from_numpy(clin),
                           torch.from_numpy(np.arange(BS) % 2),
                           torch.ones(BS))
    task = make_fusion_task(TrainConfig())

    def steps(state, n):
        for _ in range(n):
            engine.train_step(task, state, batch)
        return state.model.state_dict()

    a = steps(_tiny_state(1, variables), 2)
    b = steps(_tiny_state(1, variables), 2)
    c = steps(_tiny_state(2, variables), 2)
    assert all(torch.equal(v, b[k]) for k, v in a.items())
    assert not torch.equal(a["fusion_classifier.0.weight"],
                           c["fusion_classifier.0.weight"])

    ckpt = CheckpointManager(str(tmp_path))
    first = _tiny_state(1, variables)
    steps(first, 1)
    ckpt.save("last", first)
    resumed = ckpt.restore("last", _tiny_state(1, variables))
    assert torch.equal(resumed.generator.get_state(),
                       first.generator.get_state())
    r = steps(resumed, 1)
    assert all(torch.equal(v, r[k]) for k, v in a.items())


@pytest.mark.parametrize("raw", [True, False], ids=["uint8", "float"])
def test_resnet18_train_mode_matches_jax(jax_models, raw):
    """The image encoder's train-mode output and the running statistics
    it leaves, against the JAX ResNet-18's updated `batch_stats`: the
    biased batch variance is folded in (torch's BatchNorm2d folds the
    unbiased one)."""
    jmodel, variables = jax_models["canonical"]
    img = _inputs(2)[0]
    x = img if raw else img.astype(np.float32) / 127.5 - 1.0
    want, mut = jmodel.apply(
        variables, jnp.asarray(x), mutable=["batch_stats"],
        method=lambda m, x: m.image_encoder(x, train=True))
    model = _port_model("canonical", variables).train()
    got = model.image_encoder(_nchw(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4 * float(np.abs(want).max()))
    want_sd = _port_sd({"params": variables["params"],
                        "batch_stats": {**variables["batch_stats"],
                                        **mut["batch_stats"]}})
    _assert_stats(model, want_sd, "image_encoder.")


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("dims", [2, 3, 4])
def test_batchnorm_statistics_dtype(dtype, dims):
    """Flax-style train-mode BatchNorm (1d and 2d) takes the batch
    statistics in at least float32, whatever the activation's dtype, and
    folds the biased variance into buffers of the module's dtype: a
    float64 model (the float64 gradients of `tools/grad_precision`) keeps
    float64, a bf16 activation under autocast updates float32 buffers."""
    rng = np.random.default_rng(dims)
    shape = (6, 3) + (5,) * (dims - 2)
    x = torch.from_numpy(rng.normal(1.0, 2.0, size=shape))
    bn = (BatchNorm2d(3) if dims == 4 else BatchNorm1d(3)).train()
    if dtype == "float64":
        bn = bn.double()
    x = x.to(getattr(torch, dtype))
    out = bn(x)
    assert out.dtype == x.dtype
    ref = x.double()
    axes = (0,) + tuple(range(2, dims))
    var, mean = torch.var_mean(ref, dim=axes, unbiased=False)
    tol = 1e-2 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(bn.running_mean.double().numpy(),
                               0.1 * mean.numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(bn.running_var.double().numpy(),
                               0.9 + 0.1 * var.numpy(), rtol=tol, atol=tol)
    assert bn.running_var.dtype == (torch.float64 if dtype == "float64"
                                    else torch.float32)


# ------------------------------------------------------------ encoders

@pytest.mark.parametrize("b,vbs", [(10, 4), (9, 4), (4, 4), (6, 8),
                                   (10, 128)],
                         ids=["chunks-4-4-2", "chunks-3-3-3", "equal-vbs",
                              "below-vbs", "plain"])
def test_tabnet_train_mode_matches_jax(jax_models, monkeypatch, b, vbs):
    """TabNet's train forward (latent and m_loss) and the running
    statistics of every BatchNorm, ghost BN over torch.chunk's greedy
    virtual batches, against JAX."""
    _jax_vbs(monkeypatch, vbs)
    jmodel, variables = jax_models["canonical"]
    clin = _inputs(2, b=b)[2] * 3.0
    (want, want_m), mut = jmodel.apply(
        variables, jnp.asarray(clin), mutable=["batch_stats"],
        method=lambda m, c: m.clinical_encoder(c, train=True))
    model = _port_model("canonical", variables, vbs).train()
    got, m_loss = model.clinical_encoder(torch.from_numpy(clin))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4 if b > vbs else 1e-5)
    np.testing.assert_allclose(float(m_loss), float(want_m), atol=1e-5)
    want_sd = _port_sd({"params": variables["params"],
                        "batch_stats": {**variables["batch_stats"],
                                        **mut["batch_stats"]}})
    _assert_stats(model, want_sd, "clinical_encoder.")
    # one update per chunk: the GLU BNs count ceil(b / ceil(b / n)) chunks
    bn = model.clinical_encoder.tabnet.encoder.att_transformers[0].bn.bn
    n_chunks = -(-b // vbs)
    assert int(bn.num_batches_tracked) == -(-b // -(-b // n_chunks))


def test_clinical_mlp_train_mode_matches_jax(jax_models):
    jmodel, variables = jax_models["modal_balance"]
    clin = _inputs(24, b=7)[2]
    want, mut = jmodel.apply(
        variables, jnp.asarray(clin), mutable=["batch_stats"],
        method=lambda m, c: m.clinical_encoder(c, train=True))
    model = _port_model("modal_balance", variables).train()
    got = model.clinical_encoder(torch.from_numpy(clin))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    want_sd = _port_sd({"params": variables["params"],
                        "batch_stats": {**variables["batch_stats"],
                                        **mut["batch_stats"]}})
    _assert_stats(model, want_sd, "clinical_encoder.")


@pytest.mark.parametrize("variant", VARIANTS)
def test_fusion_output_train_mode_matches_jax(jax_models, variant):
    """The whole model in train mode, pad rows masked: every FusionOutput
    field and every encoder's running statistics."""
    jmodel, variables = jax_models[variant]
    img, sig, clin = _inputs(jmodel.cfg.clinical_in_features)
    mask = np.r_[np.ones(7), np.zeros(3)].astype(np.float32)
    want, mut = jmodel.apply(
        variables, jnp.asarray(img), jnp.asarray(sig), jnp.asarray(clin),
        mask=jnp.asarray(mask), train=True, mutable=["batch_stats"])
    model = _port_model(variant, variables).train()
    got = model(_nchw(img), torch.from_numpy(sig), torch.from_numpy(clin),
                mask=torch.from_numpy(mask))
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-4, err_msg=name)
    _assert_stats(model, _port_sd({"params": variables["params"],
                                   **mut}))


@pytest.mark.parametrize("variant", VARIANTS)
def test_weights_bridge_equals_jax_exporter(jax_models, variant):
    """`from_jax_variables` equals the variant's JAX exporter bit for bit,
    and every BatchNorm's batch_stats land in its running buffers."""
    _, variables = jax_models[variant]
    exporter = (export_fusion_canonical if variant == "canonical"
                else export_fusion_modal_balance)
    got = from_jax_variables(variables)
    want = exporter(variables)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == np.asarray(v).dtype, k
        assert np.array_equal(got[k].numpy(), v), k
    stats = flatten_path_dict(variables["batch_stats"])
    for kind, buf in (("mean", "running_mean"), ("var", "running_var")):
        leaves = sorted(np.asarray(v).tobytes() for k, v in stats.items()
                        if k.endswith("/" + kind))
        bufs = sorted(v.numpy().tobytes() for k, v in got.items()
                      if k.endswith(buf))
        assert leaves == bufs
    model = ECGMultimodalModel(_model_configs(variant)[1])
    model.load_state_dict(got, strict=True)


def _port_output(outs, var_loss, sw):
    return FusionOutput(*map(torch.from_numpy, outs),
                        torch.tensor(var_loss), torch.from_numpy(sw),
                        torch.zeros(()))


@pytest.mark.parametrize("branch_weight", [0.0, 1.0])
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_fusion_loss_matches_jax(branch_weight, kind):
    """The fusion task's loss (CE(fusion) + 0.1 var_loss, plus the summed
    branch CEs where `branch_loss_weight` is set, train_exhausted.py) and
    its metrics, against the JAX task's on the same outputs."""
    rng = np.random.default_rng(int(branch_weight) + len(kind))
    outs = [rng.normal(size=(6, 2)).astype(np.float32) * 2
            for _ in range(4)]
    var_loss, sw = np.float32(0.7), np.asarray([0.2, 0.5, 0.3], np.float32)
    labels = rng.integers(0, 2, 6)
    mask = _mask(kind, 6, rng)
    tc = dict(branch_loss_weight=branch_weight)
    want, want_mets = jax_fusion_loss(JaxTrainConfig(**tc))(
        jax_fusion.FusionOutput(*map(jnp.asarray, outs), jnp.asarray(var_loss),
                                jnp.asarray(sw), jnp.float32(0.0)),
        jax_pipeline.Batch(None, None, None, jnp.asarray(labels),
                           jnp.asarray(mask)))
    task = make_fusion_task(TrainConfig(**tc))
    got, mets = task.loss(
        _port_output(outs, var_loss, sw),
        pipeline.Batch(None, None, None, torch.from_numpy(labels),
                       torch.from_numpy(mask)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert set(mets) == set(want_mets) == {"var_loss", "soft_weights"}
    np.testing.assert_array_equal(mets["soft_weights"].numpy(), sw)


# ------------------------------------------------------------ train steps

STEP_CASES = [("canonical", 128), ("canonical", 4), ("modal_balance", 128)]


def _step_plan(n_train, distinct_pads=False):
    """Three batches of BS rows: full, padded (6 real rows), and one real
    row (sum(mask) == 1). Pad rows take index 0, as the engine's plan
    does, or with `distinct_pads` other rows of the split: a ghost-BN
    chunk made only of copies of one row has zero variance, so each
    BatchNorm multiplies its rounding by 1 / sqrt(eps) ~ 316 and the two
    frameworks' roundings grow apart to order 1 within a few layers
    (measured 6e-3 in a running mean), which is the reference's
    arithmetic, not a fault of either side."""
    rng = np.random.default_rng(SEED)
    order = rng.permutation(n_train)
    pads = (order[-BS:] if distinct_pads
            else np.zeros(BS, np.int64))
    idx = [order[:BS], np.r_[order[BS:BS + 6], pads[:4]],
           np.r_[order[BS + 6:BS + 7], pads[:BS - 1]]]
    masks = [np.ones(BS, np.float32),
             np.r_[np.ones(6), np.zeros(4)].astype(np.float32),
             (np.arange(BS) == 0).astype(np.float32)]
    return idx, masks


@pytest.fixture(scope="module")
def trimodal_data():
    """variant -> the JAX and the port materialisation of one cohort."""
    out = {}
    for variant in VARIANTS:
        jm, pm = _model_configs(variant)
        cohort = synthetic.make_cohort(n=40, signal_len=T, img_hw=HW,
                                       n_clinical=jm.clinical_in_features,
                                       seed=SEED)
        out[variant] = (
            jax_pipeline.materialize_trimodal(
                cohort, JaxConfig(model=jm, train=JaxTrainConfig(seed=SEED))),
            pipeline.materialize_trimodal(
                cohort, Config(model=pm, train=TrainConfig(seed=SEED)),
                device="cpu"),
        )
    return out


@pytest.mark.parametrize("variant,vbs", STEP_CASES,
                         ids=["canonical", "canonical-ghost-bn",
                              "modal-balance"])
def test_fusion_train_steps_match_jax(jax_models, trimodal_data, monkeypatch,
                                      variant, vbs):
    """One and three `fusion` train steps (constant Adam 1e-4, frozen
    encoders in train mode) against JAX `make_train_step(make_fusion_task)`
    with `encoder_freeze_predicate`, over a full, a padded and a
    sum(mask) == 1 batch: loss and metrics, the first step's gradients,
    the trainable parameters and every encoder's running statistics after
    each step, frozen parameters unchanged bit for bit."""
    _jax_vbs(monkeypatch, vbs)
    jmodel, variables = jax_models[variant]
    jdata, pdata = trimodal_data[variant]
    tc = dict(batch_size=BS, seed=SEED)
    jcfg, cfg = JaxTrainConfig(**tc), TrainConfig(**tc)
    tx = jax_optim.make_optimizer(jcfg, 3)
    jstate = jax_create_state(variables, tx, jax.random.PRNGKey(0),
                              freeze_predicate=jax_freeze)
    jtask = jax_make_fusion_task(jmodel, jcfg)
    jstep = jax_engine.make_train_step(jtask, tx, donate=False)
    model = _port_model(variant, variables, vbs)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_state(model, cfg, 3, freeze=encoder_freeze_predicate)
    task = make_fusion_task(cfg)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trainable and all(not encoder_freeze_predicate(n)
                             for n in trainable)
    assert sum(p.numel() for g in state.optimizer.adam.param_groups
               for p in g["params"]) == sum(
        p.numel() for n, p in model.named_parameters() if n in trainable)

    sum_lr = 0.0
    plan = _step_plan(pdata.train.n, distinct_pads=vbs < BS)
    for i, (idx, mask) in enumerate(zip(*plan)):
        jb = jax_pipeline.Batch(
            *(jnp.take(a, idx, axis=0) for a in (
                jdata.train.images, jdata.train.signals,
                jdata.train.clinical, jdata.train.labels)),
            jnp.asarray(mask))
        if i == 0:
            def jloss(params):
                out, _ = jtask.apply(
                    {"params": merge_params(params, jstate.frozen),
                     **jstate.model_state}, jb, train=True,
                    rngs={"dropout": jstate.rng})
                return jtask.loss(out, jb)[0]

            jgrads = jax.device_get(jax.grad(jloss)(jstate.trainable))
        jstate, jmets = jstep(jstate, jb)
        mets = engine.train_step(task, state, engine.gather_batch(
            pdata.train, torch.from_numpy(idx), torch.from_numpy(mask)))
        sum_lr += cfg.lr
        np.testing.assert_allclose(float(mets["loss"]), float(jmets["loss"]),
                                   rtol=1e-4 if i == 0 else 1e-3)
        for k in ("var_loss", "soft_weights"):
            np.testing.assert_allclose(mets[k].numpy(),
                                       np.asarray(jmets[k]), rtol=1e-3,
                                       atol=1e-4, err_msg=k)
        assert float(mets["count"]) == float(jmets["count"]) == mask.sum()
        want = _port_sd({"params": merge_params(jstate.trainable,
                                                jstate.frozen),
                         **jstate.model_state})
        if i == 0:
            want_grads = _port_sd({"params": merge_params(jgrads,
                                                          jstate.frozen),
                                   "batch_stats": variables["batch_stats"]})
            for name, p in model.named_parameters():
                if name not in trainable:
                    assert p.grad is None, name
                    continue
                g = want_grads[name]
                got = torch.zeros_like(p) if p.grad is None else p.grad
                scale = float(g.abs().max())
                np.testing.assert_allclose(got.numpy(), g.numpy(),
                                           atol=1e-3 * scale + 1e-12,
                                           err_msg=name)
        n_off = n_all = 0
        for name, got in model.state_dict().items():
            if name.endswith("num_batches_tracked") or "running_" in name:
                continue
            w = want[name]
            if name not in trainable:
                assert torch.equal(got, init[name]), name
                assert torch.equal(w, init[name]), name
                continue
            diff = (got - w).abs()
            assert float(diff.max()) <= 2 * sum_lr + 1e-7, name
            n_off += int((diff > 1e-6).sum())
            n_all += diff.numel()
        assert n_off <= n_all // 2000, (n_off, n_all)
        _assert_stats(model, want)
    assert state.step == 3 and model.training
    if variant == "canonical":  # branch classifiers: no loss reaches them
        for name in ("image_classifier.weight", "clinical_classifier.bias"):
            assert torch.equal(model.state_dict()[name], init[name])


# ------------------------------------------------------------ data

@pytest.mark.parametrize("n_clinical", [2, 24])
def test_make_cohort_with_images_bit_equal(n_clinical):
    want = jax_synthetic.make_cohort(n=5, signal_len=600, img_hw=(224, 224),
                                     n_clinical=n_clinical, seed=9)
    got = synthetic.make_cohort(n=5, signal_len=600, img_hw=(224, 224),
                                n_clinical=n_clinical, seed=9)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert got.images.dtype == np.uint8 and got.images.shape[1:] == (
        224, 224, 3)


@pytest.mark.parametrize("variant", VARIANTS)
def test_materialize_trimodal_matches_jax(trimodal_data, variant):
    jdata, pdata = trimodal_data[variant]
    for name in ("train", "val", "test"):
        j, p = getattr(jdata, name), getattr(pdata, name)
        assert p.images.dtype == torch.uint8 and p.images.shape[1] == 3
        np.testing.assert_array_equal(
            p.images.numpy(), np.asarray(j.images).transpose(0, 3, 1, 2))
        np.testing.assert_allclose(p.signals.numpy(), np.asarray(j.signals),
                                   atol=1e-5)
        np.testing.assert_array_equal(p.clinical.numpy(),
                                      np.asarray(j.clinical))
        np.testing.assert_array_equal(p.labels.numpy(),
                                      np.asarray(j.labels))
        np.testing.assert_array_equal(p.indices, j.indices)
    for s in ("ecg_scaler", "clinical_scaler"):
        for f in ("mean", "scale"):
            np.testing.assert_array_equal(getattr(getattr(pdata, s), f),
                                          getattr(getattr(jdata, s), f))
    n_scaled = 24 if variant == "modal_balance" else 2
    assert pdata.clinical_scaler.mean.shape == (n_scaled,)


def _small(cfg, tmp_path=None, epochs=1):
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, signal_len=T, img_height=HW[0],
                                 img_width=HW[1]),
        model=dataclasses.replace(cfg.model, signal_base_filters=FILTERS))
    if tmp_path is None:
        return cfg
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=epochs,
        checkpoint_dir=str(tmp_path / "ckpt"),
        log_dir=str(tmp_path / "runs"),
        output_dir=str(tmp_path / "output")))


@pytest.mark.parametrize("name", ["fusion", "fusion_modal_balance"])
def test_load_data_matches_jax(name):
    want = jax_run.load_data(_small(jax_get_preset(name)), "synthetic", 40)
    got = port_run.load_data(_small(get_preset(name)), "synthetic", 40,
                             device="cpu")
    for split in ("train", "val", "test"):
        j, p = getattr(want, split), getattr(got, split)
        np.testing.assert_array_equal(p.indices, j.indices)
        np.testing.assert_array_equal(
            p.images.numpy(), np.asarray(j.images).transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(p.clinical.numpy(),
                                      np.asarray(j.clinical))
        np.testing.assert_allclose(p.signals.numpy(), np.asarray(j.signals),
                                   atol=1e-5)


# ------------------------------------------------------------ end to end

@pytest.mark.parametrize("name", ["fusion", "fusion_modal_balance"])
def test_run_end_to_end_on_cpu(name, tmp_path):
    """`run()` trains the preset (bf16 encoders under autocast, frozen,
    in train mode), logs the attention weights and the val var_loss,
    writes the best/last reports and checkpoints, and resumes."""
    cfg = _small(get_preset(name), tmp_path, epochs=2)
    data = port_run.load_data(cfg, "synthetic", 40, device="cpu")
    result, results = port_run.run(cfg, data, run_dir=str(tmp_path / "r"),
                                   verbose=False, device="cpu")
    assert len(result.history) == 2
    for h in result.history:
        assert np.isfinite(h["Loss/Train"]) and np.isfinite(h["VarLoss/Val"])
        sw = [h[f"AttentionWeights/{b}_w"]
              for b in ("Image", "Signal", "Clinical")]
        assert abs(sum(sw) - 1.0) < 1e-5
    assert result.history[0]["LR"] == pytest.approx(1e-4)
    model = result.state.model
    assert all(not p.requires_grad for n, p in model.named_parameters()
               if encoder_freeze_predicate(n))
    for tag in ("best", "last"):
        assert {"accuracy", "f1", "auroc", "temperature"} <= set(results[tag])
        assert os.path.isfile(tmp_path / "output" / "r" / f"report_{tag}.txt")
    ckpt = CheckpointManager(str(tmp_path / "r"))
    assert all(ckpt.exists(t) for t in ("best", "last", "calibration"))
    log = (tmp_path / "runs" / "r" / "metrics.jsonl").read_text()
    assert len(log.splitlines()) == 2 and "AttentionWeights/Image_w" in log

    resumed, _ = port_run.run(cfg, data, run_dir=str(tmp_path / "r"),
                              verbose=False, resume=True, device="cpu")
    assert resumed.history == [] and resumed.state.epoch == 2
    live = result.state.model.state_dict()
    for k, v in resumed.state.model.state_dict().items():
        assert torch.equal(v, live[k]), k


def test_fusion_cli_and_the_waiting_paths(tmp_path, monkeypatch):
    """`--preset fusion --device cpu` trains and reports (here at the
    small size, through `main`), and so do the cached-embedding path's
    two spellings, `--cache-embeddings` and `--preset fusion_cached`: the
    run encodes its splits once and trains the fusion head over them."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_run, "get_preset",
                        lambda name: _small(get_preset(name)))
    port_run.main(["--preset", "fusion", "--device", "cpu", "--epochs", "1",
                   "--n-synth", "40", "--run-dir", "checkpoints/r"])
    for path in ("checkpoints/r/best.pt", "checkpoints/r/last.pt",
                 "output/r/report_best.txt", "output/r/report_last.txt"):
        assert (tmp_path / path).is_file(), path
    from ecgmm_torch.train import embed

    encoded = []
    real = embed.precompute_fusion_embeddings
    monkeypatch.setattr(embed, "precompute_fusion_embeddings",
                        lambda *a: encoded.append(a[1].n) or real(*a))
    for i, argv in enumerate((["--cache-embeddings"],
                              ["--preset", "fusion_cached"])):
        encoded.clear()
        port_run.main(argv + ["--device", "cpu", "--epochs", "1",
                              "--n-synth", "40", "--run-dir", f"c{i}"])
        assert len(encoded) == 3  # train, val, test: once each
        assert (tmp_path / "output" / f"c{i}" / "report_last.txt").is_file()
