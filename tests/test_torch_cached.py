"""The cached-embedding fusion path of the port (`fusion_cached`,
`--cache-embeddings`) and the fusion head's compute dtype, against the JAX
package on the CPU at a small size: images 32x32, signals of 256 samples,
ResNet1D-SE base filters 16, inputs from numpy seeds.

Where a test runs the encoders in train mode with dropout off, the JAX
classes are replaced in `ecgmm_tpu.models.fusion` by partials with dropout
0 (the JAX signal encoder keeps its own 0.3, which `ModelConfig` cannot
reach), and the port sets p = 0 on its `Dropout` modules. The
calibration test keeps every dropout live on both sides: no dropout lies
before a BatchNorm, so the buffers do not depend on the masks.

Bars, and why:
  * float32 encoders in eval mode (`encode_raw`): 1e-4 of the largest
    component: every BatchNorm uses fixed statistics, so the outputs
    carry the float32 rounding of the convolutions summed in other orders
    (measured ~1e-6 relative);
  * the surface over the same embeddings (`from_embeddings`), float32:
    atol 1e-5 (LayerNorms, small Linears);
  * a cached head step: loss rtol 1e-5, gradients within 1e-4 of each
    tensor's largest component, parameters within 1e-6 but for Adam's
    turned elements (as tests/test_torch_fusion_train.py states);
  * calibrated BatchNorm buffers: rtol and atol 1e-4, as the fusion
    train steps hold the running statistics;
  * the bf16 head: flax's bf16 Dense rounds the f32 product to bf16, then
    adds the bf16 bias and rounds again; the port's head does the same,
    so its bf16 hidden activations equal JAX's and the logits agree to
    float32 rounding (atol 1e-5), while a head in float32 stays the whole
    bf16 gap (~1e-2) away from JAX's bf16 head;
  * the bf16 model against JAX's bf16 model: the two frameworks round in
    other places (autocast against flax's dtype), so the bar comes from
    bf16 rounding itself: per tensor, max|port_bf16 - jax_bf16| <=
    2 max|jax_bf16 - jax_f32| + atol, atol 1e-6 of the tensor's largest
    component (a tensor bf16 leaves alone, such as a scalar that rounds
    the same in both dtypes, is held to float32 rounding).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecgmm_tpu.config import Config as JaxConfig
from ecgmm_tpu.config import ModelConfig as JaxModelConfig
from ecgmm_tpu.config import TrainConfig as JaxTrainConfig
from ecgmm_tpu.data import pipeline as jax_pipeline
from ecgmm_tpu.models import fusion as jax_fusion
from ecgmm_tpu.models.clinical import ClinicalMLPEncoder as JaxMLP
from ecgmm_tpu.models.resnet1d_se import ResNet1DSE as JaxResNet1DSE
from ecgmm_tpu.train import embed as jax_embed
from ecgmm_tpu.train import engine as jax_engine
from ecgmm_tpu.train import optim as jax_optim
from ecgmm_tpu.train.state import create_state as jax_create_state
from ecgmm_tpu.train.state import encoder_freeze_predicate as jax_freeze
from ecgmm_tpu.utils.tree import merge_params
from ecgmm_tpu.workloads.tasks import make_fusion_head_task as jax_head_task
from ecgmm_tpu.workloads.tasks import make_fusion_task as jax_fusion_task
from ecgmm_torch.config import Config, ModelConfig, TrainConfig, get_preset
from ecgmm_torch.data import pipeline, synthetic
from ecgmm_torch.models import ECGMultimodalModel, ResNet1DSE
from ecgmm_torch.models.layers import Dropout, flax_init_
from ecgmm_torch.tools.weights import from_jax_variables
from ecgmm_torch.train import embed, engine
from ecgmm_torch.train.checkpoint import CheckpointManager
from ecgmm_torch.train.state import create_state, encoder_freeze_predicate
from ecgmm_torch.workloads import run as port_run
from ecgmm_torch.workloads.tasks import (make_fusion_head_task,
                                         make_fusion_task)

torch.set_num_threads(2)

HW, T, FILTERS, BS, SEED = (32, 32), 256, 16, 8, 5
VARIANTS = ("canonical", "modal_balance")


@pytest.fixture
def jax_dropout_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fusion, "ResNet1DSE",
                   functools.partial(JaxResNet1DSE, dropout=0.0))
        mp.setattr(jax_fusion, "ClinicalMLPEncoder",
                   functools.partial(JaxMLP, dropout=0.0))
        yield


def _model_configs(variant, dtype="float32", dropout=0.0):
    small = dict(dtype=dtype, signal_base_filters=FILTERS, dropout=dropout)
    if variant == "canonical":
        return JaxModelConfig(**small), ModelConfig(**small)
    return (dataclasses.replace(JaxModelConfig.modal_balance(), **small),
            dataclasses.replace(ModelConfig.modal_balance(), **small))


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


@functools.lru_cache(maxsize=None)
def _variables(variant):
    jcfg, _ = _model_configs(variant)
    model = jax_fusion.ECGMultimodalModel(cfg=jcfg)
    return _variables_of(model, (1,) + HW + (3,), (1, T),
                         (1, jcfg.clinical_in_features))


@pytest.fixture(scope="module")
def variables():
    """variant -> perturbed variables of the small JAX fusion model, made
    on first use."""
    class Lazy(dict):
        def __missing__(self, variant):
            return _variables(variant)

    return Lazy()


def _port_model(variant, variables, dtype="float32", dropout=0.0,
                dropout_off=True):
    model = ECGMultimodalModel(_model_configs(variant, dtype, dropout)[1])
    model.load_state_dict(from_jax_variables(variables), strict=True)
    if dropout_off:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return model


@functools.lru_cache(maxsize=None)
def _trimodal_data(variant):
    """The JAX and the port materialisation of one small cohort."""
    jm, pm = _model_configs(variant)
    cohort = synthetic.make_cohort(n=45, signal_len=T, img_hw=HW,
                                   n_clinical=jm.clinical_in_features,
                                   seed=SEED)
    return (jax_pipeline.materialize_trimodal(
                cohort, JaxConfig(model=jm, train=JaxTrainConfig(seed=SEED))),
            pipeline.materialize_trimodal(
                cohort, Config(model=pm, train=TrainConfig(seed=SEED)),
                device="cpu"))


def _nchw(img):
    return torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))


def _inputs(n_clinical, b=BS, seed=3):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(b,) + HW + (3,), dtype=np.uint8)
    sig = rng.normal(size=(b, T)).astype(np.float32)
    clin = rng.normal(size=(b, n_clinical)).astype(np.float32)
    return img, sig, clin


def _close_to_largest(got, want, rel, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rel * float(np.abs(want).max()) + 1e-12,
                               err_msg=name)


def _assert_stats(model, want, prefix=""):
    n = 0
    for name, got in model.state_dict().items():
        if name.startswith(prefix) and "running_" in name:
            np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=name)
            n += 1
    assert n > 0


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("variant", VARIANTS)
def test_encode_raw_and_from_embeddings_match_jax(variables, variant):
    """`encode_raw` (eval-mode encoders, the port's modules left in the
    mode they had) and `from_embeddings` (the trainable surface, pad rows
    masked) against JAX's, and from_embeddings(encode_raw(x)) equals the
    eval-mode forward."""
    jcfg, _ = _model_configs(variant)
    jmodel = jax_fusion.ECGMultimodalModel(cfg=jcfg)
    v = variables[variant]
    img, sig, clin = _inputs(jcfg.clinical_in_features)
    mask = np.r_[np.ones(5), np.zeros(3)].astype(np.float32)
    want_raw = jax.jit(functools.partial(
        jmodel.apply, method=jax_fusion.ECGMultimodalModel.encode_raw))(
        v, jnp.asarray(img), jnp.asarray(sig), jnp.asarray(clin))
    want = jax.jit(functools.partial(
        jmodel.apply, method=jax_fusion.ECGMultimodalModel.from_embeddings))(
        v, *want_raw, mask=jnp.asarray(mask))
    model = _port_model(variant, v).train()
    with torch.no_grad():
        raw = model.encode_raw(_nchw(img), torch.from_numpy(sig),
                               torch.from_numpy(clin))
        assert model.training and all(m.training for m in model.modules())
        for name, g, w in zip(("img", "sig", "clin"), raw, want_raw):
            assert g.dtype == torch.float32 and g.shape == w.shape
            _close_to_largest(g.numpy(), w, 1e-4, name)
        raw_j = [torch.from_numpy(np.array(w)) for w in want_raw]
        got = model.from_embeddings(*raw_j, mask=torch.from_numpy(mask))
        assert got._fields == want._fields
        for name, g, w in zip(got._fields, got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       err_msg=name)
        model.eval()
        direct = model(_nchw(img), torch.from_numpy(sig),
                       torch.from_numpy(clin), mask=torch.from_numpy(mask))
        cached = model.from_embeddings(*raw, mask=torch.from_numpy(mask))
    for name, d, c in zip(direct._fields, direct, cached):
        if name != "m_loss":
            np.testing.assert_allclose(c.numpy(), d.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=name)


def _fused(rng, b, dims):
    return [rng.normal(size=(b, w)).astype(np.float32) for w in dims]


def test_bf16_head_matches_jax_head():
    """`fuse_embeddings` (attention fusion, then `head`) of a bf16 model
    against JAX's on the same LayerNorm'd embeddings: the hidden layer,
    its ReLU and dropout in bf16, the output layer in float32. JAX's bf16
    head is ~1e-2 from its float32 head; the port's is at float32
    rounding from JAX's bf16 one (a float32 hidden layer would not be)."""
    jf32, _ = _model_configs("canonical")
    jbf, pbf = _model_configs("canonical", "bfloat16")
    dims = (jf32.image_dim, jf32.signal_dim, jf32.clinical_dim)
    rng = np.random.default_rng(2)
    feats = _fused(rng, 16, dims)
    model = ECGMultimodalModel(pbf)
    head = {"fusion_hidden": {"kernel": rng.normal(size=(sum(dims), 128))
                              .astype(np.float32) * 0.05,
                              "bias": rng.normal(size=128)
                              .astype(np.float32) * 0.2},
            "fusion_out": {"kernel": rng.normal(size=(128, 2))
                           .astype(np.float32) * 0.1,
                           "bias": np.asarray([0.1, -0.1], np.float32)},
            "attention_fusion": {
                "weights": np.asarray([0.3, -0.2, 0.1], np.float32),
                "norm": {"scale": 1 + 0.1 * rng.normal(size=sum(dims))
                         .astype(np.float32),
                         "bias": 0.1 * rng.normal(size=sum(dims))
                         .astype(np.float32)}}}
    want, hidden = {}, {}
    for dt, jcfg in (("bf16", jbf), ("f32", jf32)):
        jm = jax_fusion.ECGMultimodalModel(cfg=jcfg)
        want[dt] = np.asarray(jm.apply(
            {"params": head}, *map(jnp.asarray, feats),
            method=jax_fusion.ECGMultimodalModel.fuse_embeddings))
        hidden[dt] = jm.apply(
            {"params": head}, *map(jnp.asarray, feats),
            method=lambda m, *f: jax.nn.relu(m.fusion_hidden(
                m.attention_fusion(*f)[0])))
    assert hidden["bf16"].dtype == jnp.bfloat16
    sd = model.state_dict()
    sd.update({
        "fusion_classifier.0.weight": head["fusion_hidden"]["kernel"].T,
        "fusion_classifier.0.bias": head["fusion_hidden"]["bias"],
        "fusion_classifier.3.weight": head["fusion_out"]["kernel"].T,
        "fusion_classifier.3.bias": head["fusion_out"]["bias"],
        "attention_fusion.weights": head["attention_fusion"]["weights"],
        "attention_fusion.norm.weight":
            head["attention_fusion"]["norm"]["scale"],
        "attention_fusion.norm.bias": head["attention_fusion"]["norm"]["bias"],
    })
    model.load_state_dict({k: torch.as_tensor(np.ascontiguousarray(v))
                           for k, v in sd.items()})
    seen = []
    model.fusion_classifier[1].register_forward_hook(
        lambda mod, args, out: seen.append(out))
    model.eval()
    with torch.no_grad():
        got = model.fuse_embeddings(*map(torch.from_numpy, feats))
    assert got.dtype == torch.float32 and got.shape == (16, 2)
    # the ReLU's output: bf16, and JAX's bf16 activations bit for bit
    assert seen[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(seen[0].float().numpy(),
                                  np.asarray(hidden["bf16"], np.float32))
    gap = np.abs(want["bf16"] - want["f32"]).max()
    assert gap > 1e-3  # the bf16 head is measurably not the float32 one
    np.testing.assert_allclose(got.numpy(), want["bf16"], atol=1e-5)


DRAWS = 8  # input draws the bf16 bars pool over


def test_bf16_forward_and_step_match_jax(variables, jax_dropout_off):
    """bf16 forwards (train mode, frozen encoders, pad rows masked) and
    the first `fusion` step's gradients of the canonical model against
    JAX's bf16 model, on the same weights and DRAWS seeded batches: every
    FusionOutput field, the loss and every trainable gradient. The bar is
    JAX's own bf16-vs-float32 gap: per tensor, the root mean square over
    the draws and the elements of port_bf16 - jax_bf16 is at most twice
    that of jax_bf16 - jax_f32, plus atol 1e-6 of the tensor's largest
    float32 component. The two frameworks round in other places
    (autocast against flax's dtype; JAX folds the uint8 normalisation
    into its bf16 stem), so their bf16 errors are independent and the
    difference has about sqrt(2) times the gap's spread: a maximum over a
    few elements would exceed twice the gap by chance (for three
    independent elements, one time in four), the pooled root mean square
    settles near sqrt(2). A head computed in float32 stays inside that
    bar (it sits one gap from JAX's bf16 head by construction), so the
    test also holds `head` alone, over one fused input, to JAX's bf16
    head at float32 rounding."""
    v = variables["canonical"]
    labels = np.arange(10) % 2
    mask = np.r_[np.ones(7), np.zeros(3)].astype(np.float32)
    jstate = jax_create_state(
        v, jax_optim.make_optimizer(JaxTrainConfig(), 1),
        jax.random.PRNGKey(0), freeze_predicate=jax_freeze)
    steps = {}
    for dt in ("bfloat16", "float32"):
        jtask = jax_fusion_task(jax_fusion.ECGMultimodalModel(
            cfg=_model_configs("canonical", dt)[0]), JaxTrainConfig())

        def jloss(params, batch, jtask=jtask):
            out, _ = jtask.apply(
                {"params": merge_params(params, jstate.frozen),
                 **jstate.model_state}, batch, train=True,
                rngs={"dropout": jstate.rng})
            return jtask.loss(out, batch)[0], out

        steps[dt] = jax.jit(jax.value_and_grad(jloss, has_aux=True))

    model = _port_model("canonical", v, "bfloat16")
    state = create_state(model, TrainConfig(), 1,
                         freeze=encoder_freeze_predicate)
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    assert len(trainable) == 19  # norms, classifiers, fusion, head
    task = make_fusion_task(TrainConfig())
    sq = {}  # tensor -> [sum (port - jax_bf16)^2, sum (gap)^2, n, max]

    def add(name, got, jb16, jf32):
        got, jb16, jf32 = (np.asarray(a, np.float64)
                           for a in (got, jb16, jf32))
        acc = sq.setdefault(name, [0.0, 0.0, 0, 0.0])
        acc[0] += float(((got - jb16) ** 2).sum())
        acc[1] += float(((jb16 - jf32) ** 2).sum())
        acc[2] += got.size
        acc[3] = max(acc[3], float(np.abs(jf32).max()))

    for k in range(DRAWS):
        img, sig, clin = _inputs(2, b=10, seed=100 + k)
        jb = jax_pipeline.Batch(jnp.asarray(img), jnp.asarray(sig),
                                jnp.asarray(clin), jnp.asarray(labels),
                                jnp.asarray(mask))
        want = {}
        for dt, step in steps.items():
            (loss, out), grads = step(jstate.trainable, jb)
            want[dt] = (out, float(loss), _port_sd_of(merge_params(
                jax.device_get(grads), jstate.frozen), v))
        model.train()
        batch = pipeline.Batch(_nchw(img), torch.from_numpy(sig),
                               torch.from_numpy(clin),
                               torch.from_numpy(labels),
                               torch.from_numpy(mask))
        out = task.apply(model, batch)
        loss, _ = task.loss(out, batch)
        state.optimizer.zero_grad()
        loss.backward()
        wb, wf = want["bfloat16"], want["float32"]
        for name, g, jb16, jf32 in zip(out._fields, out, wb[0], wf[0]):
            assert g.dtype == torch.float32, name
            add(name, g.detach().numpy(), jb16, jf32)
        add("loss", loss.item(), wb[1], wf[1])
        for name in trainable:
            p = dict(model.named_parameters())[name]
            add(name, (torch.zeros_like(p) if p.grad is None
                       else p.grad).numpy(),
                wb[2][name].numpy(), wf[2][name].numpy())
    failed = []
    for name, (err2, gap2, n, scale) in sq.items():
        err, bar = np.sqrt(err2 / n), 2 * np.sqrt(gap2 / n) + 1e-6 * scale
        if err > bar:
            failed.append((name, err, bar))
    assert not failed, failed

    # The head rounds where JAX's does, so over one fused input its bf16
    # output is JAX's to float32 rounding (atol 1e-5), far inside the gap
    # the bar above allows it: a float32 head fails here.
    fused = np.random.default_rng(9).normal(size=(10, 672)).astype(
        np.float32)
    heads = {dt: np.asarray(jax.jit(functools.partial(
        jax_fusion.ECGMultimodalModel(
            cfg=_model_configs("canonical", dt)[0]).apply,
        method=jax_fusion.ECGMultimodalModel.head))(
            {"params": v["params"]}, jnp.asarray(fused)))
        for dt in ("bfloat16", "float32")}
    model.eval()
    with torch.no_grad():
        got = model.head(torch.from_numpy(fused)).numpy()
    assert np.abs(heads["bfloat16"] - heads["float32"]).max() > 1e-3
    np.testing.assert_allclose(got, heads["bfloat16"], atol=1e-5)


def _port_sd_of(params, variables):
    return from_jax_variables(jax.device_get(
        {"params": params, "batch_stats": variables["batch_stats"]}))
# ------------------------------------------------------------ train/embed


def _jax_state(variables, lr=1e-3):
    tx = jax_optim.make_optimizer(JaxTrainConfig(lr=lr), 3)
    return tx, jax_create_state(variables, tx, jax.random.PRNGKey(0),
                                freeze_predicate=jax_freeze)


def test_cached_head_steps_match_jax(variables):
    """The train split encoded by `precompute_fusion_embeddings` at eval
    batch 8 (the last batch padded) against JAX's, then two head steps
    (`make_fusion_head_task`, a full and a padded batch) over the cached
    embeddings against JAX's head task: loss, metrics, the first step's
    gradients, the trainable parameters after each step; the frozen
    encoders and their BatchNorm buffers do not move."""
    v = variables["canonical"]
    jdata, pdata = _trimodal_data("canonical")
    jmodel = jax_fusion.ECGMultimodalModel(
        cfg=_model_configs("canonical")[0])
    tx, jstate = _jax_state(v)
    jcached = jax_embed.precompute_fusion_embeddings(jmodel, jstate,
                                                     jdata.train, BS)
    model = _port_model("canonical", v)
    init = {k: t.clone() for k, t in model.state_dict().items()}
    cfg = TrainConfig(lr=1e-3, batch_size=BS)
    state = create_state(model, cfg, 3, freeze=encoder_freeze_predicate)
    cached = embed.precompute_fusion_embeddings(model, pdata.train, BS)
    assert model.training  # encode_raw restored the mode
    for f, dim in (("images", 512), ("signals", 128), ("clinical", 32)):
        got = getattr(cached, f)
        assert got.shape == (pdata.train.n, dim), f
        _close_to_largest(got.numpy(), getattr(jcached, f), 1e-4, f)
    assert torch.equal(cached.labels, pdata.train.labels)

    jtask = jax_head_task(jmodel, JaxTrainConfig(lr=1e-3))
    jstep = jax_engine.make_train_step(jtask, tx, donate=False)
    task = make_fusion_head_task(cfg)
    rng = np.random.default_rng(SEED)
    order = rng.permutation(pdata.train.n)
    plan = [(order[:BS], np.ones(BS, np.float32)),
            (np.r_[order[BS:BS + 5], np.zeros(3, np.int64)],
             np.r_[np.ones(5), np.zeros(3)].astype(np.float32))]
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    for i, (idx, mask) in enumerate(plan):
        jb = jax_pipeline.Batch(
            *(jnp.take(a, idx, axis=0) for a in (
                jcached.images, jcached.signals, jcached.clinical,
                jcached.labels)), jnp.asarray(mask))
        if i == 0:
            def jloss(params):
                out, _ = jtask.apply(
                    {"params": merge_params(params, jstate.frozen),
                     **jstate.model_state}, jb, train=True,
                    rngs={"dropout": jstate.rng})
                return jtask.loss(out, jb)[0]

            jgrads = _port_sd_of(merge_params(jax.device_get(
                jax.jit(jax.grad(jloss))(jstate.trainable)), jstate.frozen),
                v)
        jstate, jmets = jstep(jstate, jb)
        mets = engine.train_step(task, state, engine.gather_batch(
            cached, torch.from_numpy(idx), torch.from_numpy(mask)))
        np.testing.assert_allclose(float(mets["loss"]), float(jmets["loss"]),
                                   rtol=1e-5)
        for k in ("var_loss", "soft_weights"):
            np.testing.assert_allclose(mets[k].numpy(),
                                       np.asarray(jmets[k]), atol=1e-5,
                                       err_msg=k)
        if i == 0:
            for name in trainable:
                p = dict(model.named_parameters())[name]
                got = torch.zeros_like(p) if p.grad is None else p.grad
                _close_to_largest(got.numpy(), jgrads[name].numpy(), 1e-4,
                                  name)
        want = _port_sd_of(merge_params(jstate.trainable, jstate.frozen), v)
        n_off = n_all = 0
        for name, got in model.state_dict().items():
            if name not in trainable:
                assert torch.equal(got, init[name]), name
                continue
            diff = (got - want[name]).abs()
            assert float(diff.max()) <= 2 * (i + 1) * 1e-3 + 1e-7, name
            n_off += int((diff > 1e-6).sum())
            n_all += diff.numel()
        assert n_off <= n_all // 2000, (n_off, n_all)


@pytest.mark.parametrize("variant,bs", [("canonical", BS),
                                        ("modal_balance", 64)],
                         ids=["canonical-full-batches", "mlp-one-batch"])
def test_calibrated_buffers_match_jax(variables, variant, bs):
    """`calibrate_bn_stats` (3 train-mode passes without gradients) against
    JAX's on the train split of 36 rows: at batch 8, four full batches (the
    padded tail skipped); at batch 64, one batch of all 36 rows. Every
    dropout is live on both sides (the MLP's follows its BatchNorm), the
    generators differ, and the buffers still agree; the parameters, the
    train state's generator and the model's mode do not change."""
    v = variables[variant]
    jdata, pdata = _trimodal_data(variant)
    jmodel = jax_fusion.ECGMultimodalModel(
        cfg=_model_configs(variant, dropout=0.3)[0])
    _, jstate = _jax_state(v)
    want = jax_embed.calibrate_bn_stats(jmodel, jstate, jdata.train, bs)
    model = _port_model(variant, v, dropout=0.3, dropout_off=False)
    assert any(isinstance(m, Dropout) and m.p > 0 for m in
               model.signal_encoder.modules())
    params = {k: p.clone() for k, p in model.named_parameters()}
    state = create_state(model, TrainConfig(seed=SEED), 3,
                         freeze=encoder_freeze_predicate)
    model.eval()
    gen = state.generator.get_state()
    before = {k: t.clone() for k, t in model.state_dict().items()}
    assert embed.calibrate_bn_stats(state, pdata.train, bs) is state
    want_sd = _port_sd_of(want.params, {"batch_stats":
                                        want.model_state["batch_stats"]})
    _assert_stats(model, want_sd)
    moved = [k for k, t in model.state_dict().items()
             if "running_" in k and not torch.equal(t, before[k])]
    assert len(moved) == sum("running_" in k for k in before)
    assert all(torch.equal(p, params[k])
               for k, p in model.named_parameters())
    assert torch.equal(state.generator.get_state(), gen)
    assert not model.training


@pytest.mark.parametrize("variant", VARIANTS)
def test_precompute_empty_split_keeps_branch_dims(variant):
    model = ECGMultimodalModel(_model_configs(variant)[1])
    empty = pipeline.Arrays(
        images=torch.zeros((0, 3) + HW, dtype=torch.uint8),
        signals=torch.zeros((0, T)), clinical=torch.zeros((0, 2)),
        labels=torch.zeros((0,), dtype=torch.int64),
        indices=np.zeros((0,), np.int64))
    out = embed.precompute_fusion_embeddings(model, empty, BS)
    c = model.cfg
    assert [tuple(getattr(out, f).shape) for f in
            ("images", "signals", "clinical")] == [
        (0, c.image_dim), (0, c.signal_dim), (0, c.clinical_dim)]
    assert all(getattr(out, f).dtype == torch.float32
               for f in ("images", "signals", "clinical"))


def _small_state(freeze=True):
    model = flax_init_(ECGMultimodalModel(_model_configs("canonical")[1]),
                       torch.Generator().manual_seed(0))
    return create_state(model, TrainConfig(batch_size=BS, seed=SEED), 3,
                        freeze=encoder_freeze_predicate if freeze else None)


def test_maybe_calibrate_preconditions():
    """A quiet no-op unless the cached path applies and
    `cache_bn_calibrate` is set; then the train split's calibration."""
    train = _trimodal_data("canonical")[1].train
    state = _small_state()
    before = {k: t.clone() for k, t in state.model.state_dict().items()}

    def unchanged():
        return all(torch.equal(t, before[k])
                   for k, t in state.model.state_dict().items())

    on = TrainConfig(batch_size=BS, cache_embeddings=True)
    for cfg, frozen in ((TrainConfig(batch_size=BS), True), (on, False),
                        (dataclasses.replace(on, cache_bn_calibrate=False),
                         True)):
        assert embed.maybe_calibrate_bn_stats(state, train, cfg,
                                              frozen=frozen) is state
        assert unchanged()
    signal_state = create_state(ResNet1DSE(base_filters=FILTERS), on, 3)
    assert embed.maybe_calibrate_bn_stats(signal_state, train,
                                          on) is signal_state
    assert embed.maybe_calibrate_bn_stats(state, train, on) is state
    assert not unchanged()


def test_maybe_cache_preconditions():
    """Flag off: the splits as they are and no task. Flag on with encoders
    that are not frozen, or a model that is not a fusion model: a warning,
    and the uncached path. Flag on, frozen fusion model: every split
    cached (order kept) and the head task."""
    data = _trimodal_data("canonical")[1]
    splits = {"train": data.train, "val": data.val}
    state = _small_state()
    cfg = TrainConfig(batch_size=BS)
    assert embed.maybe_cache_fusion_embeddings(state, splits, cfg) == (
        splits, None)
    on = dataclasses.replace(cfg, cache_embeddings=True)
    with pytest.warns(UserWarning, match="cache_embeddings"):
        out, task = embed.maybe_cache_fusion_embeddings(state, splits, on,
                                                        frozen=False)
    assert out is splits and task is None
    signal_state = create_state(ResNet1DSE(base_filters=FILTERS), on, 3)
    with pytest.warns(UserWarning, match="ResNet1DSE"):
        assert not embed.cache_applies(signal_state.model, on, True)
    out, task = embed.maybe_cache_fusion_embeddings(state, splits, on)
    assert list(out) == ["train", "val"] and task is not None
    assert out["train"].images.shape == (data.train.n, 512)
    assert out["val"].signals.shape == (data.val.n, 128)
    np.testing.assert_array_equal(out["val"].indices, data.val.indices)


def test_cached_fit_equals_eval_encoder_fit():
    """A fit of the head task over the cached splits equals a fit whose
    task runs the eval-mode encoders inside every step
    (`from_embeddings(encode_raw(x))`): the cached path's meaning, without
    the cache (JAX tests/test_cached_embeddings.py)."""
    data = _trimodal_data("canonical")[1]
    cfg = TrainConfig(batch_size=BS, num_epochs=2, lr=1e-3, patience=10,
                      seed=SEED)

    def eval_encoder_apply(model, batch):
        return model.from_embeddings(
            *model.encode_raw(batch.images, batch.signals, batch.clinical),
            mask=batch.mask)

    head = make_fusion_head_task(cfg)
    direct_task = engine.Task(apply=eval_encoder_apply, loss=head.loss,
                              logits=head.logits)
    runs = []
    for cached in (True, False):
        state = _small_state()
        train, val = data.train, data.val
        task = direct_task
        if cached:
            train, val = (embed.precompute_fusion_embeddings(
                state.model, a, cfg.eval_bs) for a in (train, val))
            task = head
        runs.append(engine.fit(task, state, train, val, cfg, verbose=False))
    for hc, hd in zip(runs[0].history, runs[1].history):
        for k in ("Loss/Train", "Loss/Val", "VarLoss/Val"):
            assert hc[k] == pytest.approx(hd[k], rel=1e-5), k
    # the encoders see other batches (in order, against shuffled), so the
    # embeddings carry other float32 rounding: Adam may turn an element
    # whose gradient is near zero (the bar of the head-step test)
    direct = runs[1].state.model.state_dict()
    n_off = n_all = 0
    for k, t in runs[0].state.model.state_dict().items():
        diff = (t - direct[k]).abs().float()
        assert float(diff.max()) <= 2 * 2 * 5 * cfg.lr, k
        n_off += int((diff > 1e-6).sum())
        n_all += diff.numel()
    assert n_off <= n_all // 2000, (n_off, n_all)


def _small_run_cfg(name, tmp_path, epochs=2):
    cfg = get_preset(name)
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


def test_fusion_cached_run_end_to_end(tmp_path, monkeypatch):
    """`run()` of `fusion_cached` (bf16, the preset's calibration): the
    splits are encoded once and the epochs train the head task; the
    attention weights and the val var_loss are logged; the checkpoints
    hold the calibrated BatchNorm buffers and the frozen weights of the
    initial state; a resume has nothing left to train."""
    cfg = _small_run_cfg("fusion_cached", tmp_path)
    assert cfg.train.cache_embeddings and cfg.train.cache_bn_calibrate
    data = port_run.load_data(cfg, 45, device="cpu")
    encoded = []
    real = embed.precompute_fusion_embeddings
    monkeypatch.setattr(embed, "precompute_fusion_embeddings",
                        lambda *a: encoded.append(a[1].n) or real(*a))
    result, results = port_run.run(cfg, data, run_dir=str(tmp_path / "r"),
                                   verbose=False, device="cpu")
    assert encoded == [data.train.n, data.val.n, data.test.n]
    assert len(result.history) == 2
    for h in result.history:
        assert np.isfinite(h["Loss/Train"]) and np.isfinite(h["VarLoss/Val"])
        assert sum(h[f"AttentionWeights/{b}_w"] for b in
                   ("Image", "Signal", "Clinical")) == pytest.approx(1.0)
    for tag in ("best", "last"):
        assert {"accuracy", "f1", "auroc", "temperature"} <= set(results[tag])
    model, _, _ = port_run.build_model_and_task(cfg, "cpu")
    init = model.state_dict()
    last = CheckpointManager(str(tmp_path / "r")).load("last")["model"]
    stats = [k for k in init if k.startswith("image_encoder.")
             and "running_" in k]
    assert stats and all(not torch.equal(last[k], init[k]) for k in stats)
    frozen = [k for k, _ in model.named_parameters()
              if encoder_freeze_predicate(k)]
    assert all(torch.equal(last[k], init[k]) for k in frozen)
    resumed, _ = port_run.run(cfg, data, run_dir=str(tmp_path / "r"),
                              verbose=False, resume=True, device="cpu")
    assert resumed.history == [] and resumed.state.epoch == 2
