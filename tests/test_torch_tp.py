"""Tensor parallelism of the port (`ecgmm_torch/parallel/tp.py`) on the
CPU over gloo, against the JAX package's rule (`tests/test_tp.py`).

  * the sharded parameters and a rank's bytes equal JAX's `tp_spec` and
    `tp_bytes_per_device` for ResNet1D-SE, the fusion model, the CRNN and
    the Transformer: each flax leaf is filled with its own number, the
    variables go through the port's weight tables
    (`tools/weights.from_jax_*`), and a port tensor is JAX-sharded where
    its numbers come from sharded leaves;
  * on 4 ranks (one spawn, a module-scoped fixture): the (2 x 2) TP step
    equals the DP (4) step for ResNet1D-SE (tests/test_tp.py's model), a
    narrow fusion model (frozen sharded encoders, TabNet's shared GLU
    layers), the CRNN (the LSTM's fused kernels) and the Transformer (the
    packed attention projections, the positional embedding); `fit` under
    TP reproduces the DP loss history; the checkpoint written under TP has
    the DP checkpoint's keys and shapes and restores into a sharded state.

Bars: the steps within tests/test_tp.py's (loss 1e-5, parameters 5e-5,
BatchNorm buffers 1e-5); the fit's losses rel 1e-2, as JAX's
`test_fit_under_tp_matches_dp` (Adam amplifies float32 reduction-order
noise over epochs). The file's top-level imports hold no JAX.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from ecgmm_torch.config import MeshConfig, ModelConfig, TrainConfig
from ecgmm_torch.data.pipeline import Arrays, Batch
from ecgmm_torch.models import (CRNN, ECGMultimodalModel, ECGTransformer1D,
                                ResNet1DSE)
from ecgmm_torch.models.layers import flax_init_
from ecgmm_torch.parallel import launch, tp
from ecgmm_torch.parallel.mesh import local_rows, make_mesh
from ecgmm_torch.train import engine
from ecgmm_torch.train.checkpoint import CheckpointManager
from ecgmm_torch.train.state import create_state, encoder_freeze_predicate
from ecgmm_torch.workloads.tasks import (make_fusion_task, make_signal_task,
                                         make_spectrogram_task)

torch.set_num_threads(2)

T, BS, SEQ = 256, 16, 64
FIT_N = 32


def _model(kind):
    g = torch.Generator().manual_seed(0)
    if kind == "resnet1d_se":
        m = ResNet1DSE(num_classes=2, base_filters=16, dropout=0.0)
    elif kind == "fusion":
        m = ECGMultimodalModel(ModelConfig(dtype="float32",
                                           signal_base_filters=8))
    elif kind == "crnn":
        m = CRNN(2, hidden=16, lstm_layers=2, dropout=0.0)
    else:
        m = ECGTransformer1D(2, seq_len=SEQ, dropout=0.0)
    return flax_init_(m, g)


def _batch(kind):
    rng = np.random.default_rng(1)
    f32 = np.float32
    labels = torch.from_numpy(rng.integers(0, 2, BS))
    mask = torch.tensor([1.0] * (BS - 3) + [0.0] * 3)
    if kind == "fusion":
        return Batch(torch.from_numpy(rng.integers(0, 256, (BS, 3, 32, 32),
                                                   dtype=np.uint8)),
                     torch.from_numpy(rng.normal(size=(BS, T)).astype(f32)),
                     torch.from_numpy(rng.normal(size=(BS, 2)).astype(f32)),
                     labels, mask)
    shape = {"resnet1d_se": (BS, T), "crnn": (BS, 33, 16),
             "transformer": (BS, 1, SEQ)}[kind]
    return Batch(None, torch.from_numpy(rng.normal(size=shape).astype(f32)),
                 None, labels, mask)


def _state(kind):
    model = _model(kind)
    cfg = TrainConfig(batch_size=BS, seed=0)
    freeze = encoder_freeze_predicate if kind == "fusion" else None
    if kind == "crnn":
        from ecgmm_torch.models.crnn import lstm_bias_frozen

        freeze = lstm_bias_frozen
    state = create_state(model, cfg, 4, freeze=freeze)
    state.optimizer.adam = torch.optim.SGD(
        [p for p in model.parameters() if p.requires_grad], lr=1.0)
    task = {"fusion": make_fusion_task, "crnn": make_spectrogram_task}.get(
        kind, make_signal_task)(cfg)
    return state, task


def _step(kind, mesh):
    state, task = _state(kind)
    tp.place_state(state, mesh)
    b = _batch(kind)
    local = Batch(*(None if x is None else local_rows(x, mesh) for x in b))
    mets = engine.train_step(task, state, local, mesh=mesh)
    return {"loss": float(mets["loss"]),
            "sd": {k: v.detach().clone()
                   for k, v in state.state_dict()["model"].items()}}


def _fit(mesh):
    model = ResNet1DSE(num_classes=2, base_filters=8, dropout=0.0)
    flax_init_(model, torch.Generator().manual_seed(2))
    cfg = TrainConfig(batch_size=8, num_epochs=2, lr=1e-3,
                      schedule="constant", patience=10, seed=2)
    state = create_state(model, cfg, 4)
    rng = np.random.default_rng(3)

    def split():
        return Arrays(None, torch.from_numpy(
            rng.normal(size=(FIT_N, T)).astype(np.float32)), None,
            torch.from_numpy(rng.integers(0, 2, FIT_N)), np.arange(FIT_N))

    train, val = split(), split()
    res = engine.fit(make_signal_task(cfg), state, train, val, cfg,
                     verbose=False, mesh=mesh)
    return [(h["Loss/Train"], h["Loss/Val"]) for h in res.history], state


def rank_main(rank, ckpt_dir):
    out = {}
    for name, cfg in (("dp", MeshConfig(n_data=4)),
                      ("tp", MeshConfig(n_data=2, n_model=2))):
        mesh = make_mesh(cfg, "cpu")
        out[name] = {kind: _step(kind, mesh) for kind in
                     ("resnet1d_se", "fusion", "crnn", "transformer")}
        hist, state = _fit(mesh)
        out[name]["fit"] = hist
        ckpt = CheckpointManager(os.path.join(ckpt_dir, name),
                                 writer=mesh.is_writer)
        ckpt.save("last", state)
        full = state.state_dict()
        out[name]["full"] = {k: v.clone() for k, v in full["model"].items()}
        if name == "tp":
            # restore into a fresh sharded state: the same full state
            again = create_state(
                ResNet1DSE(num_classes=2, base_filters=8, dropout=0.0),
                TrainConfig(batch_size=8, num_epochs=2, lr=1e-3,
                            schedule="constant"), 4)
            tp.place_state(again, mesh)
            ckpt.restore("last", again)
            re = again.state_dict()
            out["restored"] = {
                "model": all(torch.equal(re["model"][k], v)
                             for k, v in full["model"].items()),
                "optimizer": all(
                    torch.equal(a, b) for i in full["optimizer"]["state"]
                    for a, b in zip(
                        full["optimizer"]["state"][i].values(),
                        re["optimizer"]["state"][i].values())),
                "shard_shapes": sorted(
                    tuple(p.shape) for n, p in
                    again.model.named_parameters()
                    if n.endswith(".original")),
            }
    return out


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as d:
        outs = launch.spawn(rank_main, 4, args=(d,))
        files = {name: torch.load(os.path.join(d, name, "last.pt"),
                                  weights_only=True)
                 for name in ("dp", "tp")}
    return outs, files


def _agree(got, want):
    assert got["loss"] == pytest.approx(want["loss"], abs=1e-5)
    for k, w in want["sd"].items():
        g = got["sd"][k]
        assert g.shape == w.shape, k
        if not w.is_floating_point():
            assert torch.equal(g, w), k
            continue
        bar = 1e-5 if "running_" in k else 5e-5
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=bar, rtol=0,
                                   err_msg=k)


# -------------------------------------------------- the rule against JAX

def _jax_variables(kind):
    import jax
    import jax.numpy as jnp

    from ecgmm_tpu.config import ModelConfig as JaxModelConfig
    from ecgmm_tpu.models import CRNN as JaxCRNN
    from ecgmm_tpu.models import ECGMultimodalModel as JaxFusion
    from ecgmm_tpu.models import ECGTransformer1D as JaxTransformer
    from ecgmm_tpu.models import ResNet1DSE as JaxResNet1DSE

    key = jax.random.PRNGKey(0)
    if kind == "resnet1d_se":
        v = JaxResNet1DSE(num_classes=2, base_filters=16).init(
            key, jnp.ones((1, T, 1)))
    elif kind == "fusion":
        v = JaxFusion(cfg=JaxModelConfig(dtype="float32",
                                         signal_base_filters=8)).init(
            key, jnp.ones((1, 32, 32, 3)), jnp.ones((1, T)),
            jnp.ones((1, 2)))
    elif kind == "crnn":
        v = JaxCRNN(num_classes=2, hidden=16, lstm_layers=2).init(
            key, jnp.ones((1, 33, 16)))
    else:
        v = JaxTransformer(num_classes=2, seq_len=SEQ).init(
            key, jnp.ones((1, SEQ, 1)))
    return jax.device_get(v)


def _convert(kind, variables):
    from ecgmm_torch.tools import weights

    fn = {"resnet1d_se": weights.from_jax_resnet1d_se,
          "fusion": weights.from_jax_variables,
          "crnn": weights.from_jax_crnn,
          "transformer": weights.from_jax_transformer1d}[kind]
    return fn(variables)


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("kind", ["resnet1d_se", "fusion", "crnn",
                                  "transformer"])
def test_sharded_set_and_bytes_equal_jax(kind, n_model):
    import jax
    from jax.sharding import PartitionSpec as P

    from ecgmm_tpu.config import MeshConfig as JaxMeshConfig
    from ecgmm_tpu.parallel import make_mesh as jax_mesh
    from ecgmm_tpu.parallel.tp import tp_bytes_per_device as jax_bytes
    from ecgmm_tpu.parallel.tp import tp_spec

    variables = _jax_variables(kind)
    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    sharded_ids = {i + 1 for i, leaf in enumerate(leaves)
                   if tp_spec(leaf, n_model) != P()}
    # every flax leaf filled with its own number (exact in float32)
    tagged = dict(variables)
    tagged["params"] = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(leaf), i + 1, np.float32)
                  for i, leaf in enumerate(leaves)])
    for c in variables:
        if c != "params":
            tagged[c] = jax.tree_util.tree_map(
                lambda a: np.zeros(np.shape(a), np.float32), variables[c])
    sd = _convert(kind, tagged)
    model = _model(kind)
    model.load_state_dict(sd, strict=True)  # the shapes agree
    want = set()
    for k, v in sd.items():
        ids = {int(i) for i in torch.unique(v) if i > 0} \
            if v.is_floating_point() else set()
        if ids and ids <= sharded_ids:
            want.add(k)
        else:
            assert not ids & sharded_ids, k  # all or none
    assert set(tp.tp_plan(model, n_model)) == want
    extra = sum(p.numel() * p.element_size()
                for n, p in model.named_parameters() if "bias_hh" in n)
    mesh = jax_mesh(JaxMeshConfig(n_data=8 // n_model, n_model=n_model))
    assert tp.tp_bytes_per_device(model, n_model) - extra == jax_bytes(
        variables["params"], mesh)
    assert tp.tp_bytes_per_device(model, n_model) < \
        tp.tp_bytes_per_device(model, 1)


def test_tp_rule_cases():
    """tests/test_tp.py::test_tp_spec_rules on the port's layout: a
    Linear's (out, in) weight shards dim 0 where out divides; biases,
    scalars and indivisible widths stay whole; one rank shards nothing."""
    model = torch.nn.Sequential(torch.nn.Linear(64, 128),
                                torch.nn.Linear(128, 63))
    assert tp.tp_plan(model, 2) == {"0.weight": 0}
    assert tp.tp_plan(model, 1) == {}
    enc = ECGTransformer1D(2, seq_len=SEQ)
    plan = tp.tp_plan(enc, 2)
    assert plan["pos_embedding"] == 2
    layer = "transformer_encoder.layers.0.self_attn."
    assert plan[layer + "in_proj_weight"] == 0
    assert plan[layer + "in_proj_bias"] == 0
    assert layer + "out_proj.bias" not in plan


# ------------------------------------------------------ on four ranks

@pytest.mark.parametrize("kind", ["resnet1d_se", "fusion", "crnn",
                                  "transformer"])
def test_tp_step_matches_dp(ranks, kind):
    outs, _ = ranks
    for r in outs:
        _agree(r["tp"][kind], r["dp"][kind])
    for r in outs[1:]:
        _agree(r["tp"][kind], outs[0]["tp"][kind])


def test_fit_under_tp_matches_dp(ranks):
    outs, _ = ranks
    for r in outs:
        assert len(r["tp"]["fit"]) == len(r["dp"]["fit"]) == 2
        for (tl, tv), (dl, dv) in zip(r["tp"]["fit"], r["dp"]["fit"]):
            assert tl == pytest.approx(dl, rel=1e-2)
            assert tv == pytest.approx(dv, rel=1e-2)


def test_checkpoint_after_tp_is_the_dp_format(ranks):
    outs, files = ranks
    dp, tpf = files["dp"]["model"], files["tp"]["model"]
    assert list(tpf) == list(dp)
    assert {k: v.shape for k, v in tpf.items()} == \
        {k: v.shape for k, v in dp.items()}
    for k, v in outs[0]["tp"]["full"].items():
        assert torch.equal(tpf[k], v), k
    assert files["tp"]["optimizer"]["state"].keys() == \
        files["dp"]["optimizer"]["state"].keys()
    restored = outs[0]["restored"]
    assert restored["model"] and restored["optimizer"]
    full_shapes = sorted(tuple(v.shape) for k, v in tpf.items()
                         if k.endswith("weight") and v.dim() >= 2)
    assert len(restored["shard_shapes"]) > 0
    assert sum(np.prod(s) for s in restored["shard_shapes"]) < \
        sum(np.prod(s) for s in full_shapes)
