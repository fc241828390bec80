"""Data parallelism of the port (`ecgmm_torch/parallel/`,
`train/engine.py` with `mesh=`) on the CPU over gloo, against the JAX
package's single-device and 8-device steps (`tests/test_parallel.py`) and
the port's own one-process runs.

The ranks run once per world size, in a module-scoped fixture (a 2-rank
and a 4-rank spawn through `parallel/launch.spawn`); each case then reads
their results. This file's top-level imports hold no JAX, so the spawned
ranks import none; the JAX steps run in the parent.

Bars, and why:
  * the DP step against JAX's 1- and 8-device steps (SGD(1.0), so the
    update is the gradient): loss 1e-5, parameters 5e-5, BatchNorm buffers
    1e-5, `tests/test_parallel.py`'s bars;
  * the port's DP runs against its one-process runs (the padded focal
    tail with an all-padding rank, the fusion step with a ghost chunk
    across ranks, the dropout step): the same bars;
  * dropout keep masks and the ranks' histories: equal (the masks are
    drawn from one generator as one global mask; every rank reads the
    same gathered val loss);
  * the streamed fits against the resident one: rel 1e-6 (the same rows
    in the same order);
  * the cached path's calibrated buffers and embeddings: atol 1e-5, the
    BatchNorm bar;
  * the fit's per-epoch losses against the one-process fit: rel 1e-3
    (float32 sums in another order, which Adam's normalised updates
    amplify over three epochs; JAX's `tests/test_tp.py` holds its fits to
    rel 1e-2 for the same reason).
"""

import contextlib
import dataclasses
import io
import os
import signal

import numpy as np
import pytest
import torch

from ecgmm_torch.config import MeshConfig, ModelConfig, TrainConfig
from ecgmm_torch.data.pipeline import Arrays, Batch, to_host_resident
from ecgmm_torch.models import ECGMultimodalModel
from ecgmm_torch.models.clinical import _GBN, ghost_chunks
from ecgmm_torch.models.layers import Dropout, flax_init_
from ecgmm_torch.models.resnet1d_se import ResNet1DSE
from ecgmm_torch.parallel import collectives, launch
from ecgmm_torch.parallel.mesh import (local_rows, make_mesh, mesh_shape,
                                       pad_to_multiple)
from ecgmm_torch.train import embed, engine
from ecgmm_torch.train.state import create_state, encoder_freeze_predicate
from ecgmm_torch.workloads.tasks import make_fusion_task, make_signal_task

torch.set_num_threads(2)

T, BS = 256, 32            # tests/test_parallel.py's step
FOCAL_B = 8                 # the focal step: rows 4..7 padding
GHOST_B, GHOST_VBS = 12, 4  # ghost chunks [0,4) [4,8) [8,12)
FIT_N, FIT_BS = 40, 8


# ------------------------------------------------ models, batches, steps

def _sgd(state):
    """SGD(1.0) in place of Adam: the update is the gradient."""
    state.optimizer.adam = torch.optim.SGD(
        [p for p in state.model.parameters() if p.requires_grad], lr=1.0)
    return state


def _signal_state(sd=None, dropout=0.0, loss="cross_entropy", seed=0):
    model = ResNet1DSE(num_classes=2, base_filters=16, dropout=dropout)
    if sd is None:
        flax_init_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(sd, strict=True)
    cfg = TrainConfig(batch_size=BS, loss=loss, seed=seed)
    return _sgd(create_state(model, cfg, 4)), make_signal_task(cfg)


def _signal_batch(bs, mask=None, seed=0):
    rng = np.random.default_rng(seed)
    sig = torch.tensor(rng.normal(size=(bs, T)), dtype=torch.float32)
    lab = torch.tensor(rng.integers(0, 2, bs), dtype=torch.int64)
    m = torch.ones(bs) if mask is None else torch.tensor(mask)
    return Batch(None, sig, None, lab, m)


def _fusion_state():
    """A narrow fusion model (32 x 32 images) in float32 whose TabNet ghost
    BatchNorms cut virtual batches of GHOST_VBS rows, frozen encoders in
    train mode, dropout on."""
    model = ECGMultimodalModel(ModelConfig(dtype="float32",
                                           signal_base_filters=8))
    flax_init_(model, torch.Generator().manual_seed(1))
    for m in model.modules():
        if isinstance(m, _GBN):
            m.virtual_batch_size = GHOST_VBS
    cfg = TrainConfig(batch_size=GHOST_B, seed=1)
    state = create_state(model, cfg, 4, freeze=encoder_freeze_predicate)
    return _sgd(state), make_fusion_task(cfg)


def _fusion_batch():
    rng = np.random.default_rng(2)
    return Batch(
        torch.from_numpy(rng.integers(0, 256, (GHOST_B, 3, 32, 32),
                                      dtype=np.uint8)),
        torch.tensor(rng.normal(size=(GHOST_B, T)), dtype=torch.float32),
        torch.tensor(rng.normal(size=(GHOST_B, 2)), dtype=torch.float32),
        torch.tensor(rng.integers(0, 2, GHOST_B), dtype=torch.int64),
        torch.tensor([1.0] * 10 + [0.0] * 2))


def _local(batch, mesh):
    return Batch(*(None if x is None else local_rows(x, mesh)
                   for x in batch))


def _snapshot(state, loss):
    return {"loss": float(loss),
            "sd": {k: v.detach().clone()
                   for k, v in state.state_dict()["model"].items()}}


def _step(state, task, batch, mesh=None):
    mets = engine.train_step(task, state, batch, mesh=mesh)
    return _snapshot(state, mets["loss"])


def _fit_arrays(seed):
    rng = np.random.default_rng(seed)
    n = FIT_N
    return Arrays(images=None,
                  signals=torch.tensor(rng.normal(size=(n, T)),
                                       dtype=torch.float32),
                  clinical=None,
                  labels=torch.tensor(rng.integers(0, 2, n)),
                  indices=np.arange(n))


def _fit(mesh=None, preempt_rank=None, chunk=None):
    """A 3-epoch fit with dropout, Adam and the plateau decay (patience 1,
    so the learning rate moves on the gathered val loss); with `chunk` its
    splits stream from the host (0: batch by batch, > 1: in chunks)."""
    model = ResNet1DSE(num_classes=2, base_filters=8, dropout=0.3)
    flax_init_(model, torch.Generator().manual_seed(4))
    cfg = TrainConfig(batch_size=FIT_BS, num_epochs=3, lr=1e-2,
                      schedule="constant", patience=0, plateau_patience=1,
                      loss="focal", seed=4)
    state = create_state(model, cfg, 5)
    task = make_signal_task(cfg)
    if preempt_rank is not None:
        apply = task.apply

        def apply_then_signal(model, batch):
            if state.step == 0 and mesh.data_index == preempt_rank:
                os.kill(os.getpid(), signal.SIGTERM)
            return apply(model, batch)

        task = dataclasses.replace(task, apply=apply_then_signal)
    train, val = _fit_arrays(5), _fit_arrays(6)
    if chunk is not None:
        train, val = to_host_resident(train), to_host_resident(val)
        cfg = dataclasses.replace(cfg, stream_chunk_batches=chunk)
    res = engine.fit(task, state, train, val, cfg, verbose=False,
                     mesh=mesh)
    return {"history": [{k: v for k, v in h.items() if k != "Time/Epoch"}
                        for h in res.history],
            "preempted": res.preempted}


def _keep_mask(mesh=None):
    """The keep mask Dropout(0.5) draws for a (16, 6) batch of ones from a
    generator seeded 7: this rank's rows under `mesh`."""
    drop = Dropout(0.5)
    drop.generator = torch.Generator().manual_seed(7)
    x = torch.ones(16, 6)
    if mesh is not None:
        x = local_rows(x, mesh)
    with collectives.data_parallel(None if mesh is None
                                   else mesh.row_shard()):
        return (drop(x) * 0.5).clone()


def _cached(mesh=None):
    """The cached path's set-up on the narrow fusion model: one
    calibration pass over full batches of 4, then every split row
    encoded; returns the BatchNorm buffers and the embeddings."""
    state, _ = _fusion_state()
    b = _fusion_batch()
    arrays = Arrays(images=b.images, signals=b.signals, clinical=b.clinical,
                    labels=b.labels, indices=np.arange(GHOST_B))
    embed.calibrate_bn_stats(state, arrays, 4, passes=1, mesh=mesh)
    emb = embed.precompute_fusion_embeddings(state.model, arrays, 4, mesh)
    return {"buffers": {k: v.clone() for k, v in
                        state.model.state_dict().items() if "running" in k},
            "emb": [emb.images, emb.signals, emb.clinical]}


def _cli_split_cache(work):
    """The CLI with `--split-cache` run twice on every rank in `work`:
    the first run saves the splits (the writer alone), the second reopens
    them. Returns each run's standard output."""
    from ecgmm_torch.workloads import run as port_run

    argv = ["--preset", "ptbxl_af", "--device", "cpu", "--epochs", "1",
            "--n-synth", "40", "--split-cache", os.path.join(work, "cache")]
    cwd = os.getcwd()
    os.chdir(work)
    logs = []
    try:
        for _ in range(2):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                port_run.main(argv)
            logs.append(buf.getvalue())
    finally:
        os.chdir(cwd)
    return logs


# -------------------------------------------------------------------- ranks

def rank_main(rank, sd, work):
    """Every case of one spawned world; returns this rank's results."""
    mesh = make_mesh(MeshConfig(), "cpu")
    out = {"coords": mesh.coords}
    # the JAX step: B = 32, dropout 0, cross entropy
    state, task = _signal_state(sd)
    out["jax_step"] = _step(state, task, _local(_signal_batch(BS), mesh),
                            mesh)
    if mesh.n_data != 2:
        return out
    # a padded focal tail: rank 1's rows are all padding
    mask = [1.0] * 4 + [0.0] * 4
    state, task = _signal_state(loss="focal", seed=3)
    out["focal_pad"] = _step(state, task,
                             _local(_signal_batch(FOCAL_B, mask, 3), mesh),
                             mesh)
    # the fusion step with a ghost chunk across the two ranks
    state, task = _fusion_state()
    out["ghost"] = _step(state, task, _local(_fusion_batch(), mesh), mesh)
    # dropout on
    state, task = _signal_state(dropout=0.3, seed=9)
    out["dropout"] = _step(state, task, _local(_signal_batch(BS, seed=9),
                                               mesh), mesh)
    out["keep"] = _keep_mask(mesh)
    out["fit"] = _fit(mesh)
    out["preempt"] = _fit(mesh, preempt_rank=1)
    out["streamed"] = [_fit(mesh, chunk=k) for k in (0, 2)]
    out["cached"] = _cached(mesh)
    out["counts"] = collectives.counts()
    out["cli"] = _cli_split_cache(work)
    return out


@pytest.fixture(scope="module")
def init_sd():
    """The JAX ResNet1D-SE's initial variables (dropout 0, base filters
    16) as the port's state dict."""
    import jax
    import jax.numpy as jnp

    from ecgmm_torch.tools.weights import from_jax_resnet1d_se
    from ecgmm_tpu.models import ResNet1DSE as JaxResNet1DSE

    model = JaxResNet1DSE(num_classes=2, base_filters=16, dropout=0.0)
    variables = jax.device_get(model.init(jax.random.PRNGKey(0),
                                          jnp.ones((1, T, 1))))
    return variables, from_jax_resnet1d_se(variables)


@pytest.fixture(scope="module")
def ranks(init_sd, tmp_path_factory):
    _, sd = init_sd
    work = str(tmp_path_factory.mktemp("cli"))
    return {n: launch.spawn(rank_main, n, args=(sd, work)) for n in (2, 4)}


@pytest.fixture(scope="module")
def jax_steps(init_sd):
    """JAX's step (tests/test_parallel.py::_train_one_step) on 1 and 8
    devices from the same variables and batch, as port state dicts."""
    import jax
    import jax.numpy as jnp
    import optax

    from ecgmm_torch.tools.weights import from_jax_resnet1d_se
    from ecgmm_tpu.config import MeshConfig as JaxMeshConfig
    from ecgmm_tpu.config import TrainConfig as JaxTrainConfig
    from ecgmm_tpu.data.pipeline import Batch as JaxBatch
    from ecgmm_tpu.models import ResNet1DSE as JaxResNet1DSE
    from ecgmm_tpu.parallel import batch_sharding, make_mesh as jax_mesh
    from ecgmm_tpu.parallel import replicate
    from ecgmm_tpu.train import engine as jax_engine
    from ecgmm_tpu.train.state import create_state as jax_state
    from ecgmm_tpu.workloads import make_signal_task as jax_task

    variables, _ = init_sd
    b = _signal_batch(BS)
    out = {}
    for n in (1, 8):
        mesh = jax_mesh(JaxMeshConfig(n_data=n))
        cfg = JaxTrainConfig(batch_size=BS, lr=1e-3, donate_state=False)
        model = JaxResNet1DSE(num_classes=2, base_filters=16, dropout=0.0)
        tx = optax.sgd(1.0)
        state = replicate(jax_state(variables, tx, jax.random.PRNGKey(0)),
                          mesh)
        sh = batch_sharding(mesh)
        batch = JaxBatch(
            images=None, clinical=None,
            signals=jax.device_put(jnp.asarray(b.signals.numpy()), sh),
            labels=jax.device_put(jnp.asarray(b.labels.numpy(),
                                              jnp.int32), sh),
            mask=jax.device_put(jnp.asarray(b.mask.numpy()), sh))
        step = jax_engine.make_train_step(jax_task(model, cfg), tx,
                                          donate=False)
        new, mets = step(state, batch)
        new_vars = jax.device_get({"params": new.params,
                                   **new.model_state})
        out[n] = {"loss": float(mets["loss"]),
                  "sd": from_jax_resnet1d_se(new_vars)}
    return out


def _agree(got, want, loss=1e-5, param=5e-5, bn=1e-5, counters=True):
    """Within the bars; `counters`: the BatchNorms' step counts equal too
    (JAX keeps none)."""
    assert got["loss"] == pytest.approx(want["loss"], abs=loss)
    for k, w in want["sd"].items():
        g = got["sd"][k]
        assert g.shape == w.shape, k
        if not w.is_floating_point():
            assert not counters or torch.equal(g, w), k
            continue
        bar = bn if "running_" in k else param
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=bar,
                                   rtol=0, err_msg=k)


# -------------------------------------------------------------------- cases

def test_mesh_helpers_and_errors_match_jax():
    """`tests/test_parallel.py:85-100` and `test_tp.py`'s mesh errors: the
    port's layout of 8 ranks raises and warns as JAX's make_mesh over its
    8 CPU devices does."""
    from ecgmm_tpu.config import MeshConfig as JaxMeshConfig
    from ecgmm_tpu.parallel import make_mesh as jax_mesh

    assert mesh_shape(MeshConfig(n_data=4), 8) == (4, 1)
    assert mesh_shape(MeshConfig(n_data=4, n_model=2), 8) == (4, 2)
    assert mesh_shape(MeshConfig(), 8) == (8, 1)
    assert pad_to_multiple(13, 8) == 16
    for bad in (MeshConfig(n_model=16), MeshConfig(n_model=0),
                MeshConfig(n_data=8, n_model=2)):
        with pytest.raises(ValueError) as want:
            jax_mesh(JaxMeshConfig(n_data=bad.n_data, n_model=bad.n_model))
        with pytest.raises(ValueError) as got:
            mesh_shape(bad, 8)
        assert str(got.value) == str(want.value)
    with pytest.warns(UserWarning, match="does not divide"):
        assert mesh_shape(MeshConfig(n_model=3), 8) == (2, 3)
    one = make_mesh(MeshConfig(), "cpu")
    assert (one.n_data, one.n_model, one.coords) == (1, 1, (0, 0))
    assert one.data_group is None and one.is_writer
    x = torch.arange(12)
    assert local_rows(x, one) is x
    assert ghost_chunks(12, 4) == [(0, 4), (4, 8), (8, 12)]
    assert ghost_chunks(260, 128) == [(0, 87), (87, 174), (174, 260)]


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("jax_devices", [1, 8])
def test_dp_step_matches_jax(ranks, jax_steps, n_ranks, jax_devices):
    """The port's data-parallel step at 2 and 4 ranks, on every rank,
    against JAX's 1- and 8-device steps: the loss, the updated parameters
    and the global-batch BatchNorm statistics."""
    for r in ranks[n_ranks]:
        _agree(r["jax_step"], jax_steps[jax_devices], counters=False)


def test_ranks_lie_on_the_mesh(ranks):
    assert [r["coords"] for r in ranks[4]] == [(i, 0) for i in range(4)]


@pytest.mark.parametrize("case", ["focal_pad", "ghost", "dropout"])
def test_dp_equals_one_process(ranks, case):
    """focal_pad: rank 1's rows are all padding (its local sum of the mask
    is 0; the loss divides by the global one). ghost: the fusion step
    whose TabNet ghost chunk [4, 8) straddles the two ranks' rows [0, 6)
    and [6, 12), the running statistics lerped chunk by chunk. dropout:
    the global keep masks."""
    if case == "focal_pad":
        state, task = _signal_state(loss="focal", seed=3)
        want = _step(state, task,
                     _signal_batch(FOCAL_B, [1.0] * 4 + [0.0] * 4, 3))
    elif case == "ghost":
        state, task = _fusion_state()
        want = _step(state, task, _fusion_batch())
    else:
        state, task = _signal_state(dropout=0.3, seed=9)
        want = _step(state, task, _signal_batch(BS, seed=9))
    for r in ranks[2]:
        _agree(r[case], want)


def test_dropout_masks_are_the_one_process_masks(ranks):
    want = _keep_mask()
    got = torch.cat([r["keep"] for r in ranks[2]])
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < want.numel()


def test_fit_history_is_the_same_on_every_rank(ranks):
    """The plateau decay and the early stop read the gathered val loss:
    every rank logs the same history, and it is the one-process fit's."""
    h0, h1 = (r["fit"]["history"] for r in ranks[2])
    assert h0 == h1
    want = _fit()["history"]
    assert [h["LR"] for h in h0] == [h["LR"] for h in want]
    for g, w in zip(h0, want):
        for k in ("Loss/Train", "Loss/Val"):
            assert g[k] == pytest.approx(w[k], rel=1e-3), k


def test_streamed_fit_is_the_resident_fit(ranks):
    """Each rank stages only its rows of every batch, per batch and in
    chunks: the histories are the resident run's, on every rank."""
    for r in ranks[2]:
        want = r["fit"]["history"]
        for got in r["streamed"]:
            for g, w in zip(got["history"], want):
                for k in ("Loss/Train", "Loss/Val", "LR"):
                    assert g[k] == pytest.approx(w[k], rel=1e-6), k


def test_cached_path_over_the_ranks(ranks):
    """Calibration under the data-parallel context (global ghost chunks
    of the calibration batches) and the encoding of every rank's rows,
    gathered: the one-process buffers and embeddings on every rank."""
    want = _cached()
    for r in ranks[2]:
        got = r["cached"]
        for k, w in want["buffers"].items():
            np.testing.assert_allclose(got["buffers"][k].numpy(),
                                       w.numpy(), atol=1e-5, err_msg=k)
        for g, w in zip(got["emb"], want["emb"]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


def test_sigterm_on_one_rank_stops_every_rank(ranks):
    """SIGTERM reaches rank 1 alone during the first epoch: the flag is
    all-reduced at the epoch's end, so both ranks stop after it."""
    for r in ranks[2]:
        assert r["preempt"]["preempted"]
        assert len(r["preempt"]["history"]) == 1


def test_cli_split_cache_is_written_by_one_rank(ranks):
    """Under two ranks with `--split-cache` the writer alone saves the
    splits, and every rank opens them only after the save: both runs end
    on both ranks, and the second reopens what the first saved."""
    (first0, second0), (first1, second1) = (r["cli"] for r in ranks[2])
    assert "saved materialized splits" in first0
    assert "saved materialized splits" not in first1
    assert "reopened materialized splits" in second0
    assert "saved materialized splits" not in second0 + second1


def test_collectives_are_counted(ranks):
    counts = ranks[2][0]["counts"]
    for op in ("all_reduce", "all_reduce_sum", "gather_rows"):
        assert counts[op]["calls"] > 0 and counts[op]["bytes"] > 0


def test_batch_size_must_divide_over_the_data_axis():
    class TwoRanks:
        n_data, data_index = 2, 0

    with pytest.raises(ValueError, match="does not divide"):
        local_rows(torch.zeros(5), TwoRanks())
    with pytest.raises(ValueError, match="does not divide"):
        engine.check_divides(5, TwoRanks(), "batch size")
