"""Host-resident splits, device-memory budgets, the split cache and the
streamed engine paths of the port (`ecgmm_torch.data.pipeline`,
`train/engine.py`, `train/embed.py`, the CLI's `--split-cache`) on the
CPU, against the JAX package (`ecgmm_tpu/data/pipeline.py`) where the two
share a contract, and against the port's own resident path.

Bars: the plans, budgets, chunk sizes, cached files and the rows of every
streamed batch equal JAX's; a streamed fit (per batch on a split the batch
size divides, or chunked on any split) equals the resident fit bit for
bit: the same rows in the same order through the same float32 arithmetic.
A per-batch streamed batch pads with its last row, as JAX's does, so on a
ragged split only the chunked path (which streams the resident plan) is
held to bit equality.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from ecgmm_tpu.config import Config as JaxConfig
from ecgmm_tpu.data import pipeline as jax_pipeline
from ecgmm_tpu.data import synthetic as jax_synthetic
from ecgmm_torch.config import Config, ModelConfig, TrainConfig, get_preset
from ecgmm_torch.data import pipeline, synthetic
from ecgmm_torch.models import ECGMultimodalModel
from ecgmm_torch.models.layers import flax_init_
from ecgmm_torch.train import embed, engine
from ecgmm_torch.train.state import create_state, encoder_freeze_predicate
from ecgmm_torch.workloads import run as port_run
from ecgmm_torch.workloads.tasks import make_fusion_task

torch.set_num_threads(2)

BS = 8
MODEL = ModelConfig(dtype="float32", signal_base_filters=8)
CFG = Config(model=MODEL)


def _trim(h: pipeline.HostArrays, k: int) -> pipeline.HostArrays:
    return pipeline.HostArrays(*(a[:k] for a in h))


@pytest.fixture(scope="module")
def cohort():
    return synthetic.make_cohort(n=80, signal_len=256, img_hw=(16, 32),
                                 seed=3)


@pytest.fixture(scope="module")
def host(cohort):
    """Host splits of 48/8/8 rows (sizes the batch size divides) and the
    ragged originals."""
    d = pipeline.materialize_trimodal(cohort, CFG, device=None)
    return {"train": _trim(d.train, 48), "val": _trim(d.val, 8),
            "test": _trim(d.test, 8), "ragged": d.train, "data": d}


# ----------------------------------------------------------------- budgets

def test_fit_in_budget_demotes_only_over_budget(host):
    h = host["train"]
    size = pipeline.split_nbytes(h)
    assert size == jax_pipeline.split_nbytes(h)
    dev = pipeline.fit_in_budget(h, size + 1, "cpu")
    assert isinstance(dev, pipeline.Arrays)
    assert dev.images.shape == (48, 3, 16, 32) and dev.labels.dtype == \
        torch.int64
    assert isinstance(pipeline.fit_in_budget(h, size - 1, "cpu"),
                      pipeline.HostArrays)
    assert isinstance(pipeline.fit_in_budget(h, 0, "cpu"), pipeline.Arrays)
    back = pipeline.fit_in_budget(dev, 10, "cpu")
    assert isinstance(back, pipeline.HostArrays)
    for f in ("images", "signals", "clinical", "labels", "indices"):
        np.testing.assert_array_equal(getattr(back, f), getattr(h, f))
        assert getattr(back, f).dtype == getattr(h, f).dtype


def test_fit_splits_in_budget_is_cumulative(host):
    splits = (host["train"], host["val"], host["test"])
    sizes = [pipeline.split_nbytes(s) for s in splits]
    for budget in (0, sum(sizes), sizes[0] + sizes[1], sizes[0],
                   sizes[0] - 1, 1):
        got = pipeline.fit_splits_in_budget(splits, budget, "cpu")
        want = jax_pipeline.fit_splits_in_budget(splits, budget)
        assert [isinstance(g, pipeline.Arrays) for g in got] == \
            [isinstance(w, jax_pipeline.Arrays) for w in want], budget


def test_resolve_hbm_budget(monkeypatch):
    monkeypatch.delenv("ECGMM_HBM_BUDGET_BYTES", raising=False)
    assert pipeline.resolve_hbm_budget("cpu") == 0
    monkeypatch.setenv("ECGMM_HBM_BUDGET_BYTES", "12345")
    assert pipeline.resolve_hbm_budget("cpu") == 12345 == \
        jax_pipeline.resolve_hbm_budget()


@pytest.mark.parametrize("budget,bs,ebs", [(10 ** 6, 8, 0), (10 ** 6, 8, 32),
                                           (5 * 10 ** 7, 16, 0), (10, 8, 0)])
def test_auto_chunk_batches_matches_jax(host, budget, bs, ebs):
    h = host["train"]
    assert pipeline.auto_chunk_batches(budget, h, bs, ebs) == \
        jax_pipeline.auto_chunk_batches(budget, h, bs, ebs)


# ------------------------------------------------------------- prefetchers

def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("weighted", [False, True])
def test_prefetch_batches_match_jax(host, weighted):
    """The same rows, order and pad rows as JAX's streamed batches, on the
    ragged split (a padded tail)."""
    h = host["ragged"]
    w = np.linspace(1, 2, h.n) if weighted else None
    got = list(pipeline.prefetch_batches(h, BS, shuffle=True, seed=4,
                                         epoch=2, device="cpu",
                                         sample_weights=w))
    want = list(jax_pipeline.prefetch_batches(h, BS, shuffle=True, seed=4,
                                              epoch=2, sample_weights=w))
    assert len(got) == len(want) == -(-h.n // BS)
    for g, wb in zip(got, want):
        np.testing.assert_array_equal(_nhwc(g.images), np.asarray(wb.images))
        for f in ("signals", "clinical", "labels", "mask"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(wb, f)))
        assert g.labels.dtype == torch.int64


@pytest.mark.parametrize("k", [1, 2, 4])
def test_prefetch_chunks_match_jax(host, k):
    h = host["ragged"]
    idx, mask = engine.epoch_indices(h.n, BS, shuffle=True, seed=1, epoch=0)
    stats = {}
    got = list(pipeline.prefetch_chunks(h, idx, mask, k, device="cpu",
                                        stats=stats))
    want = list(jax_pipeline.prefetch_chunks(h, idx, mask, k))
    assert len(got) == len(want) == stats["chunks"]
    assert stats["gather_s"] >= 0 and stats["put_s"] >= 0
    for (gc, gi, gm, gh), (wc, wi, wm, wh) in zip(got, want):
        np.testing.assert_array_equal(_nhwc(gc.images), np.asarray(wc.images))
        for f in ("signals", "clinical", "labels"):
            np.testing.assert_array_equal(getattr(gc, f).numpy(),
                                          np.asarray(getattr(wc, f)))
        np.testing.assert_array_equal(gc.indices, wc.indices)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        np.testing.assert_array_equal(gh, wh)


def test_prefetch_chunks_retires_its_producer(host):
    """A caller that leaves after one chunk stops the producer thread."""
    h = host["ragged"]
    idx, mask = engine.epoch_indices(h.n, BS, shuffle=False, seed=0,
                                     epoch=0)
    before = {t.ident for t in threading.enumerate()}
    gen = pipeline.prefetch_chunks(h, idx, mask, 1, device="cpu")
    next(gen)
    gen.close()
    left = [t for t in threading.enumerate() if t.ident not in before
            and t.name == "ecgmm-chunk-stager"]
    assert not left


# ------------------------------------------------------------------ engine

def _state(seed=0):
    model = flax_init_(ECGMultimodalModel(MODEL),
                       torch.Generator().manual_seed(seed))
    return create_state(model, TrainConfig(batch_size=BS, seed=5), 6,
                        freeze=encoder_freeze_predicate)


def _fit(train, val, **train_kw):
    cfg = TrainConfig(batch_size=BS, num_epochs=2, lr=1e-3, patience=0,
                      seed=5, **train_kw)
    state = _state()
    res = engine.fit(make_fusion_task(cfg), state, train, val, cfg,
                     verbose=False)
    return res.history, state.model.state_dict()


def _assert_same_fit(a, b):
    for ha, hb in zip(a[0], b[0]):
        for k in ("Loss/Train", "Loss/Val", "Accuracy/Train",
                  "Accuracy/Val", "VarLoss/Val"):
            assert ha[k] == hb[k], k
    for k, t in a[1].items():
        assert torch.equal(t, b[1][k]), k


@pytest.mark.parametrize("chunk", [0, 2, 4])
def test_streamed_fit_equals_resident_fit(host, chunk):
    """Per batch (chunk 0) and in chunks of 2 and 4 batches: the same
    losses, accuracies and parameters as the resident fit."""
    resident = _fit(pipeline.promote(host["train"], "cpu"),
                    pipeline.promote(host["val"], "cpu"))
    streamed = _fit(host["train"], host["val"], stream_chunk_batches=chunk)
    _assert_same_fit(streamed, resident)


def test_chunked_fit_equals_resident_on_a_ragged_split(host):
    d = host["data"]
    resident = _fit(pipeline.promote(d.train, "cpu"),
                    pipeline.promote(d.val, "cpu"))
    streamed = _fit(d.train, d.val, stream_chunk_batches=3)
    _assert_same_fit(streamed, resident)


@pytest.mark.parametrize("chunk", [0, 1, 3])
def test_evaluate_streamed_equals_evaluate(host, chunk):
    d = host["data"]
    state = _state(seed=1)
    task = make_fusion_task(TrainConfig(batch_size=BS))
    want = engine.evaluate(task, state, pipeline.promote(d.test, "cpu"), BS)
    for split in (d.test, host["test"]):
        got = engine.evaluate_streamed(task, state, split, BS, chunk)
        if split is d.test and chunk <= 1:
            # per batch, the padded tail repeats its last row (JAX's
            # convention): the loss of that batch may differ, not the rows
            np.testing.assert_array_equal(got.logits, want.logits)
            np.testing.assert_array_equal(got.labels, want.labels)
            continue
        ref = want if split is d.test else engine.evaluate(
            task, state, pipeline.promote(split, "cpu"), BS)
        assert got.loss == ref.loss and got.metrics == ref.metrics
        np.testing.assert_array_equal(got.logits, ref.logits)
        np.testing.assert_array_equal(got.labels, ref.labels)
    empty = pipeline.HostArrays(*(a[:0] for a in d.test))
    assert np.isnan(engine.evaluate_streamed(task, state, empty, BS).loss)


def test_streamed_calibration_and_encoding_equal_resident(host):
    """`calibrate_bn_stats` and `precompute_fusion_embeddings` over a host
    split give the resident split's buffers and embeddings."""
    d = host["data"]
    out = []
    for split in (d.train, pipeline.promote(d.train, "cpu")):
        state = _state(seed=2)
        embed.calibrate_bn_stats(state, split, 16)
        enc = embed.precompute_fusion_embeddings(state.model, split, 16)
        out.append((state.model.state_dict(), enc))
    for k, t in out[0][0].items():
        assert torch.equal(t, out[1][0][k]), k
    for f in ("images", "signals", "clinical", "labels"):
        assert torch.equal(getattr(out[0][1], f), getattr(out[1][1], f)), f
    np.testing.assert_array_equal(out[0][1].indices, out[1][1].indices)


# ------------------------------------------------------------- split cache

def _jax_data():
    cohort = jax_synthetic.make_cohort(n=40, signal_len=256,
                                       img_hw=(16, 32))
    return jax_pipeline.materialize_trimodal(cohort, JaxConfig())


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith(".npy"):
                a = np.load(os.path.join(d, n))
                out[os.path.relpath(os.path.join(d, n), root)] = (a.dtype,
                                                                  a.shape)
    return out


def test_jax_split_cache_opens_in_the_port(tmp_path):
    jdata = _jax_data()
    cache = str(tmp_path / "jax")
    jax_pipeline.save_materialized(jdata, cache, meta={"preset": "fusion"})
    assert pipeline.has_materialized(cache)
    for budget in (0, 1):
        got = pipeline.load_materialized(cache, device="cpu",
                                         hbm_budget_bytes=budget,
                                         expect_meta={"preset": "fusion"})
        for name in ("train", "val", "test"):
            g, w = getattr(got, name), getattr(jdata, name)
            assert isinstance(g, pipeline.HostArrays if budget
                              else pipeline.Arrays)
            images = g.images if budget else _nhwc(g.images)
            np.testing.assert_array_equal(images, np.asarray(w.images))
            for f in ("signals", "clinical", "labels"):
                v = getattr(g, f)
                v = v if budget else v.numpy()
                np.testing.assert_array_equal(v, np.asarray(getattr(w, f)))
            np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_array_equal(got.ecg_scaler.mean,
                                      jdata.ecg_scaler.mean)
        np.testing.assert_array_equal(got.clinical_scaler.scale,
                                      jdata.clinical_scaler.scale)
    mapped = pipeline.load_materialized(cache, device="cpu",
                                        hbm_budget_bytes=1)
    assert isinstance(mapped.train.signals, np.memmap)


def test_port_split_cache_opens_in_jax(tmp_path, host):
    data = host["data"]
    resident = pipeline.MaterializedData(
        *(pipeline.promote(getattr(data, s), "cpu")
          for s in ("train", "val", "test")),
        ecg_scaler=data.ecg_scaler, clinical_scaler=data.clinical_scaler)
    jcache = str(tmp_path / "jax")
    jax_pipeline.save_materialized(_jax_data(), jcache)
    for src, name in ((data, "host"), (resident, "resident")):
        cache = str(tmp_path / name)
        pipeline.save_materialized(src, cache, meta={"seed": 42})
        assert jax_pipeline.has_materialized(cache)
        assert _files(cache).keys() == _files(jcache).keys()
        assert {k: v[0] for k, v in _files(cache).items()} == \
            {k: v[0] for k, v in _files(jcache).items()}
        got = jax_pipeline.load_materialized(cache, hbm_budget_bytes=0,
                                             expect_meta={"seed": 42})
        for s in ("train", "val", "test"):
            g, w = getattr(got, s), getattr(data, s)
            for f in ("images", "signals", "clinical", "labels", "indices"):
                np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                              getattr(w, f))
        np.testing.assert_array_equal(np.asarray(got.ecg_scaler.mean),
                                      data.ecg_scaler.mean)


def test_fingerprint_refusal(tmp_path, host):
    cache = str(tmp_path / "c")
    pipeline.save_materialized(host["data"], cache,
                               meta={"preset": "fusion", "seed": 42})
    with pytest.raises(ValueError, match="seed: cached=42 requested=7"):
        pipeline.load_materialized(cache, device="cpu",
                                   expect_meta={"preset": "fusion",
                                                "seed": 7})
    with pytest.raises(ValueError, match="different run configuration"):
        jax_pipeline.load_materialized(cache, expect_meta={"seed": 7})
    os.remove(os.path.join(cache, "meta.json"))  # no fingerprint: opens
    pipeline.load_materialized(cache, device="cpu", expect_meta={"seed": 7})


# --------------------------------------------------------------- CLI, run()

def test_cli_split_cache_saves_reopens_and_refuses(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.chdir(tmp_path)
    cache = str(tmp_path / "cache")
    argv = ["--preset", "ptbxl_af", "--device", "cpu", "--epochs", "1",
            "--n-synth", "40", "--split-cache", cache]
    port_run.main(argv)
    assert "saved materialized splits" in capsys.readouterr().out
    with open(os.path.join(cache, "meta.json")) as f:
        meta = json.load(f)
    assert meta["preset"] == "ptbxl_af" and meta["n_synth"] == 40
    port_run.main(argv)
    assert "reopened materialized splits" in capsys.readouterr().out
    with pytest.raises(ValueError, match="n_synth: cached=40 requested=41"):
        port_run.main(argv[:-3] + ["41", "--split-cache", cache])


def test_run_streams_over_budget_as_it_runs_resident(tmp_path, monkeypatch):
    """`run()` under a budget that holds no split: all three stream, in
    chunks of ECGMM_STREAM_CHUNK_BATCHES, and the history and test
    reports equal the resident run's."""
    cfg = get_preset("fusion")
    cfg = dataclasses.replace(
        cfg, model=MODEL,
        data=dataclasses.replace(cfg.data, signal_len=256, img_height=16,
                                 img_width=32),
        train=dataclasses.replace(
            cfg.train, batch_size=BS, num_epochs=2,
            checkpoint_dir=str(tmp_path / "ckpt"),
            log_dir=str(tmp_path / "runs"),
            output_dir=str(tmp_path / "out")))
    out = []
    for budget in (None, "1000"):
        if budget:
            monkeypatch.setenv("ECGMM_HBM_BUDGET_BYTES", budget)
            monkeypatch.setenv("ECGMM_STREAM_CHUNK_BATCHES", "2")
        data = port_run.load_data(cfg, "synthetic", 60, device="cpu")
        assert isinstance(data.train, pipeline.HostArrays) == bool(budget)
        out.append(port_run.run(cfg, data, run_dir=str(tmp_path / str(budget)),
                                verbose=False, device="cpu"))
    (ra, ta), (rb, tb) = out
    assert ta == tb
    for ha, hb in zip(ra.history, rb.history):
        assert ha["Loss/Train"] == hb["Loss/Train"]
        assert ha["Loss/Val"] == hb["Loss/Val"]
    assert "Time/StreamGather" in rb.history[0]


def test_from_run_takes_a_host_resident_train_split(tmp_path, host):
    """`ServingPipeline.from_run` over a run whose train split streamed:
    the same SHAP background, signal length and image size as over the
    resident split."""
    from ecgmm_torch.serve.pipeline import ServingPipeline
    from ecgmm_torch.train.checkpoint import CheckpointManager

    d = host["data"]
    CheckpointManager(str(tmp_path)).save("best", _state(seed=3))
    resident = dataclasses.replace(d, train=pipeline.promote(d.train, "cpu"))
    pipes = [ServingPipeline.from_run(str(tmp_path), data,
                                      model=ECGMultimodalModel(MODEL),
                                      device="cpu")
             for data in (d, resident)]
    assert torch.equal(pipes[0].background, pipes[1].background)
    assert (pipes[0].signal_len, pipes[0].img_hw) == \
        (pipes[1].signal_len, pipes[1].img_hw) == (256, (16, 32))
