"""Micro-batched serving in the port (`ecgmm_torch.serve.batching`, the
batched request program `ServingPipeline._predict_many`) against the JAX
package, and the two repairs of the served path: TF32 off inside the
device program, exact launch counters under threads.

The MicroBatcher cases are the port's counterparts of
`tests/test_batching.py`. The batched program is held against JAX's
`_batched_packed_fn()` (its vmapped `predict_many`) at a small size
(64x64 model images, 512-sample signals) on the same weights and SHAP
draws, within `tests/test_torch_serve.py`'s bars: probability 1e-4, the
CAM 1e-3, feature importance 0.1 percentage points."""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecgmm_tpu.config import ModelConfig as JaxModelConfig
from ecgmm_tpu.data import synthetic as jax_synthetic
from ecgmm_tpu.models import ECGMultimodalModel as JaxModel
from ecgmm_tpu.serve.pipeline import ServingPipeline as JaxPipeline
from ecgmm_torch.config import ModelConfig
from ecgmm_torch.explain.shap_fusion import modality_contributions
from ecgmm_torch.models import ECGMultimodalModel
from ecgmm_torch.ops import _ext, fusion, se
from ecgmm_torch.ops import losses as focal
from ecgmm_torch.serve import batching
from ecgmm_torch.serve.batching import MicroBatcher, _bucket_for
from ecgmm_torch.serve.pipeline import ServingPipeline
from ecgmm_torch.tools.weights import from_jax_variables

torch.set_num_threads(2)

HW, T = 64, 512
JOIN_S = 120


# ------------------------------------------------------------ MicroBatcher


def _join_all(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)


def _counting_fn(calls):
    def fn(x, y):
        calls.append(x.shape[0])
        return (x * 2.0, y + 1.0)

    return fn


def test_bucket_for():
    assert _bucket_for(1, (1, 2, 4, 8)) == 1
    assert _bucket_for(3, (1, 2, 4, 8)) == 4
    assert _bucket_for(8, (1, 2, 4, 8)) == 8


def test_single_submit_roundtrip():
    calls = []
    mb = MicroBatcher(_counting_fn(calls), window_ms=1, max_batch=8)
    try:
        out_x, out_y = mb.submit(np.full((3,), 2.0), np.zeros((2, 2)))
        np.testing.assert_array_equal(out_x, np.full((3,), 4.0))
        np.testing.assert_array_equal(out_y, np.ones((2, 2)))
        assert calls == [1]  # padded to bucket 1
    finally:
        mb.close()


def _submit_together(mb, args_of, n):
    results = [None] * n
    barrier = threading.Barrier(n)

    def worker(i):
        barrier.wait()
        results[i] = mb.submit(*args_of(i))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    _join_all(threads)
    return results


def test_concurrent_submits_coalesce():
    calls = []
    mb = MicroBatcher(_counting_fn(calls), window_ms=200, max_batch=8)
    try:
        results = _submit_together(
            mb, lambda i: (np.full((4,), float(i)), np.zeros((1,))), 8)
        for i in range(8):
            np.testing.assert_array_equal(results[i][0],
                                          np.full((4,), 2.0 * i))
        assert sum(calls) >= 8
        assert len(calls) <= 4
    finally:
        mb.close()


def test_batch_padding_discards_pad_rows():
    calls = []
    mb = MicroBatcher(_counting_fn(calls), window_ms=150, max_batch=8,
                      buckets=(1, 2, 4, 8))
    try:
        results = _submit_together(
            mb, lambda i: (np.full((2,), float(i)), np.zeros(())), 3)
        for i in range(3):
            np.testing.assert_array_equal(results[i][0],
                                          np.full((2,), 2.0 * i))
        assert all(c in (1, 2, 4, 8) for c in calls)
    finally:
        mb.close()


def test_heterogeneous_shapes_never_share_a_dispatch():
    shapes_seen = []

    def fn(x):
        shapes_seen.append(x.shape)
        return (x,)

    mb = MicroBatcher(fn, window_ms=100, max_batch=8)
    specs = [(0, (3,)), (1, (4,)), (2, (3,)), (3, (4,))]
    try:
        results = _submit_together(
            mb, lambda i: (np.full(specs[i][1], float(i)),), 4)
        for i, shape in specs:
            np.testing.assert_array_equal(results[i][0],
                                          np.full(shape, float(i)))
        assert all(s[1:] in ((3,), (4,)) for s in shapes_seen)
    finally:
        mb.close()


def test_error_propagates_to_submitter():
    def boom(x):
        raise RuntimeError("device on fire")

    mb = MicroBatcher(boom, window_ms=1, max_batch=2, buckets=(1, 2))
    try:
        for _ in range(2):  # the worker survives a failed dispatch
            with pytest.raises(batching.BatchDispatchError,
                               match="device on fire"):
                mb.submit(np.zeros((1,)))
    finally:
        mb.close()


def test_submit_after_close_raises():
    mb = MicroBatcher(lambda x: (x,), window_ms=1, max_batch=1,
                      buckets=(1,))
    mb.close()
    with pytest.raises(batching.BatcherClosed, match="closed"):
        mb.submit(np.zeros((1,)))


# ------------------------------------------------ the batched program


def _jax_draws():
    """The SHAP draws of the JAX request program (PRNGKey(0), one row):
    every row of a bucket gets these (predict_many vmaps the one-row
    program)."""
    kb, ka = jax.random.split(jax.random.PRNGKey(0))
    return (np.asarray(jax.random.randint(jax.random.split(kb, 1)[0], (32,),
                                          0, 32)),
            np.asarray(jax.random.uniform(jax.random.split(ka, 1)[0],
                                          (32,))))


@pytest.fixture(scope="module")
def pipelines():
    jmodel = JaxModel(cfg=JaxModelConfig(dtype="float32"))
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(2), jnp.ones((1, HW, HW, 3)), jnp.ones((1, T)),
        jnp.ones((1, 2)),
    ))
    jpipe = JaxPipeline(jmodel, variables, signal_len=T, img_hw=(HW, HW))
    pipe = ServingPipeline(
        ECGMultimodalModel(ModelConfig(dtype="float32")),
        from_jax_variables(variables), signal_len=T, img_hw=(HW, HW),
        device="cpu", shap_draws=_jax_draws(),
    )
    return jpipe, pipe


@pytest.fixture(scope="module")
def bucket():
    """A bucket of 4: three distinct requests and a pad row repeating the
    last, as the MicroBatcher pads."""
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, size=(3, HW, HW, 3)).astype(np.float32)
    sig = rng.normal(size=(3, T)).astype(np.float32)
    clin = rng.normal(size=(3, 2)).astype(np.float32)
    return tuple(np.concatenate([a, a[-1:]]) for a in (img, sig, clin))


def _split(pipe, row):
    probs, pred, cam, attr, ca = pipe._unpack(row)
    contrib = modality_contributions(attr, pipe.dims)
    share = np.abs(ca) / np.abs(ca).sum()
    clin = float(contrib["Clinical_%"][0])
    importance = np.array([float(contrib["Image_%"][0]),
                           float(contrib["Signal_%"][0]),
                           clin * share[0], clin * share[1]])
    return probs, pred, cam, importance


def _assert_rows_close(pipe, got, want):
    for g, w in zip(got, want):
        gp, gpred, gcam, gimp = _split(pipe, g)
        wp, wpred, wcam, wimp = _split(pipe, w)
        assert gpred == wpred
        np.testing.assert_allclose(gp, wp, atol=1e-4)
        np.testing.assert_allclose(gcam, wcam, atol=1e-3)
        np.testing.assert_allclose(gimp, wimp, atol=0.1)


def test_batched_rows_match_jax_predict_many(pipelines, bucket):
    """The port's packed (b, K) rows of a padded bucket against JAX's
    vmapped request program on the same weights and draws; the pad row
    equals the row it repeats (to float32 rounding: its position in the
    batch moves the CPU's summation blocks)."""
    jpipe, pipe = pipelines
    img, sig, clin = bucket
    (want,) = jpipe._batched_packed_fn()(jnp.asarray(img), jnp.asarray(sig),
                                         jnp.asarray(clin))
    want = np.asarray(want)
    got, _ = pipe._dispatch(img.transpose(0, 3, 1, 2), sig, clin)
    assert got.shape == want.shape == (4, want.shape[1])
    _assert_rows_close(pipe, got, want)
    np.testing.assert_allclose(got[3], got[2], rtol=1e-4, atol=1e-5)


def test_batched_rows_match_unbatched_program(pipelines, bucket):
    """Each row of the bucket equals the one-request program on that
    input, and every row used the pipeline's one set of SHAP draws."""
    _, pipe = pipelines
    img, sig, clin = (torch.from_numpy(a) for a in bucket)
    img = img.permute(0, 3, 1, 2).contiguous()
    rows = pipe._predict_many(img, sig, clin).numpy()
    for i in range(3):
        one = pipe._predict_many(img[i:i + 1], sig[i:i + 1],
                                 clin[i:i + 1])[0].numpy()
        np.testing.assert_allclose(rows[i], one, rtol=1e-4, atol=1e-5)
    assert pipe.shap_bidx.shape == pipe.shap_alphas.shape == (1, 32)


# ------------------------------------------- batched predict() and HTTP


@pytest.fixture(scope="module")
def cohort():
    return jax_synthetic.make_cohort(n=4, signal_len=2476,
                                     img_hw=(250, 2500), seed=3)


def _questionnaire(i):
    return {"age": 50 + 7 * i, "weight": 60 + 5 * i}


def _assert_same_response(a, b):
    """`tests/test_serve_batched.py::_assert_same_response`."""
    assert a["label"] == b["label"]
    assert np.isclose(a["probability"], b["probability"],
                      rtol=1e-3, atol=1e-4)
    for k in ("image", "signal", "age", "wt"):
        assert np.isclose(a["feature_importance"][k],
                          b["feature_importance"][k], rtol=5e-2,
                          atol=0.5), k
    assert a["ecg_signal"] == b["ecg_signal"]
    assert set(a) == set(b)


def test_concurrent_predict_through_batching_matches_unbatched(pipelines,
                                                               cohort):
    _, pipe = pipelines
    n = 4
    expected = [pipe.predict(cohort.images[i], _questionnaire(i), "cam")
                for i in range(n)]
    pipe.enable_batching(window_ms=1500, max_batch=4, buckets=(1, 2, 4))
    try:
        results = [None] * n
        barrier = threading.Barrier(n)

        def worker(i):
            barrier.wait()
            results[i] = pipe.predict(cohort.images[i], _questionnaire(i),
                                      "cam")

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        _join_all(threads)
        for want, got in zip(expected, results):
            _assert_same_response(got, want)
            np.testing.assert_allclose(got["heatmap_cam"],
                                       want["heatmap_cam"], atol=1e-3)
        stats = pipe.stats()["batching"]
        assert stats["requests"] == n
        assert stats["mean_coalescence"] > 1
        assert stats["n_data"] == 1
    finally:
        pipe.close_batching()
    assert pipe.stats()["batching"] is None


def test_closed_race_takes_unbatched_path_dispatch_failure_surfaces(
        pipelines, cohort):
    """predict() takes the unbatched path when submit races a close (the
    request was never dispatched) but lets a BatchDispatchError through:
    a failing batched program must surface."""
    _, pipe = pipelines
    q = _questionnaire(0)
    want = pipe.predict(cohort.images[0], q, "cam")

    class ClosedStub:
        def submit(self, *args):
            raise batching.BatcherClosed("MicroBatcher is closed")

    def boom(*args):
        raise RuntimeError("device on fire")

    try:
        pipe._batcher = ClosedStub()
        _assert_same_response(pipe.predict(cohort.images[0], q, "cam"), want)
        pipe._batcher = MicroBatcher(boom, window_ms=1, max_batch=1,
                                     buckets=(1,))
        with pytest.raises(batching.BatchDispatchError,
                           match="device on fire"):
            pipe.predict(cohort.images[0], q, "cam")
    finally:
        if isinstance(pipe._batcher, MicroBatcher):
            pipe._batcher.close()
        pipe._batcher = None


def test_enable_batching_validates_before_replacing(pipelines):
    """A bad re-enable keeps the live batcher; n_data beyond the visible
    devices raises as in JAX, and within them names the ROADMAP item."""
    _, pipe = pipelines
    pipe.enable_batching(window_ms=5, buckets=(1, 2))
    try:
        old = pipe._batcher
        with pytest.raises(ValueError, match="max_batch"):
            pipe.enable_batching(window_ms=5, max_batch=6)
        assert pipe._batcher is old
        with pytest.raises(ValueError, match="visible"):
            pipe.enable_batching(n_data=2)
        with pytest.raises(ValueError, match="n_data"):
            pipe.enable_batching(n_data=0)
        assert pipe._batcher is old
    finally:
        pipe.close_batching()


# ------------------------------------------------------------ the repairs


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def test_served_program_turns_tf32_off_and_restores_it(pipelines, bucket,
                                                       cohort, monkeypatch):
    """With the caller's TF32 flags on, both read False inside the device
    program (read from the model's encode), through `_predict_many` of
    one row and of the bucket, and predict() on the unbatched and the batched path;
    afterwards they are on again."""
    _, pipe = pipelines
    seen = []
    inner = pipe.model.encode

    def encode(*args, **kwargs):
        seen.append(_flags())
        return inner(*args, **kwargs)

    monkeypatch.setattr(pipe.model, "encode", encode)
    saved = _flags()
    img, sig, clin = (torch.from_numpy(a) for a in bucket)
    img = img.permute(0, 3, 1, 2).contiguous()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        calls = [
            lambda: pipe._predict_many(img[:1], sig[:1], clin[:1]),
            lambda: pipe._predict_many(img, sig, clin),
            lambda: pipe.predict(cohort.images[0], _questionnaire(0), "cam"),
        ]
        for call in calls:
            call()
            assert _flags() == (True, True)
        pipe.enable_batching(window_ms=1, buckets=(1,))
        try:
            pipe.predict(cohort.images[1], _questionnaire(1), "cam")
        finally:
            pipe.close_batching()
        assert _flags() == (True, True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    assert len(seen) == 4
    assert all(s == (False, False) for s in seen), seen


def _op_calls():
    """(module, name of its plain version, one CPU call of its wrapper)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 16, 5, generator=g)
    ws = [torch.randn(*s, generator=g) for s in ((1, 16), (1,), (16, 1),
                                                (16,))]
    f_in = [torch.randn(1, w, generator=g) for w in (4, 3, 2)] + [
        torch.randn(3, generator=g), torch.ones(9), torch.zeros(9)]
    logits = torch.randn(2, 2, generator=g)
    labels = torch.tensor([0, 1])
    mask = torch.ones(2)
    return [
        (se, "reference_se", lambda: se.fused_se(x, *ws)),
        (fusion, "reference_attention_fusion",
         lambda: fusion.fused_attention_fusion(*f_in)),
        (focal, "reference_focal",
         lambda: focal.fused_focal_loss(logits, labels, mask)),
    ]


def test_launch_counters_are_exact_under_threads(monkeypatch):
    """8 threads x 200 CPU calls of each op's wrapper, the plain version
    hooked to count through `_ext.count` as a launch does (chip_smoke's
    rehearsal): the counter gains exactly 1600, with the interpreter
    switching threads as often as it can; and an increment waits for the
    counters' lock."""
    calls = _op_calls()
    for mod, name, _ in calls:
        plain = getattr(mod, name)

        def counted(*args, _plain=plain, _mod=mod.__name__, **kwargs):
            _ext.count(_mod, "launches")
            return _plain(*args, **kwargs)

        monkeypatch.setattr(mod, name, counted)
    before = [mod.launches for mod, _, _ in calls]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        barrier = threading.Barrier(8)

        def worker():
            barrier.wait()
            for _ in range(200):
                for _, _, call in calls:
                    call()

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        _join_all(threads)
    finally:
        sys.setswitchinterval(interval)
    assert [mod.launches - b for (mod, _, _), b in zip(calls, before)] == \
        [1600] * 3
    # the increment holds the counters' lock: it waits while another
    # holder has it (CPython's GIL alone would hide a missing lock here)
    n0 = se.launches
    with _ext._count_lock:
        t = threading.Thread(target=_ext.count,
                             args=(se.__name__, "launches"))
        t.start()
        t.join(timeout=0.2)
        assert t.is_alive() and se.launches == n0
    t.join(timeout=JOIN_S)
    assert not t.is_alive() and se.launches == n0 + 1
