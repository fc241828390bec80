"""Mesh serving of the port (`ServingPipeline.enable_batching(n_data=k)`)
on the CPU, against `tests/test_serve_mesh.py`: `visible_devices` is
patched to list the CPU twice, so two replicas of the model answer each
bucketed dispatch, a half each.

Bars: the replicas' packed rows of a bucket against JAX's sharded
batched program over two of its CPU devices (`_batched_packed_fn(mesh)`)
on the same weights and SHAP draws, with tests/test_torch_batching.py's
bars (probabilities 1e-4, CAM 1e-3, importances 0.1); the served
responses against the unbatched single-replica answers with
tests/test_serve_mesh.py's bars (probability rtol 1e-3 atol 1e-4, the
importances rtol 5e-2 atol 0.5, labels and waveforms equal).
"""

import threading

import numpy as np
import pytest
import torch

from ecgmm_torch.config import ModelConfig
from ecgmm_torch.models import ECGMultimodalModel
from ecgmm_torch.parallel import mesh as meshlib
from ecgmm_torch.serve import http as port_http
from ecgmm_torch.serve.pipeline import ServingPipeline

torch.set_num_threads(2)

HW, T = 64, 512


@pytest.fixture(scope="module")
def two_cpus():
    real = meshlib.visible_devices
    meshlib.visible_devices = lambda device="cuda": [torch.device("cpu")] * 2
    yield
    meshlib.visible_devices = real


@pytest.fixture(scope="module")
def weights():
    import jax
    import jax.numpy as jnp

    from ecgmm_tpu.config import ModelConfig as JaxModelConfig
    from ecgmm_tpu.models import ECGMultimodalModel as JaxModel

    jmodel = JaxModel(cfg=JaxModelConfig(dtype="float32"))
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(2), jnp.ones((1, HW, HW, 3)), jnp.ones((1, T)),
        jnp.ones((1, 2))))
    kb, ka = jax.random.split(jax.random.PRNGKey(0))
    draws = (np.asarray(jax.random.randint(jax.random.split(kb, 1)[0], (32,),
                                           0, 32)),
             np.asarray(jax.random.uniform(jax.random.split(ka, 1)[0],
                                           (32,))))
    return jmodel, variables, draws


def _pipe(weights):
    from ecgmm_torch.tools.weights import from_jax_variables

    _, variables, draws = weights
    return ServingPipeline(
        ECGMultimodalModel(ModelConfig(dtype="float32")),
        from_jax_variables(variables), signal_len=T, img_hw=(HW, HW),
        device="cpu", shap_draws=draws)


@pytest.fixture(scope="module")
def pipelines(weights, two_cpus):
    ref = _pipe(weights)
    sharded = _pipe(weights)
    sharded.enable_batching(window_ms=150, max_batch=4, buckets=(2, 4),
                            n_data=2)
    yield ref, sharded
    sharded.close_batching()


@pytest.fixture(scope="module")
def strips():
    from ecgmm_torch.data import synthetic

    return synthetic.make_cohort(n=4, signal_len=2476, img_hw=(250, 2500),
                                 seed=3).images


def _concurrent_predict(pipe, images, n):
    results = [None] * n
    barrier = threading.Barrier(n)

    def worker(i):
        barrier.wait()
        results[i] = pipe.predict(images[i], {"age": 50 + i,
                                              "weight": 70 + i}, "cam")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def test_sharded_batched_equals_unbatched(pipelines, strips):
    ref, sharded = pipelines
    before = sharded._batcher.n_dispatches
    got = _concurrent_predict(sharded, strips, 4)
    assert sharded._batcher.n_dispatches > before
    for i, b in enumerate(got):
        a = ref.predict(strips[i], {"age": 50 + i, "weight": 70 + i},
                        "cam")
        assert a["label"] == b["label"]
        assert np.isclose(a["probability"], b["probability"], rtol=1e-3,
                          atol=1e-4)
        assert a["ecg_signal"] == b["ecg_signal"]
        for k in ("image", "signal", "age", "wt"):
            assert np.isclose(a["feature_importance"][k],
                              b["feature_importance"][k], rtol=5e-2,
                              atol=0.5), k
        assert set(a) == set(b)


def test_dispatch_splits_over_the_replicas(pipelines, weights):
    """Each replica takes an equal slice of the bucket, and the
    concatenated rows are JAX's sharded program's on two devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ecgmm_tpu.serve.pipeline import ServingPipeline as JaxPipeline

    _, sharded = pipelines
    seen = []
    fn = sharded._batcher._batch_fn
    reps = fn.replicas
    assert len(reps) == 2 and reps[0].model is not reps[1].model
    originals = [r._dispatch for r in reps]
    for r, orig in zip(reps, originals):
        def spy(img, sig, clin, orig=orig):
            seen.append(img.shape[0])
            return orig(img, sig, clin)
        r._dispatch = spy
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, size=(4, HW, HW, 3)).astype(np.float32)
    sig = rng.normal(size=(4, T)).astype(np.float32)
    clin = rng.normal(size=(4, 2)).astype(np.float32)
    try:
        rows, ms = fn(img.transpose(0, 3, 1, 2), sig, clin)
    finally:
        for r, orig in zip(reps, originals):
            r._dispatch = orig
    assert seen == [2, 2] and rows.shape[0] == 4 and ms.shape == (4,)
    jmodel, variables, _ = weights
    jpipe = JaxPipeline(jmodel, variables, signal_len=T, img_hw=(HW, HW))
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    (want,) = jpipe._batched_packed_fn(mesh)(jnp.asarray(img),
                                             jnp.asarray(sig),
                                             jnp.asarray(clin))
    want = np.asarray(want)
    for g, w in zip(rows, want):
        gp, gpred, gcam, gattr, gca = sharded._unpack(g)
        wp, wpred, wcam, wattr, wca = sharded._unpack(w)
        assert gpred == wpred
        np.testing.assert_allclose(gp, wp, atol=1e-4)
        np.testing.assert_allclose(gcam, wcam, atol=1e-3)


def test_stats_reports_n_data(pipelines):
    _, sharded = pipelines
    assert sharded.stats()["batching"]["n_data"] == 2


def test_validation_errors(pipelines):
    ref, _ = pipelines
    with pytest.raises(ValueError, match="not divisible"):
        ref.enable_batching(buckets=(2, 3), n_data=2)
    with pytest.raises(ValueError, match="exceeds the 2 visible"):
        ref.enable_batching(n_data=3)
    with pytest.raises(ValueError, match=">= 1"):
        ref.enable_batching(n_data=0)
    assert ref._batcher is None  # no failed enable left a batcher behind


def test_default_buckets_scale_with_n_data(weights, two_cpus):
    pipe = _pipe(weights)
    try:
        pipe.enable_batching(window_ms=50, n_data=2)
        assert pipe._batcher._buckets == (2, 4, 8, 16)
    finally:
        pipe.close_batching()
    assert port_http.batch_buckets(8, 2) == (2, 4, 8)
    assert port_http.batch_buckets(16, 2) == (2, 4, 8, 16)


def test_reenable_reuses_the_replicas(pipelines):
    _, sharded = pipelines
    fn_before = sharded._batcher._batch_fn
    sharded.enable_batching(window_ms=120, max_batch=4, buckets=(2, 4),
                            n_data=2)
    assert sharded._batcher._batch_fn is fn_before
