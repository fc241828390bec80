"""The port's AOT serving bundle (`ecgmm_torch.serve.export`) against the
JAX one (`tests/test_export.py`), on the CPU.

A full-width bundle of the demo pipeline (224x224 images, 2476-sample
signals) carries JAX's meta and host constants and answers as the live
port pipeline does, with no model. A narrow bundle (64x64, 512 samples,
buckets 1 and 2) of a pipeline on the JAX weights (`from_jax_variables`)
and the JAX SHAP draws answers as JAX's live `ServingPipeline` does, to
`tests/test_export.py`'s bars: label equal; probability rtol 1e-4, atol
1e-5; each feature importance rtol 1e-3, atol 1e-4; `ecg_signal` equal;
the same keys. Every exported program holds exactly the serving plan's
kernel operators. The HTTP server serves the narrow bundle batched over
its buckets, each response within the same bars of the unbatched
bundle's."""

import concurrent.futures
import json
import os
import urllib.request
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecgmm_tpu.config import ModelConfig as JaxModelConfig
from ecgmm_tpu.data import synthetic as jax_synthetic
from ecgmm_tpu.models import ECGMultimodalModel as JaxModel
from ecgmm_tpu.serve.export import export_bundle as jax_export_bundle
from ecgmm_tpu.serve.pipeline import ServingPipeline as JaxPipeline
from ecgmm_torch.config import ModelConfig
from ecgmm_torch.models import ECGMultimodalModel
from ecgmm_torch.serve import export as ex
from ecgmm_torch.serve import http as port_http
from ecgmm_torch.serve.pipeline import ServingPipeline
from ecgmm_torch.serve.wire import ENDPOINT, encode_multipart
from ecgmm_torch.tools.weights import from_jax_variables

torch.set_num_threads(2)
HW, T = 64, 512


def _jax_draws(key=0):
    kb, ka = jax.random.split(jax.random.PRNGKey(key))
    return (np.asarray(jax.random.randint(jax.random.split(kb, 1)[0], (32,),
                                          0, 32)),
            np.asarray(jax.random.uniform(jax.random.split(ka, 1)[0],
                                          (32,))))


def assert_export_bars(a, b):
    """`tests/test_export.py::test_exported_predict_matches_live`'s bars."""
    assert a["label"] == b["label"]
    assert np.isclose(a["probability"], b["probability"], rtol=1e-4,
                      atol=1e-5)
    for k in ("image", "signal", "age", "wt"):
        assert np.isclose(a["feature_importance"][k],
                          b["feature_importance"][k], rtol=1e-3,
                          atol=1e-4), k
    assert a["ecg_signal"] == b["ecg_signal"]
    assert set(a) == set(b)


@pytest.fixture(scope="module")
def cohort():
    return jax_synthetic.make_cohort(n=4, signal_len=2476,
                                     img_hw=(250, 2500), seed=23)


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """The full-width demo pipeline on the CPU and its bundle (b = 1)."""
    pipe = ServingPipeline.demo(device="cpu")
    out = tmp_path_factory.mktemp("serving") / "bundle"
    return pipe, ex.export_bundle(pipe, str(out), platforms=("cpu",))


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """JAX's live pipeline and the port's on the same weights and draws
    (64x64, 512 samples), and the port pipeline's bundle at buckets 1
    and 2."""
    jmodel = JaxModel(cfg=JaxModelConfig(dtype="float32"))
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(5), jnp.ones((1, HW, HW, 3)), jnp.ones((1, T)),
        jnp.ones((1, 2))))
    jpipe = JaxPipeline(jmodel, variables, signal_len=T, img_hw=(HW, HW))
    pipe = ServingPipeline(
        ECGMultimodalModel(ModelConfig(dtype="float32")),
        from_jax_variables(variables), signal_len=T, img_hw=(HW, HW),
        device="cpu", shap_draws=_jax_draws())
    out = tmp_path_factory.mktemp("narrow") / "bundle"
    bundle = ex.export_bundle(pipe, str(out), platforms=("cpu",),
                              batch_buckets=(2,))
    return jpipe, variables, pipe, bundle


def test_bundle_contents_and_meta(demo):
    """JAX's meta fields (`torch_version` for `jax_version`), the number
    of classes, the program kind, and the background and scalers in the
    host constants, as JAX writes them."""
    pipe, bundle = demo
    program, meta, host = ex.load_bundle(bundle, device="cpu")
    assert meta["format_version"] == 1
    assert meta["program"] == "torch.export"
    assert meta["platforms"] == ["cpu"]
    assert meta["img_hw"] == [224, 224]
    assert meta["signal_len"] == 2476
    assert meta["clinical_in_features"] == 2
    assert meta["dims"] == [512, 128, 32]
    assert meta["num_classes"] == 2
    assert meta["batch_buckets"] == []
    assert meta["temperature"] == 1.0
    assert meta["torch_version"] == torch.__version__
    assert "background" in host
    np.testing.assert_array_equal(host["background"],
                                  pipe.background.numpy())
    prog = meta["programs"]["predict_many_1.cpu.pt2"]
    assert prog["bytes"] == os.path.getsize(
        os.path.join(bundle, "predict_many_1.cpu.pt2"))
    assert prog["trace_s"] > 0 and prog["export_s"] > 0
    assert callable(program)


def test_exported_predict_matches_live(demo, cohort):
    """`tests/test_export.py::test_exported_predict_matches_live` on the
    port: no model is rehydrated, and the bundle answers as the live
    pipeline it was exported from."""
    pipe, bundle = demo
    exported = ServingPipeline.from_exported(bundle, device="cpu")
    assert exported.model is None
    assert exported.stats()["aot"] is True
    assert exported._exported_buckets is None
    q = {"age": 63, "weight": 71, "sex": "F"}
    assert_export_bars(exported.predict(cohort.images[0], q),
                       pipe.predict(cohort.images[0], q))
    assert exported.stats()["requests"] == 1
    assert "ecgmm_requests_total 1" in exported.metrics()


def test_bundle_matches_jax_live_pipeline(narrow, cohort):
    """The port's bundle against JAX's live pipeline on the same weights
    and SHAP draws, at `tests/test_export.py`'s bars."""
    jpipe, _, _, bundle = narrow
    exported = ServingPipeline.from_exported(bundle, device="cpu")
    questionnaires = [{"age": 63, "weight": 71, "sex": "F"},
                      {"age": "45", "weight": "", "sex": "M"}]
    for img, q in zip(cohort.images[:2], questionnaires):
        assert_export_bars(exported.predict(img, q), jpipe.predict(img, q))


def test_every_program_holds_the_serving_plan(demo, narrow):
    """Each saved program, at b = 1 and at each bucket, holds exactly the
    plan's `ecgmm.*` nodes: 3 SE forwards, 3 fusion forwards and 2 fusion
    backwards (SHAP and IG); no kernel reached the trace outside an
    operator."""
    names = []
    for bundle in (demo[1], narrow[3]):
        for name in sorted(os.listdir(bundle)):
            if name.endswith(".pt2"):
                program = torch.export.load(os.path.join(bundle, name))
                assert ex.operator_counts(program.graph) == ex.SERVE_PLAN
                names.append(name)
    assert names == ["predict_many_1.cpu.pt2", "predict_many_1.cpu.pt2",
                     "predict_many_2.cpu.pt2"]
    assert ex.SERVE_PLAN == {"ecgmm.fused_se": 3,
                             "ecgmm.attention_fusion": 3,
                             "ecgmm.attention_fusion_backward": 2}


def test_batched_programs_answer_as_the_live_bucket(narrow):
    """The bucket-2 program equals the live request program on the same
    rows to the bars, and a bundle dispatches only the buckets it holds."""
    _, _, pipe, bundle = narrow
    exported = ServingPipeline.from_exported(bundle, device="cpu")
    assert exported._exported_buckets == (2,)
    progs = ex.load_batched_programs(bundle, device="cpu")
    assert sorted(progs) == [2]
    rng = np.random.default_rng(0)
    ins = (rng.normal(size=(2, 3, HW, HW)), rng.normal(size=(2, T)),
           rng.normal(size=(2, 2)))
    ins = [torch.as_tensor(a, dtype=torch.float32) for a in ins]
    got = progs[2](*ins).numpy()
    want = pipe._predict_many(*ins).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="no program for bucket 2"):
        exported._predict_many(*ins)
    with pytest.raises(ValueError, match="not all exported"):
        exported.enable_batching(5, buckets=(1, 4))


def test_draws_are_constants_of_the_program(narrow, tmp_path):
    """The SHAP draws are lifted into the program: a pipeline with other
    draws exports a program whose SHAP attributions differ, its
    probabilities not."""
    _, variables, pipe, bundle = narrow
    other = ServingPipeline(
        ECGMultimodalModel(ModelConfig(dtype="float32")),
        from_jax_variables(variables), signal_len=T, img_hw=(HW, HW),
        device="cpu", shap_draws=_jax_draws(1))
    other_bundle = ex.export_bundle(other, str(tmp_path / "other"),
                                    platforms=("cpu",))
    a, _, host_a = ex.load_bundle(bundle, device="cpu")
    b, _, host_b = ex.load_bundle(other_bundle, device="cpu")
    np.testing.assert_array_equal(host_a["background"], host_b["background"])
    rng = np.random.default_rng(1)
    ins = [torch.as_tensor(x, dtype=torch.float32) for x in (
        rng.normal(size=(1, 3, HW, HW)), rng.normal(size=(1, T)),
        rng.normal(size=(1, 2)))]
    ra, rb = a(*ins).numpy()[0], b(*ins).numpy()[0]
    d = sum(pipe.dims)
    shap = slice(3 + pipe.cam_hw[0] * pipe.cam_hw[1], -2)
    assert ra[shap].shape == (d,)
    np.testing.assert_array_equal(ra[:3], rb[:3])
    assert not np.allclose(ra[shap], rb[shap])


def test_cli_run_dir_wiring(monkeypatch, tmp_path):
    """--run-dir reaches from_run with the data split it needs, on the
    platform's device (`tests/test_export.py::test_cli_run_dir_wiring`)."""
    captured = {}

    def fake_from_run(cls, run_dir, data, **kw):
        captured["run_dir"] = run_dir
        captured["n"] = data.train.n + data.val.n + data.test.n
        captured["device"] = kw.get("device")
        return object()

    monkeypatch.setattr(ServingPipeline, "from_run",
                        classmethod(fake_from_run))
    monkeypatch.setattr(
        ex, "export_bundle",
        lambda pipe, out, platforms, batch_buckets=None: out)
    ex.main(["--out", str(tmp_path / "b"), "--run-dir", "/some/run",
             "--n-synth", "32", "--platforms", "cpu"])
    assert captured == {"run_dir": "/some/run", "n": 32, "device": "cpu"}


def test_format_version_gate_and_jax_bundle_refused(narrow, tmp_path):
    """A bundle of another format asks for a re-export, as JAX's does; a
    JAX StableHLO bundle is named as such; a bundle without the platform
    asked for, or without meta.json, raises."""
    jpipe, _, pipe, _ = narrow
    out = ex.export_bundle(pipe, str(tmp_path / "b3"), platforms=("cpu",))
    meta_path = os.path.join(out, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["format_version"] = 999
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="re-export"):
        ex.load_bundle(out, device="cpu")
    jax_bundle = jax_export_bundle(jpipe, str(tmp_path / "jax"),
                                   platforms=("cpu",))
    with pytest.raises(ValueError, match="JAX StableHLO bundle"):
        ex.load_bundle(jax_bundle, device="cpu")
    with pytest.raises(ValueError, match="JAX StableHLO bundle"):
        ServingPipeline.from_exported(jax_bundle, device="cpu")
    meta["format_version"] = 1
    meta["platforms"] = ["cuda"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="not 'cpu'"):
        ex.load_bundle(out, device="cpu")
    with pytest.raises(FileNotFoundError, match="meta.json"):
        ex.load_bundle(str(tmp_path / "missing"), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal; the card exports in chip_smoke.py phase 14")
def test_cuda_export_without_a_card_raises(narrow, tmp_path):
    """A 'cuda' export or load where there is no card raises; nothing
    falls back to the CPU."""
    _, _, pipe, bundle = narrow
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.export_bundle(pipe, str(tmp_path / "c"), platforms=("cuda",))
    assert not os.path.exists(tmp_path / "c")
    with pytest.raises(ValueError, match="not 'cuda'"):
        ex.load_bundle(bundle)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.main(["--out", str(tmp_path / "d")])


def _post(base, img_bytes, q):
    body, ctype = encode_multipart(
        {"file": ("strip.png", img_bytes),
         "questionnaire": (None, json.dumps(q).encode())})
    req = urllib.request.Request(base + ENDPOINT, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def test_http_bundle_batched_over_its_buckets(narrow, cohort):
    """The server on the bundle, batched over its buckets (1 is the
    unbatched program, 2 the batched): four concurrent uploads each
    answer within the bars of the unbatched bundle's answer to the same
    upload, and at least one dispatch coalesced two requests (a full
    bucket dispatches at once; the long window only waits for a
    straggler)."""
    from ecgmm_torch import native

    _, _, _, bundle = narrow
    plain = ServingPipeline.from_exported(bundle, device="cpu")
    served = ServingPipeline.from_exported(bundle, device="cpu")
    served.enable_batching(window_ms=2000.0, max_batch=2)
    assert served._batcher._buckets == (2,)
    server = port_http.serve(served, port=0, background=True)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    uploads = [native.png_encode(img) for img in cohort.images]
    qs = [{"age": 50 + i, "weight": 60 + i} for i in range(4)]
    try:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            got = list(pool.map(lambda i: _post(base, uploads[i], qs[i]),
                                range(4)))
        batching = served.stats()["batching"]
    finally:
        server.shutdown()
        server.server_close()
        served.close_batching()
    for img, q, resp in zip(cohort.images, qs, got):
        assert_export_bars(resp, plain.predict(img, q))
    stats = served.stats()
    assert stats["requests"] == 4 and stats["aot"] is True
    assert batching["dispatches"] < 4
    assert batching["mean_coalescence"] > 1


def test_cli_refusals_with_a_bundle(narrow, demo, capsys):
    """JAX's two refusals (`ecgmm_tpu/serve/http.py:280-291`): --n-data
    > 1 with --bundle, and batching on a bundle exported without
    buckets."""
    with pytest.raises(SystemExit):
        port_http.main(["--bundle", narrow[3], "--n-data", "2",
                        "--batch-window-ms", "5", "--device", "cpu"])
    assert "an AOT bundle is a fixed single-device program" in \
        capsys.readouterr().err
    with pytest.raises(SystemExit):
        port_http.main(["--bundle", demo[1], "--batch-window-ms", "5",
                        "--device", "cpu", "--no-warmup"])
    assert "re-export with --batch-buckets" in capsys.readouterr().err


def test_export_times_tool(capsys):
    """`python -m ecgmm_torch.tools.export_times --device cpu`: one pair
    of exports of the demo program, the stack-trace capture off and on,
    each with its trace and export seconds; the capture is off again
    after it."""
    from ecgmm_torch.tools import export_times

    export_times.main(["--device", "cpu", "--pairs", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["b"] == 1
    (row,) = out["pairs"]
    assert set(row) == {f"{k}_capture_{c}" for k in ("trace_s", "export_s")
                        for c in ("off", "on")}
    assert all(v > 0 for v in row.values())


def test_export_captures_no_stack_traces(narrow):
    """`trace_program` exports with the tracer's stack capture off: torch
    captures no Python stack for any node (it would keep none of a
    `make_fx` graph), and the switch is restored after."""
    import torch.utils._traceback as tb
    from torch.fx.experimental import proxy_tensor

    captured = []
    extract = tb.CapturedTraceback.extract

    def counted(*a, **k):
        captured.append(1)
        return extract(*a, **k)

    _, _, pipe, _ = narrow
    with mock.patch.object(tb.CapturedTraceback, "extract",
                           staticmethod(counted)):
        program, _, _ = ex.trace_program(pipe, 1)
    assert captured == []
    assert not any(n.meta.get("stack_trace") for n in program.graph.nodes)
    assert "record_stack_traces" not in vars(proxy_tensor._ModuleStackTracer)
