"""The port's HTTP front end (`ecgmm_torch.serve.http`), its CLI and
`ServingPipeline.from_run`, against the JAX package.

A JAX server and a port server, both on the CPU on ephemeral ports, hold
the same weights at a small size (64x64 model images, 512-sample
signals) and answer the same upload bytes: JAX decodes them with Pillow,
the port with its own decoder. The responses agree within
`tests/test_serve_batched.py::_assert_same_response`'s bars (probability
rtol 1e-3 / atol 1e-4, feature importance rtol 5e-2 / atol 0.5 points,
the waveform and the label equal). The port's transport is then held to
the JAX transport's tests (`tests/test_serve.py`): status codes, /healthz,
/stats, /metrics, the drain and the recycle."""

import base64
import dataclasses
import http.client
import io
import json
import os
import re
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ecgmm_tpu.config import ModelConfig as JaxModelConfig
from ecgmm_tpu.data import synthetic as jax_synthetic
from ecgmm_tpu.data.pipeline import normalize_images
from ecgmm_tpu.models import ECGMultimodalModel as JaxModel
from ecgmm_tpu.serve import http as jax_http
from ecgmm_tpu.serve.pipeline import ServingPipeline as JaxPipeline
from ecgmm_tpu.tools.convert_pth import convert_fusion_canonical
from ecgmm_torch.config import ModelConfig, get_preset
from ecgmm_torch.models import ECGMultimodalModel
from ecgmm_torch.serve import http as port_http
from ecgmm_torch.serve.pipeline import ServingPipeline
from ecgmm_torch.serve.wire import ENDPOINT, encode_multipart
from ecgmm_torch.tools import serve_hammer
from ecgmm_torch.tools.weights import from_jax_variables
from ecgmm_torch.train.checkpoint import CheckpointManager
from ecgmm_torch.workloads import run as port_run

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, T = 64, 512
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "ecgmm_tpu", "PIL")


def _jax_draws():
    kb, ka = jax.random.split(jax.random.PRNGKey(0))
    return (np.asarray(jax.random.randint(jax.random.split(kb, 1)[0], (32,),
                                          0, 32)),
            np.asarray(jax.random.uniform(jax.random.split(ka, 1)[0],
                                          (32,))))


@pytest.fixture(scope="module")
def servers():
    """(JAX base URL, port base URL, port pipeline) on the same weights."""
    jmodel = JaxModel(cfg=JaxModelConfig(dtype="float32"))
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(7), jnp.ones((1, HW, HW, 3)), jnp.ones((1, T)),
        jnp.ones((1, 2)),
    ))
    jpipe = JaxPipeline(jmodel, variables, signal_len=T, img_hw=(HW, HW))
    pipe = ServingPipeline(
        ECGMultimodalModel(ModelConfig(dtype="float32")),
        from_jax_variables(variables), signal_len=T, img_hw=(HW, HW),
        device="cpu", shap_draws=_jax_draws(),
    )
    jserver = jax_http.serve(jpipe, port=0, background=True)
    server = port_http.serve(pipe, port=0, background=True)
    try:
        yield (f"http://127.0.0.1:{jserver.server_address[1]}",
               f"http://127.0.0.1:{server.server_address[1]}", pipe)
    finally:
        for s in (jserver, server):
            s.shutdown()
            s.server_close()


@pytest.fixture(scope="module")
def cohort():
    return jax_synthetic.make_cohort(n=2, signal_len=2476,
                                     img_hw=(250, 2500), seed=21)


def _encoded(img, fmt="JPEG") -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt)
    return buf.getvalue()


def _body(photo: bytes, questionnaire=None, heatmap_format=None,
          name="photo.jpg"):
    fields = {"file": (name, photo),
              "questionnaire": (None, json.dumps(
                  questionnaire or {"age": 60}).encode())}
    if heatmap_format is not None:
        fields["heatmap_format"] = (None, heatmap_format.encode())
    return encode_multipart(fields, boundary="testboundary123")


def _post(base, body, ctype, timeout=300):
    req = urllib.request.Request(base + ENDPOINT, data=body,
                                 headers={"Content-Type": ctype},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


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


@pytest.mark.parametrize("fmt", ["JPEG", "PNG", "WEBP", "ARITHMETIC",
                                 "TIFF", "PPM", "ZSTD", "OJPEG", "TGA",
                                 "PSD", "JP2"])
def test_same_upload_same_response_as_jax(servers, cohort, fmt):
    """Both servers as they ship: each digitizes through its native
    kernels, the port's a copy of JAX's, so the waveforms are equal. A
    WebP upload (lossy, Pillow's default quality) decodes in the port
    bit-equal to the JAX handler's Pillow, and so do an arithmetic-coded
    JPEG (the committed `strip_arith.jpg`, half a cohort strip), a
    JPEG-in-TIFF strip (the committed `strip_ycbcr22.tif`: YCbCr at 2x2,
    as scanners write it), a PPM (P6, Pillow's writer), a ZSTD TIFF strip
    and an old-style JPEG TIFF strip (`strip_zstd.tif`,
    `strip_ojpeg.tif`), a TGA (Pillow's run-length writer), a PSD (the
    committed `strip.psd`) and a JPEG 2000 strip (the committed
    `strip_layers.jp2`: three reversible layers)."""
    jbase, base, _ = servers
    committed = {"ARITHMETIC": ("strip_arith.jpg", "JPEG"),
                 "TIFF": ("strip_ycbcr22.tif", "TIFF"),
                 "ZSTD": ("strip_zstd.tif", "TIFF"),
                 "OJPEG": ("strip_ojpeg.tif", "TIFF"),
                 "PSD": ("strip.psd", "PSD"),
                 "JP2": ("strip_layers.jp2", "JPEG2000")}
    if fmt in committed:
        name, fmt = committed[fmt]
        with open(os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "ecgmm_torch", "serve",
                "fixtures", name), "rb") as f:
            photo = f.read()
    elif fmt == "TGA":
        buf = io.BytesIO()
        Image.fromarray(cohort.images[0]).save(buf, format="TGA",
                                               compression="tga_rle")
        photo = buf.getvalue()
    else:
        photo = _encoded(cohort.images[0], fmt)
    body, ctype = _body(photo, {"age": 71, "weight": 58, "gender": "1"},
                        name=f"photo.{fmt.lower()}")
    want = _post(jbase, body, ctype)
    got = _post(base, body, ctype)
    _assert_same_response(got, want)
    assert got["digitization"] == want["digitization"]
    assert got["gpt_result"] == want["gpt_result"]


def test_contract_and_heatmap_formats(servers, cohort):
    """The ResultScreen contract with the png heatmap; "cam" returns the
    raw CAM grid; "jpeg" returns the overlay as Pillow's quality-85 JPEG
    (the JAX request's encoder) with heatmap_mime. Each format's key set
    is the JAX server's."""
    jbase, base, _ = servers
    photo = _encoded(cohort.images[1])
    body, ctype = _body(photo, {"age": 66, "weight": 72, "sex": "F"})
    data = _post(base, body, ctype)
    assert data["label"] in ("Normal", "Abnormal")
    assert 0.0 <= data["probability"] <= 1.0
    assert len(data["ecg_signal"]) > 100
    assert base64.b64decode(data["heatmap"])[:8] == b"\x89PNG\r\n\x1a\n"
    fi = data["feature_importance"]
    assert set(fi) == {"image", "signal", "age", "wt"}
    assert abs(sum(fi.values()) - 100.0) < 1.0
    assert data["digitization"]["px_per_mv"] > 0
    assert len(data["gpt_result"]) == 5
    body, ctype = _body(photo, heatmap_format="cam")
    cam = np.asarray(_post(base, body, ctype)["heatmap_cam"], np.float32)
    assert cam.shape == (2, 2) and np.isfinite(cam).all()
    body, ctype = _body(photo, heatmap_format="jpeg")
    jpeg = _post(base, body, ctype)
    assert jpeg["heatmap_mime"] == "image/jpeg"
    body, ctype = _body(photo, heatmap_format="png")
    overlay = Image.open(io.BytesIO(base64.b64decode(
        _post(base, body, ctype)["heatmap"])))
    buf = io.BytesIO()
    overlay.save(buf, format="JPEG", quality=85)
    assert base64.b64decode(jpeg["heatmap"]) == buf.getvalue()
    for fmt in ("png", "cam", "jpeg"):
        body, ctype = _body(photo, heatmap_format=fmt)
        assert set(_post(base, body, ctype)) == set(_post(jbase, body,
                                                          ctype)), fmt


def test_client_errors_are_400(servers, cohort):
    """`tests/test_serve.py::test_http_endpoint_client_errors_are_400`'s
    cases, a non-numeric age, and a JPEG both decoders refuse: a lossless
    arithmetic-coded frame (SOF11), which libjpeg-turbo cannot decode
    either. (An arithmetic-coded JPEG, SOF9, was this case until the
    decoder learned it: test_same_upload_same_response_as_jax.)"""
    _, base, _ = servers
    good = _encoded(np.zeros((20, 40, 3), np.uint8))
    blank = _encoded(np.full((250, 500, 3), 245, np.uint8))
    arith = bytearray(good)
    arith[arith.index(b"\xff\xc0") + 1] = 0xCB  # SOF11
    cases = [
        (encode_multipart({"notfile": (None, b"x")}),
         "missing multipart field 'file'"),
        (encode_multipart({"file": ("f.jpg", b"not an image")}),
         "not a decodable image"),
        (encode_multipart({"file": ("f.jpg", good),
                           "questionnaire": (None, b"{broken")}),
         "not valid JSON"),
        (encode_multipart({"file": ("f.jpg", good),
                           "questionnaire": (None, b"[1, 2]")}),
         "must be a JSON object"),
        ((b"xx", "application/octet-stream"), "boundary"),
        (encode_multipart({"file": ("f.jpg", good),
                           "questionnaire": (None, b"{}"),
                           "heatmap_format": (None, b"jpg")}),
         "unknown heatmap_format"),
        (encode_multipart({"file": ("f.jpg", blank),
                           "questionnaire": (None, b"{}")}),
         "no ECG trace"),
        (encode_multipart({"file": ("f.jpg", _encoded(cohort.images[0])),
                           "questionnaire": (None, b'{"age": "sixty"}')}),
         "must be numeric"),
        (encode_multipart({"file": ("f.jpg", bytes(arith))}),
         "lossless arithmetic-coded JPEG"),
    ]
    for (body, ctype), want in cases:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, body, ctype, timeout=60)
        assert e.value.code == 400, want
        assert want in json.loads(e.value.read())["error"]


def test_oversize_body_is_413_and_unknown_path_404(servers):
    _, base, _ = servers
    conn = http.client.HTTPConnection(base.split("//")[1], timeout=60)
    try:
        conn.putrequest("POST", ENDPOINT)
        conn.putheader("Content-Type", "multipart/form-data; boundary=b")
        conn.putheader("Content-Length",
                       str(port_http.MAX_REQUEST_BYTES + 1))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413
        assert "exceeds" in json.loads(resp.read())["error"]
    finally:
        conn.close()
    for req in (urllib.request.Request(base + "/nope", data=b"x",
                                       method="POST"),
                urllib.request.Request(base + "/nope")):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 404


def test_health_stats_metrics_and_page(servers, cohort):
    _, base, pipe = servers
    assert json.load(urllib.request.urlopen(base + "/healthz",
                                            timeout=60)) == {"status": "ok"}
    page = urllib.request.urlopen(base + "/", timeout=60).read().decode()
    assert "upload-ecgImage-lead2only" in page and "ecgmm_torch" in page
    body, ctype = _body(_encoded(cohort.images[0], "PNG"),
                        heatmap_format="cam")
    _post(base, body, ctype)
    stats = json.load(urllib.request.urlopen(base + "/stats", timeout=60))
    assert stats["requests"] >= 1 and stats["mean_latency_ms"] > 0
    assert stats["aot"] is False and stats["batching"] is None
    assert stats["device"] == "cpu"
    text = urllib.request.urlopen(base + "/metrics", timeout=60).read(
    ).decode()
    buckets = [int(v) for v in re.findall(
        r'ecgmm_request_latency_seconds_bucket\{le="[^"]+"\} (\d+)', text)]
    assert buckets and buckets == sorted(buckets)
    m = serve_hammer._scrape_metrics(base)
    assert m["bucket_+Inf"] == m["ecgmm_request_latency_seconds_count"] \
        == stats["requests"]
    assert m["ecgmm_request_errors_total"] == stats["errors"]
    assert m["ecgmm_batching_enabled"] == 0
    assert m["ecgmm_process_rss_bytes"] > 1e6
    assert "ecgmm_live_buffer_bytes" not in m  # no device gauge on the CPU
    bad_body, bad_ctype = encode_multipart({"file": ("x", b"junk")})
    with pytest.raises(urllib.error.HTTPError):
        _post(base, bad_body, bad_ctype, timeout=60)
    m2 = serve_hammer._scrape_metrics(base)
    assert m2["ecgmm_request_errors_total"] == \
        m["ecgmm_request_errors_total"] + 1
    assert pipe.stats()["errors"] == m2["ecgmm_request_errors_total"]


def test_graceful_shutdown_drains_in_flight(servers, cohort):
    """A request whose body is still arriving when the drain fires
    completes with a 200 before the server exits."""
    _, _, pipe = servers
    httpd = port_http.GracefulHTTPServer(("127.0.0.1", 0),
                                         port_http.make_handler(pipe))
    loop = threading.Thread(target=httpd.serve_forever)
    loop.start()
    try:
        body, ctype = _body(_encoded(cohort.images[0], "PNG"),
                            heatmap_format="cam")
        head = (f"POST {ENDPOINT} HTTP/1.1\r\nHost: t\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n\r\n").encode()
        s = socket.create_connection(("127.0.0.1", httpd.server_address[1]),
                                     timeout=120)
        try:
            s.sendall(head + body[:-64])  # the handler blocks in read()
            time.sleep(0.5)
            drain = port_http.install_graceful_shutdown(httpd, pipe)
            drain()
            loop.join(timeout=30)
            assert not loop.is_alive()
            s.sendall(body[-64:])
            s.settimeout(300)
            chunks = []
            while True:
                c = s.recv(65536)
                if not c:
                    break
                chunks.append(c)
            raw = b"".join(chunks)
        finally:
            s.close()
        assert raw.startswith(b"HTTP/1.0 200"), raw[:80]
        assert json.loads(raw.split(b"\r\n\r\n", 1)[1])["label"] in (
            "Normal", "Abnormal")
        httpd.server_close()
    finally:
        if loop.is_alive():
            httpd.shutdown()
            loop.join(timeout=10)
            httpd.server_close()


def test_max_requests_recycle_drains_and_exits(servers, cohort):
    _, _, pipe = servers
    start = pipe.stats()["requests"]
    httpd = port_http.GracefulHTTPServer(("127.0.0.1", 0),
                                         port_http.make_handler(pipe))
    port_http.install_max_requests_recycle(httpd, pipe, start + 2)
    t = threading.Thread(target=httpd.serve_forever)
    t.start()
    try:
        body, ctype = _body(_encoded(cohort.images[1], "PNG"),
                            heatmap_format="cam")
        for _ in range(2):
            _post(f"http://127.0.0.1:{httpd.server_address[1]}", body,
                  ctype)
        t.join(timeout=30)
        assert not t.is_alive(), "the accept loop did not drain"
        assert pipe.stats()["requests"] == start + 2
    finally:
        if t.is_alive():
            httpd.shutdown()
            t.join(timeout=10)
        httpd.server_close()
        pipe.on_request_done = None


def test_soak_histogram_percentiles_interpolate():
    m0 = {"bucket_0.05": 10, "bucket_0.1": 10, "bucket_0.2": 10,
          "bucket_+Inf": 10}
    m1 = {"bucket_0.05": 10, "bucket_0.1": 60, "bucket_0.2": 110,
          "bucket_+Inf": 110}
    assert abs(serve_hammer._hist_percentile(m0, m1, 0.5) - 0.1) < 1e-9
    assert abs(serve_hammer._hist_percentile(m0, m1, 0.9) - 0.18) < 1e-9
    assert abs(serve_hammer._hist_percentile(m0, m1, 0.99) - 0.198) < 1e-9
    assert serve_hammer._hist_percentile(m0, m0, 0.5) == 0.0
    assert serve_hammer.percentile([1.0, 2.0, 3.0, 4.0], 0.5) == 2.0


# ---------------------------------------------------------------- the CLI


def test_cli_defaults_to_the_card():
    """Without --device the server runs on CUDA: where there is no card
    it raises instead of quietly using the CPU. --bundle of a missing
    directory raises FileNotFoundError, as JAX's load_bundle does;
    --n-data beyond the visible devices
    (one CPU) raises JAX's error before the pipeline is built."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            port_http.main(["--synthetic", "--no-warmup"])
    with pytest.raises(FileNotFoundError, match="nonexistent"):
        port_http.main(["--bundle", "/nonexistent", "--device", "cpu"])
    with pytest.raises(ValueError, match="visible device"):
        port_http.main(["--n-data", "2", "--batch-window-ms", "5",
                   "--device", "cpu"])
    assert port_http.batch_buckets(8) == (1, 2, 4, 8)
    assert port_http.batch_buckets(12) == (1, 2, 4, 8)
    assert port_http.batch_buckets(0) == ()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serves_on_cpu_without_jax_or_pillow():
    """`python -m ecgmm_torch.serve.api --synthetic --device cpu` with JAX,
    the JAX package and Pillow blocked: the full-width demo, batched,
    answers the hammer's JPEG fixture and, with --max-requests 1, drains
    and exits 0."""
    port = _free_port()
    code = textwrap.dedent(f"""
        import runpy, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        sys.path.insert(0, {REPO!r})
        sys.argv = ["api", "--synthetic", "--device", "cpu", "--port",
                    "{port}", "--no-warmup", "--max-requests", "1",
                    "--batch-window-ms", "5", "--max-batch", "2"]
        runpy.run_module("ecgmm_torch.serve.api", run_name="__main__")
    """)
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env={**os.environ,
                                            "OMP_NUM_THREADS": "2"})
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 240
        while True:
            try:
                urllib.request.urlopen(base + "/healthz", timeout=5)
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.communicate()
                assert time.monotonic() < deadline
                time.sleep(0.5)
        body, ctype = serve_hammer.request_body("cam")
        data = _post(base, body, ctype)
        assert data["label"] in ("Normal", "Abnormal")
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        assert "drained" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# ------------------------------------------------------------- from_run

FILTERS = 16


def test_pipeline_from_run(tmp_path):
    """A port `fusion` run (1 epoch, CPU, small widths) served through
    `ServingPipeline.from_run`: the weights are bit-equal to the best
    checkpoint, the temperature is the run's fitted one, the scalers are
    the data's, and SHAP's background equals JAX's `_encode` of the first
    train rows on the same weights within float32 bars (atol 1e-4)."""
    cfg = get_preset("fusion")
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, signal_len=T, img_height=HW,
                                 img_width=HW),
        model=dataclasses.replace(cfg.model, signal_base_filters=FILTERS),
        train=dataclasses.replace(
            cfg.train, num_epochs=1, checkpoint_dir=str(tmp_path / "ckpt"),
            log_dir=str(tmp_path / "runs"),
            output_dir=str(tmp_path / "output")))
    data = port_run.load_data(cfg, "synthetic", 40, device="cpu")
    run_dir = str(tmp_path / "run")
    port_run.run(cfg, data, run_dir=run_dir, verbose=False, device="cpu")
    f32 = dataclasses.replace(cfg.model, dtype="float32")
    pipe = ServingPipeline.from_run(run_dir, data,
                                    model=ECGMultimodalModel(f32),
                                    device="cpu")
    ckpt = CheckpointManager(run_dir)
    saved = ckpt.load("best")["model"]
    got = pipe.model.state_dict()
    assert set(got) == set(saved)
    assert all(torch.equal(got[k], saved[k]) for k in saved)
    assert pipe.temperature == ckpt.load("calibration")["temperature_best"]
    assert pipe.ecg_scaler is data.ecg_scaler
    assert pipe.clinical_scaler is data.clinical_scaler
    assert (pipe.signal_len, pipe.img_hw) == (T, (HW, HW))
    n = min(64, data.train.n)
    assert pipe.background.shape == (n, 672)

    jmodel = JaxModel(cfg=JaxModelConfig(dtype="float32",
                                         signal_base_filters=FILTERS))
    variables = convert_fusion_canonical(
        {k: v.numpy() for k, v in saved.items()})
    jpipe = JaxPipeline(jmodel, variables, signal_len=T, img_hw=(HW, HW))
    train = data.train
    want = np.asarray(jpipe._encode(
        normalize_images(jnp.asarray(
            train.images[:n].permute(0, 2, 3, 1).numpy())),
        jnp.asarray(train.signals[:n].numpy()),
        jnp.asarray(train.clinical[:n].numpy())))
    np.testing.assert_allclose(pipe.background.numpy(), want, atol=1e-4)
    with pytest.raises(FileNotFoundError, match="last"):
        ServingPipeline.from_run(str(tmp_path / "empty"), data,
                                 which="last", device="cpu")
