"""The port's host kernels (`ecgmm_torch.native`) against the JAX package's
native kernels (`ecgmm_tpu.native`, built here by its own g++ call), the
port's plain numpy/scipy versions, and Pillow.

Bars: the darkness and gridness maps, the column and row maxima, the
valid mask, the CAM overlay, the resize and the JPEG bytes are bit-equal.
The trace centroid is bit-equal to JAX's kernel, within one float32 ulp
of a float64 numpy reference, and within 1e-3 px of the numpy path on
strip-sized photos (numpy sums in float32 pairwise; on taller frames the
bar is that summation's error, 1e-6 px per row). The hospital filter's
float32 result, the one both serving paths use, is bit-equal to JAX's
kernel, its float64 result within 1e-9 of JAX's kernel and of scipy, and
the filtfilt alone equal to scipy's. The float64 results differ from
JAX's in their last bits because the JAX library is built with
`-march=native`, which lets the compiler fuse the filter's multiply-adds
on a CPU with FMA, and the port's with `-ffp-contract=off`.

The shapes are those of JAX's `tests/test_native*.py`.
`ecgmm_torch/serve/fixtures/host_kernels_sha256.json`, which
`chip_smoke.py` holds the card machine's results to, is recomputed here
from the JAX package and Pillow."""

import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
from PIL import Image

from ecgmm_tpu import native as jax_native
from ecgmm_tpu.data import synthetic as jax_synthetic
from ecgmm_tpu.explain.gradcam import _jet_lut as jax_jet_lut
from ecgmm_tpu.serve import digitize as jax_digitize
from ecgmm_torch import native
from ecgmm_torch.data import preprocess
from ecgmm_torch.explain.gradcam import _jet_lut, overlay_heatmap
from ecgmm_torch.serve import digitize, request
from ecgmm_torch.serve.imdecode import decode_upload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "ecgmm_torch", "serve", "fixtures")
HOST_FIXTURE = os.path.join(FIXTURES, "host_kernels_sha256.json")


@pytest.fixture(scope="module")
def strips():
    """Three synthetic strips (250x2500) and a scene: a strip on a larger
    table-coloured photo."""
    images = jax_synthetic.make_cohort(n=3, signal_len=2476,
                                       img_hw=(250, 2500), seed=11).images
    scene = np.zeros((640, 2900, 3), np.uint8)
    scene[:] = (120, 95, 70)
    scene[200:450, 150:2650] = images[0]
    return list(images) + [scene]


def _fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _noisy(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


# ------------------------------------------------------ the digitizer


@pytest.mark.parametrize("shape", [(250, 2500, 3), (301, 777), (130, 430, 4),
                                   (20, 30, 3)],
                         ids=["strip-rgb", "grayscale", "rgba", "tiny"])
def test_darkness_map_bit_equal_to_jax_and_plain(rng, shape):
    img = _noisy(rng, shape)
    got = native.darkness_map(img)
    for a, b in zip(got, jax_native.darkness_map(img)):
        np.testing.assert_array_equal(a, b)
    rel = digitize.darkness_map(img, impl="plain")
    np.testing.assert_array_equal(got[0], rel)
    np.testing.assert_array_equal(got[1], rel.max(axis=0))
    np.testing.assert_array_equal(got[2], rel.max(axis=1))
    np.testing.assert_array_equal(native.colmax(rel), rel.max(axis=0))
    np.testing.assert_array_equal(native.colmax(rel),
                                  jax_native.colmax(rel))


@pytest.mark.parametrize("shape", [(1250, 1900, 3), (250, 2500, 3),
                                   (300, 400, 4), (131, 257, 3),
                                   (97, 64, 3)],
                         ids=["scene", "strip", "rgba", "odd",
                              "small-unpooled"])
def test_gridness_bit_equal_to_jax_and_plain(rng, shape):
    img = _noisy(rng, shape)
    for pool in (1, 2):
        g, bright = native.gridness(img, pool=pool, bg_window=32 // pool)
        want_g, want_bright = jax_native.gridness(img, pool=pool,
                                                  bg_window=32 // pool)
        np.testing.assert_array_equal(g, want_g)
        np.testing.assert_array_equal(bright, want_bright)
    np.testing.assert_array_equal(
        digitize.gridness_map(img), digitize.gridness_map(img, impl="plain"))
    got = digitize._grid_analysis(img)
    want = digitize._grid_analysis(img, impl="plain")
    for a, b in zip(got, want):  # map, brightness, scale, pitch
        np.testing.assert_array_equal(a, b)


def test_trace_centroid_against_jax_and_plain(rng, strips):
    """Bit-equal to JAX's kernel and within an ulp of float64 numpy; the
    valid mask bit-equal and the centroid within 1e-3 px of the numpy
    path (1e-6 px per row on the 1530-row frame)."""
    for img in strips + [_noisy(rng, (97, 113, 3)),
                         _noisy(rng, (1530, 510, 3))]:
        rel, col_max, _ = native.darkness_map(img)
        for col_frac, floor in ((0.6, 0.12), (0.5, 0.3)):
            c, v = native.trace_centroid(rel, col_frac, floor, col_max)
            want_c, want_v = jax_native.trace_centroid(rel, col_frac, floor,
                                                       col_max)
            np.testing.assert_array_equal(c, want_c)
            np.testing.assert_array_equal(v, want_v)
            thr = np.maximum(floor, col_frac * col_max)
            wts = np.where(rel >= thr, rel, 0.0).astype(np.float64)
            ref = (wts * np.arange(rel.shape[0])[:, None]).sum(axis=0) / \
                np.maximum(wts.sum(axis=0), 1e-6)
            ref = np.where(v, ref, 0.0).astype(np.float32)
            assert (np.abs(c - ref) <= np.spacing(ref)).all()
        c, v = digitize.extract_trace(img)
        pc, pv = digitize.extract_trace(img, impl="plain")
        np.testing.assert_array_equal(v, pv)
        assert np.abs(c - pc).max() <= max(1e-3, 1e-6 * img.shape[0])


def test_digitizer_native_against_plain(strips):
    """The served digitizer against its plain path: the same metadata,
    the waveform within what 1e-3 px of centroid moves it."""
    for img in strips:
        mv, info = digitize.digitize_lead2_info(img)
        pmv, pinfo = digitize.digitize_lead2_info(img, impl="plain")
        assert info == pinfo
        assert np.abs(mv - pmv).max() <= 1e-3 / info["px_per_mv"] * 4
    with pytest.raises(ValueError, match="impl"):
        digitize.digitize_lead2_info(strips[0], impl="numpy")


# ------------------------------------------------------ the hospital filter


@pytest.mark.parametrize("shape", [(6, 2476), (1, 2476), (3, 4, 700)])
def test_preprocess_hospital_against_jax_and_scipy(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    got = native.preprocess_hospital(x)
    want = jax_native.preprocess_hospital(x)
    assert got.shape == want.shape == x.shape
    np.testing.assert_array_equal(got.astype(np.float32),
                                  want.astype(np.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got, preprocess.hospital_filter(x, "plain"),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(preprocess.preprocess_hospital(x),
                                  got.astype(np.float32))


def test_baseline_and_filtfilt_against_jax_and_scipy(rng):
    from scipy import signal as sps

    from ecgmm_tpu.data import preprocess as jax_preprocess

    x = rng.normal(size=(5, 1200))
    np.testing.assert_allclose(native.remove_baseline(x, 50),
                               jax_native.remove_baseline(x, 50),
                               rtol=0, atol=1e-9)
    for ba, filt in ((preprocess.butter_lowpass_ptb(),
                      jax_preprocess.butter_lowpass_ptb()),
                     (preprocess.butter_bandpass(),
                      jax_preprocess.butter_bandpass())):
        got = native.filtfilt(ba, x)
        np.testing.assert_allclose(got, jax_native.filtfilt(filt, x),
                                   rtol=0, atol=1e-9)
        np.testing.assert_array_equal(got, sps.filtfilt(*ba, x, axis=-1))
    with pytest.raises(ValueError, match="padlen"):
        native.preprocess_hospital(np.zeros((2, 18)))


# ------------------------------------------------------------ the heatmap


@pytest.mark.parametrize("hw,cam_hw", [((250, 2500), (7, 7)),
                                       ((224, 224), (7, 7)),
                                       ((123, 457), (5, 9)),
                                       ((40, 40), (77, 13)),
                                       ((3, 5), (1, 1))],
                         ids=["strip", "square224", "odd", "downsample",
                              "degenerate"])
def test_cam_overlay_bit_equal_to_jax_and_plain(rng, hw, cam_hw):
    img = _noisy(rng, hw + (3,))
    # values outside [0, 1] exercise the clip
    cam = rng.uniform(-0.2, 1.2, cam_hw).astype(np.float32)
    got = native.cam_overlay(img, cam, _jet_lut())
    np.testing.assert_array_equal(
        got, jax_native.cam_overlay(img, cam, jax_jet_lut()))
    np.testing.assert_array_equal(
        got, overlay_heatmap(img, request.resize_bilinear_f32(cam, hw)))
    with pytest.raises(ValueError, match="lut"):
        native.cam_overlay(img, cam, _jet_lut()[:4])


@pytest.mark.parametrize("hw", [(1, 1), (1, 513), (15, 257), (16, 16),
                                (250, 2500), (333, 41)])
def test_png_round_trips_through_pillow_and_the_port_decoder(rng, hw):
    img = _noisy(rng, hw + (3,))
    data = native.png_encode(img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), img)
    np.testing.assert_array_equal(decode_upload(data), img)
    assert data == jax_native.png_encode(img)


# -------------------------------------------------- Pillow's own kernels


def _pillow_resize(img, hw):
    return np.asarray(Image.fromarray(img).resize(
        (hw[1], hw[0]), Image.Resampling.BILINEAR))


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((250, 2500), (224, 224)), ((250, 2500), (64, 64)),
    ((37, 51), (224, 224)), ((300, 420), (224, 224)),
    ((224, 224), (224, 224)), ((250, 2500), (250, 224)),
    ((250, 2500), (64, 2500)), ((1, 1), (224, 224)), ((3, 700), (5, 2))])
def test_resize_bit_equal_to_pillow(rng, src_hw, dst_hw):
    """The test_torch_serve resize shapes, one axis at a time, and the
    degenerate ones; the numpy plain version is bit-equal too."""
    img = _noisy(rng, src_hw + (3,))
    got = native.resize_bilinear_u8(img, dst_hw)
    np.testing.assert_array_equal(got, _pillow_resize(img, dst_hw))
    np.testing.assert_array_equal(got,
                                  request.resize_bilinear_u8(img, dst_hw))


def test_resize_of_the_fixtures_bit_equal_to_pillow(strips):
    """The strip, the scene and the served crop of the scene fixture."""
    scene = decode_upload(_fixture("scene_exif6.jpg"))
    _, info = digitize.digitize_lead2_info(scene)
    y0, y1, x0, x1 = info["crop"]
    for img in (decode_upload(_fixture("strip.jpg")), scene,
                scene[y0:y1, x0:x1], strips[3]):
        np.testing.assert_array_equal(
            native.resize_bilinear_u8(img, (224, 224)),
            _pillow_resize(np.ascontiguousarray(img), (224, 224)))


def _pillow_jpeg(img, quality=85) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("hw", [(1, 1), (15, 17), (17, 15), (16, 16),
                                (250, 2500), (37, 51), (9, 33), (100, 3),
                                (333, 41)])
def test_jpeg_bytes_equal_to_pillow_on_random_content(rng, hw):
    """Random content at sizes whose width and height are, and are not,
    multiples of the 16-pixel MCU and the 8-pixel block (dummy blocks at
    the right and bottom edges)."""
    img = _noisy(rng, hw + (3,))
    assert native.jpeg_encode(img) == _pillow_jpeg(img)


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 95, 100])
def test_jpeg_qualities_equal_to_pillow(rng, quality):
    img = _noisy(rng, (40, 70, 3))
    assert native.jpeg_encode(img, quality) == _pillow_jpeg(img, quality)


def test_jpeg_heatmaps_equal_to_pillow(rng, strips):
    """The overlays the server encodes: the strips, the scene, the fixtures
    as the port decodes them, each under a seeded CAM."""
    images = strips + [decode_upload(_fixture("strip.jpg")),
                       decode_upload(_fixture("scene_exif6.jpg"))]
    for img in images:
        cam = rng.uniform(0, 1, (7, 7)).astype(np.float32)
        overlay = native.cam_overlay(img, cam, _jet_lut())
        assert native.jpeg_encode(overlay) == _pillow_jpeg(overlay)
    with pytest.raises(ValueError, match="rgb"):
        native.jpeg_encode(np.zeros((4, 4), np.uint8))


# ----------------------------------------------- the card's fixture hashes


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def host_fixture() -> dict:
    """What `chip_smoke.py` holds the card machine's host kernels to,
    computed with the JAX package (its native digitizer, the JAX server's
    own) and Pillow (the JAX request's JPEG save): each committed photo
    decoded by Pillow and digitized to the served 2476 samples, and
    Pillow's quality-85 JPEG of the strip's overlay under the CAM of
    `np.random.default_rng(0)`."""
    from PIL import ImageOps

    out = {"digitize": {}}
    for name in ("strip.jpg", "scene_exif6.jpg"):
        rgb = np.asarray(ImageOps.exif_transpose(
            Image.open(io.BytesIO(_fixture(name)))).convert("RGB"))
        mv, info = jax_digitize.digitize_lead2_info(rgb, target_len=2476)
        out["digitize"][name] = {"mv_sha256": _sha(mv), "info": info}
    rgb = np.asarray(Image.open(io.BytesIO(_fixture("strip.jpg"))))
    cam = np.random.default_rng(0).uniform(0, 1, (7, 7)).astype(np.float32)
    overlay = jax_native.cam_overlay(rgb, cam, jax_jet_lut())
    data = _pillow_jpeg(overlay)
    out["jpeg_heatmap"] = {"image": "strip.jpg", "cam_seed": 0,
                           "quality": 85, "bytes": len(data),
                           "sha256": hashlib.sha256(data).hexdigest()}
    return out


def test_host_fixture_is_recomputed_and_met():
    with open(HOST_FIXTURE) as f:
        stored = json.load(f)
    assert stored == json.loads(json.dumps(host_fixture()))
    for name, want in stored["digitize"].items():
        mv, info = digitize.digitize_lead2_info(
            decode_upload(_fixture(name)), target_len=2476)
        assert _sha(mv) == want["mv_sha256"]
        assert info == want["info"]
    rgb = decode_upload(_fixture("strip.jpg"))
    cam = np.random.default_rng(0).uniform(0, 1, (7, 7)).astype(np.float32)
    data = native.jpeg_encode(native.cam_overlay(rgb, cam, _jet_lut()))
    assert hashlib.sha256(data).hexdigest() == \
        stored["jpeg_heatmap"]["sha256"]


# ------------------------------------------------- threads and the build


def test_kernels_agree_under_16_threads(strips):
    """16 threads call the kernels at once (each call spawns its own
    worker threads): every result equals the serial one."""
    img = strips[0]
    cam = np.random.default_rng(1).uniform(0, 1, (7, 7)).astype(np.float32)
    x = np.random.default_rng(2).normal(size=(1, 2476)).astype(np.float32)

    def work():
        overlay = native.cam_overlay(img, cam, _jet_lut())
        return (native.darkness_map(img)[0], native.gridness(img, 2)[0],
                native.resize_bilinear_u8(img, (224, 224)), overlay,
                native.jpeg_encode(overlay), native.png_encode(overlay),
                native.preprocess_hospital(x))

    want = work()
    results = [None] * 16

    def run(i):
        results[i] = work()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for got in results:
        for a, b in zip(got, want):
            if isinstance(a, bytes):
                assert a == b
            else:
                np.testing.assert_array_equal(a, b)


def test_failed_build_raises_on_the_served_path(tmp_path):
    """A copy of the package whose digitizer source does not compile: the
    served host work raises the compiler's error, and nothing falls back
    to numpy."""
    pkg = tmp_path / "ecgmm_torch"
    shutil.copytree(os.path.join(REPO, "ecgmm_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    with open(pkg / "native" / "digitize.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    code = textwrap.dedent("""
        import types
        import numpy as np
        import ecgmm_torch
        from ecgmm_torch.serve import request
        assert ecgmm_torch.__file__.startswith(%r), ecgmm_torch.__file__
        pipe = types.SimpleNamespace(signal_len=512, ecg_scaler=None,
                                     img_hw=(64, 64), n_clin=2,
                                     clinical_scaler=None)
        img = np.full((250, 2500, 3), 240, np.uint8)
        img[120:125] = 20
        try:
            request.prepare_inputs(pipe, img, {})
        except RuntimeError as e:
            assert "g++ failed" in str(e), e
            print("RAISED")
    """ % str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "RAISED"
