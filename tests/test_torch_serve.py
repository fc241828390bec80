"""The port's serving path (`ecgmm_torch.serve`) against the JAX one.

Host pieces: the digitizer copy (bit-equal to the JAX numpy path), the
signal filter, the Pillow-free resizes and PNG writer, the rule-based
report. End to end: the JAX `ServingPipeline` and the port's, on the same
weights and SHAP draws, answer the same requests at a small size (64x64
model images, 512-sample signals)."""

import base64
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ecgmm_tpu.config import ModelConfig as JaxModelConfig
from ecgmm_tpu.data import preprocess as jax_preprocess
from ecgmm_tpu.data import synthetic as jax_synthetic
from ecgmm_tpu.models import ECGMultimodalModel as JaxModel
from ecgmm_tpu.serve import digitize as jax_digitize
from ecgmm_tpu.serve import report as jax_report
from ecgmm_tpu.serve import request as jax_request
from ecgmm_tpu.serve.pipeline import ServingPipeline as JaxPipeline
from ecgmm_torch.config import ModelConfig
from ecgmm_torch.data import preprocess
from ecgmm_torch.data.synthetic import _render_strip
from ecgmm_torch.explain.gradcam import overlay_heatmap
from ecgmm_torch.models import ECGMultimodalModel
from ecgmm_torch.serve import digitize, report, request
from ecgmm_torch.serve.pipeline import ServingPipeline
from ecgmm_torch.serve.wire import BadRequest
from ecgmm_torch.tools.weights import from_jax_variables

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cohort():
    return jax_synthetic.make_cohort(n=3, signal_len=2476,
                                     img_hw=(250, 2500), seed=11)


def _scene(strip, offset=(300, 250)):
    """The strip on a larger table-coloured photo (exercises the crop)."""
    photo = np.zeros((800, 3000, 3), np.uint8)
    ramp = np.linspace(0.8, 1.2, 3000, dtype=np.float32)[None, :, None]
    photo[:] = np.clip(np.float32((120, 95, 70)) * ramp, 0, 255).astype(
        np.uint8)
    y0, x0 = offset
    photo[y0:y0 + strip.shape[0], x0:x0 + strip.shape[1]] = strip
    return photo


def _shadowed(img):
    ramp = np.linspace(0.55, 1.0, img.shape[1], dtype=np.float32)
    return np.clip(img * ramp[None, :, None], 0, 255).astype(np.uint8)


def test_render_strip_equals_jax(cohort):
    sig = cohort.signals[0]
    np.testing.assert_array_equal(_render_strip(sig, 250, 2500),
                                  jax_synthetic._render_strip(sig, 250, 2500))


@pytest.mark.parametrize("case", ["strip", "shadow", "scene"])
def test_digitizer_bit_equal_to_jax_numpy_path(cohort, monkeypatch, case):
    monkeypatch.setenv("ECGMM_NO_NATIVE_DIGITIZE", "1")
    for i, img in enumerate(cohort.images):
        if case == "shadow":
            img = _shadowed(img)
        elif case == "scene":
            img = _scene(img, offset=(200 + 40 * i, 150))
        mv, info = digitize.digitize_lead2_info(img, target_len=2476)
        want_mv, want_info = jax_digitize.digitize_lead2_info(
            img, target_len=2476)
        assert info == want_info
        np.testing.assert_array_equal(mv, want_mv)
        if case == "scene":
            assert info["crop"] is not None


def test_preprocess_hospital_matches_jax(cohort):
    scaler = preprocess.Scaler.fit(cohort.signals)
    x = scaler.transform(cohort.signals)
    want = np.asarray(jax_preprocess.preprocess_hospital(jnp.asarray(x)))
    np.testing.assert_allclose(preprocess.preprocess_hospital(x), want,
                               atol=1e-5)
    np.testing.assert_allclose(
        preprocess.remove_baseline_drift(x),
        np.asarray(jax_preprocess.remove_baseline_drift(jnp.asarray(x))),
        atol=1e-5,
    )
    jax_scaler = jax_preprocess.Scaler.fit(cohort.signals)
    np.testing.assert_array_equal(scaler.mean, jax_scaler.mean)
    np.testing.assert_array_equal(scaler.scale, jax_scaler.scale)


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((250, 2500), (224, 224)), ((250, 2500), (64, 64)),
    ((37, 51), (224, 224)), ((300, 420), (224, 224)), ((224, 224), (224, 224)),
])
def test_resize_u8_matches_pillow(rng, cohort, src_hw, dst_hw):
    if src_hw == (250, 2500):
        img = cohort.images[0]
    else:
        img = rng.integers(0, 256, size=src_hw + (3,), dtype=np.uint8)
    got = request.resize_bilinear_u8(img, dst_hw)
    want = np.asarray(Image.fromarray(img).resize(
        (dst_hw[1], dst_hw[0]), Image.Resampling.BILINEAR))
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


@pytest.mark.parametrize("src_hw,dst_hw", [((7, 7), (250, 2500)),
                                           ((2, 2), (64, 64)),
                                           ((7, 7), (3, 5))])
def test_resize_f32_matches_pillow(rng, src_hw, dst_hw):
    cam = rng.uniform(0, 1, size=src_hw).astype(np.float32)
    got = request.resize_bilinear_f32(cam, dst_hw)
    want = np.asarray(Image.fromarray(cam, mode="F").resize(
        (dst_hw[1], dst_hw[0]), Image.Resampling.BILINEAR))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_png_overlay_decodes_to_jax_overlay(rng, cohort, monkeypatch):
    """The port's PNG decodes (with Pillow) to exactly the overlay the
    JAX PIL path renders for the same strip and CAM."""
    monkeypatch.setenv("ECGMM_NO_NATIVE_HEATMAP", "1")
    image = cohort.images[1][:120, :700]
    cam = rng.uniform(0, 1, size=(7, 7)).astype(np.float32)
    b64, cam_out = request.render_heatmap(image, cam, "png")
    assert cam_out is None
    got = np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))
    want_b64, _, _ = jax_request.render_heatmap(image, cam, "png")
    want = np.asarray(Image.open(io.BytesIO(base64.b64decode(want_b64))))
    np.testing.assert_array_equal(got, want)
    raw = rng.integers(0, 256, size=(9, 13, 3), dtype=np.uint8)
    decoded = Image.open(io.BytesIO(request.encode_png(raw)))
    np.testing.assert_array_equal(np.asarray(decoded), raw)
    assert decoded.mode == "RGB"
    np.testing.assert_array_equal(
        overlay_heatmap(image, request.resize_bilinear_f32(cam, (120, 700))),
        got)


@pytest.mark.parametrize("abnormal", [False, True])
@pytest.mark.parametrize("age", [None, 50.0, 70.0])
def test_rule_based_report_equal(cohort, abnormal, age):
    for sig in cohort.signals:
        for sex in (None, "F"):
            assert report.rule_based_report(
                sig, abnormal, 0.73, age=age, sex=sex
            ) == jax_report.rule_based_report(
                sig, abnormal, 0.73, age=age, sex=sex)
    flat = np.zeros(500, np.float32)
    assert report.rule_based_report(flat, True, 0.5) == \
        jax_report.rule_based_report(flat, True, 0.5)


# ---------------------------------------------------------------- end to end

HW, T = 64, 512


def _jax_draws():
    """The SHAP draws of the JAX request program (PRNGKey(0), one row)."""
    kb, ka = jax.random.split(jax.random.PRNGKey(0))
    k1 = jax.random.split(kb, 1)[0]
    k2 = jax.random.split(ka, 1)[0]
    return (np.asarray(jax.random.randint(k1, (32,), 0, 32)),
            np.asarray(jax.random.uniform(k2, (32,))))


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


@pytest.mark.parametrize("fmt", ["png", "cam"])
def test_predict_matches_jax_pipeline(pipelines, cohort, fmt):
    jpipe, pipe = pipelines
    n_before = pipe.stats()["requests"]
    questionnaires = [{"age": 71, "weight": 58, "gender": "1"},
                      {"age": "45", "weight": "", "sex": "M"}]
    for img, q in zip(cohort.images[:2], questionnaires):
        got = pipe.predict(img, q, fmt)
        want = jpipe.predict(img, q, fmt)
        assert set(got) == set(want)
        assert got["label"] == want["label"]
        assert got["gpt_result"] == want["gpt_result"]
        assert got["digitization"] == want["digitization"]
        np.testing.assert_allclose(got["probability"], want["probability"],
                                   atol=1e-4)
        np.testing.assert_allclose(
            [v["Voltage (mV)"] for v in got["ecg_signal"]],
            [v["Voltage (mV)"] for v in want["ecg_signal"]], atol=1e-5)
        for k, v in want["feature_importance"].items():
            assert abs(got["feature_importance"][k] - v) <= 0.1, k
        if fmt == "cam":
            np.testing.assert_allclose(np.asarray(got["heatmap_cam"]),
                                       np.asarray(want["heatmap_cam"]),
                                       atol=1e-3)
            assert got["heatmap"] == want["heatmap"] == ""
        else:
            a = np.asarray(Image.open(io.BytesIO(
                base64.b64decode(got["heatmap"]))))
            b = np.asarray(Image.open(io.BytesIO(
                base64.b64decode(want["heatmap"]))))
            assert a.shape == b.shape == img.shape
            # the CAMs agree to 1e-3, so a jet bin may flip at a boundary
            assert (a == b).all(axis=-1).mean() >= 0.99
    assert pipe.stats()["requests"] == n_before + 2


def test_predict_rejects_bad_requests(pipelines, cohort):
    _, pipe = pipelines
    with pytest.raises(BadRequest, match="ROADMAP"):
        pipe.predict(cohort.images[0], {"age": 60}, "jpeg")
    with pytest.raises(BadRequest, match="heatmap_format"):
        pipe.predict(cohort.images[0], {"age": 60}, "gif")
    with pytest.raises(BadRequest, match="numeric"):
        pipe.predict(cohort.images[0], {"age": "old"}, "cam")
    with pytest.raises(ValueError, match="temperature"):
        ServingPipeline(pipe.model, pipe.model.state_dict(), device="cpu",
                        temperature=0.0)
