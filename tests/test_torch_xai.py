"""The port's XAI batch path (`ecgmm_torch.explain`: Grad-CAM, gradient
and Deep SHAP, LIME, TabNet masks and `run_xai`) against the JAX
package's on the same weights (carried across by `from_jax_variables`),
inputs and random draws, on the CPU at a small size: the `fusion`
preset's model at full width in float32 with 32x32 images and 256-sample
signals (the size of `tests/test_xai_cli.py`), 64x64 images where a CAM
needs a feature map wider than one cell.

Tolerances, float32 on both sides, sums taken in other orders:
- CAMs (in [0, 1]) and logits: atol 1e-4 (as tests/test_torch_explain.py);
- TabNet latent, m_loss, m_explain and step masks: atol 1e-5;
- embeddings: atol 1e-5;
- `head_forward` against `fuse_embeddings` and JAX's: atol 1e-5;
- SHAP and Deep-SHAP attributions: rtol 1e-4 + atol 1e-5 of JAX's;
- LIME coefficients: 1e-4 of the largest |coefficient| + 1e-6 (a
  Cholesky solve of a 672-wide Gram matrix, reduced in another order);
- CSV percentages: atol 1e-3 percentage points; row sums 100 within
  1e-3 (tests/test_xai_cli.py's bar);
- Grad-CAM overlays: the decoded PNG equals the port's own overlay of its
  CAM bit for bit; against JAX's, a CAM value 1e-4 off can move its
  uint8 bin by one, so at most 1% of the pixels differ, by at most 8
  levels (0.4 of one jet step);
- the viridis table and the mask colours: equal to matplotlib's.
"""

import os
import subprocess
import sys
import textwrap

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecgmm_tpu.config import get_preset as jax_get_preset
from ecgmm_tpu.explain import gradcam as jax_gradcam
from ecgmm_tpu.explain import lime_fusion as jax_lime
from ecgmm_tpu.explain import run_xai as jax_run_xai
from ecgmm_tpu.explain import shap_fusion as jax_shap
from ecgmm_tpu.models import ECGMultimodalModel as JaxModel
from ecgmm_tpu.models import ResNet18 as JaxResNet18
from ecgmm_tpu.models import ResNet1DSE as JaxResNet1DSE
from ecgmm_tpu.workloads.run import load_data as jax_load_data
from ecgmm_torch.data import pipeline
from ecgmm_torch.explain import gradcam, lime_fusion, run_xai
from ecgmm_torch.explain import shap_fusion
from ecgmm_torch.models import ECGMultimodalModel, ResNet18, ResNet1DSE
from ecgmm_torch.tools.weights import (from_jax_resnet1d_se,
                                       from_jax_resnet18, from_jax_variables)

torch.set_num_threads(2)

# both packages re-export the functions `deep_shap` and `tabnet_masks`
# under their modules' names
jax_deep = importlib.import_module("ecgmm_tpu.explain.deep_shap")
deep_shap = importlib.import_module("ecgmm_torch.explain.deep_shap")
masks_mod = importlib.import_module("ecgmm_torch.explain.tabnet_masks")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = (512, 128, 32)
D = sum(DIMS)
CAM_ATOL = 1e-4


def _cfg(hw, signal_len=256):
    cfg = jax_get_preset("fusion")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype="float32"),
        data=dataclasses.replace(cfg.data, img_height=hw, img_width=hw,
                                 signal_len=signal_len))


def port_arrays(a) -> pipeline.Arrays:
    """A JAX split as the port's Arrays (images NHWC -> NCHW)."""
    return pipeline.Arrays(
        images=torch.from_numpy(np.ascontiguousarray(
            np.asarray(a.images).transpose(0, 3, 1, 2))),
        signals=torch.from_numpy(np.array(a.signals, np.float32)),
        clinical=torch.from_numpy(np.array(a.clinical, np.float32)),
        labels=torch.from_numpy(np.array(a.labels, np.int64)),
        indices=a.indices)


@pytest.fixture(scope="module")
def fusion():
    """(JAX model, its variables, the port's model on the same weights):
    the fusion preset at full width, float32, JAX's init at PRNGKey(0)."""
    cfg = _cfg(32)
    jmodel = JaxModel(cfg=cfg.model)
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)), jnp.ones((1, 256)),
        jnp.ones((1, 2))))
    from ecgmm_torch.config import get_preset

    pcfg = get_preset("fusion")
    model = ECGMultimodalModel(
        dataclasses.replace(pcfg.model, dtype="float32"))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, variables, model.eval()


@pytest.fixture(scope="module")
def data32():
    """JAX's synthetic cohort at tests/test_xai_cli.py's size (n_synth
    48, 32x32 images, 256-sample signals)."""
    return jax_load_data(_cfg(32), "synthetic", 48)


@pytest.fixture(scope="module")
def data64():
    return jax_load_data(_cfg(64), "synthetic", 24)


def jax_shap_draws(rows, n_samples, n_bg, key):
    """The (bidx, alphas) that `ecgmm_tpu.explain.shap_fusion.
    gradient_shap` draws for each row from `key` (shap_fusion.py:47-68)."""
    kb, ka = jax.random.split(key)
    k1, k2 = jax.random.split(kb, rows), jax.random.split(ka, rows)
    bidx = np.stack([np.asarray(jax.random.randint(k, (n_samples,), 0,
                                                   n_bg)) for k in k1])
    alphas = np.stack([np.asarray(jax.random.uniform(k, (n_samples,)))
                       for k in k2])
    return bidx, alphas


def jax_lime_noise(rows, num_samples, d, key=None):
    """The standard-normal draws of `ecgmm_tpu.explain.lime_fusion.
    lime_tabular` for each row (lime_fusion.py:33-34,80)."""
    key = key if key is not None else jax.random.PRNGKey(0)
    return np.stack([np.asarray(jax.random.normal(k, (num_samples, d)))
                     for k in jax.random.split(key, rows)])


def _nchw(img):
    return torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))


# --- Grad-CAM ------------------------------------------------------------


def test_grad_cam_fusion_image_default_is_input_resolution(fusion, data64):
    """With its defaults, `grad_cam_fusion_image` returns the CAM at the
    input's resolution, as JAX's does (its `resize_to_input` defaults to
    True)."""
    jmodel, variables, model = fusion
    imgs = np.asarray(data64.test.images[:3])
    want, want_logits = jax_gradcam.grad_cam_fusion_image(
        jmodel, variables, jax_run_xai.normalize_images(jnp.asarray(imgs)))
    got, logits = gradcam.grad_cam_fusion_image(model, _nchw(imgs))
    assert got.shape == want.shape == (3, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=CAM_ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=CAM_ATOL)


@pytest.mark.parametrize("classes", [None, [1, 0]])
def test_grad_cam_image_matches_jax(classes):
    jmodel = JaxResNet18(num_classes=2)
    x = np.random.default_rng(3).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    variables = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                    jnp.asarray(x)))
    model = ResNet18(num_classes=2)
    model.load_state_dict(from_jax_resnet18(variables), strict=True)
    model.eval()
    cls = None if classes is None else np.asarray(classes)
    want, want_logits = jax.jit(
        lambda v, a, c: jax_gradcam.grad_cam_image(jmodel, v, a, c))(
        variables, jnp.asarray(x), None if cls is None else jnp.asarray(cls))
    got, logits = gradcam.grad_cam_image(
        model, _nchw(x), None if cls is None else torch.from_numpy(cls))
    assert got.shape == (2, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=CAM_ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=CAM_ATOL)


@pytest.mark.parametrize("classes", [None, [0, 1]])
def test_grad_cam_signal_matches_jax(classes):
    """ResNet1D-SE at base 16, T=512: the CAM over 64 feature steps,
    resized linearly to 512 (an energetic region in one row)."""
    jmodel = JaxResNet1DSE(num_classes=2, base_filters=16)
    x = np.random.default_rng(4).normal(size=(2, 512)).astype(np.float32)
    x[0, 250:260] = 5.0
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(x)[..., None]))
    model = ResNet1DSE(num_classes=2, base_filters=16)
    model.load_state_dict(from_jax_resnet1d_se(variables), strict=True)
    model.eval()
    cls = None if classes is None else np.asarray(classes)
    want, want_logits = jax.jit(
        lambda v, a, c: jax_gradcam.grad_cam_signal(jmodel, v, a, c))(
        variables, jnp.asarray(x), None if cls is None else jnp.asarray(cls))
    got, logits = gradcam.grad_cam_signal(
        model, torch.from_numpy(x),
        None if cls is None else torch.from_numpy(cls))
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=CAM_ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=CAM_ATOL)


@pytest.mark.parametrize("n_in,n_out", [(2, 64), (7, 224), (155, 2476)])
def test_upsampling_equals_jax_resize(n_in, n_out):
    """F.interpolate(align_corners=False) upsamples as jax.image.resize:
    "linear" in 1-D and "bilinear" in 2-D, edges included."""
    import torch.nn.functional as F

    rng = np.random.default_rng(n_in)
    a = rng.uniform(size=(2, n_in)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(a), (2, n_out),
                                       "linear"))
    got = F.interpolate(torch.from_numpy(a)[:, None], size=n_out,
                        mode="linear", align_corners=False)[:, 0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    if n_in > 10:
        return
    b = rng.uniform(size=(2, n_in, n_in)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(b), (2, n_out, n_out),
                                       "bilinear"))
    got = F.interpolate(torch.from_numpy(b)[:, None], size=(n_out, n_out),
                        mode="bilinear", align_corners=False)[:, 0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


# --- TabNet masks ----------------------------------------------------------


def test_tabnet_return_masks_matches_jax(fusion):
    jmodel, variables, model = fusion
    x = np.random.default_rng(6).normal(size=(9, 2)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x),
                        method=lambda m, c: m.clinical_encoder(
                            c, return_masks=True))
    enc = model.clinical_encoder
    with torch.no_grad():
        got = enc(torch.from_numpy(x), return_masks=True)
        plain = enc(torch.from_numpy(x))
    assert len(got) == 4 and len(plain) == 2 and len(got[3]) == 3
    for a, b in zip(plain, got[:2]):  # the default output is unchanged
        assert torch.equal(a, b)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    for a, b in zip(got[3], want[3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    m_explain, masks = masks_mod.tabnet_masks(enc, torch.from_numpy(x))
    np.testing.assert_array_equal(m_explain, got[2].numpy())
    assert all(np.array_equal(m, g.numpy()) for m, g in zip(masks, got[3]))


def test_viridis_equals_matplotlib():
    os.environ.setdefault("MPLBACKEND", "Agg")
    from matplotlib import colormaps
    from matplotlib.colors import Normalize

    cmap = colormaps["viridis"]
    want = cmap(np.linspace(0.0, 1.0, 256), bytes=True)[:, :3]
    lut = masks_mod.viridis_lut()
    np.testing.assert_array_equal(lut, want)
    rng = np.random.default_rng(7)
    rows = [rng.uniform(size=37).astype(np.float32),
            rng.normal(size=5), np.full(4, 0.25, np.float32),
            np.array([0.0, 1.0, 0.5, 1 / 256, 255 / 256], np.float32)]
    for row in rows:
        norm = Normalize(row.min(), row.max())
        np.testing.assert_array_equal(masks_mod.viridis_rgb(row),
                                      cmap(norm(row), bytes=True)[:, :3])


def test_tabnet_masks_report_matches_jax(fusion, data32, tmp_path):
    """Both reports write the four files under the same names; each PNG of
    the port decodes to its mask row's viridis colours, one block per
    feature, with the title and the feature names as tEXt."""
    from PIL import Image

    jmodel, variables, model = fusion
    want = jax_run_xai.tabnet_masks_report(jmodel, variables, data32.test,
                                           str(tmp_path / "jax"))
    got = run_xai.tabnet_masks_report(model, port_arrays(data32.test),
                                      str(tmp_path / "port"))
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] == [
        "mask_M[1].png", "mask_M[2].png", "mask_M[3].png", "mask_M_agg.png"]
    _, masks = masks_mod.tabnet_masks(
        model.clinical_encoder, port_arrays(data32.test).clinical)
    rows = [m.mean(0) for m in masks]
    rows.append(np.mean(rows, axis=0))
    for path, row in zip(got, rows):
        img = Image.open(path)
        assert img.text["Features"] == "AGE, Wt"
        assert img.text["Title"].endswith("(mean over batch)")
        pix = np.asarray(img.convert("RGB"))
        w = max(8, masks_mod.STRIP_W // 2)
        assert pix.shape == (masks_mod.CELL_H, 2 * w, 3)
        colours = masks_mod.viridis_rgb(row)
        for k in range(2):
            assert (pix[:, k * w:(k + 1) * w] == colours[k]).all()


def test_tabnet_masks_report_needs_tabnet():
    from ecgmm_torch.config import get_preset

    cfg = dataclasses.replace(get_preset("fusion_modal_balance").model,
                              dtype="float32")
    with pytest.raises(ValueError, match="TabNet"):
        run_xai.tabnet_masks_report(ECGMultimodalModel(cfg), None, "unused")


# --- gradient SHAP, Deep SHAP, LIME -----------------------------------------


def _jax_head(jmodel, variables):
    def head(e):
        return jmodel.apply(variables, e[:, :512], e[:, 512:640], e[:, 640:],
                            method=type(jmodel).fuse_embeddings)
    return head


def test_explain_fusion_matches_jax(fusion):
    """Per-class gradient SHAP through the fusion head with JAX's draws
    (class c keyed PRNGKey(seed + c)); the parameters' requires_grad flags
    are restored afterwards."""
    jmodel, variables, model = fusion
    rng = np.random.default_rng(8)
    emb = rng.normal(size=(4, D)).astype(np.float32)
    bg = rng.normal(size=(16, D)).astype(np.float32)
    want = jax_shap.explain_fusion(jmodel, variables, emb, bg, DIMS,
                                   n_samples=8)
    draws = {c: jax_shap_draws(4, 8, 16, jax.random.PRNGKey(c))
             for c in range(2)}
    flags = [p.requires_grad for p in model.parameters()]
    got, attrs = shap_fusion.explain_fusion(
        model, emb, bg, DIMS, n_samples=8, draws=draws,
        return_attributions=True)
    assert [p.requires_grad for p in model.parameters()] == flags
    for c in range(2):
        want_attr = np.asarray(jax_shap.gradient_shap(
            _jax_head(jmodel, variables), jnp.asarray(emb), jnp.asarray(bg),
            c, n_samples=8, key=jax.random.PRNGKey(c)))
        np.testing.assert_allclose(attrs[c], want_attr, rtol=1e-4,
                                   atol=1e-5)
        for k in want[c]:
            np.testing.assert_allclose(got[c][k], want[c][k], atol=1e-3)


def test_explain_fusion_draws_from_seeded_generators(fusion):
    _, _, model = fusion
    rng = np.random.default_rng(9)
    emb = rng.normal(size=(2, D)).astype(np.float32)
    bg = rng.normal(size=(5, D)).astype(np.float32)
    a = shap_fusion.explain_fusion(model, emb, bg, DIMS, n_samples=4)
    b = shap_fusion.explain_fusion(model, emb, bg, DIMS, n_samples=4)
    for c in range(2):
        for k in a[c]:
            np.testing.assert_array_equal(a[c][k], b[c][k])
            assert a[c][k].shape == (2,)


def test_head_forward_matches_fuse_embeddings(fusion):
    jmodel, variables, model = fusion
    e = np.random.default_rng(10).normal(size=(5, D)).astype(np.float32)
    with torch.no_grad():
        got = deep_shap.head_forward(model, torch.from_numpy(e), DIMS)
        te = torch.from_numpy(e)
        want = model.fuse_embeddings(te[:, :512], te[:, 512:640],
                                     te[:, 640:])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_deep.head_forward(
            variables, jnp.asarray(e), DIMS)), atol=1e-5)


def test_rescale_relu_backward_matches_jax():
    """The secant slope, the local derivative where |x - x_ref| < 1e-7,
    crossing zero both ways."""
    x = np.array([1.0, -1.0, 2.0, -0.5, 0.3, 0.3, -0.2, 0.0], np.float32)
    r = np.array([-1.0, 1.0, 0.5, -2.0, 0.3, 0.3 + 5e-8, -0.2, 1.0],
                 np.float32)
    g = np.arange(1, 9, dtype=np.float32)
    _, vjp = jax.vjp(jax_deep._rescale_relu, jnp.asarray(x), jnp.asarray(r))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    out = deep_shap._rescale_relu(xt, torch.from_numpy(r))
    np.testing.assert_array_equal(out.detach().numpy(), np.maximum(x, 0))
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("cls", [0, 1])
def test_deep_shap_matches_jax(fusion, cls):
    """JAX's deep_shap over every (sample, reference) pair; the sample
    whose only reference equals it gets exactly 0."""
    jmodel, variables, model = fusion
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, D)).astype(np.float32)
    bg = rng.normal(size=(6, D)).astype(np.float32)
    want = np.asarray(jax_deep.deep_shap(variables, jnp.asarray(x),
                                         jnp.asarray(bg), cls, DIMS))
    got = deep_shap.deep_shap(model, torch.from_numpy(x),
                              torch.from_numpy(bg), cls, DIMS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    own = deep_shap.deep_shap(model, torch.from_numpy(x),
                              torch.from_numpy(x[:1].repeat(4, 0)), cls,
                              DIMS)
    np.testing.assert_array_equal(own[0].numpy(), 0.0)
    assert (own[1:].abs() > 0).any()


def test_explain_fusion_deep_contract(fusion):
    jmodel, variables, model = fusion
    rng = np.random.default_rng(12)
    emb = rng.normal(size=(4, D)).astype(np.float32)
    bg = rng.normal(size=(8, D)).astype(np.float32)
    want = jax_deep.explain_fusion_deep(jmodel, variables, emb, bg, DIMS)
    got = deep_shap.explain_fusion_deep(model, emb, bg, DIMS)
    assert set(got) == {0, 1}
    for c in got:
        total = sum(got[c][k] for k in ("Image_%", "Signal_%", "Clinical_%"))
        np.testing.assert_allclose(total, 100.0, atol=1e-4)
        for k in want[c]:
            np.testing.assert_allclose(got[c][k], want[c][k], atol=1e-3)


def _lime_close(got, want):
    bar = 1e-4 * np.abs(want).max() + 1e-6
    assert np.abs(got - want).max() <= bar, (np.abs(got - want).max(), bar)


def test_lime_tabular_matches_jax():
    """JAX's `jax.random.normal` noise injected, a softmax-linear
    predictor; one call for both classes equals the two calls of one."""
    rng = np.random.default_rng(13)
    d, b, s = 12, 3, 300
    w = rng.normal(size=(d, 2)).astype(np.float32)
    x = rng.normal(size=(b, d)).astype(np.float32)
    std = rng.uniform(0.2, 1.5, size=d).astype(np.float32)

    def jpredict(p):
        return jax.nn.softmax(p @ jnp.asarray(w), -1)

    def predict(p):
        return torch.softmax(p @ torch.from_numpy(w), -1)

    noise = jax_lime_noise(b, s, d)
    both = lime_fusion.lime_tabular(predict, torch.from_numpy(x),
                                    torch.from_numpy(std), (0, 1),
                                    num_samples=s,
                                    noise=torch.from_numpy(noise))
    assert both.shape == (2, b, d)
    for c in range(2):
        want = np.asarray(jax_lime.lime_tabular(
            jpredict, jnp.asarray(x), jnp.asarray(std), c, num_samples=s))
        one = lime_fusion.lime_tabular(predict, torch.from_numpy(x),
                                       torch.from_numpy(std), c,
                                       num_samples=s,
                                       noise=torch.from_numpy(noise))
        assert one.shape == (b, d)
        torch.testing.assert_close(one, both[c], rtol=1e-5, atol=1e-6)
        _lime_close(one.numpy(), want)


def test_lime_recovers_linear_model():
    """JAX's recovery case (tests/test_explain.py): around x, the fit of a
    sigmoid-linear probability points along its weights."""
    rng = np.random.default_rng(42)
    d = 6
    w = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32))

    def predict(pts):
        p1 = torch.sigmoid(pts @ w)
        return torch.stack([1 - p1, p1], dim=1)

    x = torch.from_numpy(rng.normal(size=(3, d)).astype(np.float32))
    std = torch.full((d,), 0.1)
    coefs = lime_fusion.lime_tabular(
        predict, x, std, class_idx=1, num_samples=2000,
        generator=torch.Generator().manual_seed(0)).numpy()
    t = w.numpy() / np.linalg.norm(w.numpy())
    for i in range(3):
        assert abs(float(coefs[i] / np.linalg.norm(coefs[i]) @ t)) > 0.95
    agg = lime_fusion.lime_modality_contributions(coefs, (2, 2, 2))
    np.testing.assert_allclose(
        agg["Image_%"] + agg["Signal_%"] + agg["Clinical_%"], 100.0,
        atol=1e-3)
    with pytest.raises(ValueError, match="noise or a generator"):
        lime_fusion.lime_tabular(predict, x, std, 1)


# --- run_xai -----------------------------------------------------------------


def test_compute_embeddings_and_background_match_jax(fusion, data32):
    """Batches of 32 with the ragged tail padded (38 train rows); the
    background picks the same rows."""
    jmodel, variables, model = fusion
    want = jax_run_xai.compute_embeddings(jmodel, variables, data32.train)
    got = run_xai.compute_embeddings(model, port_arrays(data32.train))
    assert got.shape == want.shape == (data32.train.n, D)
    assert data32.train.n % 32 != 0
    np.testing.assert_allclose(got, want, atol=1e-5)
    labels = np.asarray(data32.train.labels)
    for per_class in (50, 3):
        np.testing.assert_array_equal(
            run_xai.class_balanced_background(got, labels, per_class),
            jax_run_xai.class_balanced_background(got, labels, per_class))


def _read_csv(path):
    with open(path) as f:
        header = f.readline().strip().split(",")
        rows = np.array([[float(v) for v in line.split(",")] for line in f])
    return header, rows


@pytest.fixture(scope="module")
def reports(fusion, data32, tmp_path_factory):
    """JAX's xai_report CSVs for shap, deep_shap and lime (64 SHAP draws,
    1000 LIME perturbations), and the draws it took."""
    jmodel, variables, _ = fusion
    out = str(tmp_path_factory.mktemp("jax_xai"))
    for method in ("shap", "deep_shap", "lime"):
        jax_run_xai.xai_report(jmodel, variables, data32.train, data32.test,
                               DIMS, method=method, out_dir=out)
    n_test = data32.test.n
    n_bg = len(jax_run_xai.class_balanced_background(
        np.zeros((data32.train.n, 1)), np.asarray(data32.train.labels)))
    draws = {
        "shap": {c: jax_shap_draws(n_test, 64, n_bg, jax.random.PRNGKey(c))
                 for c in range(2)},
        "deep_shap": None,
        "lime": torch.from_numpy(jax_lime_noise(n_test, 1000, D)),
    }
    return out, draws


@pytest.mark.parametrize("method", ["shap", "deep_shap", "lime"])
def test_xai_report_csvs_match_jax(fusion, data32, reports, tmp_path,
                                   method, capsys):
    _, _, model = fusion
    jax_dir, draws = reports
    frames, attrs = run_xai.xai_report(
        model, port_arrays(data32.train), port_arrays(data32.test), DIMS,
        method=method, out_dir=str(tmp_path), draws=draws[method],
        return_attributions=True)
    printed = capsys.readouterr().out
    assert f"xai[{method}]: encode {data32.train.n + data32.test.n} " \
           "samples in" in printed
    assert "samples/s attrib" in printed
    assert "attention weights: image=0.3333 signal=0.3333 " \
           "clinical=0.3333" in printed
    assert set(frames) == set(attrs) == {0, 1}
    for c in range(2):
        name = f"fusion_{method}_fusion_class{c}.csv"
        header, got = _read_csv(os.path.join(tmp_path, method, name))
        want_header, want = _read_csv(os.path.join(jax_dir, method, name))
        assert header == want_header == list(run_xai.CSV_COLUMNS)
        assert got.shape == want.shape == (data32.test.n, 4)
        np.testing.assert_array_equal(got[:, 0], data32.test.indices)
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=1e-3)
        np.testing.assert_allclose(got[:, 1:].sum(1), 100.0, atol=1e-3)
        assert attrs[c].shape == (data32.test.n, D)


def test_gradcam_report_pngs_match_jax(fusion, data64, tmp_path):
    """The overlays (64x64 strips, a 2x2 feature map) under JAX's file
    names; each decodes (Pillow) to the port's overlay of its own CAM, and
    to JAX's overlay but for CAM values on a uint8 bin's edge."""
    from PIL import Image

    jmodel, variables, model = fusion
    want = jax_run_xai.gradcam_report(jmodel, variables, data64.test,
                                      str(tmp_path / "jax"), n_samples=3)
    test = port_arrays(data64.test)
    got = run_xai.gradcam_report(model, test, str(tmp_path / "port"),
                                 n_samples=3)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    cam, _ = gradcam.grad_cam_fusion_image(model, test.images[:3])
    for i, (g, w) in enumerate(zip(got, want)):
        pix = np.asarray(Image.open(g).convert("RGB"))
        img = test.images[i].permute(1, 2, 0).numpy()
        np.testing.assert_array_equal(
            pix, gradcam.overlay_heatmap(img, cam[i].numpy()))
        diff = np.abs(pix.astype(int)
                      - np.asarray(Image.open(w).convert("RGB")).astype(int))
        assert (diff > 0).mean() <= 0.01 and diff.max() <= 8


@pytest.mark.parametrize("method", run_xai.METHODS)
def test_cli_runs_on_cpu_without_jax_pandas_matplotlib_pillow(tmp_path,
                                                              method):
    """`python -m ecgmm_torch.explain.run_xai --device cpu --n-synth 48
    --method M` writes JAX's file names, with JAX, pandas, matplotlib and
    Pillow blocked."""
    blocked = ("jax", "jaxlib", "flax", "optax", "orbax", "ecgmm_tpu",
               "PIL", "pandas", "matplotlib")
    code = textwrap.dedent(f"""
        import runpy, sys
        for name in {blocked!r}:
            sys.modules[name] = None
        sys.path.insert(0, {REPO!r})
        sys.argv = ["run_xai", "--device", "cpu", "--n-synth", "48",
                    "--method", {method!r}, "--out-dir", "out"]
        runpy.run_module("ecgmm_torch.explain.run_xai", run_name="__main__")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr
    files = sorted(os.listdir(tmp_path / "out" / {
        "gradcam": "gradcam", "tabnet_masks": "tabnet"}.get(method, method)))
    if method == "tabnet_masks":
        assert files == ["mask_M[1].png", "mask_M[2].png", "mask_M[3].png",
                         "mask_M_agg.png"]
    elif method == "gradcam":
        assert len(files) == 5 and all(
            f.startswith("sample") and f.endswith(".png") for f in files)
    else:
        assert files == [f"fusion_{method}_fusion_class{c}.csv"
                         for c in range(2)]
        assert f"xai[{method}]" in out.stdout


def test_cli_defaults_to_the_card():
    """Without --device the CLI runs on CUDA: where there is no card it
    raises instead of quietly using the CPU."""
    if torch.cuda.is_available():
        assert run_xai._device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            run_xai.main(["--method", "shap", "--n-synth", "48"])
