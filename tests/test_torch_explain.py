"""The port's explainers (`ecgmm_torch.explain` and the pipeline's clinical
IG) against the JAX ones on the same weights, at a small size (64x64
images, 256-sample signals)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecgmm_tpu.config import ModelConfig as JaxModelConfig
from ecgmm_tpu.explain import gradcam as jax_gradcam
from ecgmm_tpu.explain import shap_fusion as jax_shap
from ecgmm_tpu.models import ECGMultimodalModel as JaxModel
from ecgmm_tpu.serve.pipeline import ServingPipeline as JaxPipeline
from ecgmm_torch.config import ModelConfig
from ecgmm_torch.explain import gradcam, shap_fusion
from ecgmm_torch.models import ECGMultimodalModel
from ecgmm_torch.serve.pipeline import ServingPipeline
from ecgmm_torch.tools.weights import from_jax_variables

torch.set_num_threads(2)

HW, T = 64, 256


@pytest.fixture(scope="module")
def models():
    jmodel = JaxModel(cfg=JaxModelConfig(dtype="float32",
                                         signal_base_filters=16))
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(1), jnp.ones((1, HW, HW, 3)), jnp.ones((1, T)),
        jnp.ones((1, 2)),
    ))
    model = ECGMultimodalModel(ModelConfig(dtype="float32",
                                           signal_base_filters=16))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, variables, model.eval()


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, size=(2, HW, HW, 3)).astype(np.float32)
    sig = rng.normal(size=(2, T)).astype(np.float32)
    clin = rng.normal(size=(2, 2)).astype(np.float32)
    return img, sig, clin


def _nchw(img):
    return torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("resize", [False, True])
def test_grad_cam_fusion_image(models, batch, resize):
    jmodel, variables, model = models
    img = batch[0]
    cls = np.asarray([1, 0])
    want, want_logits = jax_gradcam.grad_cam_fusion_image(
        jmodel, variables, jnp.asarray(img), jnp.asarray(cls),
        resize_to_input=resize,
    )
    got, logits = gradcam.grad_cam_fusion_image(
        model, _nchw(img), torch.from_numpy(cls), resize_to_input=resize
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-4)


def test_clinical_integrated_gradients(models, batch):
    jmodel, variables, model = models
    img, sig, clin = (a[:1] for a in batch)
    jpipe = JaxPipeline(jmodel, variables, signal_len=T, img_hw=(HW, HW))
    pipe = ServingPipeline(model, model.state_dict(), signal_len=T,
                           img_hw=(HW, HW), device="cpu")
    for cls in (0, 1):
        want = np.asarray(jpipe._clin_attr(
            jnp.asarray(img), jnp.asarray(sig), jnp.asarray(clin),
            jnp.asarray(cls),
        ))
        with torch.no_grad():
            img_f, sig_f, _, _ = model.encode(
                _nchw(img), torch.from_numpy(sig), torch.from_numpy(clin)
            )
        got = pipe._clinical_ig(img_f, sig_f, torch.from_numpy(clin),
                                torch.tensor(cls))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def jax_shap_draws(rows, n_samples, n_bg, key=None):
    """The (bidx, alphas) that `ecgmm_tpu.explain.shap_fusion.
    gradient_shap` draws for each row (shap_fusion.py:59-66)."""
    key = key if key is not None else jax.random.PRNGKey(0)
    kb, ka = jax.random.split(key)
    k1, k2 = jax.random.split(kb, rows), jax.random.split(ka, rows)
    bidx = np.stack([np.asarray(jax.random.randint(k, (n_samples,), 0,
                                                   n_bg)) for k in k1])
    alphas = np.stack([np.asarray(jax.random.uniform(k, (n_samples,)))
                       for k in k2])
    return bidx, alphas


def test_gradient_shap_matches_jax(models, batch):
    jmodel, variables, model = models
    img, sig, clin = batch
    with torch.no_grad():
        feats = model.encode(_nchw(img), torch.from_numpy(sig),
                             torch.from_numpy(clin))[:3]
    emb = torch.cat(feats, dim=1)
    bg = np.random.default_rng(0).normal(size=(32, 672)).astype(np.float32)

    def jax_head(e):
        return jmodel.apply(variables, e[:, :512], e[:, 512:640],
                            e[:, 640:], method=type(jmodel).fuse_embeddings)

    def head(e):
        return model.fuse_embeddings(e[:, :512], e[:, 512:640], e[:, 640:])

    bidx, alphas = jax_shap_draws(2, 32, 32)
    for cls in (0, 1):
        want = np.asarray(jax_shap.gradient_shap(
            jax_head, jnp.asarray(emb.numpy()), jnp.asarray(bg), cls,
            n_samples=32,
        ))
        got = shap_fusion.gradient_shap(
            head, emb, torch.from_numpy(bg), cls, n_samples=32,
            bidx=torch.from_numpy(bidx), alphas=torch.from_numpy(alphas),
        )
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
        assert all(
            np.array_equal(a, b) for a, b in zip(
                shap_fusion.modality_contributions(got.numpy(),
                                                   (512, 128, 32)).values(),
                jax_shap.modality_contributions(got.numpy(),
                                                (512, 128, 32)).values())
        )


def test_gradient_shap_draws_from_generator(models, batch):
    """Without explicit draws the estimator draws from the generator it is
    given: the same seed gives the same attributions."""
    _, _, model = models
    emb = torch.randn(1, 672, generator=torch.Generator().manual_seed(3))
    bg = torch.randn(8, 672, generator=torch.Generator().manual_seed(4))

    def head(e):
        return model.fuse_embeddings(e[:, :512], e[:, 512:640], e[:, 640:])

    a = shap_fusion.gradient_shap(head, emb, bg, 1, n_samples=16,
                                  generator=torch.Generator().manual_seed(9))
    b = shap_fusion.gradient_shap(head, emb, bg, 1, n_samples=16,
                                  generator=torch.Generator().manual_seed(9))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        shap_fusion.gradient_shap(head, emb, bg, 1, n_samples=16)


def test_jet_lut_equals_matplotlib():
    os.environ.setdefault("MPLBACKEND", "Agg")
    from matplotlib import colormaps

    want = (colormaps["jet"](np.linspace(0.0, 1.0, 256))[:, :3] * 255
            ).astype(np.uint8)
    np.testing.assert_array_equal(gradcam._jet_lut(), want)
    np.testing.assert_array_equal(gradcam._jet_lut(), jax_gradcam._jet_lut())


def test_overlay_heatmap_equals_jax(rng):
    image = rng.integers(0, 256, size=(20, 30, 3), dtype=np.uint8)
    cam = rng.uniform(0, 1, size=(20, 30)).astype(np.float32)
    np.testing.assert_array_equal(gradcam.overlay_heatmap(image, cam),
                                  jax_gradcam.overlay_heatmap(image, cam))
