"""The port's models (`ecgmm_torch.models`) against the JAX models on the
same weights: JAX random init (perturbed so every parameter and BN
statistic matters) -> `from_jax_variables` -> strict load, then eval
outputs compared per branch and for the whole FusionOutput, in float32,
at a small size (64x64 images, 256-sample signals, base_filters 16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecgmm_tpu.config import ModelConfig as JaxModelConfig
from ecgmm_tpu.models import ECGMultimodalModel as JaxModel
from ecgmm_tpu.models.clinical import sparsemax as jax_sparsemax
from ecgmm_tpu.tools.export_pth import export_fusion_canonical
from ecgmm_torch.config import ModelConfig
from ecgmm_torch.models import ECGMultimodalModel, sparsemax
from ecgmm_torch.tools.weights import from_jax_variables

torch.set_num_threads(2)

HW, T, FILTERS = 64, 256, 16


def _perturbed(tree, rng):
    """Every leaf with seeded noise: kernels and BN variances scaled (so
    activations keep their size), every other leaf shifted."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _perturbed(v, rng)
            continue
        a = np.asarray(v, np.float32)
        noise = rng.normal(size=a.shape).astype(np.float32)
        if k == "var":
            out[k] = a * np.exp(0.2 * noise)
        elif k == "kernel":
            out[k] = a * (1 + 0.1 * noise)
        else:
            out[k] = a + 0.1 * noise
    return out


@pytest.fixture(scope="module")
def models():
    jcfg = JaxModelConfig(dtype="float32", signal_base_filters=FILTERS)
    jmodel = JaxModel(cfg=jcfg)
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.ones((1, HW, HW, 3)), jnp.ones((1, T)),
        jnp.ones((1, 2)),
    )
    variables = _perturbed(jax.device_get(variables),
                           np.random.default_rng(7))
    model = ECGMultimodalModel(
        ModelConfig(dtype="float32", signal_base_filters=FILTERS)
    )
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model.eval()
    return jmodel, variables, model


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    img_u8 = rng.integers(0, 256, size=(2, HW, HW, 3), dtype=np.uint8)
    sig = rng.normal(size=(2, T)).astype(np.float32)
    clin = rng.normal(size=(2, 2)).astype(np.float32)
    return img_u8, sig, clin


def _nchw(img):
    return torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))


def test_state_dict_equals_jax_exporter(models):
    _, variables, _ = models
    got = from_jax_variables(variables)
    want = export_fusion_canonical(variables)
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == np.asarray(v).dtype, k
        assert g.shape == np.shape(v), k
        assert np.array_equal(g, v), k


def test_resnet1d_se_logits_and_features(models, inputs):
    jmodel, variables, model = models
    _, sig, _ = inputs
    want, want_feats = jmodel.apply(
        variables, jnp.asarray(sig)[..., None],
        method=lambda m, s: m.signal_encoder(s, return_features=True),
    )
    with torch.no_grad():
        got, feats = model.signal_encoder(torch.from_numpy(sig)[:, None],
                                          return_features=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_allclose(feats.numpy(),
                               np.asarray(want_feats).transpose(0, 2, 1),
                               atol=2e-4)


@pytest.mark.parametrize("raw", [True, False], ids=["uint8", "float"])
def test_resnet18_fc_and_layer4(models, inputs, raw):
    jmodel, variables, model = models
    img_u8 = inputs[0]
    img = img_u8 if raw else img_u8.astype(np.float32) / 127.5 - 1.0
    want, want_map = jmodel.apply(
        variables, jnp.asarray(img),
        method=lambda m, x: m.image_encoder(x, return_features=True),
    )
    with torch.no_grad():
        got, fmap = model.image_encoder(_nchw(img), return_features=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(fmap.numpy(),
                               np.asarray(want_map).transpose(0, 3, 1, 2),
                               atol=1e-4)


def test_tabnet_latent_and_m_loss(models, inputs):
    jmodel, variables, model = models
    clin = inputs[2]
    want, want_m = jmodel.apply(
        variables, jnp.asarray(clin),
        method=lambda m, c: m.clinical_encoder(c),
    )
    with torch.no_grad():
        got, m_loss = model.clinical_encoder(torch.from_numpy(clin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(m_loss), float(want_m), atol=1e-5)


def test_fusion_output(models, inputs):
    jmodel, variables, model = models
    img_u8, sig, clin = inputs
    img = img_u8.astype(np.float32) / 127.5 - 1.0
    mask = np.asarray([1.0, 0.0], np.float32)
    want = jmodel.apply(variables, jnp.asarray(img), jnp.asarray(sig),
                        jnp.asarray(clin), mask=jnp.asarray(mask))
    with torch.no_grad():
        got = model(_nchw(img), torch.from_numpy(sig), torch.from_numpy(clin),
                    mask=torch.from_numpy(mask))
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=name)


def test_sparsemax_matches_jax(rng):
    z = rng.normal(size=(5, 7)).astype(np.float32) * 2
    got = sparsemax(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_sparsemax(z)), atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


def test_bf16_compute_dtype_runs(inputs):
    """cfg.dtype='bfloat16' runs the encoders under autocast; the fused
    embeddings and logits come out float32 and finite."""
    img_u8, sig, clin = inputs
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = ECGMultimodalModel(
            ModelConfig(dtype="bfloat16", signal_base_filters=FILTERS)
        ).eval()
    with torch.no_grad():
        out = model(_nchw(img_u8), torch.from_numpy(sig),
                    torch.from_numpy(clin))
    assert out.fusion_logits.dtype == torch.float32
    assert torch.isfinite(out.fusion_logits).all()
