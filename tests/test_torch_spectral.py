"""The spectrogram front end, the CRNN and the 1-D Transformer of the port
(`ecgmm_torch.ops.spectrogram`, `ecgmm_torch.models.{crnn,transformer1d}`,
`ecgmm_torch.tools.weights.from_jax_{crnn,transformer1d}`) against the
JAX package on the CPU, with inputs from numpy seeds: the CRNN at full
width over the spectrograms of 512-sample signals (33 x 17), the
Transformer at full width with `seq_len` 64.

Bars, and why:
  * `tukey_window`: bit-equal (the same float64 numpy arithmetic);
  * `stft_mag`, `log_spectrogram`: rtol 1e-5 with atol 1e-7: both take a
    float32 rfft (pocketfft in both frameworks, other orders of the
    butterflies); where a magnitude falls below ~0.01 one float32 step of
    the sum is 6e-8, above 1e-5 of the value;
  * weights: bit-equal to the JAX exporters;
  * logits, eval and train mode: rtol 1e-5 with atol 1e-6 (float32 sums
    in other orders; the logits are of order 0.1-1). The Transformer's
    LayerNorms take flax's fast variance E[x^2] - E[x]^2 in JAX and
    torch's two-pass variance here: at d_model 128, with activations of
    order 1, the two differ by a few float32 steps of E[x^2] (~1e-7), and
    the logits carry it within the same bar;
  * BatchNorm running statistics after one train-mode pass: atol 1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ecgmm_tpu.models import CRNN as JaxCRNN
from ecgmm_tpu.models import ECGTransformer1D as JaxTransformer1D
from ecgmm_tpu.models import transformer1d as jax_transformer1d
from ecgmm_tpu.ops import spectrogram as jax_spectrogram
from ecgmm_tpu.tools.export_pth import export_crnn, export_transformer1d
from ecgmm_torch.config import TrainConfig
from ecgmm_torch.models import CRNN, ECGTransformer1D
from ecgmm_torch.models.crnn import GemmConv2d
from ecgmm_torch.models.layers import (BroadcastDropout, Dropout,
                                       MultiHeadSelfAttention, flax_init_)
from ecgmm_torch.ops import spectrogram
from ecgmm_torch.tools.weights import from_jax_crnn, from_jax_transformer1d
from ecgmm_torch.train.state import create_state

torch.set_num_threads(2)

SEQ = 64  # the Transformer's seq_len here


# -------------------------------------------------------------- spectrogram

@pytest.mark.parametrize("m,alpha", [(64, 0.5), (64, 0.25), (33, 0.5),
                                     (8, 0.0)])
@pytest.mark.parametrize("periodic", [False, True])
def test_tukey_window_bit_equal(m, alpha, periodic):
    got = spectrogram.tukey_window(m, alpha, periodic=periodic)
    want = jax_spectrogram.tukey_window(m, alpha, periodic=periodic)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("t", [3000, 2476, 1001])
def test_stft_and_log_spectrogram_match_jax(t):
    x = np.random.default_rng(t).normal(size=(3, t)).astype(np.float32)
    frames = 1 + -(-t // 32)  # scipy's padded framing at hop 32
    for name in ("stft_mag", "log_spectrogram"):
        want = np.asarray(getattr(jax_spectrogram, name)(jnp.asarray(x)))
        got = getattr(spectrogram, name)(torch.from_numpy(x))
        assert got.dtype == torch.float32
        assert got.shape == want.shape == (3, 33, frames)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    if t == 3000:
        assert frames == 95  # the CRNN's (33, 95) input


# ------------------------------------------------------------------ weights

def _perturbed(tree, rng):
    """Every leaf with seeded noise, so that every parameter and BatchNorm
    statistic matters (the positional embedding starts at 0)."""
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


def _spectra(n, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, 512)).astype(np.float32)
    return np.array(jax_spectrogram.log_spectrogram(jnp.asarray(x)))


@pytest.fixture(scope="module")
def crnn():
    spec = _spectra(4)
    jmodel = JaxCRNN(num_classes=2, dropout=0.0)
    variables = _perturbed(
        jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(spec))),
        np.random.default_rng(1))
    return jmodel, variables, spec


@pytest.fixture(scope="module")
def transformer():
    x = np.random.default_rng(2).normal(size=(4, SEQ, 1)).astype(np.float32)
    jmodel = JaxTransformer1D(num_classes=2, seq_len=SEQ, dropout=0.0)
    variables = _perturbed(
        jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))),
        np.random.default_rng(3))
    return jmodel, variables, x


def without_layer_dropout(monkeypatch, model=None):
    """The JAX Transformer's encoder layers with dropout 0 (their 0.1 is
    fixed in `PostLNEncoderLayer`): a subclass in its place, for the test
    only; the layers are named explicitly, so the parameter paths stay.
    With `model`, the port's dropouts too."""
    class NoDropout(jax_transformer1d.PostLNEncoderLayer):
        dropout: float = 0.0

    monkeypatch.setattr(jax_transformer1d, "PostLNEncoderLayer", NoDropout)
    if model is not None:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return model


def _port_crnn(variables, classes=2):
    model = CRNN(classes, dropout=0.0)
    model.load_state_dict(from_jax_crnn(variables), strict=True)
    return model


def _port_transformer(variables):
    model = ECGTransformer1D(2, seq_len=SEQ, dropout=0.0)
    model.load_state_dict(from_jax_transformer1d(variables), strict=True)
    return model


@pytest.mark.parametrize("which", ["crnn", "transformer"])
def test_weights_bridge_equals_jax_exporter(crnn, transformer, which):
    variables = (crnn if which == "crnn" else transformer)[1]
    got = (from_jax_crnn if which == "crnn"
           else from_jax_transformer1d)(variables)
    want = (export_crnn if which == "crnn"
            else export_transformer1d)(variables)
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == np.asarray(v).dtype and g.shape == np.shape(v), k
        assert np.array_equal(g, v), k
    model = _port_crnn(variables) if which == "crnn" \
        else _port_transformer(variables)
    assert set(model.state_dict()) == set(want)


def test_crnn_flatten_permutation():
    """torch flattens the conv output (C, F') channel-major, flax (F', C):
    the bridge permutes the first LSTM layer's input columns so that
    column c * F' + f of torch's weight is flax's row f * C + c."""
    c, f = 128, 4
    kern = np.arange(f * c * 200, dtype=np.float32).reshape(f * c, 200)
    full = jax.device_get(JaxCRNN(num_classes=2).init(
        jax.random.PRNGKey(0), jnp.ones((1, 33, 17))))
    full = jax.tree_util.tree_map(np.asarray, full)
    full["params"]["bilstm0"]["OptimizedLSTMCell_0"]["ii"]["kernel"] = kern
    w = from_jax_crnn(full)["bilstm.weight_ih_l0"].numpy()[:200]
    for ci, fi in ((0, 0), (1, 0), (0, 1), (127, 3), (5, 2)):
        np.testing.assert_array_equal(w[:, ci * f + fi], kern[fi * c + ci])


# ------------------------------------------------------------------ forward

def test_crnn_logits_match_jax(crnn):
    jmodel, variables, spec = crnn
    model = _port_crnn(variables)
    # train mode: the batch statistics normalise and move the buffers
    want, mut = jmodel.apply(variables, jnp.asarray(spec), train=True,
                             mutable=["batch_stats"])
    model.train()
    got = model(torch.from_numpy(spec))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    after = from_jax_crnn({"params": variables["params"], **jax.device_get(
        mut)})
    for name, buf in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), after[name].numpy(),
                                       atol=1e-6, err_msg=name)
    # eval mode on the updated buffers
    want = jmodel.apply({"params": variables["params"], **mut},
                        jnp.asarray(spec))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(spec))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert got.shape == (4, 2)


def test_transformer_logits_match_jax(transformer, monkeypatch):
    jmodel, variables, x = transformer
    model = without_layer_dropout(monkeypatch, _port_transformer(variables))
    xt = torch.from_numpy(x).transpose(1, 2)  # the port's (B, C, T)
    for train in (False, True):
        want = jmodel.apply(variables, jnp.asarray(x), train=train,
                            rngs={"dropout": jax.random.PRNGKey(0)})
        model.train(train)
        with torch.no_grad():
            got = model(xt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=f"train={train}")
    # it attends over time: reversing the batch reverses the logits
    model.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(xt.flip(0)).numpy(),
                                   model(xt).flip(0).numpy(), atol=1e-6)


def test_transformer_takes_shorter_signals(transformer):
    """The positional embedding is cut to the input's length, as JAX's."""
    jmodel, variables, x = transformer
    model = _port_transformer(variables).eval()
    short = x[:, :40]
    want = jmodel.apply(variables, jnp.asarray(short))
    with torch.no_grad():
        got = model(torch.from_numpy(short).transpose(1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------- dropout and init

def test_attention_dropout_is_flax_broadcast_mask():
    """One (T, T) keep mask shared by every sample and head, kept at rate
    1 - p and scaled by 1 / (1 - p), drawn from the generator: the same
    seed gives the same mask."""
    b, h, t, p = 3, 4, 60, 0.25
    drop = BroadcastDropout(p).train()
    drop.generator = torch.Generator().manual_seed(5)
    out = drop(torch.ones(b, h, t, t))
    mask = out[0, 0]
    assert torch.equal(out, mask.expand(b, h, t, t))
    assert set(mask.unique().tolist()) == {
        0.0, float(np.float32(1.0 / (1.0 - p)))}
    assert abs(float((mask > 0).float().mean()) - (1 - p)) < 0.03
    drop.generator = torch.Generator().manual_seed(5)
    assert torch.equal(drop(torch.ones(b, h, t, t)), out)
    assert not torch.equal(drop(torch.ones(b, h, t, t)), out)
    drop.eval()
    x = torch.randn(b, h, t, t)
    assert torch.equal(drop(x), x)


def test_attention_dropout_draws_from_the_train_state():
    """The attention of a train state's model draws its mask from the
    state's generator: the output is the attention recomputed with the
    (T, T) mask that generator gives, identical for identical samples and
    across heads; flax's attention shares its mask the same way."""
    torch.manual_seed(0)
    model = flax_init_(ECGTransformer1D(2, seq_len=SEQ),
                       torch.Generator().manual_seed(0))
    state = create_state(model, TrainConfig(seed=11))
    attn = model.transformer_encoder.layers[0].self_attn
    assert attn.dropout.generator is state.generator
    assert attn.dropout.p == 0.1 and model.classifier[3].p == 0.3
    x = torch.randn(1, SEQ, 128).expand(3, SEQ, 128).contiguous()
    attn.train()
    state.generator.manual_seed(11)
    got = attn(x)
    keep = torch.empty(1, 1, SEQ, SEQ).bernoulli_(
        0.9, generator=torch.Generator().manual_seed(11))
    q, k, v = (torch.nn.functional.linear(x, w, bias).view(3, SEQ, 4, 32)
               .transpose(1, 2) for w, bias in zip(
                   attn.in_proj_weight.chunk(3), attn.in_proj_bias.chunk(3)))
    w = torch.softmax(q / 32 ** 0.5 @ k.transpose(-1, -2), -1) * (keep / 0.9)
    want = attn.out_proj((w @ v).transpose(1, 2).reshape(3, SEQ, 128))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])

    jattn = nn.MultiHeadDotProductAttention(num_heads=4, dropout_rate=0.5,
                                            deterministic=False)
    jx = jnp.asarray(x.numpy())
    jv = jattn.init(jax.random.PRNGKey(0), jx, jx)
    jout = np.asarray(jattn.apply(jv, jx, jx,
                                  rngs={"dropout": jax.random.PRNGKey(1)}))
    np.testing.assert_array_equal(jout[0], jout[1])
    np.testing.assert_array_equal(jout[0], jout[2])


def test_port_attention_without_broadcast_would_differ():
    """Per-element dropout (torch's own) gives identical samples different
    outputs: the broadcast mask is what makes them equal."""
    x = torch.randn(1, SEQ, 128).expand(2, SEQ, 128).contiguous()
    attn = flax_init_(MultiHeadSelfAttention(128, 4, 0.5),
                      torch.Generator().manual_seed(0)).train()
    attn.dropout.generator = torch.Generator().manual_seed(0)
    out = attn(x)
    assert torch.equal(out[0], out[1])
    attn.dropout = Dropout(0.5).train()
    attn.dropout.generator = torch.Generator().manual_seed(0)
    out = attn(x)
    assert not torch.allclose(out[0], out[1])


def test_flax_init_of_the_new_parameters():
    crnn = flax_init_(CRNN(2), torch.Generator().manual_seed(0))
    lstm = crnn.bilstm
    for name, p in lstm.named_parameters():
        p = p.detach()
        if name.startswith("weight_hh"):  # (4H, H): each gate orthogonal
            for block in p.chunk(4):
                torch.testing.assert_close(block @ block.t(), torch.eye(200),
                                           atol=1e-5, rtol=0)
            assert not torch.allclose(p[:200], p[200:400])
        elif name.startswith("weight_ih"):  # lecun-normal, fan-in = width
            std = (1.0 / p.shape[1]) ** 0.5
            assert abs(float(p.std()) - std) < 0.05 * std, name
            assert float(p.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
        else:
            assert float(p.abs().max()) == 0.0, name
    assert not any(p.requires_grad for n, p in lstm.named_parameters()
                   if n.startswith("bias_hh"))
    assert crnn.bilstm.input_size == 512  # 128 channels x 33 // 8 bins

    model = ECGTransformer1D(2, seq_len=SEQ)
    with torch.no_grad():
        model.pos_embedding.fill_(1.0)
    flax_init_(model, torch.Generator().manual_seed(0))
    assert float(model.pos_embedding.detach().abs().max()) == 0.0
    attn = model.transformer_encoder.layers[1].self_attn
    w = attn.in_proj_weight.detach()
    std = (1.0 / 128) ** 0.5
    for part in w.chunk(3):  # q, k, v: fan-in 128 each
        assert abs(float(part.std()) - std) < 0.1 * std
    assert float(attn.in_proj_bias.abs().max()) == 0.0
    ow = attn.out_proj.weight.detach()  # fan-in heads x head_dim = 128
    assert abs(float(ow.std()) - std) < 0.1 * std


def test_gemm_conv_equals_conv2d():
    conv = GemmConv2d(3, 5, 5, padding=2)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 3, 9, 13)).astype(np.float32))
    torch.testing.assert_close(
        conv(x), torch.nn.functional.conv2d(x, conv.weight, conv.bias,
                                            padding=2),
        rtol=1e-5, atol=1e-5)


def test_gemm_conv_gradients_match_float64():
    """`GemmConv2d`'s float32 gradients at the CRNN's second block (B=16,
    32 -> 64 channels, 16 x 47 maps) within 1e-5 of each float64 tensor's
    largest component (float32 sums; ~1e-6 seen)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(16, 32, 16, 47)).astype(
        np.float32))
    g = torch.from_numpy(rng.normal(size=(16, 64, 16, 47)).astype(
        np.float32))
    conv = flax_init_(GemmConv2d(32, 64, 5, padding=2),
                      torch.Generator().manual_seed(0))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        m = copy.deepcopy(conv).to(dtype)
        leaf = x.to(dtype).requires_grad_(True)
        grads[dtype] = torch.autograd.grad(
            m(leaf), [leaf, m.weight, m.bias], g.to(dtype))
    for got, want in zip(*grads.values()):
        err = (got.double() - want).abs().max()
        assert float(err) <= 1e-5 * float(want.abs().max())
