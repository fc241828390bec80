"""The self-attention kernels (`ecgmm_torch/ops/attention.py`,
`ops/csrc/attention.cu`) against the unfused path of
`layers.MultiHeadSelfAttention`.

On the CPU the kernels' launches are replaced by their plain versions
(`reference_softmax_drop`, and the plain model of the backward kernels,
`reference_backward`: the keep bits, the scores recomputed from the saved
log-sum-exp, D = rowsum(dO o out)) under the autograd Function: the
output equals the unfused path's to the bit and every gradient is held
against autograd of the unfused path with the same dropout draw; then
the mask's bits, the generator's stream and the routing.

Tests marked `card` run the kernels themselves and skip without a CUDA
card; on the card's machine (no JAX there, hence `--noconftest`):
`python -m pytest --noconftest -m card tests/test_torch_attention_kernel.py`.
This file imports no JAX.
"""

import pytest
import torch
import torch.nn.functional as F

from ecgmm_torch.models.layers import MultiHeadSelfAttention, flax_init_
from ecgmm_torch.ops import _ext, attention

GRAD_GAP = 2e-5  # the Transformer cell's grad_gap limit (benchmark)


def _rel(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _module(d, heads, p, seed=0, device="cpu"):
    attn = flax_init_(MultiHeadSelfAttention(d, heads, p),
                      torch.Generator().manual_seed(seed))
    with torch.no_grad():  # non-zero biases, so their gradients count
        attn.in_proj_bias.normal_(generator=torch.Generator().manual_seed(1))
        attn.out_proj.bias.uniform_(-0.1, 0.1)
    return attn.to(device).train()


def _run(attn, x, gy, seed, fused):
    """Output and the gradients of x and every parameter, the dropout
    generator seeded with `seed`; the fused path by `_attend_fused`, the
    unfused by `_attend` with the routing held to it."""
    attn.dropout.generator = torch.Generator(x.device).manual_seed(seed)
    attn.zero_grad()
    x = x.clone().requires_grad_(True)
    y = attn._attend_fused(x) if fused else _unfused(attn, x)
    y.backward(gy)
    grads = {"x": x.grad}
    grads.update({n: p.grad for n, p in attn.named_parameters()})
    return y.detach(), grads, attn.dropout.generator.get_state()


def _unfused(attn, x):
    reason = attention.unfused_reason
    attention.unfused_reason = lambda *_: "test"
    try:
        return attn._attend(x)
    finally:
        attention.unfused_reason = reason


@pytest.fixture
def plain_launches(monkeypatch):
    """The kernels' launches replaced by their plain versions, counted."""
    calls = {"softmax_drop": 0, "backward": 0}

    def softmax_drop(scores, bits, c):
        calls["softmax_drop"] += 1
        return attention.reference_softmax_drop(scores, bits, c)

    def backward(q, k, v, heads, bits, c, out, lse, dout):
        calls["backward"] += 1
        return attention.reference_backward(q, k, v, heads, bits, c, out,
                                            lse, dout)

    monkeypatch.setattr(attention, "_launch_softmax_drop", softmax_drop)
    monkeypatch.setattr(attention, "_launch_backward", backward)
    return calls


def _compare(b, t, p, tol, seed=0):
    attn = _module(128, 4, p)
    g = torch.Generator().manual_seed(seed + 2)
    x = torch.randn(b, t, 128, generator=g)
    gy = torch.randn(b, t, 128, generator=g)
    want = _run(attn, x, gy, seed, fused=False)
    got = _run(attn, x, gy, seed, fused=True)
    # the same draws, and the forward the unfused one to the bit
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[0], want[0])
    gaps = {n: _rel(got[1][n], w) for n, w in want[1].items()}
    assert max(gaps.values()) < tol, gaps
    return gaps


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 200])
def test_kernel_model_matches_unfused_autograd(plain_launches, t, b, p):
    """The autograd Function with the plain versions of its launches,
    against autograd of the unfused path, at ragged sizes: the output equal
    to the bit, the gradients of x, in_proj_* and out_proj within float32
    rounding of sums over at most 200 keys, in relative norm."""
    _compare(b, t, p, 1e-5)
    assert plain_launches == {"softmax_drop": 1, "backward": 1}


def test_kernel_model_at_the_cells_length(plain_launches):
    """T = 3000 (the `transformer-train-b8` cell), B = 1, p = 0.1: the
    output equal to the bit, the largest relative gap of the gradients
    against the cell's grad_gap limit of 2e-5."""
    gaps = _compare(1, 3000, 0.1, GRAD_GAP, seed=5)
    assert plain_launches == {"softmax_drop": 1, "backward": 1}
    print("T=3000 relative gaps:",
          {k: f"{v:.2e}" for k, v in gaps.items()})


@pytest.mark.parametrize("t", [1, 31, 32, 33, 100])
def test_packed_bits_unpack_to_the_draw(t):
    g = torch.Generator().manual_seed(t)
    keep = torch.empty((1, 1, t, t)).bernoulli_(0.9, generator=g)
    bits = attention.pack_keep(keep)
    assert bits.dtype == torch.int32 and bits.shape == (t, -(-t // 32))
    assert torch.equal(attention.unpack_keep(bits, t), keep.view(t, t))
    # bit j of word w is key 32 w + j; the bits past T are 0
    for i in range(t):
        for j in (0, t - 1):
            word = int(bits[i, j // 32]) & 0xffffffff
            assert (word >> (j % 32)) & 1 == int(keep[0, 0, i, j])
        assert int(bits[i, -1]) & 0xffffffff < 2 ** (t - 32 * (bits.shape[1]
                                                               - 1))


@pytest.mark.parametrize("bits", [True, False], ids=["mask", "no_mask"])
def test_softmax_drop_plain_version_is_the_unfused_dropout(bits):
    """`reference_softmax_drop` overwrites the scores with torch's softmax
    of them times keep / (1 - p), to the bit, and gives each row's
    log-sum-exp in base 2."""
    g = torch.Generator().manual_seed(6)
    scores = torch.randn(2, 3, 70, 70, generator=g) * 3
    keep = torch.empty((1, 1, 70, 70)).bernoulli_(0.9, generator=g)
    want = torch.softmax(scores, dim=-1)
    if bits:
        want = want * (keep / (1.0 - 0.1))
    got = scores.clone()
    lse = attention.reference_softmax_drop(
        got, attention.pack_keep(keep) if bits else None,
        attention.drop_scale(0.1) if bits else 1.0)
    assert torch.equal(got, want)
    torch.testing.assert_close(
        lse, torch.logsumexp(scores, -1) * attention.LOG2E)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_generator_stream_is_the_same_on_both_paths(plain_launches, train):
    """The fused forward draws the keep mask by the same `bernoulli_` call
    at the same point as the unfused one: after a forward and a second
    one, the generator's state is the same on both paths, and the outputs
    are equal to the bit. In eval mode nothing is drawn."""
    attn = _module(128, 4, 0.1).train(train)
    x = torch.randn(2, 70, 128, generator=torch.Generator().manual_seed(3))
    outs, states = [], []
    for fused in (False, True):
        attn.dropout.generator = torch.Generator().manual_seed(9)
        with torch.no_grad():
            ys = [attn._attend_fused(x) if fused else _unfused(attn, x)
                  for _ in range(2)]
        outs.append(torch.stack(ys))
        states.append(attn.dropout.generator.get_state())
    assert torch.equal(states[0], states[1])
    fresh = torch.Generator().manual_seed(9).get_state()
    assert torch.equal(states[0], fresh) != train
    assert torch.equal(outs[1], outs[0])
    assert plain_launches == {"softmax_drop": 2, "backward": 0}


def _vmapped(attn, x):
    return torch.func.vmap(attn)(x[None])[0]


def _traced(attn, x):
    with _ext.tracing_ops():
        return attn(x)


def _with_keep(attn, x):
    t = x.shape[1]
    attn.dropout.keep = torch.ones((1, 1, t, t), device=x.device)
    return attn(x)


@pytest.mark.parametrize("reason, d, dtype, call", [
    ("device", 128, torch.float32, lambda a, x: a(x)),
    ("functorch", 128, torch.float32, _vmapped),
    ("keep", 128, torch.float32, _with_keep),
    ("tracing", 128, torch.float32, _traced),
    ("dtype", 128, torch.float64, lambda a, x: a(x)),
    ("head_dim", 64, torch.float32, lambda a, x: a(x)),
    ("length", 128, torch.float32, lambda a, x: a(x)),
])
def test_unfused_calls_take_todays_path_and_count(monkeypatch, reason, d,
                                                  dtype, call):
    """Each reason sends a call down the unfused path, unchanged; the
    kernels are not reached, and `fallbacks`, which counts calls on a CUDA
    device, stays as it was (T = 40 is outside `SOFTMAX_T`, so the CPU
    case runs at 2052)."""
    _unfused_call(torch.device("cpu"), monkeypatch, reason, d, dtype, call,
                  counted=False)


def _unfused_call(device, monkeypatch, reason, d, dtype, call, counted):
    attn = _module(d, 4, 0.0, device=device).to(dtype).eval()
    t = 2052 if reason == "device" else 40
    x = torch.randn(2, t, d, dtype=dtype,
                    generator=torch.Generator().manual_seed(4)).to(device)
    seen = []
    real = attention.unfused_reason
    monkeypatch.setattr(attention, "unfused_reason",
                        lambda *a: seen.append(real(*a)) or seen[-1])
    monkeypatch.setattr(type(attn), "_attend_fused", None)
    before = (attention.fallbacks, attention.launches)
    y = call(attn, x)
    assert seen == [reason]
    assert (attention.fallbacks, attention.launches) == (
        before[0] + counted, before[1])
    q, k, v = F.linear(x, attn.in_proj_weight, attn.in_proj_bias).chunk(3, -1)
    want = attn.out_proj(attention.reference_self_attention(
        q, k, v, 4, None if reason != "keep" else attn.dropout.keep, 0.0))
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


# -- on the card --------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 3000])
def test_kernels_match_the_unfused_path_on_the_card(card, t, b, p, train):
    """The kernels against the unfused path on the card, the dropout
    generator seeded alike. Where the module takes them (T = 3000): the
    same draws, the output equal to the bit, every gradient within the
    cell's grad_gap limit in relative norm, and the forward without
    autograd equal to the bit. Elsewhere the module takes the unfused path
    and counts a fallback, and the backward kernels alone are held to
    autograd of the plain version at that length."""
    attn = _module(128, 4, p, device=card).train(train)
    g = torch.Generator().manual_seed(t + b)
    x = torch.randn(b, t, 128, generator=g).to(card)
    gy = torch.randn(b, t, 128, generator=g).to(card)
    if attention.unfused_reason(x, attn) == "length":
        before = (attention.launches, attention.fallbacks)
        with torch.no_grad():
            attn(x)
        assert (attention.launches, attention.fallbacks) == (
            before[0], before[1] + 1)
        gaps = _backward_kernel_gaps(x, gy, 4, p if train else 0.0)
        assert max(gaps.values()) < GRAD_GAP, gaps
        return
    before = (attention.launches, attention.backward_launches)
    want = _run(attn, x, gy, 11, fused=False)
    got = _run(attn, x, gy, 11, fused=True)
    assert (attention.launches, attention.backward_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[0], want[0])
    gaps = {n: _rel(got[1][n], w) for n, w in want[1].items()}
    assert max(gaps.values()) < GRAD_GAP, gaps
    attn.dropout.generator = torch.Generator(card).manual_seed(11)
    with torch.no_grad():
        assert torch.equal(attn._attend_fused(x), want[0])


def _backward_kernel_gaps(x, gy, heads, p):
    """The backward kernels alone on projections q, k, v = x against
    autograd of `reference_self_attention`: the gaps of dq, dk and dv in
    norm over the largest of their three norms (at T = 1 dq and dk are 0
    exactly: a softmax over one key has no gradient)."""
    t = x.shape[1]
    keep = None
    if p:
        keep = torch.empty((1, 1, t, t), device=x.device).bernoulli_(
            1 - p, generator=torch.Generator(x.device).manual_seed(t))
    leaves = [x.clone().requires_grad_(True) for _ in range(3)]
    out = attention.reference_self_attention(*leaves, heads, keep, p)
    want = torch.autograd.grad(out, leaves, gy)
    qh, kh = (attention._heads(z, heads) for z in (x, x))
    lse = torch.logsumexp(torch.matmul(qh / 32 ** 0.5, kh.transpose(-1, -2)),
                          -1) * attention.LOG2E
    bits = None if keep is None else attention.pack_keep(keep)
    c = 1.0 if keep is None else attention.drop_scale(p)
    got = attention._launch_backward(x, x, x, heads, bits, c, out.detach(),
                                     lse, gy)
    scale = max(float(w.norm()) for w in want)
    return {n: float((a - w).norm()) / scale
            for n, a, w in zip("qkv", got, want)}


@pytest.mark.card
@pytest.mark.parametrize("reason, d, dtype, call", [
    ("functorch", 128, torch.float32, _vmapped),
    ("keep", 128, torch.float32, _with_keep),
    ("tracing", 128, torch.float32, _traced),
    ("dtype", 128, torch.float64, lambda a, x: a(x)),
    ("head_dim", 64, torch.float32, lambda a, x: a(x)),
    ("length", 128, torch.float32, lambda a, x: a(x)),
])
def test_unfused_calls_on_the_card_count_as_fallbacks(card, monkeypatch,
                                                      reason, d, dtype, call):
    """On the card each reason sends a call down the unfused path,
    unchanged, and counts it in `fallbacks`; the kernels are not
    reached."""
    _unfused_call(card, monkeypatch, reason, d, dtype, call, counted=True)


@pytest.mark.card
def test_a_train_step_of_the_preset_counts_two_and_two(card):
    """The `physionet_transformer` model (2 layers) on the card: one train
    step runs 2 fused forwards and 2 fused backwards, no fallback; an eval
    forward 2 more forwards without the backward's residual."""
    from ecgmm_torch.config import get_preset
    from ecgmm_torch.workloads import run as port_run

    model, _, _ = port_run.build_model_and_task(
        get_preset("physionet_transformer"), "cuda")
    x = torch.randn(2, 1, 3000, device=card)
    counts = (attention.launches, attention.backward_launches,
              attention.fallbacks)
    model.train()
    model(x).sum().backward()
    model.eval()
    with torch.no_grad():
        model(x)
    torch.cuda.synchronize()
    assert (attention.launches, attention.backward_launches,
            attention.fallbacks) == (counts[0] + 4, counts[1] + 2, counts[2])


@pytest.mark.card
@pytest.mark.parametrize("t", [2052, 3000, 4096, 9216])
def test_softmax_kernel_is_torchs_to_the_bit(card, t):
    """`softmax_drop` on the card at lengths where the training forward
    takes it (`SOFTMAX_T`): torch's softmax of the scores to the bit, and
    with a mask the unfused dropout of it to the bit; the log-sum-exp
    within float32 rounding."""
    assert attention.takes_length(t)
    g = torch.Generator(card).manual_seed(t)
    scores = torch.randn(1, 2, t, t, device=card, generator=g) * 3
    keep = torch.empty((1, 1, t, t), device=card).bernoulli_(0.9,
                                                            generator=g)
    want = torch.softmax(scores, dim=-1)
    for bits, c, w in ((attention.pack_keep(keep), attention.drop_scale(0.1),
                        want * (keep / (1.0 - 0.1))), (None, 1.0, want)):
        got = scores.clone()
        lse = attention._launch_softmax_drop(got, bits, c)
        assert torch.equal(got, w)
        torch.testing.assert_close(
            lse, torch.logsumexp(scores, -1) * attention.LOG2E)


@pytest.mark.card
def test_pack_kernel_matches_the_plain_bits(card):
    for t in (1, 31, 32, 33, 3000):
        keep = torch.empty((1, 1, t, t), device=card).bernoulli_(0.9)
        assert torch.equal(attention.pack_keep(keep).cpu(),
                           attention.reference_pack_keep(keep.cpu()))


@pytest.mark.card
def test_no_tensor_of_t_by_t_kept_or_made_by_the_backward(card):
    """At B = 8, T = 3000, one (B, H, T, T) tensor is 1.15 GB: the fused
    path keeps none for the backward (the unfused one keeps several), its
    backward makes none, and its forward without autograd makes one (the
    scores, overwritten by their dropped softmax)."""
    size = 8 * 4 * 3000 * 3000 * 4
    attn = _module(128, 4, 0.1, device=card)
    x = torch.randn(8, 3000, 128, device=card, requires_grad=True)
    attn.dropout.generator = torch.Generator(card).manual_seed(0)
    kept, backward = [], []
    for fused in (True, False):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        y = attn._attend_fused(x) if fused else _unfused(attn, x)
        torch.cuda.synchronize()
        kept.append(torch.cuda.memory_allocated() - base)
        torch.cuda.reset_peak_memory_stats()
        y.sum().backward()
        torch.cuda.synchronize()
        backward.append(torch.cuda.max_memory_allocated() - base)
        del y
    assert kept[0] < size < 2 * size < kept[1], kept
    assert backward[0] < size, backward
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        attn._attend_fused(x)
    torch.cuda.synchronize()
    assert size <= torch.cuda.max_memory_allocated() - base < 2 * size
