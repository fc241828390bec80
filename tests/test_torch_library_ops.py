"""The serving kernels as `torch.library` operators (`ecgmm::fused_se`,
`ecgmm::fused_se_backward`, `ecgmm::attention_fusion`,
`ecgmm::attention_fusion_backward`) on the CPU, where each runs its plain
version.

- `torch.library.opcheck` on the four operators: schema, fake (meta)
  implementation against the real one, and the autograd registration;
- each forward equals its plain version bit for bit, each backward the
  closed form bit for bit, and autograd through a forward operator
  reaches the backward operator (the gradients equal the closed form's);
- outside `ecgmm_torch.ops.tracing_ops()` the entry points are today's
  code, bit for bit (the plain versions on the CPU); inside it they call
  the operators, which give the same values.
"""

import numpy as np
import pytest
import torch

from ecgmm_torch import ops
from ecgmm_torch.ops import fusion, se

torch.set_num_threads(2)
EPS = 1e-5


def _se_inputs(seed=0, b=3, c=64, t=37, dtype=torch.float32):
    g = np.random.default_rng(seed)
    r = c // 16
    arrays = (g.normal(size=(b, c, t)), g.normal(size=(r, c)) * 0.3,
              g.normal(size=(r,)), g.normal(size=(c, r)) * 0.3,
              g.normal(size=(c,)))
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


def _fusion_inputs(seed=0, b=5, dims=(16, 8, 4)):
    g = np.random.default_rng(seed)
    d = sum(dims)
    arrays = [g.normal(size=(b, k)) for k in dims]
    arrays += [g.normal(size=(3,)), 1 + 0.1 * g.normal(size=(d,)),
               0.1 * g.normal(size=(d,))]
    return [torch.as_tensor(a, dtype=torch.float32) for a in arrays]


@pytest.mark.parametrize("needs", [(True,) * 5, (True, False, True, False,
                                                 False), (False,) * 4
                                   + (True,)])
def test_opcheck_se(needs):
    """Schema, fake implementation and autograd registration of the SE
    operators, for inputs that do and do not require gradients."""
    inputs = [a.requires_grad_(n) for a, n in zip(_se_inputs(), needs)]
    torch.library.opcheck(se.se_op, tuple(inputs))
    x, w1, b1, w2, b2 = _se_inputs(1)
    state = se.reference_se_state(x, w1, b1, w2, b2)
    torch.library.opcheck(
        se.se_backward_op,
        (x, w1, b1, w2, b2, state, torch.randn_like(x), list(needs)))


@pytest.mark.parametrize("needs", [(True,) * 6,
                                   (True, True, True, False, False, False),
                                   (False, False, True, False, False, False)])
def test_opcheck_fusion(needs):
    """Schema, fake implementation and autograd registration of the
    fusion operators; the backward with and without a cotangent for the
    soft weights."""
    inputs = [a.requires_grad_(n) for a, n in zip(_fusion_inputs(), needs)]
    torch.library.opcheck(fusion.fusion_op, (*inputs, EPS))
    img, sig, clin, w, scale, bias = _fusion_inputs(2)
    stats = fusion.reference_fusion_stats(img, sig, clin, w, EPS)
    grad_out = torch.randn(img.shape[0], 28)
    for grad_sw in (None, torch.randn(3)):
        torch.library.opcheck(
            fusion.fusion_backward_op,
            (img, sig, clin, w, scale, bias, stats, grad_out, grad_sw, EPS,
             list(needs)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_se_operators_equal_the_plain_versions(dtype):
    """Forward: `reference_se` and `reference_se_state`; backward: the
    closed form `reference_se_backward`, a (0,) tensor for a gradient
    that is not needed; autograd through the forward operator runs the
    backward operator."""
    inputs = _se_inputs(3, dtype=dtype)
    out, state = se.se_op(*inputs)
    assert torch.equal(out, se.reference_se(*inputs))
    assert torch.equal(state, se.reference_se_state(*inputs))
    assert state.dtype == torch.float32 and state.shape == (2, 3, 64)
    grad = torch.randn_like(inputs[0])
    want = se.reference_se_backward(inputs, grad)
    needs = [True, False, True, True, False]
    got = se.se_backward_op(*inputs, state, grad, needs)
    for g, w, n in zip(got, want, needs):
        assert torch.equal(g, w) if n else g.shape == (0,)
    leaves = [a.clone().requires_grad_(True) for a in inputs]
    se.se_op(*leaves)[0].backward(grad)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_fusion_operators_equal_the_plain_versions():
    """Forward: `reference_attention_fusion` and the (mu, rstd) residual;
    backward: the closed form on the saved residual, with and without the
    soft weights' cotangent; autograd reaches the backward operator."""
    inputs = _fusion_inputs(4)
    out, sw, stats = fusion.fusion_op(*inputs, EPS)
    want_out, want_sw = fusion.reference_attention_fusion(*inputs, eps=EPS)
    assert torch.equal(out, want_out) and torch.equal(sw, want_sw)
    assert torch.equal(stats, fusion.reference_fusion_stats(
        *inputs[:4], EPS))
    grad_out = torch.randn_like(out)
    for grad_sw in (None, torch.randn(3)):
        needs = [True, False, True, True, True, False]
        got = fusion.fusion_backward_op(*inputs, stats, grad_out, grad_sw,
                                        EPS, needs)
        want = fusion.reference_fusion_backward(
            inputs, EPS, grad_out, grad_sw, tuple(needs), stats=stats)
        for g, w, n in zip(got, want, needs):
            assert torch.equal(g, w) if n else g.shape == (0,)
    leaves = [a.clone().requires_grad_(True) for a in inputs]
    o, s, _ = fusion.fusion_op(*leaves, EPS)
    grad_sw = torch.randn(3)
    torch.autograd.backward([o, s], [grad_out, grad_sw])
    want = fusion.reference_fusion_backward(inputs, EPS, grad_out, grad_sw,
                                            stats=stats)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_entry_points_outside_and_inside_tracing_ops():
    """Outside `tracing_ops()` the entry points are the plain versions
    bit for bit and their autograd is the plain expression's; inside it
    they route through the operators (seen by a dispatch mode), with the
    same forward values."""
    x, w1, b1, w2, b2 = _se_inputs(5)
    img, sig, clin, w, scale, bias = _fusion_inputs(5)
    leaves = [a.clone().requires_grad_(True) for a in (img, sig, clin)]
    out = se.fused_se(x, w1, b1, w2, b2)
    assert torch.equal(out, se.reference_se(x, w1, b1, w2, b2))
    fo, fsw = fusion.fused_attention_fusion(*leaves, w, scale, bias, EPS)
    ro, rsw = fusion.reference_attention_fusion(*leaves, w, scale, bias,
                                                eps=EPS)
    assert torch.equal(fo, ro) and torch.equal(fsw, rsw)
    assert fo.grad_fn.name() == ro.grad_fn.name()  # plain autograd
    assert "ecgmm" not in fo.grad_fn.name().lower()

    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    seen = Seen()
    with ops.tracing_ops(), seen:
        t_out = se.fused_se(x, w1, b1, w2, b2)
        t_fo, t_fsw = fusion.fused_attention_fusion(img, sig, clin, w, scale,
                                                    bias, EPS)
    assert "ecgmm.fused_se.default" in seen.names
    assert "ecgmm.attention_fusion.default" in seen.names
    assert torch.equal(t_out, out)
    assert torch.equal(t_fo, ro.detach()) and torch.equal(t_fsw, rsw)
    # the context is per thread and closes
    from ecgmm_torch.ops import _ext

    assert not _ext.tracing()
