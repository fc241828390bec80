"""Deep SHAP (the DeepLIFT rescale rule) over the fusion head (port of
`ecgmm_tpu/explain/deep_shap.py`).

Per sample x and background reference r, one modified backward pass:
the linear ops (the softmax-weighted chunk scaling, the two Dense layers)
pass multipliers through their weights, the LayerNorm through its
gradient at the input point, and the ReLU through the secant slope
(relu(x) - relu(x_ref)) / (x - x_ref) (`_rescale_relu`). The attribution
is m(x, r) * (x - r), averaged over the background set.

The head is re-derived from the model's own parameters (`head_forward`)
and held to `fuse_embeddings` by the tests. It is plain ops, as in JAX:
the fused AttentionFusion kernel is not on this path. All (sample,
reference) pairs go through the head as one batch of B*N independent
rows.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ecgmm_torch.explain.shap_fusion import (frozen_parameters,
                                             modality_contributions,
                                             model_tensor)


class _RescaleReLU(torch.autograd.Function):
    """relu(x); the backward multiplies by the secant slope between x and
    the reference pre-activation x_ref, and by the local derivative where
    |x - x_ref| < 1e-7 (the DeepLIFT spec). x_ref gets no gradient."""

    @staticmethod
    def forward(ctx, x, x_ref):
        ctx.save_for_backward(x, x_ref)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        x, x_ref = ctx.saved_tensors
        dx = x - x_ref
        near = dx.abs() < 1e-7
        secant = (torch.relu(x) - torch.relu(x_ref)) / torch.where(
            near, torch.ones_like(dx), dx)
        slope = torch.where(near, (x > 0).to(g.dtype), secant)
        return g * slope, None


_rescale_relu = _RescaleReLU.apply


def _normed(model, e, dims):
    """AttentionFusion written out: softmax weights, scaled chunks,
    concat, LayerNorm (biased variance, eps 1e-5)."""
    af = model.attention_fusion
    d0, d1, _ = dims
    sw = torch.softmax(af.weights.float(), dim=0)
    scaled = torch.cat([sw[0] * e[:, :d0], sw[1] * e[:, d0:d0 + d1],
                        sw[2] * e[:, d0 + d1:]], dim=1)
    mu = scaled.mean(dim=-1, keepdim=True)
    var = scaled.var(dim=-1, unbiased=False, keepdim=True)
    return ((scaled - mu) / torch.sqrt(var + 1e-5) * af.norm.weight
            + af.norm.bias)


def head_forward(model, e, dims: Sequence[int], e_ref=None):
    """The fusion head (AttentionFusion scale, concat, LayerNorm, then
    Dense, ReLU, Dense) from the model's parameters, on concatenated
    embeddings (B, D); equal to `model.fuse_embeddings` in eval mode.
    With e_ref (B, D), the ReLU carries the reference's pre-activation
    for the rescale-rule backward."""
    hidden, _, _, out = model.fusion_classifier
    pre = F.linear(_normed(model, e, dims), hidden.weight.float(),
                   hidden.bias)
    if e_ref is None:
        h = torch.relu(pre)
    else:
        with torch.no_grad():
            pre_r = F.linear(_normed(model, e_ref, dims),
                             hidden.weight.float(), hidden.bias)
        h = _rescale_relu(pre, pre_r)
    return F.linear(h, out.weight.float(), out.bias)


def deep_shap(model, x, background, class_idx: int, dims: Sequence[int]):
    """DeepLIFT-rescale attributions of head(x)[:, class_idx], averaged
    over the background references (shap.DeepExplainer semantics).
    x: (B, D), background: (N, D) -> (B, D)."""
    b, d = x.shape
    n = background.shape[0]
    xi = x[:, None, :].expand(b, n, d).reshape(b * n, d)
    ref = background[None].expand(b, n, d).reshape(b * n, d)
    with torch.enable_grad():
        e = xi.detach().requires_grad_(True)
        score = head_forward(model, e, dims, e_ref=ref)[:, class_idx].sum()
        (m,) = torch.autograd.grad(score, e)
    return (m * (xi - ref)).reshape(b, n, d).mean(dim=1)


def explain_fusion_deep(model, embeddings, background, dims: Sequence[int],
                        num_classes: int = 2,
                        return_attributions: bool = False):
    """The Deep-SHAP counterpart of `shap_fusion.explain_fusion`: per-class
    modality contributions, the same CSV contract; with
    return_attributions also {class: (B, D) attributions}."""
    x = model_tensor(model, embeddings)
    bg = model_tensor(model, background)
    out, attrs = {}, {}
    with frozen_parameters(model):
        for c in range(num_classes):
            attrs[c] = deep_shap(model, x, bg, c, tuple(dims)).cpu().numpy()
            out[c] = modality_contributions(attrs[c], dims)
    return (out, attrs) if return_attributions else out
