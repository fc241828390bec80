"""Gradient SHAP (expected gradients) over the fusion head (port of
`ecgmm_tpu/explain/shap_fusion.py`).

For each row x: baselines b ~ background and alpha ~ U(0, 1), attribution
= mean over draws of grad f(b + alpha (x - b))[class] * (x - b). The
draws of every row go through `f` as one batch of rows * n_samples
points: every module is in eval mode and rows are independent, so the
gradient of the summed class scores w.r.t. the batch is each point's own
gradient. Each row has its own class.

`explain_fusion` is the XAI batch path's gradient SHAP: every class's
attributions through `fuse_embeddings`, reduced per modality.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Sequence

import numpy as np
import torch


def draw_shap_samples(n_rows: int, n_samples: int, n_background: int,
                      generator: torch.Generator):
    """(bidx (n_rows, n_samples) int64, alphas (n_rows, n_samples) f32)."""
    bidx = torch.randint(0, n_background, (n_rows, n_samples),
                         generator=generator)
    alphas = torch.rand((n_rows, n_samples), generator=generator)
    return bidx, alphas


def gradient_shap(f: Callable[[torch.Tensor], torch.Tensor], x, background,
                  class_idx, n_samples: int = 64, bidx=None, alphas=None,
                  generator=None):
    """Attributions (shape of x) of f(.)[:, class] for each row of x.

    f: (N, D) -> (N, C) logits; background: (M, D); class_idx: one class
    for every row, or (rows,) classes. bidx/alphas are the draws, shaped
    (rows, n_samples); when absent they are drawn from `generator`."""
    rows = x.shape[0]
    if bidx is None:
        if generator is None:
            raise ValueError("gradient_shap needs draws or a generator")
        bidx, alphas = draw_shap_samples(rows, n_samples,
                                         background.shape[0], generator)
    bidx = torch.as_tensor(bidx, device=x.device).reshape(rows, n_samples)
    alphas = torch.as_tensor(alphas, dtype=x.dtype,
                             device=x.device).reshape(rows, n_samples)
    # a tensor index keeps a device-side class off the host
    cls = torch.as_tensor(class_idx, device=x.device).expand(rows)
    bases = background[bidx]  # (rows, n_samples, D)
    delta = x.detach()[:, None, :] - bases
    with torch.enable_grad():
        points = (bases + alphas[..., None] * delta).reshape(
            rows * n_samples, -1).requires_grad_(True)
        logits = f(points)
        score = logits[torch.arange(rows * n_samples, device=x.device),
                       cls.repeat_interleave(n_samples)].sum()
        (grads,) = torch.autograd.grad(score, points)
    return (grads.reshape(rows, n_samples, -1) * delta).mean(dim=1)


def modality_contributions(
    attributions: np.ndarray,
    dims: Sequence[int],
    names: Sequence[str] = ("Image", "Signal", "Clinical"),
) -> Dict[str, np.ndarray]:
    """Per-sample |SHAP| summed per modality chunk -> % of total
    (reference shap_fusion.py:90-110). dims: chunk widths."""
    a = np.abs(np.asarray(attributions))
    out: Dict[str, np.ndarray] = {}
    start = 0
    totals = a.sum(axis=1)
    totals = np.where(totals == 0, 1.0, totals)
    for name, d in zip(names, dims):
        out[f"{name}_%"] = 100.0 * a[:, start:start + d].sum(axis=1) / totals
        start += d
    return out


@contextlib.contextmanager
def frozen_parameters(model):
    """The model's parameters need no gradient while the context lasts
    (as in `ServingPipeline`): an attribution pass then differentiates
    w.r.t. its inputs alone, and the fusion backward kernel writes only
    the input gradients. Each parameter's flag is restored on exit."""
    params = list(model.parameters())
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield model
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)


def model_tensor(model, array):
    """A float32 tensor of `array` on the model's device."""
    device = next(model.parameters()).device
    return torch.as_tensor(np.asarray(array, np.float32), device=device)


def explain_fusion(model, embeddings, background, dims: Sequence[int],
                   num_classes: int = 2, n_samples: int = 64, seed: int = 0,
                   draws=None, return_attributions: bool = False):
    """Gradient SHAP through the fusion head (AttentionFusion + MLP) for
    every class, aggregated per modality: {class: {"Image_%": ...}}.
    embeddings (B, D) are the concatenated LayerNorm'd branch features,
    background (N, D). draws: {class: (bidx, alphas)}, each (B,
    n_samples); absent, class c draws from a generator seeded seed + c (as
    JAX keys class c with PRNGKey(seed + c)). With return_attributions
    also {class: (B, D) attributions}."""
    d0, d1, _ = dims
    x = model_tensor(model, embeddings)
    bg = model_tensor(model, background)

    def head(e):
        return model.fuse_embeddings(e[:, :d0], e[:, d0:d0 + d1],
                                     e[:, d0 + d1:])

    out, attrs = {}, {}
    with frozen_parameters(model):
        for c in range(num_classes):
            if draws is None:
                bidx, alphas = draw_shap_samples(
                    x.shape[0], n_samples, bg.shape[0],
                    torch.Generator().manual_seed(seed + c))
            else:
                bidx, alphas = draws[c]
            attrs[c] = gradient_shap(head, x, bg, c, n_samples, bidx=bidx,
                                     alphas=alphas).cpu().numpy()
            out[c] = modality_contributions(attrs[c], dims)
    return (out, attrs) if return_attributions else out
