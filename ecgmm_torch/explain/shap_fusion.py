"""Gradient SHAP (expected gradients) over the fusion head (port of
`ecgmm_tpu/explain/shap_fusion.py`).

For each row x: baselines b ~ background and alpha ~ U(0, 1), attribution
= mean over draws of grad f(b + alpha (x - b))[class] * (x - b). All draws
of a row go through `f` as one batch: every module is in eval mode and
rows are independent, so the gradient of the summed class score w.r.t.
the batch is each point's own gradient.
"""

from __future__ import annotations

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
    """Attributions (shape of x) of f(.)[:, class_idx] for each row of x.

    f: (N, D) -> (N, C) logits; background: (M, D). bidx/alphas are the
    draws, shaped (rows, n_samples); when absent they are drawn from
    `generator`."""
    rows = x.shape[0]
    if bidx is None:
        if generator is None:
            raise ValueError("gradient_shap needs draws or a generator")
        bidx, alphas = draw_shap_samples(rows, n_samples,
                                         background.shape[0], generator)
    bidx = torch.as_tensor(bidx, device=x.device).reshape(rows, n_samples)
    alphas = torch.as_tensor(alphas, dtype=x.dtype,
                             device=x.device).reshape(rows, n_samples)
    # a 0-d index tensor keeps a device-side class off the host
    cls = torch.as_tensor(class_idx, device=x.device)
    out = []
    for i in range(rows):
        xi = x[i].detach()
        bases = background[bidx[i]]
        delta = xi[None, :] - bases
        with torch.enable_grad():
            points = (bases + alphas[i][:, None] * delta).requires_grad_(True)
            score = f(points)[:, cls].sum()
            (grads,) = torch.autograd.grad(score, points)
        out.append((grads * delta).mean(dim=0))
    return torch.stack(out)


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
