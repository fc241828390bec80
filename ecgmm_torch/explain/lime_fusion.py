"""LIME over the fused embeddings (port of
`ecgmm_tpu/explain/lime_fusion.py`): per test row, perturb the embedding
by standard-normal noise times the training features' std (LIME
tabular's gaussian sampling; row 0 keeps the original), weight each
perturbation by the kernel sqrt(exp(-d^2 / w^2)) of its standardised
distance, and fit a weighted ridge regression of the class probability
on the standardised perturbation, (Z^T W Z + lambda I)^-1 Z^T W y; the
coefficients' |.| aggregate per modality chunk.

All rows' perturbations go through the predictor as one batch, and the
ridge systems are solved batched over rows by Cholesky (the Gram matrix
plus lambda I is symmetric positive definite). The Gram matrix does not
depend on the class, so one factorisation serves every class asked for.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ecgmm_torch.explain.shap_fusion import modality_contributions


def draw_lime_noise(rows: int, num_samples: int, d: int,
                    generator: torch.Generator) -> torch.Tensor:
    """(rows, num_samples, d) standard-normal float32 draws."""
    return torch.randn((rows, num_samples, d), generator=generator)


def lime_tabular(
    predict_proba: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    feature_std: torch.Tensor,
    class_idx,
    num_samples: int = 1000,
    kernel_width: Optional[float] = None,
    ridge: float = 1.0,
    noise=None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Local linear coefficients for each row of x (B, D).

    predict_proba: (N, D) -> (N, C) probabilities; feature_std (D,) scales
    the perturbations (LIME's discretize_continuous=False). class_idx: one
    class -> (B, D), or a sequence of k classes -> (k, B, D) from the same
    perturbations. noise: the (B, num_samples, D) standard-normal draws;
    absent, they are drawn from `generator`. kernel_width defaults to
    0.75 sqrt(D), LIME's."""
    b, d = x.shape
    kernel_width = kernel_width or math.sqrt(d) * 0.75
    if noise is None:
        if generator is None:
            raise ValueError("lime_tabular needs noise or a generator")
        noise = draw_lime_noise(b, num_samples, d, generator)
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(feature_std, dtype=x.dtype, device=x.device)
    classes = torch.as_tensor(class_idx, device=x.device).reshape(-1)
    xi = x[:, None, :]
    pts = xi + noise * std
    pts[:, 0] = x  # LIME keeps the original as row 0
    z = (pts - xi) / (std + 1e-12)
    dist = torch.sqrt(torch.sum(z ** 2, dim=-1))
    w = torch.sqrt(torch.exp(-(dist ** 2) / kernel_width ** 2))
    y = predict_proba(pts.reshape(b * num_samples, d)).reshape(
        b, num_samples, -1)[..., classes]
    zw_t = (z * w[..., None]).transpose(1, 2)
    gram = zw_t @ z + ridge * torch.eye(d, dtype=x.dtype, device=x.device)
    coefs = torch.cholesky_solve(zw_t @ y, torch.linalg.cholesky(gram))
    coefs = coefs.permute(2, 0, 1)  # (k, B, D)
    return coefs if isinstance(class_idx, (list, tuple)) else coefs[0]


# the same reduction as SHAP's: |coefficient| summed per chunk, % of total
lime_modality_contributions = modality_contributions
