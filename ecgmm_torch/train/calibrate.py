"""Post-hoc temperature scaling (port of `ecgmm_tpu/train/calibrate.py`,
numpy and scipy on host logits): one scalar T > 0 fit on the validation
split by NLL, applied as softmax(logits / T) (Guo et al. 2017). It changes
no argmax prediction and no threshold-free metric; it only makes the
reported probability honest.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def nll(logits: np.ndarray, labels: np.ndarray,
        temperature: float = 1.0) -> float:
    """Mean negative log-likelihood of `labels` under
    softmax(logits / temperature)."""
    z = np.asarray(logits, np.float64) / float(temperature)
    z = z - z.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    idx = np.asarray(labels, np.int64)
    return float(-logp[np.arange(len(idx)), idx].mean())


def fit_temperature(
    logits: np.ndarray, labels: np.ndarray,
    bounds: Tuple[float, float] = (0.05, 20.0),
) -> float:
    """Fit T minimizing validation NLL. The objective is convex in
    log T, so a bounded 1-D scalar minimize is exact for practical
    purposes; optimized in log-space to give the (0, 1) cooling and
    (1, ∞) smoothing ranges equal resolution."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    if logits.ndim != 2 or len(logits) != len(labels) or len(logits) == 0:
        raise ValueError(
            f"need (n, C) logits and (n,) labels, got {logits.shape} / "
            f"{np.shape(labels)}"
        )
    # Degenerate-split guards: on a perfectly separated validation set
    # NLL decreases monotonically as T→0, so the "fit" is just the lower
    # bound — softmax(logits/0.05) would SHARPEN every served probability
    # ~20×, the opposite of calibration. Same for a split too small to
    # estimate one parameter from. Identity is the honest answer.
    if len(logits) < 8 or (logits.argmax(axis=1) == labels).all():
        return 1.0
    from scipy.optimize import minimize_scalar

    res = minimize_scalar(
        lambda log_t: nll(logits, labels, float(np.exp(log_t))),
        bounds=(np.log(bounds[0]), np.log(bounds[1])),
        method="bounded",
        options={"xatol": 1e-4},
    )
    t = float(np.exp(res.x))
    # A fit pinned to a bound means the objective had no interior
    # minimum on this split — a bound artifact, not a calibration.
    if t <= bounds[0] * 1.01 or t >= bounds[1] * 0.99:
        return 1.0
    return t


def expected_calibration_error(
    probs: np.ndarray, labels: np.ndarray, n_bins: int = 15,
) -> float:
    """Top-label ECE: bin predictions by confidence, average
    |accuracy − confidence| weighted by bin mass (the standard
    equal-width-bin estimator)."""
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels, np.int64)
    conf = probs.max(axis=1)
    pred = probs.argmax(axis=1)
    correct = (pred == labels).astype(np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    # confidence 1.0 belongs to the last bin, not a phantom n_bins-th
    which = np.clip(np.digitize(conf, edges[1:-1]), 0, n_bins - 1)
    ece = 0.0
    n = len(conf)
    for b in range(n_bins):
        m = which == b
        if not m.any():
            continue
        ece += m.mean() * abs(correct[m].mean() - conf[m].mean())
    return float(ece)


def calibrated_probs(logits: np.ndarray, temperature: float) -> np.ndarray:
    """softmax(logits / T) in float64 on host."""
    z = np.asarray(logits, np.float64) / float(temperature)
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)
