"""Deterministic synthetic cohort (port of `ecgmm_tpu/data/synthetic.py`):
`make_cohort` for the training presets and `_render_strip` for request
images, in numpy alone (the JAX module imports pandas for its fixture
writer, which the port does not need)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np


class SyntheticCohort(NamedTuple):
    indices: np.ndarray            # (N,) patient ids
    labels: np.ndarray             # (N,) int {0, 1}
    signals: np.ndarray            # (N, T) float32 raw digitized lead-II
    clinical: np.ndarray           # (N, C) float32 [AGE, Wt, ...]
    images: Optional[np.ndarray]   # (N, H, W, 3) uint8, or None
    clinical_columns: Tuple[str, ...]


def _render_strip(signal: np.ndarray, h: int, w: int) -> np.ndarray:
    """Render a 1-D trace into an (h, w, 3) uint8 image resembling the
    reference's 2500x250 lead-II strips (dark trace on light grid paper)."""
    t = np.linspace(0, len(signal) - 1, w)
    trace = np.interp(t, np.arange(len(signal)), signal)
    lo, hi = trace.min(), trace.max()
    span = (hi - lo) or 1.0
    rows = ((1.0 - (trace - lo) / span) * (h - 3) + 1).astype(np.int64)

    img = np.full((h, w, 3), 255, np.uint8)
    img[::25, :, :] = (250, 200, 200)  # horizontal grid
    img[:, ::25, :] = (250, 200, 200)  # vertical grid
    cols = np.arange(w)
    for dy in (-1, 0, 1):  # 3-px-thick trace
        img[np.clip(rows + dy, 0, h - 1), cols, :] = (40, 40, 40)
    return img


def make_cohort(
    n: int = 244,
    signal_len: int = 2476,
    img_hw: Optional[Tuple[int, int]] = (250, 2500),
    n_clinical: int = 2,
    seed: int = 42,
    abnormal_frac: float = 0.45,
) -> SyntheticCohort:
    """ECG-like cohort: the abnormal class gets irregular RR intervals and
    baseline wander so the task is learnable. The same RNG sequence as the
    JAX module, so signals, labels and clinical columns are bit-equal;
    images are rendered after every draw, so `img_hw=None` (no images, as
    the signal-only tasks need) changes nothing else."""
    rng = np.random.default_rng(seed)
    indices = np.arange(1, n + 1)
    labels = (rng.random(n) < abnormal_frac).astype(np.int64)

    t = np.arange(signal_len) / 250.0
    signals = np.zeros((n, signal_len), np.float32)
    for i in range(n):
        hr = rng.uniform(55, 95)
        jitter = 0.25 if labels[i] else 0.02
        phase = np.cumsum(
            (hr / 60.0) * (1 + jitter * rng.standard_normal(signal_len))
            / 250.0
        )
        beats = np.exp(-np.square(((phase % 1.0) - 0.5) * 18))
        wander = (0.4 if labels[i] else 0.1) * np.sin(
            2 * np.pi * rng.uniform(0.1, 0.5) * t + rng.uniform(0, 6)
        )
        noise = 0.04 * rng.standard_normal(signal_len)
        signals[i] = (beats + wander + noise).astype(np.float32)

    age = rng.uniform(25, 85, n) + 6.0 * labels
    wt = rng.uniform(45, 95, n)
    extra = rng.standard_normal((n, max(0, n_clinical - 2)))
    clinical = np.column_stack([age, wt, extra]).astype(np.float32)
    cols = ("AGE", "Wt") + tuple(f"VAR{i}" for i in range(n_clinical - 2))

    images = None
    if img_hw is not None:
        h, w = img_hw
        images = np.stack([_render_strip(s, h, w) for s in signals])
    return SyntheticCohort(indices, labels, signals, clinical, images, cols)
