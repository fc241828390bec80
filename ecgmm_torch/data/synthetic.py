"""Deterministic synthetic cohort (port of `ecgmm_tpu/data/synthetic.py`):
`make_cohort` for the training presets, `_render_strip` for request
images and `write_fixture_tree` for the hospital layout on disk, in numpy
alone (the JAX module writes its fixture tree with pandas and Pillow; the
port writes the same CSV text itself and the same JPEG bytes through its
native encoder)."""

from __future__ import annotations

import csv
import os
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


def _csv(path: str, header, rows) -> None:
    """A CSV file as pandas' `to_csv` writes it: minimal quoting, "\n"
    line ends, float32 values as numpy prints them."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def write_fixture_tree(
    root: str, cohort: Optional[SyntheticCohort] = None, n: int = 24
) -> SyntheticCohort:
    """Write the cohort to disk in the reference's on-disk layout:
    labels csv (xlsx surrogate), clinical.csv, ecg_signals.csv,
    images/<idx>/<idx:03d>ECG_lead2.jpg (reference dataset.py:58-60,
    127-130), byte for byte as the JAX module writes it: the JPEGs are
    Pillow's default (quality 75, `native.jpeg_encode`). Used by loader
    round-trip tests."""
    from ecgmm_torch import native

    cohort = cohort or make_cohort(n=n, img_hw=(50, 500))
    os.makedirs(root, exist_ok=True)
    # every ~8th sample Borderline to exercise the drop path
    labels = ["Borderline" if i % 8 == 5 else
              "Abnormal" if lab == 1 else "Normal"
              for i, lab in enumerate(cohort.labels)]
    _csv(os.path.join(root, "labels.csv"), ["index", "label"],
         zip(cohort.indices.tolist(), labels))
    _csv(os.path.join(root, "clinical.csv"),
         ["index", *cohort.clinical_columns, "ECG"],
         ([idx, *(str(np.float32(v)) for v in row), "unused"]
          for idx, row in zip(cohort.indices.tolist(), cohort.clinical)))
    _csv(os.path.join(root, "ecg_signals.csv"),
         [""] + [str(j) for j in range(cohort.signals.shape[1])],
         ([idx, *(str(np.float32(v)) for v in row)]
          for idx, row in zip(cohort.indices.tolist(), cohort.signals)))
    img_dir = os.path.join(root, "images")
    for i, idx in enumerate(cohort.indices):
        d = os.path.join(img_dir, str(idx))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{str(idx).zfill(3)}ECG_lead2.jpg"),
                  "wb") as f:
            f.write(native.jpeg_encode(cohort.images[i], quality=75))
    return cohort
