"""Host-side signal preprocessing for serving (port of the hospital path of
`ecgmm_tpu/data/preprocess.py` and `data/pipeline.filter_signals_host`).

Everything runs in numpy/scipy on the host in float64, as the reference
repository's `dataset.py:76-116` does: moving-average baseline removal
with numpy 'same' alignment, then a zero-phase 5th-order
Butterworth low-pass (cutoff 0.05, fs 1.0) with scipy's `filtfilt`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy import signal as sps


class Scaler(NamedTuple):
    """StandardScaler fit on the train split (reference dataset.py:194-200):
    ddof=0 std, zero-variance columns get scale 1."""

    mean: np.ndarray
    scale: np.ndarray

    @staticmethod
    def fit(x: np.ndarray) -> "Scaler":
        x64 = np.asarray(x, dtype=np.float64)
        mean = x64.mean(axis=0)
        scale = x64.std(axis=0)
        scale = np.where(scale == 0.0, 1.0, scale)
        return Scaler(mean=mean, scale=scale)

    def transform(self, x) -> np.ndarray:
        return (np.asarray(x, np.float32) - self.mean.astype(np.float32)) / (
            self.scale.astype(np.float32)
        )


def remove_baseline_drift(x: np.ndarray, window_size: int = 200
                          ) -> np.ndarray:
    """x - np.convolve(x, ones(w)/w, mode='same') along the last axis, in
    float64; returns float32 (reference dataset.py:81-83)."""
    x64 = np.asarray(x, np.float64)
    kernel = np.full(window_size, 1.0 / window_size)
    flat = x64.reshape(-1, x64.shape[-1])
    base = np.stack([np.convolve(row, kernel, mode="same") for row in flat])
    return (flat - base).reshape(x64.shape).astype(np.float32)


def butter_lowpass(cutoff: float = 0.05, fs: float = 1.0, order: int = 5):
    """(b, a) of the reference's low-pass (dataset.py:85-89 defaults)."""
    return sps.butter(order, cutoff / (0.5 * fs), btype="low")


def preprocess_hospital(x: np.ndarray) -> np.ndarray:
    """Baseline removal + LP(0.05, fs 1) filtfilt over the last axis
    (reference dataset.py:91-95). x: (..., T) already scaled."""
    b, a = butter_lowpass()
    y = sps.filtfilt(b, a, remove_baseline_drift(x).astype(np.float64),
                     axis=-1)
    return y.astype(np.float32)
