"""Host-side signal preprocessing (port of `ecgmm_tpu/data/preprocess.py`
and `data/pipeline.filter_signals_host`).

Everything runs in numpy/scipy on the host, the filters in float64, as
the reference repository's `dataset.py:76-116` does. The composite
pipelines are the reference trainers': the hospital filter (moving-average
baseline removal with numpy 'same' alignment, then a zero-phase 5th-order
Butterworth low-pass, cutoff 0.05 at fs 1.0, with scipy's `filtfilt`),
PTB-XL (500 -> 250 Hz, baseline removal, 40 Hz low-pass, pad or crop) and
PhysioNet 2017 (16-149 Hz band-pass, per-sample z-score).
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
    base = np.empty_like(flat)  # an empty split stays empty
    for i, row in enumerate(flat):
        base[i] = np.convolve(row, kernel, mode="same")
    return (flat - base).reshape(x64.shape).astype(np.float32)


def zscore(x: np.ndarray, axis: int = -1, eps: float = 1e-8) -> np.ndarray:
    """Per-sample z-score in x's dtype (reference train_physionet.py:23-26)."""
    mean = np.mean(x, axis=axis, keepdims=True)
    std = np.std(x, axis=axis, keepdims=True)
    return (x - mean) / (std + np.asarray(eps, x.dtype))


def butter_lowpass(cutoff: float = 0.05, fs: float = 1.0, order: int = 5):
    """(b, a) of the reference's low-pass (dataset.py:85-89 defaults)."""
    return sps.butter(order, cutoff / (0.5 * fs), btype="low")


def butter_lowpass_ptb(cutoff: float = 40.0, fs: float = 250.0,
                       order: int = 5):
    """(b, a) of the PTB-XL low-pass (train_signal_only_ptb.py:23-27)."""
    return sps.butter(order, cutoff / (0.5 * fs), btype="low")


def butter_bandpass(lowcut: float = 16.0, highcut: float = 149.0,
                    fs: float = 300.0, order: int = 4):
    """(b, a) of the PhysioNet band-pass (train_physionet.py:28-33)."""
    return sps.butter(order, np.asarray([lowcut, highcut]) / (0.5 * fs),
                      btype="band")


def _filtfilt(ba, x: np.ndarray) -> np.ndarray:
    """scipy's zero-phase filter (method 'pad', odd extension of
    3 * len(b)) over the last axis in float64; returns float32."""
    b, a = ba
    return sps.filtfilt(b, a, np.asarray(x, np.float64),
                        axis=-1).astype(np.float32)


def decimate2(x: np.ndarray) -> np.ndarray:
    """Naive 2x downsample (reference train_signal_only_ptb.py:45: [::2])."""
    return x[..., ::2]


def pad_or_crop(x: np.ndarray, length: int) -> np.ndarray:
    """Right-pad with zeros or truncate to `length` along the last axis
    (reference train_signal_only_ptb.py:48-52, keras pad_sequences
    'post')."""
    n = x.shape[-1]
    if n >= length:
        return x[..., :length]
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, length - n)])


def preprocess_hospital(x: np.ndarray) -> np.ndarray:
    """Baseline removal + LP(0.05, fs 1) filtfilt over the last axis
    (reference dataset.py:91-95). x: (..., T) already scaled."""
    return _filtfilt(butter_lowpass(), remove_baseline_drift(x))


def preprocess_ptbxl(x: np.ndarray, length: int = 2476) -> np.ndarray:
    """PTB-XL: 500 -> 250 Hz decimation, baseline removal, LP 40 Hz, pad
    or crop to `length` (train_signal_only_ptb.py:40-53). x: (..., T) at
    500 Hz."""
    y = remove_baseline_drift(decimate2(np.asarray(x, np.float32)))
    return pad_or_crop(_filtfilt(butter_lowpass_ptb(), y), length)


def preprocess_physionet(x: np.ndarray) -> np.ndarray:
    """PhysioNet 2017: band-pass 16-149 Hz at 300 Hz, then a per-sample
    z-score in float32 (train_physionet.py:42-45)."""
    return zscore(_filtfilt(butter_bandpass(), x))
