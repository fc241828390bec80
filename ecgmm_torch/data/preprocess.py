"""Host-side signal preprocessing (port of `ecgmm_tpu/data/preprocess.py`
and `data/pipeline.filter_signals_host`).

Everything runs on the host, the filters in float64, as the reference
repository's `dataset.py:76-116` does. The composite pipelines are the
reference trainers': the hospital filter (moving-average baseline removal
with numpy 'same' alignment, then a zero-phase 5th-order Butterworth
low-pass, cutoff 0.05 at fs 1.0, scipy's `filtfilt`), PTB-XL (500 -> 250
Hz, baseline removal, 40 Hz low-pass, pad or crop) and PhysioNet 2017
(16-149 Hz band-pass, per-sample z-score). `augment_signal` is the
train-time augmentation (noise, scale, circular shift) in torch.

The hospital filter runs the native kernel (`native/preprocess.cpp`, as
the JAX package's `filter_signals_host` prefers it) on the training data
path and the serving request alike, so train and serve share one filter;
its scipy version stays beside it as the plain version (`impl="plain"`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from scipy import signal as sps

from ecgmm_torch import native


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


def hospital_filter(x: np.ndarray, impl: str = "native") -> np.ndarray:
    """Baseline removal + LP(0.05, fs 1) filtfilt over the last axis
    (reference dataset.py:91-95), in float64 throughout. x: (..., T)
    already scaled. impl "native" runs `native.preprocess_hospital`;
    "plain" is the same arithmetic in numpy and scipy."""
    if impl == "native":
        return native.preprocess_hospital(x)
    if impl != "plain":
        raise ValueError(f"impl must be 'native' or 'plain', got {impl!r}")
    x64 = np.asarray(x, np.float64)
    kernel = np.full(200, 1.0 / 200)
    flat = x64.reshape(-1, x64.shape[-1])
    base = np.empty_like(flat)
    for i, row in enumerate(flat):
        base[i] = np.convolve(row, kernel, mode="same")
    b, a = butter_lowpass()
    return sps.filtfilt(b, a, (flat - base).reshape(x64.shape), axis=-1)


def preprocess_hospital(x: np.ndarray, impl: str = "native") -> np.ndarray:
    """The hospital filter (`hospital_filter`) with a float32 result, as
    the JAX package's `filter_signals_host` returns it."""
    return hospital_filter(x, impl).astype(np.float32)


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


# ---------------------------------------------------------------------------
# Train-time augmentation (reference train_physionet.py:47-60)
# ---------------------------------------------------------------------------

def augment_signal_with_draws(x: torch.Tensor, do_noise: torch.Tensor,
                              noise: torch.Tensor, do_scale: torch.Tensor,
                              scale: torch.Tensor, do_shift: torch.Tensor,
                              shift: torch.Tensor) -> torch.Tensor:
    """The arithmetic of `augment_signal` given its six draws: x (B, T);
    do_noise (B, 1) bool and noise (B, T) (already times noise_std);
    do_scale (B, 1) bool and scale (B, 1); do_shift (B,) bool and shift
    (B,) integers. Rows with do_noise take x + noise, then rows with
    do_scale x * scale, then rows with do_shift turn circularly right by
    shift: out[t] = x[(t - shift) mod T]."""
    x = torch.where(do_noise, x + noise, x)
    x = torch.where(do_scale, x * scale, x)
    t = x.shape[1]
    shift = torch.where(do_shift, shift, torch.zeros_like(shift))
    idx = (torch.arange(t, device=x.device)[None, :]
           - shift[:, None].to(torch.int64)) % t
    return torch.gather(x, 1, idx)


def augment_signal(x: torch.Tensor, generator: torch.Generator,
                   noise_std: float = 0.01,
                   scale_range: Tuple[float, float] = (0.8, 1.2),
                   max_shift: int = 10) -> torch.Tensor:
    """Per-sample noise, amplitude scale and circular shift, each with
    probability 0.5, on x (B, T), drawn from `generator` (on x's device):
    the JAX package's `augment_signal`, whose draws come from a key
    instead (so the two agree given the same draws,
    `augment_signal_with_draws`). The shift is an integer in
    [-max_shift, max_shift)."""
    b, t = x.shape
    kw = dict(generator=generator, device=x.device)
    do_noise = torch.rand((b, 1), **kw) < 0.5
    noise = torch.randn(x.shape, dtype=x.dtype, **kw) * noise_std
    do_scale = torch.rand((b, 1), **kw) < 0.5
    lo, hi = scale_range
    scale = (torch.rand((b, 1), dtype=x.dtype, **kw) * (hi - lo) + lo)
    do_shift = torch.rand((b,), **kw) < 0.5
    shift = torch.randint(-max_shift, max_shift, (b,), **kw)
    return augment_signal_with_draws(x, do_noise, noise, do_scale, scale,
                                     do_shift, shift)
