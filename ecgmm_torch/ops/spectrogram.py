"""Batched STFT log-spectrogram (port of `ecgmm_tpu/ops/spectrogram.py`),
the CRNN's front end (reference train_physionet2.py:30-35: scipy's
`stft` with window 'tukey', which scipy resolves to alpha 0.5, nperseg
64, noverlap 32, zero-extended boundary and padded tail, values scaled
by 1 / sum(window)).

There is no kernel here: the JAX package computes it with `jnp.fft` on
the host while it materialises the splits, and so does the port, with
`torch.fft.rfft` on the host's float32 tensors. The Tukey window is the
port's own numpy copy of scipy's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def tukey_window(m: int, alpha: float = 0.5, periodic: bool = False
                 ) -> np.ndarray:
    """scipy.signal.windows.tukey in float64; periodic=True is what
    scipy.signal.get_window returns by default (fftbins=True), the window
    `stft` uses."""
    if periodic:
        return tukey_window(m + 1, alpha, periodic=False)[:-1]
    if alpha <= 0:
        return np.ones(m)
    n = np.arange(m)
    width = int(np.floor(alpha * (m - 1) / 2.0))
    w = np.ones(m)
    left = n[: width + 1]
    w[: width + 1] = 0.5 * (
        1 + np.cos(np.pi * (-1 + 2.0 * left / alpha / (m - 1))))
    right = n[m - width - 1:]
    w[m - width - 1:] = 0.5 * (
        1 + np.cos(np.pi * (-2.0 / alpha + 1 + 2.0 * right / alpha
                            / (m - 1))))
    return w


def stft_mag(x: torch.Tensor, nperseg: int = 64, noverlap: int = 32,
             window_alpha: float = 0.5) -> torch.Tensor:
    """|STFT| with scipy's default framing: x is extended by nperseg // 2
    zeros at both ends, frames hop by nperseg - noverlap, a last partial
    frame is zero-padded and kept, and the values scale by
    1 / sum(window). x: (..., T) float32 -> (..., F, N), F = nperseg // 2
    + 1."""
    hop = nperseg - noverlap
    win = torch.as_tensor(tukey_window(nperseg, window_alpha, periodic=True),
                          dtype=torch.float32, device=x.device)
    scale = 1.0 / win.sum()
    half = nperseg // 2
    t = x.shape[-1] + 2 * half
    n_frames = 1 + (t - nperseg) // hop
    needed = (n_frames - 1) * hop + nperseg
    if needed < t:  # the tail frame (scipy padded=True)
        n_frames += 1
        needed = (n_frames - 1) * hop + nperseg
    xe = F.pad(x, (half, half + needed - t))
    frames = xe.unfold(-1, nperseg, hop) * win  # (..., N, nperseg)
    spec = torch.fft.rfft(frames, dim=-1) * scale
    return spec.abs().transpose(-1, -2)


def log_spectrogram(x: torch.Tensor, nperseg: int = 64,
                    noverlap: int = 32) -> torch.Tensor:
    """log(1 + |STFT|) (reference train_physionet2.py:30-35)."""
    return torch.log1p(stft_mag(x, nperseg, noverlap))
