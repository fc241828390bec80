"""Synthetic strip photos (port of `_render_strip` in
`ecgmm_tpu/data/synthetic.py`), so the smoke script and the tests can
make request images without pandas."""

from __future__ import annotations

import numpy as np


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
