"""Digitizer failure-envelope sweep: where does the strip digitizer
break, and is every failure HONEST?

The robustness matrix (tests/test_digitize_robust.py) proves the inside
of the envelope: ±3° tilt, 4× downscale, JPEG q25, 9 px blur, 45%
vignette all digitize fine. This tool charts the OUTSIDE — each
degradation axis swept to the breaking point on a true-geometry render
(1 mm grid = 10 px, 10 mm/mV, so ground-truth pitch and voltage scale
are known exactly) — and scores every point on two independent gates:

  * SHAPE: pearson correlation + affine-aligned relative RMSE of the
    digitized series vs the rendered ground truth;
  * CALIBRATION HONESTY: when the metadata claims ``scale_source ==
    "grid"``, the detected pitch must be within tolerance of the true
    (degradation-adjusted) pitch — a "grid" claim with a wrong pitch
    would ship a confidently wrong voltage axis, the one failure mode
    the cross-checked estimator (serve/digitize.py
    estimate_grid_pitch_px) is designed to rule out. Downgrading to
    "assumed", or raising NoTraceError, is the honest path at any
    degradation level.

The phone-photo intake this bounds is the reference's
`Groove/components/ImageUploader.tsx:23-34` path.

This is the port's copy of `ecgmm_tpu/tools/digitize_envelope.py`, with
no Pillow: the JPEG axis encodes with the port's `native.jpeg_encode`
(Pillow's bytes) and decodes with its upload decoder, and the downscale
axis is Pillow's default (bicubic) resize, `native.resize_bicubic_u8`.
Every degradation equals JAX's bit for bit, so the sweep's rows do.

Run:  python -m ecgmm_torch.tools.digitize_envelope [--csv out.csv]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ecgmm_torch import native
from ecgmm_torch.serve import digitize
from ecgmm_torch.serve.imdecode import decode_image

GRID_STEP = 10  # px per 1 mm square on the clean render
H, W = 250, 2500


def make_ground_truth(seed: int = 14, n: int = 2476
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(mv_true, clean true-geometry render). An ECG-like synthetic
    signal (near-flat baseline, QRS spikes) scaled to ±0.8 mV — unlike
    a random walk it has ~zero median slope, so the sweep can keep
    deskew ON (the production default, and required for the tilt axis)
    without the detrend eating genuine signal."""
    from ecgmm_torch.data import synthetic

    cohort = synthetic.make_cohort(n=1, signal_len=n, seed=seed,
                                   img_hw=(H, W))
    sig = cohort.signals[0].astype(np.float64)
    sig = sig - np.median(sig)
    mv_true = 0.8 * sig / (np.abs(sig).max() + 1e-9)
    return mv_true.astype(np.float32), render_mv(mv_true)


def render_mv(mv_signal: np.ndarray, grid_step: int = GRID_STEP,
              h: int = H, w: int = W,
              grid_rgb=(250, 200, 200)) -> np.ndarray:
    """Render a mV signal at true paper geometry: 1 grid square =
    grid_step px = 1 mm, 10 mm/mV."""
    px_per_mv = 10.0 * grid_step
    t = np.linspace(0, len(mv_signal) - 1, w)
    trace_mv = np.interp(t, np.arange(len(mv_signal)), mv_signal)
    rows = np.clip((h / 2 - trace_mv * px_per_mv), 1, h - 2).astype(np.int64)
    img = np.full((h, w, 3), 255, np.uint8)
    img[::grid_step, :, :] = grid_rgb
    img[:, ::grid_step, :] = grid_rgb
    cols = np.arange(w)
    for dy in (-1, 0, 1):
        img[np.clip(rows + dy, 0, h - 1), cols, :] = (40, 40, 40)
    return img


# -- degradations -----------------------------------------------------------

def tilt(img: np.ndarray, degrees: float) -> np.ndarray:
    from scipy import ndimage

    return np.clip(
        ndimage.rotate(img.astype(np.float32), degrees, axes=(1, 0),
                       reshape=True, order=1, mode="constant", cval=255.0),
        0, 255,
    ).astype(np.uint8)


def downscale(img: np.ndarray, factor: float) -> np.ndarray:
    """Pillow's `Image.resize` with its default filter (BICUBIC)."""
    h, w = img.shape[:2]
    return native.resize_bicubic_u8(
        img, (max(8, int(h / factor)), max(8, int(w / factor))))


def jpeg(img: np.ndarray, quality: int) -> np.ndarray:
    """Pillow's JPEG of the image at `quality`, decoded again."""
    return decode_image(native.jpeg_encode(img, quality=int(quality)))


def vignette(img: np.ndarray, strength: float) -> np.ndarray:
    h, w = img.shape[:2]
    y = np.linspace(-1, 1, h)[:, None]
    x = np.linspace(-1, 1, w)[None, :]
    factor = 1.0 - strength * (x**2 + y**2) / 2
    return np.clip(img.astype(np.float32) * factor[..., None], 0, 255
                   ).astype(np.uint8)


def low_contrast(img: np.ndarray, keep: float) -> np.ndarray:
    """Compress dynamic range toward mid-gray: keep=1 is identity,
    keep=0.1 leaves 10% of the original contrast."""
    f = img.astype(np.float32)
    return np.clip(160.0 + (f - 160.0) * keep, 0, 255).astype(np.uint8)


def shadow(img: np.ndarray, lo: float) -> np.ndarray:
    w = img.shape[1]
    ramp = np.linspace(lo, 1.0, w, dtype=np.float32)[None, :, None]
    return np.clip(img.astype(np.float32) * ramp, 0, 255).astype(np.uint8)


def noise(img: np.ndarray, sigma: float) -> np.ndarray:
    rng = np.random.default_rng(0)
    out = img.astype(np.float32) + rng.normal(0, sigma, img.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def motion_blur(img: np.ndarray, k: int) -> np.ndarray:
    from scipy import ndimage

    kern = np.full((1, int(k)), 1.0 / int(k))
    out = np.stack([
        ndimage.convolve(img[..., c].astype(np.float32), kern,
                         mode="nearest")
        for c in range(3)
    ], -1)
    return np.clip(out, 0, 255).astype(np.uint8)


@dataclass
class Axis:
    name: str
    params: List[float]
    apply: Callable[[np.ndarray, float], np.ndarray]
    pitch_scale: Callable[[float], float]  # true pitch multiplier
    deskew: bool = True


def default_axes() -> List[Axis]:
    ident = lambda p: 1.0  # noqa: E731
    return [
        # tilt: deskew removes the ramp; pitch of horizontal gridlines
        # grows as 1/cos(θ) in the rotated frame
        Axis("tilt_deg", [0, 2, 4, 6, 8, 10, 12], tilt,
             lambda d: 1.0 / np.cos(np.deg2rad(d))),
        # resolution: 0.625 MP render → factor 4 is ~0.04 MP; VERDICT's
        # 0.2 MP sits near factor 1.8
        Axis("downscale", [1, 1.5, 2, 3, 4, 6, 8], downscale,
             lambda f: 1.0 / f),
        Axis("jpeg_q", [95, 50, 25, 15, 10, 5], jpeg, ident),
        Axis("vignette", [0.0, 0.3, 0.45, 0.6, 0.75, 0.9], vignette, ident),
        Axis("contrast_keep", [1.0, 0.5, 0.3, 0.2, 0.1, 0.05],
             low_contrast, ident),
        Axis("shadow_lo", [1.0, 0.55, 0.35, 0.2, 0.1], shadow, ident),
        Axis("noise_sigma", [0, 12, 25, 40, 60], noise, ident),
        Axis("blur_px", [1, 9, 15, 21, 31], motion_blur, ident),
    ]


def score(mv: np.ndarray, mv_true: np.ndarray) -> Tuple[float, float, float]:
    """(corr, affine-aligned rel RMSE, affine gain a of mv≈a·true+b)."""
    a = mv_true - mv_true.mean()
    b = mv - mv.mean()
    corr = float((a @ b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
    A = np.stack([mv_true, np.ones_like(mv_true)], 1)
    coef, *_ = np.linalg.lstsq(A, mv, rcond=None)
    resid = mv - A @ coef
    rel = float(np.sqrt(np.mean(resid**2)) / (np.sqrt(np.mean(b**2)) + 1e-9))
    return corr, rel, float(coef[0])


PITCH_TOL = 0.2  # relative: a "grid" claim beyond this is a LIE


def sweep_point(axis: Axis, param: float, mv_true: np.ndarray,
                clean: np.ndarray) -> Dict:
    img = axis.apply(clean, param)
    row: Dict = {"axis": axis.name, "param": param}
    try:
        mv, info = digitize.digitize_lead2_info(img, deskew=axis.deskew)
    except digitize.NoTraceError as e:
        row.update(
            corr=None, rel_rmse=None, gain=None, scale_source="no_trace",
            grid_pitch_px=None, pitch_rel_err=None, ink_fraction=None,
            honest=True, note=str(e)[:60],
        )
        return row
    corr, rel, gain = score(np.asarray(mv), mv_true)
    pitch_err = None
    honest = True
    if info["scale_source"] == "grid":
        true_pitch = GRID_STEP * axis.pitch_scale(param)
        pitch_err = abs(info["grid_pitch_px"] - true_pitch) / true_pitch
        honest = pitch_err <= PITCH_TOL
    row.update(
        corr=round(corr, 3), rel_rmse=round(rel, 3), gain=round(gain, 3),
        scale_source=info["scale_source"],
        grid_pitch_px=info["grid_pitch_px"],
        pitch_rel_err=None if pitch_err is None else round(pitch_err, 3),
        ink_fraction=info["ink_fraction"], honest=honest, note="",
    )
    return row


def run_sweep(axes: Optional[List[Axis]] = None, seed: int = 14
              ) -> List[Dict]:
    mv_true, clean = make_ground_truth(seed)
    rows = []
    for axis in (axes or default_axes()):
        for param in axis.params:
            rows.append(sweep_point(axis, param, mv_true, clean))
    return rows


def format_table(rows: List[Dict]) -> str:
    hdr = ("axis", "param", "corr", "rel_rmse", "gain", "scale_source",
           "pitch_rel_err", "ink_fraction", "honest")
    lines = [" | ".join(hdr), " | ".join("---" for _ in hdr)]
    for r in rows:
        lines.append(" | ".join(
            "" if r.get(k) is None else str(r.get(k)) for k in hdr
        ))
    return "\n".join(lines)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--csv", default=None, help="also write rows as CSV")
    args = p.parse_args(argv)

    rows = run_sweep()
    print(format_table(rows))
    dishonest = [r for r in rows if not r["honest"]]
    print(f"\n{len(rows)} points, {len(dishonest)} dishonest "
          f"(grid-claimed pitch off by >{PITCH_TOL:.0%})")
    if args.csv:
        import csv

        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")
    return 1 if dishonest else 0


if __name__ == "__main__":
    raise SystemExit(main())
