"""ECG image → 1-D signal digitization (numpy copy of
`ecgmm_tpu/serve/digitize.py`, without its dispatch to the native C++
kernels of `ecgmm_tpu/native/`; the numpy path is the one kept here).

The mobile app uploads a *photo* of a lead-II strip and the (missing)
reference backend returns `ecg_signal` as digitized voltages
(`Groove/app/(tabs)/ResultScreen.tsx:26-48`). No digitization code exists
anywhere in the reference (SURVEY.md §0); this implements it for the known
2500×250 lead-II strip format, robust to real-photo artifacts:

  * red-grid suppression — ECG paper grid is light red (high R channel);
    ink darkness is measured on the *brightest* channel, so a pixel is
    "ink" only if it is dark in every channel. Light-red gridlines keep a
    bright red channel and vanish from the darkness map, no matter how
    dense the grid;
  * illumination normalization — local paper brightness is estimated by a
    grayscale morphological closing (block max, then block min over a
    wider window) and darkness is measured *relative* to it. The max pass
    makes shadows / lighting gradients / vignetting irrelevant; the min
    pass keeps regions BRIGHTER than the paper (white photo margins,
    a bright table behind the strip, rotation borders) from bleeding
    into the paper estimate and turning nearby paper into phantom ink;
  * contrast-adaptive ink segmentation — a pixel is ink when it is nearly
    as dark as the darkest pixel of its own column (the trace is the
    darkest thing in every column it crosses), with an absolute floor so
    noise on trace-free columns never qualifies. Motion blur or a
    low-resolution photo can halve the trace's contrast without moving
    this per-column relative threshold;
  * deskew — camera tilt shows up as a linear trend in the per-column
    trace centroid; a Theil–Sen (median-of-pairwise-slopes) robust fit
    removes it without disturbing QRS spikes or baseline wander;
  * strip auto-location — a phone photo usually contains more than the
    strip (table, margins, fingers). The paper is found by its defining
    feature, the red grid: row/column profiles of "gridness" (R minus
    max(G,B)) bound the largest contiguous grid-bearing region; when no
    grid is detectable the large bright (paper) region is used instead;
  * grid-pitch mV auto-calibration — standard ECG paper is 1 mm small
    squares at 10 mm/mV, so the vertical pixel pitch of the horizontal
    gridlines fixes the absolute voltage scale (px/mV = 10 × pitch)
    regardless of photo resolution or crop. The pitch is estimated from
    per-column-band gridness autocorrelations summed across bands —
    autocorrelation is phase-invariant, so camera tilt (which shifts the
    grid phase across the width) does not smear the peak. Falls back to
    the reference strips' fixed geometry when no grid is found;
  * per-column darkness-weighted centroid → gap interpolation →
    row-to-millivolt scaling → resampling to the model's 2476 @ 250 Hz
    input grid. (The time axis is NOT grid-calibrated: the reference's
    2500×250 strips map to 2476 samples ≈ 9.9 s, which is not standard
    25 mm/s paper — the model contract is a fixed-length resample.)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class NoTraceError(ValueError):
    """The uploaded image contains no discernible ECG trace — a client
    input problem (blank/overexposed/non-ECG photo), not a server
    fault; the HTTP layer maps it to a 400."""


def _block_max(brightness: np.ndarray, w: int) -> np.ndarray:
    """Per-tile maxima over w×w tiles (the block grid, NOT upsampled).
    Pure vectorized numpy — ~10× cheaper than a true sliding maximum
    filter at these strip sizes, and the paper background only needs to
    be a local upper envelope, not exact: any w×w tile of a strip photo
    contains paper because the trace is only ~3 px thick."""
    h, wid = brightness.shape
    ph, pw = (-h) % w, (-wid) % w
    padded = np.pad(brightness, ((0, ph), (0, pw)), mode="edge")
    hb, wb = padded.shape[0] // w, padded.shape[1] // w
    return padded.reshape(hb, w, wb, w).max(axis=(1, 3))


def _closing(brightness: np.ndarray, w: int) -> np.ndarray:
    """Grayscale closing on the block grid: w×w block max, then a min
    over non-overlapping 2×2 groups of blocks (a 2w×2w erosion),
    upsampled back to pixel resolution. All reductions run on the tiny
    hb×wb grid, so the cost over the plain block max is negligible."""
    h, wid = brightness.shape
    blocks = _block_max(brightness, w)
    hb, wb = blocks.shape
    bp = np.pad(blocks, ((0, hb % 2), (0, wb % 2)), mode="edge")
    closed = bp.reshape(bp.shape[0] // 2, 2, bp.shape[1] // 2, 2).min(
        axis=(1, 3)
    )
    up = np.repeat(np.repeat(closed, 2 * w, 0), 2 * w, 1)
    return up[:h, :wid]


def darkness_map(image: np.ndarray, bg_window: int = 25) -> np.ndarray:
    """Relative ink-darkness in [0, 1] from an RGB uint8 photo.

    brightness = max over channels: paper is bright in all channels, the
    light-red grid stays bright in R, the trace is dark in all — so the
    grid is suppressed without any explicit color segmentation. Darkness
    is then measured relative to the *local paper brightness*, estimated
    by a grayscale closing: a block-max upper envelope over `bg_window`
    px tiles (the trace is only ~3 px thick, so every tile sees paper)
    followed by a block-min over 2×`bg_window` tiles. The max pass makes
    shadows / lighting gradients irrelevant; the min pass stops anything
    brighter than the paper itself (white margins, rotation borders, a
    bright table behind a tilted strip) from inflating the envelope over
    nearby paper — without it, shadowed paper within `bg_window` px of a
    bright border reads as ink. The channel max runs on uint8 via
    pairwise np.maximum (a float conversion or an axis-reduce over the
    interleaved RGB layout each cost more than everything else in the
    digitizer combined)."""
    raw = np.asarray(image)
    if raw.ndim == 2:  # already grayscale
        bright_u8 = raw
    else:
        bright_u8 = np.maximum(
            np.maximum(raw[..., 0], raw[..., 1]), raw[..., 2]
        )
    paper = np.maximum(
        _closing(bright_u8, bg_window).astype(np.float32), 1.0
    )
    rel = (paper - bright_u8.astype(np.float32)) / paper
    return np.clip(rel, 0.0, 1.0)


def _darkness_and_colmax(
    image: np.ndarray,
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """(darkness map, None, None): the reference's native kernel also
    returns per-column and per-row maxima; callers reduce them here."""
    return darkness_map(image), None, None


def _block_min(values: np.ndarray, w: int) -> np.ndarray:
    """Per-tile minima over w×w tiles (mirror of `_block_max`)."""
    h, wid = values.shape
    ph, pw = (-h) % w, (-wid) % w
    padded = np.pad(values, ((0, ph), (0, pw)), mode="edge")
    hb, wb = padded.shape[0] // w, padded.shape[1] // w
    return padded.reshape(hb, w, wb, w).min(axis=(1, 3))


def gridness_map(
    image: np.ndarray, bg_window: int = 32
) -> Optional[np.ndarray]:
    """Per-pixel grid-line strength: local CONTRAST of R − max(G, B).

    ECG paper gridlines are light red — bright in R, dimmer in G/B — so
    raw redness (R − max(G, B)) scores them high while white paper
    (R≈G≈B) and the dark trace (R≈G≈B) score ~0. Raw redness alone also
    scores any warm surface (a wooden table, warm white balance), so the
    local background redness — a `bg_window`-tile block minimum, which
    lands on the paper between lines since lines are only a few px wide
    — is subtracted: only *line-like* local redness survives. Returns
    None for grayscale images (no color → no grid signal)."""
    raw = np.asarray(image)
    if raw.ndim != 3 or raw.shape[-1] < 3:
        return None
    r = raw[..., 0]
    gb = np.maximum(raw[..., 1], raw[..., 2])
    return _gridness_core(_redness_diff(r, gb), np.maximum(r, gb),
                          bg_window)


def _redness_diff(r: np.ndarray, gb: np.ndarray) -> np.ndarray:
    """R − max(G, B) without overflow: int16 for uint8 channels, float32
    for anything else. Float-decoded or normalized images must take the
    same grid path as uint8 ones (only the reference's native kernel is
    uint8-only) — a dtype-pinned subtract would crash them."""
    if r.dtype == np.uint8 and gb.dtype == np.uint8:
        return np.subtract(r, gb, dtype=np.int16)
    return np.asarray(r, np.float32) - np.asarray(gb, np.float32)


def _gridness_core(
    redness: np.ndarray, bright: np.ndarray, bg_window: int
) -> np.ndarray:
    """Gridness from a precomputed redness difference (R − max(G,B),
    int16/float32) and brightness (max channel) pair — see
    `gridness_map` for the semantics."""
    g = np.maximum(redness, 0).astype(np.float32)
    h, wid = g.shape
    base = np.repeat(
        np.repeat(_block_min(g, bg_window), bg_window, 0), bg_window, 1
    )[:h, :wid]
    contrast = np.maximum(g - base, 0.0)
    # illumination-normalize: grid contrast scales with local lighting
    # (a shadowed half would otherwise fall below any fixed threshold),
    # so express it relative to the local paper brightness envelope
    paper = np.maximum(
        _closing(bright, bg_window).astype(np.float32), 1.0
    )
    return 255.0 * contrast / paper


def _profile_period(
    profiles: np.ndarray, min_lag: int = 4, max_lag: Optional[int] = None,
    min_peak: float = 0.25,
) -> Optional[float]:
    """Dominant period (px) shared by a stack of 1-D profiles, from the
    SUM of their individual autocorrelations. Summing autocorrelations
    instead of profiles keeps a common period detectable when the phase
    drifts across bands (camera tilt). Sub-pixel refined by parabolic
    interpolation around the peak; None when no lag in
    [min_lag, max_lag) correlates above `min_peak` of zero-lag."""
    profiles = np.atleast_2d(np.asarray(profiles, np.float32))
    n = profiles.shape[1]
    if max_lag is None:
        max_lag = n // 4
    if max_lag <= min_lag + 1 or n < 2 * min_lag:
        return None
    p = profiles - profiles.mean(axis=1, keepdims=True)
    f = np.fft.rfft(p, 2 * n, axis=1)
    ac = np.fft.irfft(f * np.conj(f), 2 * n, axis=1)[:, :n].sum(axis=0)
    if ac[0] <= 1e-9:
        return None
    ac = ac / ac[0]
    seg = ac[min_lag:max_lag]
    # first local maximum above threshold = the fundamental pitch (a
    # global argmax could land on a harmonic, e.g. the 5 mm bold lines)
    above = np.flatnonzero(
        (seg >= min_peak)
        & (seg >= np.roll(seg, 1))
        & (seg >= np.roll(seg, -1))
    )
    above = above[(above > 0) & (above < len(seg) - 1)]
    if len(above) == 0:
        return None
    k = int(above[0]) + min_lag
    # Sub-harmonic veto: a genuine comb of period k has its next
    # autocorrelation peak one full period away (≈2k). When the true
    # pitch sits BELOW min_lag (a low-resolution photo: <4 px/mm), the
    # first reachable peak is a HARMONIC of the real grid, and the
    # row-vs-column cross-check cannot catch it (a square grid aliases
    # identically on both axes) — but the peaks are then spaced at the
    # true sub-min_lag period, much closer than k. Seeing the next peak
    # at < ~¾ k proves the fundamental is finer than we can measure:
    # downgrade to no-pitch (→ scale_source "assumed") instead of
    # shipping a 2–3× wrong voltage axis. Measured: 3×/4×/6×-downscaled
    # 10 px grids report 2–3× harmonics without this veto
    # (ecgmm_tpu/tools/digitize_envelope.py sweep).
    later = above[above > int(above[0])]
    if len(later):
        j = int(later[0]) + min_lag
        if j - k < 0.75 * k:
            return None
    # parabolic sub-pixel refinement
    y0, y1, y2 = ac[k - 1], ac[k], ac[k + 1]
    denom = y0 - 2 * y1 + y2
    delta = 0.5 * (y0 - y2) / denom if abs(denom) > 1e-12 else 0.0
    return float(k + np.clip(delta, -0.5, 0.5))


def _pitch_from_bands(
    g: np.ndarray, band_px: int
) -> Optional[float]:
    """Pitch of the horizontal gridlines from a gridness map: column
    bands `band_px` wide, per-band row profiles, summed per-band
    autocorrelation (see `estimate_grid_pitch_px`)."""
    h, w = g.shape
    if h < 16 or w < 16:
        return None
    n_bands = max(1, w // band_px)
    bands = [
        g[:, i * band_px: (i + 1) * band_px].mean(axis=1)
        for i in range(n_bands)
    ]
    return _profile_period(np.stack(bands), min_lag=4, max_lag=h // 3)


def _pool2_max(a: np.ndarray) -> np.ndarray:
    """2×2 max pool of a 2-D score map. Max pooling a REDNESS map keeps
    the thin (1–3 px) gridlines that a strided subsample or mean pool
    would thin out or erase; pooling the RGB image itself would NOT
    work (paper is brighter than the grid in every channel, so a
    channel-wise max erases the lines)."""
    h, w = a.shape[:2]
    a = a[: h - h % 2, : w - w % 2]
    return np.maximum(
        np.maximum(a[0::2, 0::2], a[0::2, 1::2]),
        np.maximum(a[1::2, 0::2], a[1::2, 1::2]),
    )


def _grid_analysis(raw: np.ndarray, band_px: int = 128):
    """Shared grid analysis at pooled resolution: returns
    (gridness-or-None, pooled brightness, scale, pitch in FULL-res px
    or None). Images ≥128 px on both sides have their redness and
    brightness maps max-pooled 2×2 first (quarter cost); sub-pixel
    autocorrelation refinement at pooled resolution keeps full-res
    pitch accuracy well under ±0.5 px."""
    pool = min(raw.shape[:2]) >= 128
    if raw.ndim != 3 or raw.shape[-1] < 3:
        bright = raw if raw.ndim == 2 else raw[..., 0]
        if pool:
            return None, _pool2_max(bright), 2, None
        return None, bright, 1, None
    scale = 2 if pool else 1
    r = raw[..., 0]
    gb = np.maximum(raw[..., 1], raw[..., 2])
    redness = _redness_diff(r, gb)
    bright = np.maximum(r, gb)
    if pool:
        redness, bright = _pool2_max(redness), _pool2_max(bright)
    g = _gridness_core(redness, bright, max(8, 32 // scale))
    pitch_s = _pitch_from_bands(g, max(16, band_px // scale))
    pitch = pitch_s * scale if pitch_s is not None else None
    return g, bright, scale, pitch


def estimate_grid_pitch_px(
    image: np.ndarray, band_px: int = 128,
) -> Optional[float]:
    """Calibration-grade vertical pixel pitch of the horizontal
    gridlines (px per 1 mm of paper), or None when the photo shows no
    TRUSTWORTHY grid.

    The gridness map of a full-resolution central slice (≤512 columns
    — resolution matters: the pooled location-grade analysis can beat
    the 1 mm grid against JPEG's 16 px chroma blocks and report a 4×
    harmonic) is split into `band_px`-wide bands; each band's per-row
    mean is one profile. Tilt shifts the gridline phase between bands
    but autocorrelation is phase-invariant, so the summed per-band
    autocorrelation keeps the pitch peak. The row pitch is then
    CROSS-CHECKED against the column pitch of the same slice: ECG grids
    are square, so a real grid agrees on both axes (measured: within
    0.1 px under shadow/noise/blur/JPEG/tilt/perspective), while
    compression-block beats and blur artifacts do not — disagreement
    > 20% (or a missing axis) returns None rather than shipping a
    confidently wrong voltage scale."""
    raw = np.asarray(image)
    if raw.ndim != 3 or raw.shape[-1] < 3:
        return None
    w = raw.shape[1]
    x0 = max(0, (w - 512) // 2)
    g = gridness_map(raw[:, x0: x0 + 512])
    if g is None:
        return None
    pitch_rows = _pitch_from_bands(g, band_px)
    pitch_cols = _pitch_from_bands(np.ascontiguousarray(g.T), band_px)
    if pitch_rows is None or pitch_cols is None:
        return None
    if abs(pitch_rows - pitch_cols) / max(pitch_rows, pitch_cols) > 0.2:
        return None
    return pitch_rows


def _largest_run(mask: np.ndarray) -> Tuple[int, int]:
    """[start, stop) of the longest True run (stop = 0 when none)."""
    idx = np.flatnonzero(mask)
    if len(idx) == 0:
        return 0, 0
    breaks = np.flatnonzero(np.diff(idx) > 1)
    starts = np.concatenate([[0], breaks + 1])
    stops = np.concatenate([breaks, [len(idx) - 1]])
    lengths = idx[stops] - idx[starts]
    k = int(np.argmax(lengths))
    return int(idx[starts[k]]), int(idx[stops[k]]) + 1


def _smooth(profile: np.ndarray, w: int) -> np.ndarray:
    w = max(3, int(w) | 1)
    return np.convolve(profile, np.full(w, 1.0 / w), mode="same")


def _brightness(raw: np.ndarray) -> np.ndarray:
    """Channel-max brightness. uint8 inputs stay uint8 — the only
    consumer (`_trim_dark_borders`) takes medians, which numpy computes
    in float64 either way, so converting up front would only add a
    full-frame float copy."""
    if raw.ndim == 3:
        m = np.maximum(np.maximum(raw[..., 0], raw[..., 1]), raw[..., 2])
    else:
        m = raw
    return m if m.dtype == np.uint8 else m.astype(np.float32)


def _trim_dark_borders(
    raw: np.ndarray, box: Tuple[int, int, int, int]
) -> Tuple[int, int, int, int]:
    """Shrink the box until no DARK background rows/columns remain at
    its borders. A few leaked rows of dark table are catastrophic
    downstream — every column's ink threshold and centroid would lock
    onto the uniformly dark border instead of the trace — while leaked
    BRIGHT background is harmless (the closing-based paper envelope
    already neutralizes brighter-than-paper regions). Paper level is
    the median brightness of the box's central half; a border row/col
    is trimmed while its median brightness is < 60% of that."""
    y0, y1, x0, x1 = box
    bright = _brightness(raw[y0:y1, x0:x1])
    bh, bw = bright.shape
    center = bright[bh // 4: bh - bh // 4 or None,
                    bw // 4: bw - bw // 4 or None]
    # medians over a 4×-subsampled axis: same robustness, quarter cost.
    # Row/column medians are evaluated LAZILY — the loops below examine
    # only border rows/columns (usually a handful), while computing the
    # full median profiles up front costs ~20 ms on a phone-camera
    # frame and dominates locate_strip
    paper = float(np.median(center[::4, ::4])) or 1.0
    row_sub = bright[:, ::4]
    col_sub = bright[::4, :]
    lim = 0.6 * paper

    def trim_it(pixels) -> bool:
        """Dark AND free of trace-strength ink. A deeply shadowed strip
        edge can fall below the 60%-of-paper brightness line while the
        trace is still perfectly legible there; trimming it would
        silently compress the signal's time axis (measured: a 0.35×
        left-shadow ramp cost the first ~190 columns and collapsed
        correlation — ecgmm_tpu/tools/digitize_envelope.py sweep). A true dark
        TABLE border is near-uniform, so its darkest percentile sits
        close to its median; ink pulls p1 far below."""
        med = float(np.median(pixels))
        if med >= lim:
            return False
        # p0.8 ≈ the 2nd-3rd darkest of a 250 px column: low enough to
        # land INSIDE a ≥2 px-thick trace (p1 would interpolate halfway
        # back up to grid brightness on gridline columns), high enough
        # that a single hot/dead pixel in a genuine table border can't
        # fake ink
        return med - float(np.percentile(pixels, 0.8)) <= 0.25 * paper

    a, b = 0, bh
    while a < b - 16 and trim_it(row_sub[a]):
        a += 1
    while b > a + 16 and trim_it(row_sub[b - 1]):
        b -= 1
    c, d = 0, bw
    while c < d - 16 and trim_it(bright[:, c]):
        c += 1
    while d > c + 16 and trim_it(bright[:, d - 1]):
        d -= 1
    return y0 + a, y0 + b, x0 + c, x0 + d


def locate_strip(
    image: np.ndarray,
) -> Optional[Tuple[int, int, int, int]]:
    """(y0, y1, x0, x1) bounding box of the ECG paper within a larger
    photo, or None when the whole frame should be used.

    Primary cue: the red grid — per-row / per-column mean gridness
    (local-contrast form, so warm backgrounds score 0), smoothed and
    thresholded relative to its own robust maximum, largest contiguous
    run. Fallback (no grid detected, e.g. a grayscale print): the large
    bright region, since paper is the brightest extended surface in a
    usable strip photo. Dark background is then trimmed off the borders
    (see `_trim_dark_borders`); a box spanning ≳95% of the frame
    returns None (use the full frame).

    Candidate-box profiling runs on the 2×2-pooled image (cheap); the
    safety passes (ink veto, dark-border trim) run at full resolution."""
    return _locate_strip_impl(np.asarray(image))[0]


def _locate_strip_impl(
    raw: np.ndarray,
) -> Tuple[
    Optional[Tuple[int, int, int, int]],
    Optional[np.ndarray],
    Optional[np.ndarray],
]:
    """`locate_strip` body returning (box, full-frame darkness map or
    None, its per-column maxima or None). The darkness map is the
    digitizer's single most expensive pass (see `darkness_map`); when
    the ink veto computed it here and the box ends up covering the
    whole frame, `digitize_lead2_info` reuses both for trace extraction
    instead of recomputing them."""
    h, w = raw.shape[:2]
    g, bright_small, scale, pitch = _grid_analysis(raw)
    rel_full: Optional[np.ndarray] = None
    col_max_full: Optional[np.ndarray] = None

    def _box_from(score: np.ndarray, frac: float, win: int):
        # thresholds are anchored at the profile's own background level
        # (p10) rather than a pure peak fraction: a shadow/vignette dims
        # one side of the strip proportionally, and the dimmed side must
        # still clear a threshold set between background and peak
        rows = _smooth(score.mean(axis=1), win)
        cols = _smooth(score.mean(axis=0), win)
        r_lo, r_hi = np.percentile(rows, [10, 90])
        c_lo, c_hi = np.percentile(cols, [10, 90])
        if r_hi <= 1e-6 or c_hi <= 1e-6:
            return None
        # background ≥ half the peak ⇒ the strip fills this axis (a
        # near-uniform profile would otherwise fragment into noise runs)
        if r_lo >= 0.5 * r_hi:
            y0, y1 = 0, score.shape[0]
        else:
            y0, y1 = _largest_run(rows >= r_lo + frac * (r_hi - r_lo))
        if c_lo >= 0.5 * c_hi:
            x0, x1 = 0, score.shape[1]
        else:
            x0, x1 = _largest_run(cols >= c_lo + frac * (c_hi - c_lo))
        if y1 - y0 < 16 or x1 - x0 < 16:
            return None
        return y0, y1, x0, x1

    box = None
    # the grid path is gated on detected PERIODICITY, not raw redness —
    # a noisy warm background can clear any redness percentile, but only
    # a real grid autocorrelates
    if pitch is not None and float(np.percentile(g, 99)) >= 8.0:
        # the gridness profile is periodic (peaks at lines, ~0 between)
        # — the smoothing window must span ≥1 pitch or the largest
        # above-threshold run is a single gridline, not the paper
        box = _box_from(g, 0.25, int(round(2 * pitch / scale)))
    if box is None:
        paper = (
            bright_small
            >= 0.85 * np.percentile(bright_small, 95)
        ).astype(np.float32)
        box = _box_from(paper, 0.55, max(bright_small.shape[:2]) // 64)
    if box is None:
        return None, rel_full, col_max_full
    # scale the pooled-coordinate candidate box back to full resolution
    y0, y1, x0, x1 = (
        box[0] * scale, min(h, box[1] * scale),
        box[2] * scale, min(w, box[3] * scale),
    )
    # a run spanning ≳80% of an axis means the strip fills that axis:
    # don't let weak tilt corners or a shadowed edge shave trace off.
    # The trim below re-removes any DARK background this re-admits;
    # re-admitted bright background is harmless (the closing-based
    # paper envelope neutralizes brighter-than-paper regions)
    if (y1 - y0) >= 0.80 * h:
        y0, y1 = 0, h
    if (x1 - x0) >= 0.80 * w:
        x0, x1 = 0, w
    # ink veto: never crop away a region that contains trace-strength
    # ink — a hard shadow + JPEG can erase the GRID's chroma on one
    # side while the dark trace survives, and cutting live trace is
    # strictly worse than keeping some background
    if x0 > 0 or x1 < w or y0 > 0 or y1 < h:
        rel_full, col_max_full, row_max_full = _darkness_and_colmax(raw)
        if col_max_full is None:
            col_max_full = rel_full.max(axis=0)
        if x0 > 0 or x1 < w:
            ink_cols = col_max_full >= 0.3
            outside = np.concatenate([ink_cols[:x0], ink_cols[x1:]])
            if outside.size and outside.mean() > 0.3:
                x0, x1 = 0, w
        if y0 > 0 or y1 < h:
            if row_max_full is None:
                # numpy fallback: the veto only consults rows OUTSIDE
                # the candidate box — reduce just those bands
                row_max_full = np.zeros(h, np.float32)
                if y0 > 0:
                    row_max_full[:y0] = rel_full[:y0].max(axis=1)
                if y1 < h:
                    row_max_full[y1:] = rel_full[y1:].max(axis=1)
            ink_rows = row_max_full >= 0.3
            outside = np.concatenate([ink_rows[:y0], ink_rows[y1:]])
            if outside.size and outside.mean() > 0.3:
                y0, y1 = 0, h
    y0, y1, x0, x1 = _trim_dark_borders(raw, (y0, y1, x0, x1))
    if (y1 - y0) >= 0.95 * h and (x1 - x0) >= 0.95 * w:
        return None, rel_full, col_max_full
    return (y0, y1, x0, x1), rel_full, col_max_full


def extract_trace(
    image: np.ndarray,
    col_frac: float = 0.6,
    abs_floor: float = 0.12,
    rel: Optional[np.ndarray] = None,
    col_max: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-column trace row (float) + validity mask from an RGB uint8
    strip photo.

    Ink segmentation is contrast-adaptive per column: the trace is the
    darkest thing in every column it crosses, so a pixel counts as ink
    when its relative darkness is ≥ `col_frac` × that column's maximum
    darkness. A fixed absolute threshold fails in both directions on
    real photos — motion blur / low resolution can smear the trace to
    half its nominal contrast (ink missed), while a slanted bright
    border next to shadowed paper produces broad mid-darkness bands
    (phantom ink admitted). The per-column rule tracks the former and
    rejects the latter.

    Column VALIDITY is strip-adaptive too: `abs_floor` alone would let
    mid-darkness artifacts (a crease shadow, pencil annotation or stain
    reads ~0.2 relative darkness) register as trace in columns the real
    trace never crosses, injecting phantom voltage excursions. The real
    trace is much darker than such artifacts in the same photo, so a
    column counts as containing trace only if its darkest pixel reaches
    40% of the strip's own trace darkness (90th percentile of column
    maxima); `abs_floor` remains the absolute minimum, so sensor noise
    on a trace-free/blank photo still never qualifies.

    `rel` (and optionally its per-column maxima `col_max`) reuse a
    precomputed `darkness_map(image)` (the digitizer's most expensive
    pass) when the caller already has one."""
    if rel is None:
        rel, col_max, _ = _darkness_and_colmax(image)
    if col_max is None:
        col_max = rel.max(axis=0)
    floor = max(abs_floor, 0.4 * float(np.percentile(col_max, 90)))
    h, w = rel.shape
    threshold = np.maximum(floor, col_frac * col_max)[None, :]
    weights = np.where(rel >= threshold, rel, 0.0)
    colsum = weights.sum(axis=0)
    valid = (col_max >= floor) & (colsum > 0)
    rows = np.arange(h, dtype=np.float32)
    centroid = np.where(
        valid,
        (weights * rows[:, None]).sum(axis=0) / np.maximum(colsum, 1e-6),
        0.0,
    )
    return centroid, valid


def interpolate_gaps(trace: np.ndarray, valid: np.ndarray) -> np.ndarray:
    if valid.all():
        return trace
    if not valid.any():
        return np.zeros_like(trace)
    x = np.arange(len(trace))
    return np.interp(x, x[valid], trace[valid])


def theil_sen_detrend(
    trace: np.ndarray, n_pairs: int = 2000, seed: int = 0
) -> Tuple[np.ndarray, float]:
    """Remove the linear baseline trend (camera tilt / perspective shear)
    with a Theil–Sen median-of-pairwise-slopes estimate — robust to QRS
    spikes and baseline wander, unlike a least-squares fit. Returns
    (detrended trace, slope px/col)."""
    n = len(trace)
    if n < 8:
        return trace, 0.0
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, n_pairs)
    j = rng.integers(0, n, n_pairs)
    keep = np.abs(i - j) > n // 8  # well-separated pairs only
    i, j = i[keep], j[keep]
    slopes = (trace[j] - trace[i]) / (j - i)
    slope = float(np.median(slopes)) if len(slopes) else 0.0
    x = np.arange(n, dtype=np.float32)
    return trace - slope * (x - x.mean()), slope


def rows_to_millivolts(
    trace_rows: np.ndarray, img_height: int,
    px_per_mv: Optional[float] = None,
) -> np.ndarray:
    """Invert (rows grow downward), centre on the median baseline, scale.
    Standard ECG paper: 10 mm/mV; the 250-px-tall reference strips span
    ~25 mm, so ≈100 px/mV by default."""
    if px_per_mv is None:
        px_per_mv = img_height * 0.4
    baseline = np.median(trace_rows)
    return (baseline - trace_rows) / px_per_mv


def resample_trace(mv: np.ndarray, target_len: int = 2476) -> np.ndarray:
    x_new = np.linspace(0, len(mv) - 1, target_len)
    return np.interp(x_new, np.arange(len(mv)), mv).astype(np.float32)


def digitize_lead2(
    image: np.ndarray, target_len: int = 2476,
    px_per_mv: Optional[float] = None,
    deskew: bool = True,
    auto_locate: bool = True,
) -> np.ndarray:
    """Full pipeline: RGB strip photo (H, W, 3) uint8 → (target_len,)
    float32 voltage series in mV.

    `auto_locate` crops to the paper region first (no-op for full-frame
    strips). When `px_per_mv` is not given, the grid pitch calibrates
    the voltage scale (10 mm/mV paper ⇒ px/mV = 10 × pitch); gridless
    photos fall back to the reference strips' fixed geometry
    (height × 0.4 ⇒ ~100 px/mV at 250 px tall).

    Raises NoTraceError when too few columns contain ink (blank,
    overexposed or non-ECG photo): digitizing that to an all-zero
    'signal' would hand the model a flat line and return a confident
    diagnosis of nothing."""
    return digitize_lead2_info(
        image, target_len, px_per_mv, deskew, auto_locate
    )[0]


def digitize_lead2_info(
    image: np.ndarray, target_len: int = 2476,
    px_per_mv: Optional[float] = None,
    deskew: bool = True,
    auto_locate: bool = True,
) -> Tuple[np.ndarray, dict]:
    """`digitize_lead2` plus a metadata dict describing HOW the photo
    was digitized, so callers (the serving API forwards it to clients)
    can warn on low-confidence digitizations:

      * ``scale_source`` — "grid" (absolute mV from the detected grid
        pitch), "explicit" (caller-supplied px_per_mv) or "assumed"
        (no grid found; reference-strip geometry assumed — voltages
        are only correct up to a scale factor);
      * ``grid_pitch_px`` — detected 1 mm pitch in px, or None;
      * ``px_per_mv`` — the voltage scale actually used;
      * ``crop`` — [y0, y1, x0, x1] strip box within the photo, or
        None when the full frame was used;
      * ``ink_fraction`` — fraction of columns with detected trace ink
        (1.0 = clean continuous trace; low values mean gaps were
        interpolated)."""
    raw = np.asarray(image)
    pitch = None
    box = None
    rel_full = col_max_full = None
    if auto_locate:
        box, rel_full, col_max_full = _locate_strip_impl(raw)
        if box is not None:
            y0, y1, x0, x1 = box
            raw = raw[y0:y1, x0:x1]
            # the crop changes the frame (and the paper-envelope block
            # alignment); recompute darkness on the much smaller crop
            rel_full = col_max_full = None
    if px_per_mv is not None:
        # reject rather than fall back: a falsy/garbage explicit scale
        # silently replaced by the assumed geometry would be recorded
        # as scale_source="explicit" — an audit would show calibrated
        # voltages that are actually assumed-scale (or sign-flipped)
        if not (np.isfinite(px_per_mv) and px_per_mv > 0):
            raise ValueError(
                f"px_per_mv must be a positive finite number, got "
                f"{px_per_mv!r}; omit it to calibrate from the grid"
            )
        scale_source = "explicit"
    else:
        # calibration-grade pitch, measured on the (cropped) strip so
        # background never pollutes the slice; cross-checked row vs
        # column (see estimate_grid_pitch_px) so a degraded photo
        # downgrades to "assumed" instead of shipping a wrong scale
        pitch = estimate_grid_pitch_px(raw)
        if pitch is not None:
            px_per_mv = 10.0 * pitch
            scale_source = "grid"
        else:
            scale_source = "assumed"
    trace, valid = extract_trace(raw, rel=rel_full, col_max=col_max_full)
    if valid.mean() < 0.05:
        raise NoTraceError(
            f"no ECG trace found in the image (ink in "
            f"{100 * valid.mean():.1f}% of columns) — is this a photo "
            "of an ECG strip?"
        )
    trace = interpolate_gaps(trace, valid)
    if deskew:
        trace, _ = theil_sen_detrend(trace)
    mv = rows_to_millivolts(trace, raw.shape[0], px_per_mv)
    info = {
        "scale_source": scale_source,
        "grid_pitch_px": None if pitch is None else round(float(pitch), 2),
        "px_per_mv": round(
            float(raw.shape[0] * 0.4 if px_per_mv is None else px_per_mv),
            2,
        ),
        "crop": None if box is None else [int(v) for v in box],
        "ink_fraction": round(float(valid.mean()), 3),
    }
    return resample_trace(mv, target_len), info
