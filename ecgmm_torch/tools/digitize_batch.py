"""Bulk strip-photo digitization -> training-format signal table (port of
`ecgmm_tpu/tools/digitize_batch.py`, the `ecgmm-digitize` CLI).

The serving digitizer (`serve/digitize.py`: strip auto-location,
red-grid suppression, grid-pitch absolute-mV calibration) over a
directory of `{idx}.png|jpg|jpeg|bmp` photos, decoded by the port's
upload decoder with the EXIF orientation applied (`serve/imdecode.py`),
writes:

  * `ecg_signals.csv`: one row per patient id, `target_len` samples,
    readable by `sources.load_hospital_tables` (index_col=0);
  * an optional per-image quality report (scale source, grid pitch,
    px/mV, ink coverage, crop, error).

Photos with no discernible trace are logged (`error` column) and left out
of the signal table; `--strict` turns any failure into an error. No
pandas: both tables are written in the layout and number format of
pandas' `to_csv` of JAX's frames (float32 samples as numpy prints them,
the report's floats as float64, NaN as an empty field).

    python -m ecgmm_torch.tools.digitize_batch strips/ -o ecg_signals.csv \
        --report quality.csv
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ecgmm_torch.serve import digitize
from ecgmm_torch.serve.imdecode import decode_upload

_EXTS = (".png", ".jpg", ".jpeg", ".bmp")
REPORT_COLUMNS = ("index", "file", "scale_source", "grid_pitch_px",
                  "px_per_mv", "ink_fraction", "cropped", "error")


def _find_images(image_dir: str) -> List[Tuple[int, str]]:
    out = []
    for f in os.listdir(image_dir):
        stem, ext = os.path.splitext(f)
        if ext.lower() in _EXTS and stem.isdigit():
            out.append((int(stem), os.path.join(image_dir, f)))
    out.sort()
    # two files of one patient id (3.jpg and 3.png): which one is the
    # patient's strip is ambiguous, so refuse rather than guess
    dups = sorted({
        idx for (idx, _), (jdx, _) in zip(out, out[1:]) if idx == jdx
    })
    if dups:
        raise ValueError(
            f"duplicate numeric stems in {image_dir!r} for patient id(s) "
            f"{dups}: multiple files share an id (e.g. 3.jpg and 3.png) "
            "— remove or rename the extras so each patient has exactly "
            "one strip image"
        )
    return out


def digitize_directory(
    image_dir: str,
    target_len: int = 2476,
    strict: bool = False,
    px_per_mv: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray, List[Dict]]:
    """Digitize every `{idx}.<ext>` strip photo in `image_dir`.

    Returns (index, signals, report): the patient ids (int64) and their
    (n, target_len) float32 signals, in id order, of the images that
    digitized; and one report dict per found image (REPORT_COLUMNS), its
    `error` empty where digitization succeeded."""
    found = _find_images(image_dir)
    if not found:
        raise FileNotFoundError(
            f"no numeric-stem images ({'/'.join(_EXTS)}) in {image_dir!r}"
        )
    ids, rows, report = [], [], []
    for idx, path in found:
        rec = {"index": idx, "file": os.path.basename(path),
               "scale_source": "", "grid_pitch_px": np.nan,
               "px_per_mv": np.nan, "ink_fraction": np.nan,
               "cropped": False, "error": ""}
        try:
            with open(path, "rb") as f:
                img = decode_upload(f.read())
            mv, info = digitize.digitize_lead2_info(
                img, target_len=target_len, px_per_mv=px_per_mv
            )
            ids.append(idx)
            rows.append(np.asarray(mv, np.float32))
            rec.update(
                scale_source=info["scale_source"],
                grid_pitch_px=(np.nan if info["grid_pitch_px"] is None
                               else info["grid_pitch_px"]),
                px_per_mv=info["px_per_mv"],
                ink_fraction=info["ink_fraction"],
                cropped=info["crop"] is not None,
            )
        except Exception as e:  # noqa: BLE001 — per-file isolation
            if strict:
                raise RuntimeError(f"{path}: {e}") from e
            rec["error"] = str(e)
        report.append(rec)
    signals = (np.stack(rows) if rows
               else np.zeros((0, target_len), np.float32))
    return np.asarray(ids, np.int64), signals, report


def _field(v) -> str:
    """One value as pandas' `to_csv` writes it."""
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, np.float32):
        return "" if np.isnan(v) else str(v)
    if isinstance(v, (float, np.floating)):
        return "" if np.isnan(v) else str(np.float64(v))
    return str(v)


def write_signals_csv(path: str, index: np.ndarray,
                      signals: np.ndarray) -> None:
    """The signal table as pandas writes JAX's frame: a header of the
    column numbers after an empty index name, then one row per id."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        if len(index) == 0:
            f.write('""\n')
            return
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + [str(j) for j in range(signals.shape[1])])
        for idx, row in zip(index, signals.astype(np.float32)):
            w.writerow([str(int(idx))] + [_field(v) for v in row])


def write_report_csv(path: str, report: List[Dict]) -> None:
    """The quality report as pandas writes JAX's frame (index `index`)."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(REPORT_COLUMNS)
        for rec in report:
            w.writerow([_field(rec[c]) for c in REPORT_COLUMNS])


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("image_dir", help="directory of {idx}.png|jpg strips")
    p.add_argument("-o", "--out", default="ecg_signals.csv",
                   help="output signal table (hospital format)")
    p.add_argument("--report", default=None,
                   help="also write the per-image quality report CSV")
    p.add_argument("--target-len", type=int, default=2476)
    p.add_argument("--px-per-mv", type=float, default=None,
                   help="override the voltage scale instead of "
                        "grid-calibrating per image")
    p.add_argument("--strict", action="store_true",
                   help="fail on the first undigitizable image")
    args = p.parse_args(argv)
    if args.px_per_mv is not None and not (
        np.isfinite(args.px_per_mv) and args.px_per_mv > 0
    ):
        # once here, not once per file as N identical report errors
        p.error(f"--px-per-mv must be > 0, got {args.px_per_mv}")

    index, signals, report = digitize_directory(
        args.image_dir, target_len=args.target_len, strict=args.strict,
        px_per_mv=args.px_per_mv,
    )
    write_signals_csv(args.out, index, signals)
    n_bad = sum(r["error"] != "" for r in report)
    n_assumed = sum(r["scale_source"] == "assumed" for r in report)
    print(f"digitized {len(index)}/{len(report)} strips → {args.out} "
          f"({n_bad} failed, {n_assumed} assumed-scale)")
    if args.report:
        write_report_csv(args.report, report)
        print(f"quality report → {args.report}")


if __name__ == "__main__":
    main()
