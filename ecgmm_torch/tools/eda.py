"""Exploratory data analysis and cohort statistics (port of
`ecgmm_tpu/tools/eda.py`, the `ecgmm-eda` CLI), without pandas:
  * cohort_table: per-group mean±std or top category with its %, the
    missing %, and a Welch t-test or chi² test against the label
    (clinical_analysis.ipynb cells 1-14);
  * ptbxl_label_stats: label distribution, AFIB ratio, age/weight
    t-tests (ptb_xl_eda.py:10-99);
  * image_size_audit: image dimension inventory (image_anaylsis.py:6-16),
    read from the image headers by the port's decoder where it can;
  * signal_merge_report: the missing-signal log (signal_analysis.py:8-27).

The tables are columns of numpy arrays (`data.sources.Table`, or any
mapping of column name to array) and the results lists of row dicts with
JAX's keys. The statistics equal JAX's; the printed tables are laid out
by `format_rows`, not by pandas' `to_string`.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Sequence

import numpy as np
from scipy import stats


def _missing(values: np.ndarray) -> np.ndarray:
    """pandas' isna: NaN floats, None and NaN objects."""
    v = np.asarray(values)
    if v.dtype.kind == "f":
        return np.isnan(v)
    if v.dtype.kind == "O":
        return np.asarray([x is None or (isinstance(x, float) and x != x)
                           for x in v], bool)
    return np.zeros(len(v), bool)


def _column(table, name: str) -> np.ndarray:
    return np.asarray(table[name])


def cohort_table(table, label_col: str, numeric_cols: Sequence[str],
                 categorical_cols: Sequence[str] = ()) -> List[Dict]:
    """Per-label-group summary with significance tests: Welch's t-test
    for numeric columns, chi² for categorical; includes missing-%. One
    dict per variable (variable, type, group_<g>..., missing_%,
    p_value where a test applies)."""
    labels = _column(table, label_col)
    lab_ok = ~_missing(labels)
    groups = [labels.dtype.type(g)
              for g in sorted(set(labels[lab_ok].tolist()))]
    rows = []
    for col in numeric_cols:
        values = _column(table, col).astype(np.float64)
        row: Dict[str, object] = {"variable": col, "type": "numeric"}
        samples = []
        for g in groups:
            vals = values[lab_ok & (labels == g)]
            vals = vals[~np.isnan(vals)]
            mean = vals.mean() if len(vals) else np.nan
            std = vals.std(ddof=1) if len(vals) > 1 else np.nan
            row[f"group_{g}"] = f"{mean:.2f}±{std:.2f}"
            samples.append(vals)
        row["missing_%"] = 100.0 * float(np.isnan(values).mean())
        if len(samples) == 2 and all(len(s) > 1 for s in samples):
            row["p_value"] = stats.ttest_ind(
                samples[0], samples[1], equal_var=False).pvalue
        rows.append(row)
    for col in categorical_cols:
        values = _column(table, col)
        row = {"variable": col, "type": "categorical"}
        ok = lab_ok & ~_missing(values)
        cats = sorted(set(values[ok].tolist()))
        present = [g for g in groups if np.any(ok & (labels == g))]
        ct = np.asarray([[int(np.sum(ok & (values == c) & (labels == g)))
                          for g in present] for c in cats], np.int64)
        ct = ct.reshape(len(cats), len(present))
        for j, g in enumerate(present):
            top = cats[int(np.argmax(ct[:, j]))]
            pct = 100.0 * ct[:, j].max() / max(ct[:, j].sum(), 1)
            row[f"group_{g}"] = f"{top} ({pct:.0f}%)"
        row["missing_%"] = 100.0 * float(_missing(values).mean())
        if ct.shape[0] > 1 and ct.shape[1] > 1:
            row["p_value"] = stats.chi2_contingency(ct).pvalue
        rows.append(row)
    return rows


def ptbxl_label_stats(manifest, meta=None) -> Dict:
    """AFIB-vs-rhythm cohort stats (ptb_xl_eda.py): class counts, AFIB
    ratio, and, where per-record metadata is given (rows aligned with
    the manifest's), age/weight Welch t-tests between the classes."""
    labels = _column(manifest, "label")
    n = int(len(labels))
    values, counts = np.unique(labels, return_counts=True)
    order = np.argsort(-counts, kind="stable")  # value_counts' order
    counted = {int(values[i]): int(counts[i]) for i in order}
    out: Dict[str, object] = {
        "n": n,
        "counts": counted,
        "afib_ratio": float(counted.get(1, 0)) / max(n, 1),
    }
    if meta is not None:
        meta_n = len(_column(meta, next(iter(_names(meta)))))
        if meta_n != n:
            raise ValueError(
                f"meta has {meta_n} rows but manifest has {n} — pass "
                "per-record metadata aligned with the manifest rows")
        is_af = labels == 1
        for col in ("age", "weight"):
            if col in _names(meta):
                vals = _column(meta, col).astype(np.float64)
                a = vals[is_af][~np.isnan(vals[is_af])]
                b = vals[~is_af][~np.isnan(vals[~is_af])]
                if len(a) > 1 and len(b) > 1:
                    t = stats.ttest_ind(a, b, equal_var=False)
                    out[f"{col}_ttest_p"] = float(t.pvalue)
    return out


def _names(table) -> List[str]:
    return list(table.columns) if hasattr(table, "columns") else list(table)


def _jpeg_size(data: bytes):
    """(width, height) from a JPEG's first frame header, or None."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return None
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        length = struct.unpack_from(">H", data, pos + 2)[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if pos + 9 > len(data):
                return None
            h, w = struct.unpack_from(">HH", data, pos + 5)
            return (w, h) if h else None
        pos += 2 + length
    return None


def image_size(path: str):
    """(width, height) of a JPEG or PNG: from its header where it is
    there (a JPEG's frame header, a PNG's IHDR), else by decoding it
    with the port's decoder (`serve/imdecode.decode_image`)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR":
        return struct.unpack_from(">II", data, 16)
    if data[:2] == b"\xff\xd8":
        size = _jpeg_size(data)
        if size is not None:
            return size
    from ecgmm_torch.serve.imdecode import decode_image

    h, w = decode_image(data).shape[:2]
    return w, h


def image_size_audit(image_dir: str) -> List[Dict]:
    """Dimension inventory of every patient image (image_anaylsis.py:
    6-16): one dict (index, file, width, height) per .jpg/.jpeg/.png in
    each subdirectory."""
    rows: List[Dict] = []
    for d in sorted(os.listdir(image_dir)):
        sub = os.path.join(image_dir, d)
        if not os.path.isdir(sub):
            continue
        for f in os.listdir(sub):
            if f.lower().endswith((".jpg", ".jpeg", ".png")):
                w, h = image_size(os.path.join(sub, f))
                rows.append({"index": d, "file": f, "width": int(w),
                             "height": int(h)})
    return rows


def size_distribution(rows: List[Dict]) -> Dict[tuple, int]:
    """{(width, height): count}, sorted by size (pandas' groupby)."""
    out: Dict[tuple, int] = {}
    for r in rows:
        key = (r["width"], r["height"])
        out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items()))


def signal_merge_report(frame, missing: List[int]) -> str:
    """`frame`: the merged signals, an (n_rows, n_samples) array or
    anything with a 2-D `shape`."""
    rows, samples = np.shape(frame)[:2]
    lines = [
        f"merged signals: {rows} rows × {samples} samples",
        f"missing ids ({len(missing)}): {missing}",
    ]
    return "\n".join(lines)


def format_rows(rows: List[Dict]) -> str:
    """Rows of dicts as a text table: the columns in order of first
    appearance, each right-aligned to its widest cell, NaN for a missing
    cell."""
    cols: List[str] = []
    for r in rows:
        cols += [k for k in r if k not in cols]

    def cell(v) -> str:
        if v is None:
            return "NaN"
        if isinstance(v, (float, np.floating)):
            return "NaN" if np.isnan(v) else f"{float(v):g}"
        return str(v)

    cells = [[cell(r.get(c)) for c in cols] for r in rows]
    widths = [max([len(c)] + [len(row[j]) for row in cells])
              for j, c in enumerate(cols)]
    lines = [" ".join(c.rjust(w) for c, w in zip(cols, widths))]
    lines += [" ".join(v.rjust(w) for v, w in zip(row, widths))
              for row in cells]
    return "\n".join(lines)


def main(argv=None):
    """CLI mirroring the reference's runnable analysis scripts
    (`python ptb_xl_eda.py`, `python image_anaylsis.py`, the
    clinical_analysis notebook):

        python -m ecgmm_torch.tools.eda cohort clinical.csv --label label
        python -m ecgmm_torch.tools.eda ptbxl ./data/ptbxl
        python -m ecgmm_torch.tools.eda images ./data/images
    """
    import argparse
    import json

    from ecgmm_torch.data.sources import load_ptbxl_manifest, read_csv

    p = argparse.ArgumentParser(
        description=main.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("cohort", help="per-group stats + significance")
    c.add_argument("clinical_csv")
    c.add_argument("--label", default="label")
    c.add_argument("--numeric", default="AGE,Wt",
                   help="comma list of numeric columns")
    c.add_argument("--categorical", default="",
                   help="comma list of categorical columns")

    x = sub.add_parser("ptbxl", help="PTB-XL AFIB-vs-rhythm label stats")
    x.add_argument("data_dir", help="dir containing ptbxl_database.csv")

    i = sub.add_parser("images", help="image dimension inventory")
    i.add_argument("image_dir")

    args = p.parse_args(argv)
    if args.cmd == "cohort":
        table = read_csv(args.clinical_csv)
        out = cohort_table(
            table, args.label,
            [s for s in args.numeric.split(",") if s],
            [s for s in args.categorical.split(",") if s],
        )
        print(format_rows(out))
    elif args.cmd == "ptbxl":
        manifest = load_ptbxl_manifest(args.data_dir)
        # the manifest carries age/weight aligned, for the reference's
        # between-class t-tests (ptb_xl_eda.py)
        meta = (manifest if {"age", "weight"} & set(manifest.columns)
                else None)
        print(json.dumps(ptbxl_label_stats(manifest, meta), indent=1))
    elif args.cmd == "images":
        out = image_size_audit(args.image_dir)
        print(format_rows(out))
        if out:
            print("\nsize distribution:")
            print(format_rows([{"width": w, "height": h, "count": n}
                               for (w, h), n in
                               size_distribution(out).items()]))


if __name__ == "__main__":
    main()
