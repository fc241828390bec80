"""Host-side readers of the record layouts the trainers take (port of
`ecgmm_tpu/data/sources.py`, without pandas): the hospital trimodal
directory (a labels workbook, `clinical.csv`, `ecg_signals.csv` and one
image folder per patient, reference dataset.py:118-213), per-record
signal CSVs (signal_analysis.py:16-38), PTB-XL
(train_signal_only_ptb.py:178-228), PhysioNet/CinC 2017
(train_physionet.py:86-107) and per-patient 12-lead workbooks
(train_signal_12_af.py:52-59).

Tables come back as a `Table`: named numpy columns beside an integer row
index, with the few operations the loaders use. CSV goes through the
standard library's `csv`; an `.xlsx` workbook through `zipfile` and
`xml.etree` (its first sheet: shared strings, inline strings, numbers).
Column types follow pandas' inference: integers, else floats (an empty
cell is NaN), else strings. Images go through the port's upload decoder
(`serve/imdecode.py`) and the Pillow-exact bilinear resize
(`native.resize_bilinear_u8`). WFDB records are read natively: formats
16, 32, 212, 80 and 24, the `fmt+offset` spec, and v4 `.mat` files.
"""

from __future__ import annotations

import ast
import csv
import os
import re
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple
from xml.etree import ElementTree

import numpy as np

from ecgmm_torch import native


# ---------------------------------------------------------------------------
# The table type
# ---------------------------------------------------------------------------

def column_array(values) -> np.ndarray:
    """A column of cell values (str, int, float or None) as pandas infers
    it: int64 when every cell is an integer, float64 when every cell is a
    number or empty (empty -> NaN), else an object array of the cells."""
    vals = list(values)
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, bool)
           for v in vals):
        return np.asarray(vals, np.int64).reshape(len(vals))
    if all(v is None or (isinstance(v, (int, float, np.number))
                         and not isinstance(v, bool)) for v in vals):
        return np.asarray([np.nan if v is None else v for v in vals],
                          np.float64).reshape(len(vals))
    out = np.empty(len(vals), object)
    out[:] = vals
    return out


def _typed_cells(strings: np.ndarray) -> np.ndarray:
    """One CSV column of strings, typed as `column_array` types it."""
    try:
        return strings.astype(np.int64)
    except ValueError:
        pass
    empty = strings == ""
    try:
        return np.where(empty, "nan", strings).astype(np.float64)
    except ValueError:
        out = strings.astype(object)
        out[empty] = np.nan
        return out


class Table:
    """Named numpy columns over rows labelled by an integer `index` (a
    RangeIndex unless `set_index` or `read_csv(index_col=0)` set it)."""

    def __init__(self, columns: Dict[str, np.ndarray],
                 index: Optional[np.ndarray] = None):
        self.data = {str(k): np.asarray(v) for k, v in columns.items()}
        n = len(next(iter(self.data.values()))) if self.data else (
            0 if index is None else len(index))
        if any(len(v) != n for v in self.data.values()):
            raise ValueError("columns of different lengths")
        self.index = (np.arange(n, dtype=np.int64) if index is None
                      else np.asarray(index))

    @property
    def columns(self) -> List[str]:
        return list(self.data)

    def __len__(self) -> int:
        return len(self.index)

    def __contains__(self, name: str) -> bool:
        return name in self.data

    def __getitem__(self, name: str) -> np.ndarray:
        return self.data[name]

    def __setitem__(self, name: str, values) -> None:
        values = np.asarray(values)
        if len(values) != len(self):
            raise ValueError(f"column {name!r} has {len(values)} rows, the "
                             f"table {len(self)}")
        self.data[name] = values

    def select(self, names: Sequence[str]) -> "Table":
        return Table({k: self.data[k] for k in names}, self.index)

    def rename(self, mapping: Dict[str, str]) -> "Table":
        return Table({mapping.get(k, k): v for k, v in self.data.items()},
                     self.index)

    def drop(self, name: str) -> "Table":
        return Table({k: v for k, v in self.data.items() if k != name},
                     self.index)

    def rows(self, keep: np.ndarray) -> "Table":
        """The rows where the boolean `keep` holds, or those at the
        positions `keep` lists, in that order, with their index labels."""
        return Table({k: v[keep] for k, v in self.data.items()},
                     self.index[keep])

    def reset_index(self) -> "Table":
        return Table(self.data)

    def set_index(self, name: str) -> "Table":
        return Table({k: v for k, v in self.data.items() if k != name},
                     self.data[name])

    def loc(self, labels) -> "Table":
        """The rows whose index labels are `labels`, in that order (each
        label must occur once)."""
        pos = {int(v): i for i, v in enumerate(self.index)}
        try:
            rows = np.asarray([pos[int(v)] for v in labels], np.int64)
        except KeyError as e:
            raise KeyError(f"index label {e.args[0]} not in the table") \
                from None
        return self.rows(rows)

    def to_numpy(self, dtype=None) -> np.ndarray:
        """The columns as an (n_rows, n_columns) array."""
        if not self.data:
            return np.zeros((len(self), 0), dtype or np.float64)
        return np.stack([np.asarray(v, dtype) if dtype is not None else v
                         for v in self.data.values()], axis=1)


# ---------------------------------------------------------------------------
# Tabular readers
# ---------------------------------------------------------------------------

def read_csv(path: str, header: bool = True,
             names: Optional[Sequence[str]] = None,
             index_col: Optional[int] = None) -> Table:
    """A CSV file as a Table. `header=False` reads every line as data,
    naming the columns `names` or 0, 1, ...; `index_col=0` takes the first
    column as the integer row index (pandas' `index_col=0`)."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        lines = [r for r in csv.reader(f) if r]
    if header:
        head, body = (lines[0] if lines else []), lines[1:]
    else:
        head, body = None, lines
    width = max([len(head or [])] + [len(r) for r in body])
    cells = np.full((len(body), width), "", dtype=object)
    for i, r in enumerate(body):
        cells[i, :len(r)] = r
    cells = cells.astype(str) if body else np.zeros((0, width), str)
    if names is not None:
        head = list(names)
    elif head is None:
        head = [str(j) for j in range(width)]
    head = list(head) + [f"Unnamed: {j}" for j in range(len(head), width)]
    index = None
    cols = {}
    for j, name in enumerate(head):
        col = _typed_cells(cells[:, j])
        if index_col is not None and j == index_col:
            index = col
        else:
            cols[name] = col
    return Table(cols, index)


_XLSX_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main",
            "r": "http://schemas.openxmlformats.org/officeDocument/2006/"
                 "relationships",
            "pr": "http://schemas.openxmlformats.org/package/2006/"
                  "relationships"}


def _xlsx_number(text: str):
    # openpyxl's cast: a '.' or an exponent makes a float, else an int
    if "." in text or "E" in text or "e" in text:
        return float(text)
    return int(text)


def _column_number(ref: str) -> int:
    n = 0
    for ch in re.match(r"[A-Z]+", ref).group(0):
        n = n * 26 + ord(ch) - 64
    return n - 1


def read_xlsx(path: str) -> Table:
    """The first sheet of an `.xlsx` workbook as a Table, its first row the
    header: shared and inline strings, numbers, booleans and formula
    results (their cached values), read with `zipfile` and `xml.etree`."""
    m = "{%s}" % _XLSX_NS["m"]
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        shared: List[str] = []
        if "xl/sharedStrings.xml" in names:
            root = ElementTree.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.iter(m + "si"):
                shared.append("".join(t.text or "" for t in si.iter(m + "t")))
        sheet = "xl/worksheets/sheet1.xml"
        if "xl/workbook.xml" in names and \
                "xl/_rels/workbook.xml.rels" in names:
            wb = ElementTree.fromstring(z.read("xl/workbook.xml"))
            first = next(wb.iter(m + "sheet"), None)
            rels = ElementTree.fromstring(z.read("xl/_rels/workbook.xml.rels"))
            rid = None if first is None else first.get(
                "{%s}id" % _XLSX_NS["r"])
            for rel in rels.iter("{%s}Relationship" % _XLSX_NS["pr"]):
                if rel.get("Id") == rid:
                    target = rel.get("Target").lstrip("/")
                    sheet = target if target.startswith("xl/") \
                        else "xl/" + target
        root = ElementTree.fromstring(z.read(sheet))
    grid: Dict[int, Dict[int, object]] = {}
    for r_i, row in enumerate(root.iter(m + "row")):
        r = int(row.get("r", r_i + 1)) - 1
        for c_i, c in enumerate(row.iter(m + "c")):
            ref = c.get("r")
            col = _column_number(ref) if ref else c_i
            kind = c.get("t", "n")
            v = c.find(m + "v")
            if kind == "inlineStr":
                is_ = c.find(m + "is")
                value = "" if is_ is None else "".join(
                    t.text or "" for t in is_.iter(m + "t"))
            elif v is None or v.text is None:
                value = None
            elif kind == "s":
                value = shared[int(v.text)]
            elif kind in ("str", "e"):
                value = v.text
            elif kind == "b":
                value = bool(int(v.text))
            else:
                value = _xlsx_number(v.text)
            grid.setdefault(r, {})[col] = value
    if not grid:
        return Table({})
    rows = sorted(grid)
    width = max(max(cells) for cells in grid.values()) + 1
    head = [grid[rows[0]].get(j) for j in range(width)]
    head = [f"Unnamed: {j}" if h is None else str(h)
            for j, h in enumerate(head)]
    body = [grid[r] for r in rows[1:]]
    return Table({name: column_array(cells.get(j) for cells in body)
                  for j, name in enumerate(head)})


def read_table(path: str) -> Table:
    """Read an `.xlsx` workbook or a CSV file. For an `.xlsx` (or `.xls`)
    path that does not exist, a same-named `.csv` sibling is read, as the
    JAX package reads it (reference dataset.py:127 reads labels with
    pd.read_excel)."""
    if path.endswith((".xlsx", ".xls")):
        csv_path = os.path.splitext(path)[0] + ".csv"
        if not os.path.exists(path) and os.path.exists(csv_path):
            return read_csv(csv_path)
        return read_xlsx(path)
    return read_csv(path)


def load_hospital_tables(label_file: str, clinical_file: str, ecg_csv: str
                         ) -> Tuple[Table, Table, Table]:
    """The three tables of a hospital directory (reference
    dataset.py:127-142): the labels; the clinical table without its `ECG`
    column and with `IDX` renamed `index`; the signals, one row a patient,
    indexed by the first column."""
    labels = read_table(label_file)
    clinical = read_table(clinical_file)
    if "ECG" in clinical:
        clinical = clinical.drop("ECG")
    if "IDX" in clinical:
        clinical = clinical.rename({"IDX": "index"})
    clinical["index"] = clinical["index"].astype(np.int64)
    ecg = read_csv(ecg_csv, index_col=0)
    ecg.index = ecg.index.astype(np.int64)
    return labels, clinical, ecg


def list_image_indices(image_dir: str) -> set:
    """Patient ids that have an image folder (reference dataset.py:144)."""
    if not os.path.isdir(image_dir):
        return set()
    return {int(d) for d in os.listdir(image_dir) if d.isdigit()}


def image_path(image_dir: str, idx: int) -> str:
    """images/{idx}/{idx:03d}ECG_lead2.jpg (reference dataset.py:58-60)."""
    return os.path.join(image_dir, str(idx),
                        f"{str(idx).zfill(3)}ECG_lead2.jpg")


def load_images(image_dir: str, indices: Sequence[int],
                hw: Tuple[int, int] = (224, 224)) -> np.ndarray:
    """Decode and resize each patient's lead-II image to (N, H, W, 3)
    uint8: the port's decoder (RGB, no EXIF turn, as Pillow's
    `Image.open(p).convert("RGB")`), then Pillow's bilinear resize, bit for
    bit. Files decode on a thread pool (the native stages release the
    interpreter lock)."""
    from ecgmm_torch.serve.imdecode import decode_image

    out = np.empty((len(indices), hw[0], hw[1], 3), np.uint8)

    def decode(i_idx):
        i, idx = i_idx
        path = image_path(image_dir, idx)
        with open(path, "rb") as f:
            data = f.read()
        try:
            rgb = decode_image(data)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        out[i] = native.resize_bilinear_u8(rgb, hw)

    with ThreadPoolExecutor() as pool:
        list(pool.map(decode, enumerate(indices)))
    return out


def merge_signal_csvs(signal_dir: str, out_csv: Optional[str] = None
                      ) -> Tuple[Table, List[int]]:
    """Merge `{idx}.csv` files (headerless, the first column the samples)
    into one Table indexed by id, one row a record, and list the missing
    ids: every gap in 1..max(id) and every file that fails to parse
    (reference signal_analysis.py:14-38). Records of different lengths are
    right-padded with NaN."""
    ids = sorted(int(os.path.splitext(f)[0]) for f in os.listdir(signal_dir)
                 if f.endswith(".csv") and os.path.splitext(f)[0].isdigit())
    missing = (sorted(set(range(1, max(ids) + 1)) - set(ids)) if ids
               else [])
    rows: Dict[int, np.ndarray] = {}
    for idx in ids:
        try:
            col = read_csv(os.path.join(signal_dir, f"{idx}.csv"),
                           header=False)["0"]
            rows[idx] = np.asarray(col, np.float32)
        except Exception:
            missing.append(idx)
    width = max((len(r) for r in rows.values()), default=0)
    mat = np.full((len(rows), width), np.nan, np.float32)
    for i, r in enumerate(rows.values()):
        mat[i, :len(r)] = r
    frame = Table({str(j): mat[:, j] for j in range(width)},
                  np.asarray(list(rows), np.int64))
    if out_csv:
        with open(out_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow([""] + frame.columns)
            for idx, row in zip(frame.index, mat):
                w.writerow([int(idx)] + [repr(float(v)) for v in row])
    return frame, missing


LEAD_PERMUTATION = (0, 4, 8, 5, 1, 9, 2, 6, 10, 3, 7, 11)


def load_12lead_xlsx(path_fmt: str, indices: Sequence[int]) -> np.ndarray:
    """Per-patient `{idx}_12leads.xlsx` -> (N, 12, T) float32: the columns
    Lead_1..Lead_12 selected by name (or a file of exactly 12 columns),
    transposed and reordered by the reference's lead permutation
    (train_signal_12_af.py:52-59)."""
    lead_cols = [f"Lead_{i}" for i in range(1, 13)]
    mats = []
    for idx in indices:
        path = path_fmt.format(idx=idx)
        table = read_table(path)
        if all(c in table for c in lead_cols):
            table = table.select(lead_cols)
        elif len(table.columns) != 12:
            raise ValueError(
                f"{path}: expected Lead_1..Lead_12 columns or exactly 12 "
                f"columns, got {table.columns[:14]}")
        mats.append(table.to_numpy(np.float32).T[list(LEAD_PERMUTATION)])
    return np.stack(mats)


# ---------------------------------------------------------------------------
# WFDB records
# ---------------------------------------------------------------------------

class WFDBHeader(NamedTuple):
    record_name: str
    n_sig: int
    fs: float
    n_samples: int
    file_names: List[str]
    formats: List[int]
    gains: List[float]
    baselines: List[int]
    sig_names: List[str]
    # leading bytes to skip in each signal file (the fmt '+offset'
    # modifier, e.g. CinC 2017's '16+24' past the .mat container header)
    offsets: Sequence[int] = ()
    units: Sequence[str] = ()


def read_wfdb_header(hea_path: str) -> WFDBHeader:
    """Parse a WFDB `.hea` file: the record line, then one line a signal
    with `fmt[+offset]` and `gain[(baseline)][/units]`. A gain of 0 means
    the default 200 adu/mV; without a parenthesised baseline the baseline
    is the ADC-zero field."""
    with open(hea_path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    rec = lines[0].split()
    record_name, n_sig = rec[0], int(rec[1])
    fs = float(rec[2].split("/")[0]) if len(rec) > 2 else 250.0
    n_samples = int(rec[3]) if len(rec) > 3 else 0
    file_names, formats, gains, baselines, names = [], [], [], [], []
    offsets: List[int] = []
    units: List[str] = []
    for ln in lines[1:1 + n_sig]:
        parts = ln.split()
        file_names.append(parts[0])
        fm = re.fullmatch(r"(\d+)(?:\+(\d+))?", parts[1])
        if not fm:  # the xN and :skew modifiers change the byte layout
            raise NotImplementedError(
                f"WFDB format spec {parts[1]!r} (xN/:skew modifiers) not "
                "supported")
        formats.append(int(fm.group(1)))
        offsets.append(int(fm.group(2) or 0))
        gain_field = parts[2] if len(parts) > 2 else "200"
        m = re.match(r"([-\d.e+]+)(?:\(([-\d]+)\))?", gain_field)
        gain = float(m.group(1)) if m else 200.0
        gains.append(gain if gain != 0.0 else 200.0)
        if m and m.group(2):
            baseline = int(m.group(2))
        elif len(parts) > 4:
            baseline = int(float(parts[4]))
        else:
            baseline = 0
        baselines.append(baseline)
        unit = gain_field.split("/", 1)[1] if "/" in gain_field else "mV"
        units.append(unit)
        names.append(parts[-1])
    return WFDBHeader(record_name, n_sig, fs, n_samples, file_names, formats,
                      gains, baselines, names, offsets, units)


def _read_digital(path: str, fmt: int, off: int) -> np.ndarray:
    if fmt == 16:
        return np.fromfile(path, "<i2", offset=off).astype(np.float64)
    if fmt == 32:
        return np.fromfile(path, "<i4", offset=off).astype(np.float64)
    if fmt == 212:
        # two 12-bit two's-complement samples per 3 bytes:
        # s0 = b1[3:0]*256 + b0, s1 = b1[7:4]*256 + b2
        b = np.fromfile(path, np.uint8, offset=off)
        b = b[:(len(b) // 3) * 3].reshape(-1, 3).astype(np.int32)
        s0 = ((b[:, 1] & 0x0F) << 8) | b[:, 0]
        s1 = ((b[:, 1] & 0xF0) << 4) | b[:, 2]
        pair = np.stack([s0, s1], axis=1).reshape(-1)
        return np.where(pair > 2047, pair - 4096, pair).astype(np.float64)
    if fmt == 80:  # offset binary: the stored byte - 128
        return np.fromfile(path, np.uint8, offset=off).astype(np.float64) \
            - 128.0
    if fmt == 24:  # 3-byte little-endian two's complement
        b = np.fromfile(path, np.uint8, offset=off)
        b = b[:(len(b) // 3) * 3].reshape(-1, 3).astype(np.int64)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        return np.where(v >= 1 << 23, v - (1 << 24), v).astype(np.float64)
    raise NotImplementedError(f"WFDB format {fmt} not supported")


def read_wfdb(record_path: str, channels: Optional[Sequence[int]] = None
              ) -> Tuple[np.ndarray, WFDBHeader]:
    """A single-file WFDB record (formats 16, 32, 212, 80, 24; or a v4
    `.mat` file, read with scipy) as (signal (T, C) float64 in physical
    units, (digital - baseline) / gain, header); `channels` selects
    columns."""
    hdr = read_wfdb_header(record_path + ".hea")
    if len(set(hdr.file_names)) > 1:
        raise NotImplementedError(
            f"multi-file WFDB records not supported: {hdr.file_names}")
    dat = hdr.file_names[0]
    path = os.path.join(os.path.dirname(record_path), dat)
    if dat.endswith(".mat"):
        from scipy.io import loadmat

        digital = loadmat(path)["val"].T.astype(np.float64)  # (T, C)
    else:
        digital = _read_digital(path, hdr.formats[0],
                                hdr.offsets[0] if hdr.offsets else 0)
        # format 212 pads an odd sample count to whole bytes: cut to the
        # header's length (when it has one) before de-interleaving
        if hdr.n_samples:
            digital = digital[:hdr.n_samples * hdr.n_sig]
        digital = digital[:(len(digital) // hdr.n_sig) * hdr.n_sig]
        digital = digital.reshape(-1, hdr.n_sig)
    physical = (digital - np.asarray(hdr.baselines, np.float64)) \
        / np.asarray(hdr.gains)
    if channels is not None:
        physical = physical[:, list(channels)]
    return physical, hdr


# ---------------------------------------------------------------------------
# PTB-XL and PhysioNet manifests
# ---------------------------------------------------------------------------

# the 11 non-AF rhythm codes of class 0 (train_signal_only_ptb.py:193-214)
PTBXL_RHYTHM_NEGATIVE = ("SR", "STACH", "SARRH", "SBRAD", "PACE", "SVARR",
                         "BIGU", "AFLT", "SVTAC", "PSVT", "TRIGU")


def _ptbxl_label(codes: Dict[str, float], min_likelihood: float):
    if codes.get("AFIB", 0) == min_likelihood:
        return 1
    for c in PTBXL_RHYTHM_NEGATIVE:
        if codes.get(c, 0) == min_likelihood:
            return 0
    return None


def load_ptbxl_manifest(ptbxl_dir: str, min_likelihood: float = 100.0
                        ) -> Table:
    """`ptbxl_database.csv` labelled AFIB at `min_likelihood` -> 1, one of
    the rhythm codes at it -> 0, the rest dropped
    (train_signal_only_ptb.py:183-214): a Table of `record` (the
    `filename_hr` path under `ptbxl_dir`), `label`, and `age` and `weight`
    where the database has them."""
    db = read_csv(os.path.join(ptbxl_dir, "ptbxl_database.csv"))
    labels = [_ptbxl_label(ast.literal_eval(c), min_likelihood)
              for c in db["scp_codes"]]
    keep = np.asarray([lab is not None for lab in labels], bool)
    out = {
        "record": column_array(os.path.join(ptbxl_dir, r)
                               for r in db["filename_hr"][keep]),
        "label": np.asarray([lab for lab in labels if lab is not None],
                            np.int64),
    }
    for col in ("age", "weight"):
        if col in db:
            out[col] = db[col][keep]
    return Table(out)


def load_physionet_manifest(physionet_dir: str,
                            data_subdir: str = "training2017",
                            multiclass: bool = False) -> Table:
    """`REFERENCE.csv` (no header): N -> 0, A and O -> 1
    (train_physionet.py:91-93), or N/A/O -> 0/1/2 with `multiclass`
    (train_physionet_multi.py:71); noise ('~') and unknown labels dropped.
    A Table of `record` (the path under `data_subdir`) and `label`."""
    ref = read_csv(os.path.join(physionet_dir, "REFERENCE.csv"),
                   header=False, names=["record", "label"])
    mapping = ({"N": 0, "A": 1, "O": 2} if multiclass
               else {"N": 0, "A": 1, "O": 1})
    keep = np.asarray([lab in mapping for lab in ref["label"]], bool)
    return Table({
        "record": column_array(
            os.path.join(physionet_dir, data_subdir, str(r))
            for r in ref["record"][keep]),
        "label": np.asarray([mapping[lab] for lab in ref["label"][keep]],
                            np.int64),
    })
