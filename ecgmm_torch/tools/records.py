"""Writers of record directories in the layouts the trainers read
(`data/sources.py`), from arrays, with numpy, scipy and the port's native
JPEG encoder alone: a hospital directory, a PTB-XL download and a
PhysioNet/CinC 2017 download. They stand in for the real records, which
are not in the repository, where the readers are driven end to end.

- `write_hospital`: `labels.xlsx` (a SpreadsheetML workbook; optionally
  its `labels.csv` sibling), `clinical.csv` (IDX, the clinical columns,
  ECG), `ecg_signals.csv` (one row a patient, the id first; floats as the
  shortest text of their float32) and
  `images/{idx}/{idx:03d}ECG_lead2.jpg`: baseline RGB JPEG from
  `native.jpeg_encode`, or for the ids in `cmyk` a 4-component Adobe CMYK
  JPEG (`cmyk_jpeg`);
- `write_ptbxl`: `ptbxl_database.csv` (scp_codes, filename_hr, age,
  weight) and `records500/{k:02d}000/{id:05d}_hr.{hea,dat}`, WFDB format
  16, at 500 Hz;
- `write_cinc2017`: `REFERENCE.csv` and `training2017/{name}.{mat,hea}`,
  v4 MAT files behind `16+24` headers, at 300 Hz.
"""

from __future__ import annotations

import csv
import os
import struct
import zipfile
from typing import Dict, Iterable, Sequence
from xml.sax.saxutils import escape

import numpy as np

from ecgmm_torch import native

_SHEET_NS = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
_REL_NS = ("http://schemas.openxmlformats.org/officeDocument/2006/"
           "relationships")


def _column_ref(j: int) -> str:
    s = ""
    j += 1
    while j:
        j, r = divmod(j - 1, 26)
        s = chr(65 + r) + s
    return s


def write_xlsx(path: str, header: Sequence[str],
               rows: Iterable[Sequence[object]]) -> None:
    """A one-sheet SpreadsheetML workbook: the header, then the rows;
    strings as shared strings, numbers as numbers (an int without a
    decimal point, a float as its repr)."""
    shared: Dict[str, int] = {}

    def cell(ref, v):
        if isinstance(v, str):
            k = shared.setdefault(v, len(shared))
            return f'<c r="{ref}" t="s"><v>{k}</v></c>'
        if isinstance(v, (int, np.integer)):
            return f'<c r="{ref}"><v>{int(v)}</v></c>'
        return f'<c r="{ref}"><v>{float(v)!r}</v></c>'

    body = []
    for i, row in enumerate([list(header)] + [list(r) for r in rows]):
        cells = "".join(cell(f"{_column_ref(j)}{i + 1}", v)
                        for j, v in enumerate(row))
        body.append(f'<row r="{i + 1}">{cells}</row>')
    sheet = (f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
             f'<worksheet xmlns="{_SHEET_NS}"><sheetData>{"".join(body)}'
             f'</sheetData></worksheet>')
    strings = "".join(f"<si><t>{escape(s)}</t></si>" for s in shared)
    sst = (f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
           f'<sst xmlns="{_SHEET_NS}" count="{len(shared)}" '
           f'uniqueCount="{len(shared)}">{strings}</sst>')
    workbook = (f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                f'<workbook xmlns="{_SHEET_NS}" xmlns:r="{_REL_NS}">'
                f'<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/>'
                f'</sheets></workbook>')
    pr = "http://schemas.openxmlformats.org/package/2006/relationships"
    rels = (f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            f'<Relationships xmlns="{pr}">'
            f'<Relationship Id="rId1" Type="{_REL_NS}/worksheet" '
            f'Target="worksheets/sheet1.xml"/>'
            f'<Relationship Id="rId2" Type="{_REL_NS}/sharedStrings" '
            f'Target="sharedStrings.xml"/></Relationships>')
    root_rels = (f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                 f'<Relationships xmlns="{pr}">'
                 f'<Relationship Id="rId1" Type="{_REL_NS}/officeDocument" '
                 f'Target="xl/workbook.xml"/></Relationships>')
    ct = "http://schemas.openxmlformats.org/package/2006/content-types"
    sm = "application/vnd.openxmlformats-officedocument.spreadsheetml"
    types = (f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
             f'<Types xmlns="{ct}">'
             f'<Default Extension="rels" ContentType="application/'
             f'vnd.openxmlformats-package.relationships+xml"/>'
             f'<Default Extension="xml" ContentType="application/xml"/>'
             f'<Override PartName="/xl/workbook.xml" '
             f'ContentType="{sm}.sheet.main+xml"/>'
             f'<Override PartName="/xl/worksheets/sheet1.xml" '
             f'ContentType="{sm}.worksheet+xml"/>'
             f'<Override PartName="/xl/sharedStrings.xml" '
             f'ContentType="{sm}.sharedStrings+xml"/></Types>')
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", types)
        z.writestr("_rels/.rels", root_rels)
        z.writestr("xl/workbook.xml", workbook)
        z.writestr("xl/_rels/workbook.xml.rels", rels)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
        z.writestr("xl/sharedStrings.xml", sst)


# ---------------------------------------------------------------------------
# A 4-component (Adobe CMYK) baseline JPEG, DC coefficients only
# ---------------------------------------------------------------------------

# the Annex K luminance DC table: code lengths and codes by category
_DC_LENGTHS = (2, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9)
_DC_CODES = (0b00, 0b010, 0b011, 0b100, 0b101, 0b110, 0b1110, 0b11110,
             0b111110, 0b1111110, 0b11111110, 0b111111110)
_DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
# the Annex K luminance AC table (only its EOB, 1010, is used)
_AC_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D)
_AC_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a8384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2"
    "c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4"
    "f5f6f7f8f9fa")


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def cmyk_jpeg(rgb: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as a baseline 4-component JPEG with an
    Adobe marker of transform 0, stored inverted as Adobe CMYK is (K the
    brightest channel, C, M and Y the channels over it), so that a decoder
    following Pillow's conversion gives back the image, each 8x8 block at
    its mean: only the DC coefficients are coded (quantiser 1, the Annex K
    tables), each block's AC an end-of-block."""
    rgb = np.asarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    k = rgb.max(axis=2).astype(np.int64)
    cmy = np.where(k[:, :, None] > 0,
                   (rgb.astype(np.int64) * 255 + k[:, :, None] // 2)
                   // np.maximum(k[:, :, None], 1), 0)
    planes = np.concatenate([cmy, k[:, :, None]], axis=2)  # stored values
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    planes = np.pad(planes, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    # each block's DC: sum(x - 128) / 8, rounded (orthonormal DCT-II)
    blocks = planes.reshape(hp // 8, 8, wp // 8, 8, 4).sum(axis=(1, 3))
    dc = np.floor((blocks - 64 * 128) / 8.0 + 0.5).astype(np.int64)
    dc = dc.reshape(-1, 4)                       # MCU order, 4 blocks each
    diff = np.diff(np.concatenate([np.zeros((1, 4), np.int64), dc]),
                   axis=0).reshape(-1)
    cat = np.where(diff == 0, 0,
                   np.floor(np.log2(np.maximum(np.abs(diff), 1))) + 1
                   ).astype(np.int64)
    extra = np.where(diff < 0, diff + (1 << cat) - 1, diff)
    lengths = np.asarray(_DC_LENGTHS)[cat] + cat + 4
    value = ((np.asarray(_DC_CODES)[cat] << (cat + 4))
             | (extra << 4) | 0b1010)
    width = 24
    shifts = lengths[:, None] - 1 - np.arange(width)[None, :]
    bits = (value[:, None] >> np.maximum(shifts, 0)) & 1
    bits = bits[shifts >= 0].astype(np.uint8)
    bits = np.concatenate([bits, np.ones((-len(bits)) % 8, np.uint8)])
    scan = np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")
    dqt = _segment(0xDB, b"\x00" + bytes([1] * 64))
    sof = _segment(0xC0, struct.pack(">BHHB", 8, h, w, 4) + b"".join(
        bytes([c + 1, 0x11, 0]) for c in range(4)))
    dht = _segment(0xC4, b"\x00" + bytes(_DC_BITS) + bytes(range(12))
                   + b"\x10" + bytes(_AC_BITS) + _AC_VALS)
    adobe = _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0))
    sos = _segment(0xDA, b"\x04" + b"".join(bytes([c + 1, 0x00])
                                             for c in range(4))
                   + b"\x00\x3f\x00")
    return (b"\xff\xd8" + adobe + dqt + sof + dht + sos + scan
            + b"\xff\xd9")


# ---------------------------------------------------------------------------
# The three layouts
# ---------------------------------------------------------------------------

def write_hospital(root: str, indices: np.ndarray, labels: Sequence[str],
                   signals: np.ndarray, clinical: Dict[str, np.ndarray],
                   images: Dict[int, np.ndarray], cmyk: Iterable[int] = (),
                   csv_sibling: bool = False) -> None:
    """A hospital directory: `labels` are the label strings (Normal,
    Abnormal, Borderline, ...) of `indices`; `signals` (N, T) float32;
    `clinical` the clinical columns in order (AGE, Wt, ...); `images` each
    patient's (H, W, 3) uint8 strip by id (a patient without one has no
    folder)."""
    os.makedirs(root, exist_ok=True)
    rows = [(int(i), str(lab)) for i, lab in zip(indices, labels)]
    write_xlsx(os.path.join(root, "labels.xlsx"), ("index", "label"), rows)
    if csv_sibling:
        with open(os.path.join(root, "labels.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(("index", "label"))
            w.writerows(rows)
    with open(os.path.join(root, "clinical.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["IDX"] + list(clinical) + ["ECG"])
        for r, idx in enumerate(indices):
            w.writerow([int(idx)] + [_cell(clinical[c][r]) for c in clinical]
                       + ["unused"])
    with open(os.path.join(root, "ecg_signals.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([""] + [str(j) for j in range(signals.shape[1])])
        for idx, row in zip(indices, np.asarray(signals, np.float32)):
            w.writerow([int(idx)] + [_cell(v) for v in row])
    cmyk = set(int(i) for i in cmyk)
    for idx, img in images.items():
        d = os.path.join(root, "images", str(idx))
        os.makedirs(d, exist_ok=True)
        data = cmyk_jpeg(img) if int(idx) in cmyk \
            else native.jpeg_encode(img)
        with open(os.path.join(d, f"{str(idx).zfill(3)}ECG_lead2.jpg"),
                  "wb") as f:
            f.write(data)


def _cell(v) -> str:
    """An integer as it is, a float as the shortest text that reads back
    as the same float32 (as a spreadsheet export of measured values
    writes a few digits, not a double's seventeen)."""
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return str(np.float32(v))


def _write_wfdb16(base: str, digital: np.ndarray, fs: float,
                  gain: float, baseline: int, names: Sequence[str]) -> None:
    """A WFDB format-16 record: `digital` (T, C) int16."""
    t, c = digital.shape
    name = os.path.basename(base)
    np.asarray(digital, "<i2").tofile(base + ".dat")
    with open(base + ".hea", "w") as f:
        f.write(f"{name} {c} {fs:g} {t}\n")
        for j in range(c):
            f.write(f"{name}.dat 16 {gain:g}({baseline})/mV 16 0 "
                    f"{int(digital[0, j])} 0 0 {names[j]}\n")


PTBXL_LEADS = ("I", "II", "III", "AVR", "AVL", "AVF", "V1", "V2", "V3",
               "V4", "V5", "V6")


def write_ptbxl(root: str, digital: np.ndarray, scp_codes: Sequence[str],
                ages: Sequence[float], weights: Sequence[float]) -> None:
    """A PTB-XL layout: `digital` (N, 5000, 12) int16 at 500 Hz, gain 1000
    adu/mV; `scp_codes` each record's codes as PTB-XL writes them
    ("{'AFIB': 100.0, ...}"); weights may hold NaN (an empty cell)."""
    rows = []
    for k, rec in enumerate(digital):
        ecg_id = k + 1
        sub = f"records500/{ecg_id // 1000:02d}000"
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        hr = f"{sub}/{ecg_id:05d}_hr"
        _write_wfdb16(os.path.join(root, hr), rec, 500.0, 1000.0, 0,
                      PTBXL_LEADS)
        lr = f"records100/{ecg_id // 1000:02d}000/{ecg_id:05d}_lr"
        weight = "" if np.isnan(weights[k]) else repr(float(weights[k]))
        rows.append((ecg_id, 15000 + k, repr(float(ages[k])), k % 2, weight,
                     scp_codes[k], lr, hr))
    with open(os.path.join(root, "ptbxl_database.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(("ecg_id", "patient_id", "age", "sex", "weight",
                    "scp_codes", "filename_lr", "filename_hr"))
        w.writerows(rows)


def write_cinc2017(root: str, names: Sequence[str], labels: Sequence[str],
                   digital: Sequence[np.ndarray]) -> None:
    """A PhysioNet/CinC 2017 layout: `digital` each record's (T,) int16 at
    300 Hz, gain 1000 adu/mV, in a v4 MAT file (`val`, 1 x T) behind a
    header whose format spec skips the file's 24-byte MAT header."""
    from scipy.io import savemat

    d = os.path.join(root, "training2017")
    os.makedirs(d, exist_ok=True)
    for name, sig in zip(names, digital):
        sig = np.asarray(sig, np.int16)
        savemat(os.path.join(d, name + ".mat"), {"val": sig[None, :]},
                format="4")
        with open(os.path.join(d, name + ".hea"), "w") as f:
            f.write(f"{name} 1 300 {len(sig)} 05:05:15 1/05/2000\n")
            f.write(f"{name}.mat 16+24 1000/mV 16 0 {int(sig[0])} 0 0 "
                    "ECG\n")
    with open(os.path.join(root, "REFERENCE.csv"), "w", newline="") as f:
        csv.writer(f).writerows(zip(names, labels))
