"""The port's record readers (`ecgmm_torch.data.sources`, `.align`,
`preprocess.augment_signal`) against the JAX package's
(`ecgmm_tpu/data/sources.py`, `align.py`, `preprocess.py`) on the CPU, on
record directories the tests write.

Bars: equal everywhere (the same cells, the same float64 arithmetic), the
images bit for bit; `augment_signal` within 1e-6 (float32 on both sides,
the noise added and the scale multiplied in one order). The JAX package
has no xlsx engine here (no openpyxl), so where a workbook is read the
test writes its `.csv` sibling too: the port reads the `.xlsx`, JAX the
`.csv`, and the two must agree.
"""

import csv
import io
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from ecgmm_tpu.data import align as jax_align
from ecgmm_tpu.data import preprocess as jax_preprocess
from ecgmm_tpu.data import sources as jax_sources
from ecgmm_torch.data import align, preprocess, sources
from ecgmm_torch.data.synthetic import make_cohort
from ecgmm_torch.tools import records

torch.set_num_threads(2)


def _assert_table_equals_frame(table, frame):
    assert table.columns == [str(c) for c in frame.columns]
    for c in frame.columns:
        got, want = table[str(c)], frame[c].to_numpy()
        assert got.dtype.kind == want.dtype.kind, c
        if want.dtype.kind == "f":
            np.testing.assert_array_equal(got, want)
        else:
            assert list(got) == list(want), c
    np.testing.assert_array_equal(table.index, frame.index.to_numpy())


# ------------------------------------------------------------------ tables

def test_read_csv_types_as_pandas(tmp_path):
    """Integers, floats (an empty cell is NaN), strings, quoted commas."""
    path = tmp_path / "t.csv"
    path.write_text('a,b,c,d\n1,0.5,x,"{\'SR\': 100.0, \'AFIB\': 0.0}"\n'
                    '2,,y,"{}"\n-3,1e-3,7,"{\'NORM\': 80.0}"\n')
    _assert_table_equals_frame(sources.read_csv(str(path)),
                               pd.read_csv(str(path)))
    _assert_table_equals_frame(
        sources.read_csv(str(path), header=False, names=["p", "q", "r", "s"]),
        pd.read_csv(str(path), header=None, names=["p", "q", "r", "s"]))


def test_xlsx_equals_its_csv_sibling_in_jax(tmp_path):
    """The port reads a SpreadsheetML workbook (shared strings, numbers);
    JAX, without an xlsx engine, reads the same-named .csv; and a missing
    .xlsx falls back to the .csv in both."""
    rows = [(3, "Normal", 61.5, 70), (1, "Abnormal", 48.25, 82),
            (7, "Borderline", 55.0, 64)]
    header = ("index", "label", "AGE", "Wt")
    records.write_xlsx(str(tmp_path / "labels.xlsx"), header, rows)
    with open(tmp_path / "labels.csv", "w", newline="") as f:
        csv.writer(f).writerows([header] + [[repr(v) if isinstance(v, float)
                                             else v for v in r]
                                            for r in rows])
    want = jax_sources.read_table(str(tmp_path / "labels.xlsx"))
    _assert_table_equals_frame(
        sources.read_table(str(tmp_path / "labels.xlsx")), want)
    os.remove(tmp_path / "labels.xlsx")
    _assert_table_equals_frame(
        sources.read_table(str(tmp_path / "labels.xlsx")), want)


def test_xlsx_inline_strings_and_gaps(tmp_path):
    """Inline strings, a skipped column and rows written out of the
    workbook's column order read as openpyxl would give them to pandas."""
    import zipfile

    ns = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
    sheet = (f'<worksheet xmlns="{ns}"><sheetData>'
             '<row r="1"><c r="A1" t="inlineStr"><is><t>id</t></is></c>'
             '<c r="C1" t="inlineStr"><is><t>v</t></is></c></row>'
             '<row r="2"><c r="C2"><v>2.5</v></c><c r="A2"><v>4</v></c>'
             '</row><row r="3"><c r="A3"><v>5</v></c></row>'
             '</sheetData></worksheet>')
    path = str(tmp_path / "x.xlsx")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("xl/worksheets/sheet1.xml", sheet)
    t = sources.read_table(path)
    assert t.columns == ["id", "Unnamed: 1", "v"]
    np.testing.assert_array_equal(t["id"], [4, 5])
    np.testing.assert_array_equal(t["v"], [2.5, np.nan])


# ------------------------------------------------------------ hospital dir

@pytest.fixture(scope="module")
def hospital(tmp_path_factory):
    """A hospital directory of 24 patients (ids 11..34): every 8th label
    Borderline, patient 17 (in known_missing) and 30 without an image,
    patient 20 with a Pillow CMYK JPEG and 21 with the writer's CMYK JPEG,
    the rest Pillow's RGB JPEG at 50x500, as the JAX fixture writer saves
    them; labels.xlsx with its .csv sibling."""
    root = tmp_path_factory.mktemp("hospital")
    c = make_cohort(n=24, signal_len=300, img_hw=(50, 500), seed=7)
    ids = c.indices + 10
    labels = np.where(c.labels == 1, "Abnormal", "Normal").astype(object)
    labels[np.arange(24) % 8 == 5] = "Borderline"
    images = {int(i): img for i, img in zip(ids, c.images)
              if i not in (17, 30)}
    records.write_hospital(str(root), ids, labels, c.signals,
                           {"AGE": c.clinical[:, 0], "Wt": c.clinical[:, 1]},
                           images, cmyk=(21,), csv_sibling=True)
    for idx, img in images.items():
        path = sources.image_path(str(root / "images"), idx)
        if idx == 21:
            continue
        im = Image.fromarray(img)
        if idx == 20:
            im = im.convert("CMYK")
        im.save(path, format="JPEG")
    return root, c


def test_load_hospital_tables_matches_jax(hospital):
    root, _ = hospital
    paths = [str(root / n) for n in ("labels.xlsx", "clinical.csv",
                                     "ecg_signals.csv")]
    got = sources.load_hospital_tables(*paths)
    want = jax_sources.load_hospital_tables(*paths)
    for g, w in zip(got, want):
        _assert_table_equals_frame(g, w)


def test_list_image_indices_matches_jax(hospital, tmp_path):
    root, _ = hospital
    assert sources.list_image_indices(str(root / "images")) == \
        jax_sources.list_image_indices(str(root / "images"))
    assert sources.list_image_indices(str(tmp_path / "none")) == set()


def test_load_images_bit_equal_to_jax(hospital):
    """The port's decoder and resize against Pillow's, CMYK included."""
    root, _ = hospital
    ids = sorted(sources.list_image_indices(str(root / "images")))
    assert 20 in ids and 21 in ids
    for hw in ((224, 224), (37, 61)):
        got = sources.load_images(str(root / "images"), ids, hw=hw)
        want = jax_sources.load_images(str(root / "images"), ids, hw=hw)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_cmyk_writer_decodes_to_its_block_means():
    """`records.cmyk_jpeg` (used where Pillow is absent) is a JPEG that
    Pillow and the port decode alike, each block at its mean."""
    rng = np.random.default_rng(0)
    img = np.repeat(np.repeat(rng.integers(0, 256, (6, 9, 3)), 8, 0), 8, 1
                    ).astype(np.uint8)[:45, :70]
    data = records.cmyk_jpeg(img)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    from ecgmm_torch.serve.imdecode import decode_image
    np.testing.assert_array_equal(decode_image(data), pil)
    assert np.abs(pil.astype(int) - img).max() <= 2


def test_merge_signal_csvs_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    for idx, n in ((1, 40), (2, 40), (4, 37), (6, 40)):
        np.savetxt(tmp_path / f"{idx}.csv", rng.normal(size=n), fmt="%.6f")
    (tmp_path / "5.csv").write_text("")            # fails to parse
    (tmp_path / "note.txt").write_text("ignored")
    got, got_missing = sources.merge_signal_csvs(str(tmp_path))
    want, want_missing = jax_sources.merge_signal_csvs(str(tmp_path))
    assert got_missing == want_missing == [3, 5]
    np.testing.assert_array_equal(got.index, want.index.to_numpy())
    np.testing.assert_array_equal(got.to_numpy(np.float64),
                                  want.to_numpy(np.float64))


def test_load_12lead_xlsx_matches_jax(tmp_path):
    """Leads chosen by name past an extra column, or a 12-column file by
    position; the lead permutation; anything else refused."""
    rng = np.random.default_rng(2)
    names = [f"Lead_{i}" for i in range(1, 13)]
    for idx in (3, 8):
        vals = np.round(rng.normal(size=(30, 12)), 4)
        header = (["time"] + names) if idx == 3 else names[::-1]
        rows = [([k] if idx == 3 else []) + list(map(float, r))
                for k, r in enumerate(vals)]
        records.write_xlsx(str(tmp_path / f"{idx}_12leads.xlsx"), header,
                           rows)
        with open(tmp_path / f"{idx}_12leads.csv", "w", newline="") as f:
            csv.writer(f).writerows([header] + [[repr(v) for v in r]
                                                for r in rows])
    fmt = str(tmp_path / "{idx}_12leads.xlsx")
    got = sources.load_12lead_xlsx(fmt, [3, 8])
    want = jax_sources.load_12lead_xlsx(fmt, [3, 8])
    assert got.dtype == np.float32 and got.shape == (2, 12, 30)
    np.testing.assert_array_equal(got, want)
    records.write_xlsx(str(tmp_path / "9_12leads.xlsx"),
                       [f"c{j}" for j in range(13)], [[0.0] * 13])
    with pytest.raises(ValueError, match="Lead_1..Lead_12"):
        sources.load_12lead_xlsx(fmt, [9])


# -------------------------------------------------------------------- WFDB

def _hea(path, name, n_sig, n, fmt_specs, gains, extra=("0",) * 4,
         fs="250", fmt_file=None):
    lines = [f"{name} {n_sig} {fs}" + (f" {n}" if n is not None else "")]
    for j in range(n_sig):
        lines.append(" ".join([fmt_file or f"{name}.dat", fmt_specs[j],
                               gains[j], *extra, f"sig{j}"]))
    (path / f"{name}.hea").write_text("\n".join(lines) + "\n# comment\n")


def _pack212(samples):
    s = np.asarray(samples, np.int64) & 0xFFF
    if len(s) % 2:
        s = np.append(s, 0)
    a, b = s[0::2], s[1::2]
    return np.stack([a & 0xFF, ((a >> 8) & 0x0F) | ((b >> 8) << 4),
                     b & 0xFF], axis=1).astype(np.uint8).reshape(-1)


def _pack24(samples):
    v = np.asarray(samples, np.int64) & 0xFFFFFF
    return np.stack([v & 0xFF, (v >> 8) & 0xFF, v >> 16],
                    axis=1).astype(np.uint8).reshape(-1)


def _compare_wfdb(path, channels=None):
    got, ghdr = sources.read_wfdb(path, channels)
    want, whdr = jax_sources.read_wfdb(path, channels)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    for f in whdr._fields:
        assert getattr(ghdr, f) == getattr(whdr, f) or \
            list(getattr(ghdr, f)) == list(getattr(whdr, f)), f
    return got, ghdr


@pytest.mark.parametrize("case", ["16", "32", "212_even", "212_odd", "80",
                                  "24", "16_offset", "212_no_length"])
def test_read_wfdb_formats_match_jax(tmp_path, case):
    rng = np.random.default_rng(len(case))
    n_sig = 2
    n = 501 if case in ("212_odd", "212_no_length") else 500
    fmt = case.split("_")[0]
    lo, hi = {"16": (-32768, 32767), "32": (-2 ** 31, 2 ** 31 - 1),
              "212": (-2048, 2047), "80": (-128, 127),
              "24": (-2 ** 23, 2 ** 23 - 1)}[fmt]
    digital = rng.integers(lo, hi + 1, (n, n_sig))
    flat = digital.reshape(-1)
    raw = {"16": lambda: flat.astype("<i2").tobytes(),
           "32": lambda: flat.astype("<i4").tobytes(),
           "212": lambda: _pack212(flat).tobytes(),
           "80": lambda: (flat + 128).astype(np.uint8).tobytes(),
           "24": lambda: _pack24(flat).tobytes()}[fmt]()
    spec = fmt
    if case == "16_offset":
        raw = b"\x07" * 24 + raw
        spec = "16+24"
    (tmp_path / "r.dat").write_bytes(raw)
    _hea(tmp_path, "r", n_sig, None if case == "212_no_length" else n,
         [spec] * n_sig, ["200(5)/mV", "1000.5(-3)/uV"])
    got, hdr = _compare_wfdb(str(tmp_path / "r"))
    assert hdr.units == ["mV", "uV"]
    if case != "212_no_length":
        np.testing.assert_array_equal(
            got, (digital - np.array([5, -3])) / np.array([200, 1000.5]))
    _compare_wfdb(str(tmp_path / "r"), channels=[1])


def test_read_wfdb_header_defaults_match_jax(tmp_path):
    """No parenthesised baseline: the ADC-zero field; gain 0: 200."""
    digital = np.arange(-20, 20, dtype=np.int16).reshape(20, 2)
    digital.tofile(tmp_path / "m.dat")
    (tmp_path / "m.hea").write_text(
        "m 2 360 20\nm.dat 16 0 11 1024 995 -22131 0 MLII\n"
        "m.dat 16 200 11 0 1011 20052 0 V5\n")
    got, hdr = _compare_wfdb(str(tmp_path / "m"))
    assert hdr.baselines == [1024, 0] and hdr.gains == [200.0, 200.0]


def test_read_wfdb_mat_behind_16_plus_24(tmp_path):
    """CinC 2017's layout: a v4 MAT file read through scipy."""
    rng = np.random.default_rng(4)
    names = ["A00001", "A00002"]
    sigs = [rng.integers(-2000, 2000, 900).astype(np.int16),
            rng.integers(-2000, 2000, 1201).astype(np.int16)]
    records.write_cinc2017(str(tmp_path), names, ["N", "A"], sigs)
    for name, sig in zip(names, sigs):
        got, hdr = _compare_wfdb(str(tmp_path / "training2017" / name))
        assert hdr.offsets == [24] and hdr.fs == 300.0
        np.testing.assert_array_equal(got[:, 0], sig / 1000.0)


def test_read_wfdb_refusals_match_jax(tmp_path):
    (tmp_path / "a.dat").write_bytes(b"\x00" * 12)
    _hea(tmp_path, "a", 1, 6, ["16x2"], ["200"])
    for mod in (sources, jax_sources):
        with pytest.raises(NotImplementedError, match="xN"):
            mod.read_wfdb(str(tmp_path / "a"))
    _hea(tmp_path, "b", 1, 6, ["61"], ["200"], fmt_file="a.dat")
    for mod in (sources, jax_sources):
        with pytest.raises(NotImplementedError, match="format 61"):
            mod.read_wfdb(str(tmp_path / "b"))


# --------------------------------------------------------------- manifests

PTB_CODES = ["{'AFIB': 100.0, 'NORM': 50.0}", "{'SR': 100.0}",
             "{'NORM': 100.0}", "{'AFLT': 100.0, 'AFIB': 0.0}",
             "{'STACH': 100.0}", "{'AFIB': 80.0}", "{'PACE': 100.0}",
             "{'SR': 0.0, 'AFIB': 100.0}"]


@pytest.fixture(scope="module")
def ptbxl(tmp_path_factory):
    root = tmp_path_factory.mktemp("ptbxl")
    rng = np.random.default_rng(5)
    n = len(PTB_CODES)
    digital = rng.integers(-3000, 3000, (n, 600, 12)).astype(np.int16)
    weights = rng.uniform(50, 90, n)
    weights[2] = np.nan
    records.write_ptbxl(str(root), digital, PTB_CODES,
                        rng.uniform(20, 80, n), weights)
    return root, digital


def test_ptbxl_manifest_matches_jax(ptbxl):
    root, digital = ptbxl
    got = sources.load_ptbxl_manifest(str(root))
    want = jax_sources.load_ptbxl_manifest(str(root))
    _assert_table_equals_frame(got, want)
    assert list(got["label"]) == [1, 0, 0, 0, 0, 1]
    sig, _ = sources.read_wfdb(got["record"][1], channels=[1])
    np.testing.assert_array_equal(sig[:, 0], digital[1, :, 1] / 1000.0)


@pytest.mark.parametrize("multiclass", [False, True])
def test_physionet_manifest_matches_jax(tmp_path, multiclass):
    names = [f"A{k:05d}" for k in range(1, 8)]
    labels = ["N", "A", "O", "~", "N", "X", "A"]
    records.write_cinc2017(str(tmp_path), names, labels,
                           [np.zeros(10, np.int16)] * 7)
    got = sources.load_physionet_manifest(str(tmp_path),
                                          multiclass=multiclass)
    want = jax_sources.load_physionet_manifest(str(tmp_path),
                                               multiclass=multiclass)
    _assert_table_equals_frame(got, want)


# ------------------------------------------------------------------- align

@pytest.mark.parametrize("label_map,drop", [
    (align.LABEL_MAP_BINARY, ()), (align.LABEL_MAP_AF, ()),
    (align.LABEL_MAP_ARR, ()), (align.LABEL_MAP_AF, ("Borderline",))])
def test_filter_and_map_labels_matches_jax(tmp_path, label_map, drop):
    labels = ["Normal", "Abnormal", "Borderline", "AF", "Arrhythmia",
              "Normal", "Abnormal", "AF"]
    path = tmp_path / "l.csv"
    pd.DataFrame({"index": np.arange(8) * 3 + 1, "label": labels}).to_csv(
        path, index=False)
    got = align.filter_and_map_labels(sources.read_csv(str(path)),
                                      label_map, drop)
    want = jax_align.filter_and_map_labels(pd.read_csv(path), label_map,
                                           drop)
    _assert_table_equals_frame(got, want)


def test_intersect_and_align_match_jax(hospital):
    root, _ = hospital
    paths = [str(root / n) for n in ("labels.xlsx", "clinical.csv",
                                     "ecg_signals.csv")]
    lab, clin, ecg = sources.load_hospital_tables(*paths)
    jlab, jclin, jecg = jax_sources.load_hospital_tables(*paths)
    lab = align.filter_and_map_labels(lab)
    jlab = jax_align.filter_and_map_labels(jlab)
    img = sources.list_image_indices(str(root / "images"))
    missing = (17, 23, 36)
    common = align.intersect_indices(lab["index"], ecg.index, clin["index"],
                                     img, missing)
    want = jax_align.intersect_indices(jlab["index"], jecg.index,
                                       jclin["index"], img, missing)
    assert common == want and 17 not in common and 30 not in common
    assert align.intersect_indices([1, 2], [2], [2, 1]) == {2}
    got = align.align_frames(lab, ecg, clin, common)
    for g, w in zip(got, jax_align.align_frames(jlab, jecg, jclin, want)):
        _assert_table_equals_frame(g, w)


# ------------------------------------------------------------ augmentation

def test_augment_signal_arithmetic_matches_jax():
    """The port's arithmetic fed the six draws JAX's augment_signal makes
    from its key (its split into six subkeys) gives JAX's result."""
    x = np.random.default_rng(6).normal(size=(9, 50)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    b, t = x.shape
    draws = (jax.random.bernoulli(k1, 0.5, (b, 1)),
             jax.random.normal(k2, x.shape) * 0.01,
             jax.random.bernoulli(k3, 0.5, (b, 1)),
             jax.random.uniform(k4, (b, 1), minval=0.8, maxval=1.2),
             jax.random.bernoulli(k5, 0.5, (b,)),
             jax.random.randint(k6, (b,), -10, 10))
    want = np.asarray(jax_preprocess.augment_signal(key, x))
    got = preprocess.augment_signal_with_draws(
        torch.from_numpy(x), *(torch.from_numpy(np.array(d))
                               for d in draws))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert any(np.asarray(draws[4])) and not all(np.asarray(draws[4]))


def test_augment_signal_draws_from_its_generator():
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(64, 40)).astype(np.float32))
    a = preprocess.augment_signal(x, torch.Generator().manual_seed(1))
    b = preprocess.augment_signal(x, torch.Generator().manual_seed(1))
    c = preprocess.augment_signal(x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # rows neither noised, scaled nor shifted come back as they were
    same = (a == x).all(dim=1)
    assert 0 < int(same.sum()) < 64
