"""The port's OCR field extraction and EDA (`ecgmm_torch/tools/ocr.py`,
`eda.py`) against JAX's (`tests/test_tools.py:38-58,103-131`,
`tests/test_cli_tools.py:12-38`), on the same inputs.

OCR: every field equal. EDA: `cohort_table`'s rows equal JAX's frame's
(the summary strings and missing-% exactly, p-values to 1e-12),
`ptbxl_label_stats` equal, `image_size_audit` equal to JAX's Pillow
inventory; the CLI prints what JAX's prints the checks on. The port's
tables are laid out by `format_rows`, not by pandas.
"""

import json

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from ecgmm_tpu.tools import eda as jax_eda
from ecgmm_tpu.tools import ocr as jax_ocr
from ecgmm_torch.data.sources import Table
from ecgmm_torch.tools import eda, ocr
from tests.test_tools import SAMPLE_OCR_TEXT

OCR_TEXTS = [
    SAMPLE_OCR_TEXT,
    "혈색소 135 13.5\n흡연 이력\n☑ 현재 흡연자\n음주\n■ 비음주자\n운동\n"
    "✅ 건강증진 실천\n1250\n중성지방\n",
    "\n".join(["혈당 검사 안내"] + ["-"] * 5 + ["공복혈당 105"]),
    "중성지방 1250\n",
    "",
]


@pytest.mark.parametrize("i", range(len(OCR_TEXTS)))
def test_ocr_equals_jax(i):
    text = OCR_TEXTS[i]
    got, want = ocr.extract_fields(text), jax_ocr.extract_fields(text)
    assert got == want
    a, b = ocr.fields_to_row(got), jax_ocr.fields_to_row(want)
    assert list(a) == list(b)
    np.testing.assert_array_equal(np.asarray(list(a.values()), float),
                                  np.asarray(list(b.values()), float))
    assert ocr.FIELDS == jax_ocr.FIELDS


def test_ocr_reference_semantics():
    """`tests/test_tools.py::test_ocr_extract_fields` and
    `::test_ocr_fields_to_row` on the port."""
    f = ocr.extract_fields(SAMPLE_OCR_TEXT)
    assert f["연령"] == 63 and f["성별"] == 1
    assert f["키"] == "165.2" and f["몸무게"] == "58.4"
    assert f["흡연"] == 1 and f["음주"] == 0
    row = ocr.fields_to_row(f)
    assert row["AGE"] == 63.0 and row["Wt"] == 58.4 and row["Cr"] == 0.8


def test_gated_backends_raise_import_error(tmp_path):
    """`pdf_to_pngs` and `vision_ocr` import their packages inside the
    call, as JAX's do, and raise ImportError where they are missing."""
    for fn, args in ((ocr.pdf_to_pngs, (str(tmp_path / "a.pdf"),
                                        str(tmp_path))),
                     (ocr.vision_ocr, (str(tmp_path / "a.png"),))):
        try:
            import importlib

            importlib.import_module("pdf2image" if fn is ocr.pdf_to_pngs
                                    else "google.cloud.vision")
        except ImportError:
            with pytest.raises(ImportError):
                fn(*args)


def _frame(seed):
    rng = np.random.default_rng(seed)
    n = 120
    cols = {"label": rng.integers(0, 2, n),
            "AGE": rng.normal(60, 10, n), "Wt": rng.normal(70, 12, n),
            "Sex": rng.integers(0, 2, n),
            "Smoke": rng.choice(np.array(["never", "past", "now"],
                                         dtype=object), n)}
    cols["AGE"][:6] = np.nan
    cols["Smoke"][3] = None
    return cols


@pytest.mark.parametrize("seed", [0, 1])
def test_cohort_table_equals_jax(seed):
    """`tests/test_tools.py::test_cohort_table`'s frame, plus a string
    category with a missing value: every row equal to JAX's."""
    cols = _frame(seed)
    want = jax_eda.cohort_table(pd.DataFrame(cols), "label", ["AGE", "Wt"],
                                ["Sex", "Smoke"])
    got = eda.cohort_table(Table(cols), "label", ["AGE", "Wt"],
                           ["Sex", "Smoke"])
    assert [list(r) for r in got] == [
        [c for c in want.columns if not pd.isna(row[c])]
        for _, row in want.iterrows()]
    for g, (_, w) in zip(got, want.iterrows()):
        for k, v in g.items():
            if k == "p_value":
                assert v == pytest.approx(w[k], rel=1e-12, abs=1e-15)
            else:
                assert v == w[k], k
    age = got[0]
    assert 0 < age["missing_%"] < 10 and 0 <= age["p_value"] <= 1


def test_ptbxl_label_stats_equal_jax():
    mani = {"label": np.array([1, 0, 0, 0, 1])}
    meta = {"age": np.array([70, 55, 60, 58, 75.0]),
            "weight": np.array([80, 70, 72, np.nan, 85])}
    got = eda.ptbxl_label_stats(mani, meta)
    want = jax_eda.ptbxl_label_stats(pd.DataFrame(mani), pd.DataFrame(meta))
    assert got.keys() == want.keys()
    assert got["n"] == 5 and got["afib_ratio"] == 0.4
    assert got["counts"] == want["counts"]
    for k in ("age_ttest_p", "weight_ttest_p"):
        assert got[k] == pytest.approx(want[k], rel=1e-12)
    with pytest.raises(ValueError, match="aligned"):
        eda.ptbxl_label_stats(mani, {"age": np.ones(3)})


def _image_dir(tmp_path):
    root = tmp_path / "images"
    for i, (size, fmt, kw) in enumerate([
            ((2500, 250), "JPEG", {}), ((640, 480), "PNG", {}),
            ((301, 97), "JPEG", {"progressive": True}),
            ((2500, 250), "JPEG", {"quality": 40})]):
        d = root / str(i % 3 + 1)
        d.mkdir(parents=True, exist_ok=True)
        ext = "jpg" if fmt == "JPEG" else "png"
        Image.new("RGB", size, (i * 40, 0, 0)).save(d / f"{i:03d}ECG.{ext}",
                                                    fmt, **kw)
    (root / "note.txt").write_text("not a directory of images")
    return root


def test_image_size_audit_equals_jax(tmp_path):
    root = _image_dir(tmp_path)
    want = jax_eda.image_size_audit(str(root))
    got = eda.image_size_audit(str(root))
    assert got == want.to_dict("records")
    sizes = want.groupby(["width", "height"]).size()
    assert eda.size_distribution(got) == {
        k: int(v) for k, v in sizes.items()}


def test_signal_merge_report_equals_jax():
    frame = np.zeros((3, 2476))
    assert eda.signal_merge_report(frame, [4, 9]) == \
        jax_eda.signal_merge_report(pd.DataFrame(frame), [4, 9])


def test_eda_cli(tmp_path, capsys):
    """`tests/test_cli_tools.py:12-38` on the port: the cohort, images
    and ptbxl commands."""
    df = pd.DataFrame({
        "label": [0, 0, 1, 1] * 6,
        "AGE": np.r_[np.full(12, 50.0), np.full(12, 70.0)],
        "Wt": np.linspace(50, 90, 24),
    })
    csv = tmp_path / "clinical.csv"
    df.to_csv(csv, index=False)
    eda.main(["cohort", str(csv), "--numeric", "AGE,Wt"])
    out = capsys.readouterr().out
    assert "AGE" in out and "p_value" in out
    d = tmp_path / "images" / "1"
    d.mkdir(parents=True)
    Image.new("RGB", (2500, 250)).save(d / "001ECG_lead2.jpg")
    eda.main(["images", str(tmp_path / "images")])
    out = capsys.readouterr().out
    assert "2500" in out and "size distribution" in out
    ptb = tmp_path / "ptbxl"
    ptb.mkdir()
    pd.DataFrame({
        "ecg_id": [1, 2, 3, 4],
        "scp_codes": ["{'AFIB': 100.0}", "{'SR': 100.0}", "{'SR': 100.0}",
                      "{'NORM': 100.0}"],
        "filename_hr": [f"records500/0000{i}_hr" for i in range(4)],
        "age": [70, 50, 60, 40], "weight": [80, 70, 75, 60],
    }).to_csv(ptb / "ptbxl_database.csv", index=False)
    eda.main(["ptbxl", str(ptb)])
    got = json.loads(capsys.readouterr().out)
    jax_eda.main(["ptbxl", str(ptb)])
    assert got == json.loads(capsys.readouterr().out)
