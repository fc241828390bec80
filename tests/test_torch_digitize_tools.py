"""The port's batch digitizer and digitizer envelope
(`ecgmm_torch/tools/digitize_batch.py`, `digitize_envelope.py`) against
JAX's (`tests/test_digitize_batch.py`, `tests/test_digitize_envelope.py`),
on the same files.

- `digitize_directory`: the signals bit-equal to JAX's frame, the ids in
  its order, the report's rows equal; a blank image reported and not
  fatal (fatal with strict), EXIF orientation applied, a duplicate stem
  and an empty directory refused with JAX's messages, `--px-per-mv`;
  the CSVs the CLI writes are the bytes pandas writes for JAX's frames;
- the envelope: every degradation at every sweep point bit-equal to
  JAX's, Pillow's default (bicubic) resize bit-equal at other sizes, and
  one axis of the sweep giving JAX's rows.

JAX's full sweep is slow-marked in `tests/test_digitize_envelope.py:85`;
here one axis runs (the JPEG one, whose points go through the port's
encoder and decoder).
"""

import numpy as np
import pytest
from PIL import Image

from ecgmm_tpu.data import synthetic
from ecgmm_tpu.tools import digitize_batch as jax_batch
from ecgmm_tpu.tools import digitize_envelope as jax_env
from ecgmm_torch import native
from ecgmm_torch.tools import digitize_batch, digitize_envelope


def _make_cohort_dir(tmp_path, n=3, blank_idx=None, seed=7):
    cohort = synthetic.make_cohort(n=n, signal_len=2476, seed=seed,
                                   img_hw=(250, 2500))
    d = tmp_path / "strips"
    d.mkdir()
    for i in range(n):
        Image.fromarray(cohort.images[i]).save(d / f"{i + 1}.png")
    if blank_idx is not None:
        blank = np.full((250, 2500, 3), 245, np.uint8)
        Image.fromarray(blank).save(d / f"{blank_idx}.jpg")
    return str(d), cohort


def _assert_same(got, want):
    index, signals, report = got
    jsig, jrep = want
    assert list(index) == list(jsig.index)
    np.testing.assert_array_equal(signals, jsig.to_numpy(np.float32))
    assert signals.dtype == np.float32
    rows = jrep.reset_index().to_dict("records")
    assert len(rows) == len(report)
    for r, w in zip(report, rows):
        assert list(r) == list(w)
        for k in r:
            if isinstance(w[k], float) and np.isnan(w[k]):
                assert np.isnan(r[k]), k
            else:
                assert r[k] == w[k], k


def test_directory_equals_jax_and_csv_bytes(tmp_path, capsys):
    """Three strips and a blank photo: the signals bit-equal, the blank
    reported (not fatal), and the CLI's two CSVs the bytes of pandas'
    `to_csv` of JAX's frames."""
    d, _ = _make_cohort_dir(tmp_path, n=3, blank_idx=9)
    want = jax_batch.digitize_directory(d)
    got = digitize_batch.digitize_directory(d)
    _assert_same(got, want)
    assert "no ECG trace" in got[2][-1]["error"]
    out, rep = tmp_path / "sig.csv", tmp_path / "rep.csv"
    digitize_batch.main([d, "-o", str(out), "--report", str(rep)])
    assert "digitized 3/4" in capsys.readouterr().out
    jsig, jrep = want
    jsig.to_csv(tmp_path / "jsig.csv")
    jrep.to_csv(tmp_path / "jrep.csv")
    assert out.read_bytes() == (tmp_path / "jsig.csv").read_bytes()
    assert rep.read_bytes() == (tmp_path / "jrep.csv").read_bytes()
    with pytest.raises(RuntimeError, match="9.jpg"):
        digitize_batch.digitize_directory(d, strict=True)


def test_px_per_mv_and_cli_refusal(tmp_path, capsys):
    d, _ = _make_cohort_dir(tmp_path, n=1)
    got = digitize_batch.digitize_directory(d, px_per_mv=100.0)
    _assert_same(got, jax_batch.digitize_directory(d, px_per_mv=100.0))
    assert got[2][0]["scale_source"] == "explicit"
    assert got[2][0]["px_per_mv"] == 100.0
    with pytest.raises(SystemExit):
        digitize_batch.main([d, "--px-per-mv", "-1"])
    assert "--px-per-mv must be > 0" in capsys.readouterr().err


def test_exif_orientation_and_refusals(tmp_path):
    """A sideways photo with EXIF orientation 6 is righted as JAX's
    `exif_transpose` rights it (signals bit-equal); a duplicate stem and
    an empty directory are refused with JAX's messages."""
    cohort = synthetic.make_cohort(n=1, signal_len=2476, seed=9,
                                   img_hw=(250, 2500))
    d = tmp_path / "strips"
    d.mkdir()
    stored = Image.fromarray(cohort.images[0]).transpose(Image.ROTATE_90)
    exif = Image.Exif()
    exif[0x0112] = 6
    stored.save(d / "1.jpg", quality=95, exif=exif)
    _assert_same(digitize_batch.digitize_directory(str(d)),
                 jax_batch.digitize_directory(str(d)))
    Image.fromarray(cohort.images[0]).save(d / "1.png")
    for mod in (digitize_batch, jax_batch):
        with pytest.raises(ValueError, match=r"\[1\]"):
            mod.digitize_directory(str(d))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no numeric-stem images"):
        digitize_batch.digitize_directory(str(tmp_path / "empty"))


@pytest.fixture(scope="module")
def truth():
    mv, clean = digitize_envelope.make_ground_truth()
    jmv, jclean = jax_env.make_ground_truth()
    np.testing.assert_array_equal(mv, jmv)
    np.testing.assert_array_equal(clean, jclean)
    return mv, clean


@pytest.mark.parametrize("axis", [a.name for a in jax_env.default_axes()])
def test_degradations_equal_jax(truth, axis):
    """Every sweep point of each axis: the degraded image bit-equal."""
    _, clean = truth
    port = {a.name: a for a in digitize_envelope.default_axes()}[axis]
    ref = {a.name: a for a in jax_env.default_axes()}[axis]
    assert port.params == ref.params
    for p in port.params:
        np.testing.assert_array_equal(port.apply(clean, p),
                                      ref.apply(clean, p), err_msg=str(p))
        assert port.pitch_scale(p) == ref.pitch_scale(p)


@pytest.mark.parametrize("src,dst", [((250, 2500), (125, 1250)),
                                     ((37, 53), (80, 91)),
                                     ((40, 30), (40, 7)),
                                     ((100, 100), (23, 100)),
                                     ((9, 3), (1, 1))])
def test_bicubic_resize_equals_pillow(src, dst):
    """`native.resize_bicubic_u8` against `Image.resize` (Pillow's
    default filter), up and down, one axis at a time and both."""
    img = np.random.default_rng(sum(src)).integers(0, 256, src + (3,),
                                                   dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst[::-1]))
    np.testing.assert_array_equal(native.resize_bicubic_u8(img, dst), want)


def test_jpeg_axis_of_the_sweep_equals_jax():
    axes = [a for a in digitize_envelope.default_axes() if a.name == "jpeg_q"]
    jaxes = [a for a in jax_env.default_axes() if a.name == "jpeg_q"]
    rows = digitize_envelope.run_sweep(axes)
    assert rows == jax_env.run_sweep(jaxes)
    assert all(r["honest"] for r in rows)
    assert digitize_envelope.format_table(rows) == \
        jax_env.format_table(rows)
