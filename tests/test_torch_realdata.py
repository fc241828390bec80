"""The port's real-data path (`ecgmm_torch.workloads.run.load_data` with a
record source, and the CLI's `--data`/`--data-dir`) against the JAX
package's `load_data` on the CPU, on a hospital directory, a PTB-XL
layout and a PhysioNet/CinC 2017 layout that the tests write
(`ecgmm_torch.tools.records`; the hospital images with Pillow, as the JAX
fixture writer saves them, two of them CMYK).

Bars: indices, labels, images (bit for bit), clinical values and both
scalers equal; the hospital-filtered signals equal as float32 (the bar
tests/test_torch_native_host.py holds the native filter to against
JAX's); the PTB-XL and PhysioNet
signals within 1e-5 (scipy's filtfilt against the JAX scan, both in
float64, stored as float32), as tests/test_torch_train.py holds them.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

from ecgmm_tpu.config import get_preset as jax_get_preset
from ecgmm_tpu.workloads import run as jax_run
from ecgmm_torch.config import get_preset
from ecgmm_torch.data import sources
from ecgmm_torch.data.synthetic import make_cohort
from ecgmm_torch.tools import records
from ecgmm_torch.workloads import run as port_run

torch.set_num_threads(2)

T = 256


@pytest.fixture(scope="module")
def hospital(tmp_path_factory):
    """48 patients, ids 1..48: every 8th label Borderline; 17 (in
    known_missing) and 40 without an image folder, 23 (in known_missing)
    with one; 4 a Pillow CMYK JPEG, 5 the writer's CMYK JPEG; 60x600
    strips."""
    root = tmp_path_factory.mktemp("hospital")
    c = make_cohort(n=48, signal_len=T, img_hw=(60, 600), seed=11)
    labels = np.where(c.labels == 1, "Abnormal", "Normal").astype(object)
    labels[np.arange(48) % 8 == 5] = "Borderline"
    images = {int(i): img for i, img in zip(c.indices, c.images)
              if i not in (17, 40)}
    records.write_hospital(str(root), c.indices, labels, c.signals,
                           {"AGE": c.clinical[:, 0], "Wt": c.clinical[:, 1]},
                           images, cmyk=(5,), csv_sibling=True)
    for idx, img in images.items():
        if idx != 5:
            im = Image.fromarray(img)
            im = im.convert("CMYK") if idx == 4 else im
            im.save(sources.image_path(str(root / "images"), idx),
                    format="JPEG")
    return str(root)


@pytest.fixture(scope="module")
def ptbxl(tmp_path_factory):
    root = tmp_path_factory.mktemp("ptbxl")
    rng = np.random.default_rng(12)
    n = 36
    codes = [("{'AFIB': 100.0}", "{'SR': 100.0, 'NORM': 100.0}",
              "{'NORM': 100.0}", "{'STACH': 100.0}")[k % 4]
             for k in range(n)]
    digital = rng.integers(-2000, 2000, (n, 2 * T, 12)).astype(np.int16)
    records.write_ptbxl(str(root), digital, codes, rng.uniform(30, 80, n),
                        rng.uniform(50, 90, n))
    return str(root)


@pytest.fixture(scope="module")
def cinc(tmp_path_factory):
    root = tmp_path_factory.mktemp("cinc")
    rng = np.random.default_rng(13)
    n = 48
    labels = [("N", "A", "O", "N", "~", "A")[k % 6] for k in range(n)]
    sigs = [rng.integers(-1500, 1500, int(rng.integers(T - 60, T + 90))
                         ).astype(np.int16) for _ in range(n)]
    records.write_cinc2017(str(root), [f"A{k:05d}" for k in range(1, n + 1)],
                           labels, sigs)
    return str(root)


def _configs(name, **data):
    out = []
    for get in (jax_get_preset, get_preset):
        cfg = get(name)
        out.append(dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, signal_len=T, img_height=32, img_width=40, **data)))
    return out


def _compare(want, got, signals_atol=0.0):
    for split in ("train", "val", "test"):
        j, p = getattr(want, split), getattr(got, split)
        assert p.n == j.n > 0
        np.testing.assert_array_equal(p.indices, j.indices)
        np.testing.assert_array_equal(p.labels.numpy(), np.asarray(j.labels))
        if j.images is not None:
            np.testing.assert_array_equal(
                p.images.numpy(), np.asarray(j.images).transpose(0, 3, 1, 2))
            np.testing.assert_array_equal(p.clinical.numpy(),
                                          np.asarray(j.clinical))
        if signals_atol:
            np.testing.assert_allclose(p.signals.numpy(),
                                       np.asarray(j.signals),
                                       atol=signals_atol, rtol=0)
        else:
            np.testing.assert_array_equal(p.signals.numpy(),
                                          np.asarray(j.signals))
    for s in ("ecg_scaler", "clinical_scaler"):
        js, ps = getattr(want, s), getattr(got, s)
        if ps is None:  # the signal tasks: JAX's identity scaler
            np.testing.assert_array_equal(js.mean, 0)
            np.testing.assert_array_equal(js.scale, 1)
            continue
        np.testing.assert_array_equal(ps.mean, js.mean)
        np.testing.assert_array_equal(ps.scale, js.scale)


@pytest.mark.parametrize("name", ["fusion", "signal_only"])
def test_hospital_load_data_matches_jax(hospital, name):
    jcfg, pcfg = _configs(name, data_dir=hospital)
    want = jax_run.load_data(jcfg, "hospital", 0)
    got = port_run.load_data(pcfg, "hospital", 0, device="cpu")
    _compare(want, got)
    kept = np.concatenate([got.train.indices, got.val.indices,
                           got.test.indices])
    assert {4, 5} <= set(kept) and not {17, 23, 36, 40, 43} & set(kept)
    # 6 Borderline; 17, 23, 36 and 43 known missing, 40 without images
    assert len(kept) == 48 - 6 - 5


def test_ptbxl_load_data_matches_jax(ptbxl):
    jcfg, pcfg = _configs("ptbxl_af", ptbxl_dir=ptbxl)
    want = jax_run.load_data(jcfg, "hospital", 0)
    got = port_run.load_data(pcfg, "hospital", 0, device="cpu")
    _compare(want, got, signals_atol=1e-5)


@pytest.mark.parametrize("name", ["physionet", "physionet_multi",
                                  "physionet_crnn"])
def test_physionet_load_data_matches_jax(cinc, name):
    jcfg, pcfg = _configs(name, physionet_dir=cinc)
    want = jax_run.load_data(jcfg, "hospital", 0)
    got = port_run.load_data(pcfg, "hospital", 0, device="cpu")
    _compare(want, got, signals_atol=1e-5)


@pytest.mark.parametrize("name,field,manifest", [
    ("ptbxl_af", "ptbxl_dir", "ptbxl_database.csv"),
    ("physionet_multi", "physionet_dir", "REFERENCE.csv")])
def test_missing_manifest_raises_as_in_jax(tmp_path, name, field, manifest):
    jcfg, pcfg = _configs(name, **{field: str(tmp_path)})
    with pytest.raises(FileNotFoundError, match=manifest):
        jax_run.load_data(jcfg, "hospital", 0)
    with pytest.raises(FileNotFoundError, match=manifest):
        port_run.load_data(pcfg, "hospital", 0, device="cpu")
    with pytest.raises(ValueError, match="unknown data source"):
        port_run.load_data(_configs("fusion")[1], "ptbxl", 0, device="cpu")
    with pytest.raises(TypeError, match="source"):
        port_run.load_data(pcfg, 40, device="cpu")


@pytest.mark.parametrize("preset,layout", [
    ("fusion", "hospital"), ("ptbxl_af", "ptbxl"),
    ("physionet_multi", "cinc")])
def test_cli_trains_a_step_on_records(request, tmp_path, monkeypatch,
                                      preset, layout):
    """`--data-dir` alone means real data: the CLI reads the directory and
    trains one step (one batch holds the train split) at the preset's full
    width on the CPU, and writes the reports, the PNGs among them."""
    root = request.getfixturevalue(layout)
    monkeypatch.chdir(tmp_path)
    port_run.main(["--preset", preset, "--data-dir", root, "--device",
                   "cpu", "--epochs", "1", "--batch-size", "64",
                   "--run-dir", str(tmp_path / "ckpt")])
    out = os.path.join("output", "ckpt")
    names = set(os.listdir(out))
    assert {"report_best.txt", "report_last.txt", "confusion_best.png",
            "confusion_last.png"} <= names
    assert ("roc_best.png" in names) == (preset != "physionet_multi")
    with open(os.path.join("runs", "ckpt", "metrics.jsonl")) as f:
        assert len(f.readlines()) == 1
