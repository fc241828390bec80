"""`correct` against its faults, at a size a CPU test run holds: the
harness's whole run (set-up, window, trace, reference) with the look for a
card skipped, once sound, once for each fault the cell can have, planted
in the program underneath: a step that returns its state unchanged (from
the start, or only once warmed up), and half of each batch left out (the
mean taken over the rest). The control (the reference in the
configuration's lower precision, in the program's place) is held against
the committed limits too. The cells run at a small size with float32 encoders: the
CPU's bfloat16 autocast is not the card's, so the fusion cell's sound
run is only comparable in float32 here."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import pytest
import torch

from benchmark import calibrate
from benchmark.harness import judge, spec
from benchmark.harness.execute import Ctx, execute

SMALL = {
    "fusion-train-b256": {"batch": 4, "pool": 8, "stretch_steps": 1},
    "transformer-train-b8": {"batch": 2, "pool": 6, "stretch_steps": 1},
}

@pytest.fixture
def small(tmp_path, monkeypatch):
    """A copy of the benchmark's files at a small size: 64x64 images,
    600-sample Transformer signals, float32 fusion encoders; the port's
    presets follow."""
    from ecgmm_torch import config as port_config

    root = str(tmp_path / "benchmark")
    shutil.copytree(spec.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    fusion = spec.load_config("fusion", root)
    fusion["inputs"]["image"] = [3, 64, 64]
    fusion["model"]["dtype"] = "float32"
    tr = spec.load_config("physionet_transformer", root)
    tr["inputs"]["signal_len"] = tr["model"]["seq_len"] = 600
    for cfg in (fusion, tr):
        with open(os.path.join(root, "configs", cfg["name"] + ".json"),
                  "w") as f:
            json.dump(cfg, f)
    presets = dict(port_config.PRESETS)

    def fusion_f32():
        c = presets["fusion"]()
        return dataclasses.replace(
            c, model=dataclasses.replace(c.model, dtype="float32"))

    def short_transformer():
        c = presets["physionet_transformer"]()
        return dataclasses.replace(
            c, data=dataclasses.replace(c.data, signal_len=600))

    monkeypatch.setitem(port_config.PRESETS, "fusion", fusion_f32)
    monkeypatch.setitem(port_config.PRESETS, "physionet_transformer",
                        short_transformer)
    monkeypatch.setattr(spec.job("train", root), "WARMUP_STEPS", 1)
    return root


def _run(root, cell, seed=4294967311, trace=False):
    return execute(cell, seed, 0.3, trace, torch.device("cpu"),
                   time.perf_counter(), root)


def _cell(root, name):
    cell = spec.load_cell(name, root)
    cell.update(SMALL[name])
    return cell


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(small, name):
    result = _run(small, _cell(small, name), trace=True)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    mfu = [v["value"] for k, v in result["metrics"].items()
           if k.startswith("step.mfu.")]
    assert len(mfu) == 1 and mfu[0] > 0
    plain = _run(small, _cell(small, name))
    assert sorted(plain["metrics"]) == sorted(_cell(small, name)["end_to_end"])


@pytest.mark.parametrize("name", sorted(SMALL))
def test_state_left_unchanged_is_not_correct(small, name, monkeypatch):
    from ecgmm_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "step", lambda self, count: None)
    result = _run(small, _cell(small, name))
    assert not result["correct"]
    for check in ("first", "warm"):
        assert result["checks"][f"{check}.update_gap"]["value"] >= 0.99


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_fault_after_the_warm_up_is_not_correct(small, name, monkeypatch):
    """A step that goes wrong only once warmed up (as work captured or
    tuned during the warm-up would) fails the warm check alone."""
    from ecgmm_torch.train import optim

    job = spec.job("train", small)
    sound = optim.Optimizer.step
    warm = job.CHECK_STEPS + job.WARMUP_STEPS

    def step(self, count):
        if count < warm:
            sound(self, count)

    monkeypatch.setattr(optim.Optimizer, "step", step)
    result = _run(small, _cell(small, name))
    assert not result["correct"]
    checks = result["checks"]
    assert all(c["value"] <= c["limit"] for k, c in checks.items()
               if k.startswith("first.")), checks
    assert checks["warm.update_gap"]["value"] >= 0.99


@pytest.mark.parametrize("name", sorted(SMALL))
def test_half_batch_is_not_correct(small, name, monkeypatch):
    from ecgmm_torch.train import engine

    gather = engine.gather_batch

    def half(arrays, idx, mask):
        k = idx.shape[0] // 2
        return gather(arrays, idx[:k], mask[:k])

    monkeypatch.setattr(engine, "gather_batch", half)
    result = _run(small, _cell(small, name))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(small, name):
    cell = _cell(small, name)
    config = spec.load_config(cell["config"], small)
    job = spec.job(cell["job"], small)
    with tempfile.TemporaryDirectory() as wd:
        ctx = Ctx(cell, config, 99991, 0.0, False, torch.device("cpu"),
                  time.perf_counter(), wd)
        (kind, numbers, _), = calibrate.train_readings(job, ctx,
                                                       ["control"])
    ok, checks = judge.verdict(numbers, cell["limits"])
    assert kind == "control" and not ok, checks


@pytest.mark.card
def test_each_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: runs on the chip only")
    root = os.path.dirname(spec.ROOT)
    for name in spec.cells():
        proc = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", name,
             "--seed", "8589934583", "--seconds", "3", "--trace", "1"],
            cwd=root, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
