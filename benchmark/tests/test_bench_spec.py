"""The benchmark finds its configurations, cells, jobs and per-layer
metrics by name from their files, `BENCHMARK.json` agrees with them, and
the command refuses what it cannot run."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run as bench_run
from benchmark.harness import spec

ROOT = os.path.dirname(spec.ROOT)
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)


def test_every_file_is_listed_and_every_entry_has_its_file():
    assert sorted(c["name"] for c in BENCH["configs"]) == spec.configs()
    assert sorted(w["name"] for w in BENCH["workloads"]) == spec.cells()
    assert sorted(m["name"] for m in BENCH["per_layer"]) == \
        spec.metric_names()


def test_entries_match_their_files():
    for entry in BENCH["configs"]:
        cfg = spec.load_config(entry["name"])
        assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
        assert entry["source"] == cfg["source"]
        assert entry["reduced"] == cfg["reduced"] == []
        assert cfg["peaks"] and cfg["peaks_why"]
    for entry in BENCH["workloads"]:
        cell = spec.load_cell(entry["name"])
        for key in ("config", "traffic", "chips", "why"):
            assert entry[key] == cell[key], (entry["name"], key)
        assert entry["chips"] == 1
        declared = [m["name"] for m in BENCH["end_to_end"]
                    if entry["name"] in m.get("workloads", [entry["name"]])]
        assert sorted(cell["end_to_end"]) == sorted(declared)
    readers = spec.metric_readers()
    for m in BENCH["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]
        assert readers[m["name"]].MOVES == m["moves"]
        # read in exactly the cells that report the metric it moves
        assert sorted(m["workloads"]) == sorted(
            c for c in spec.cells()
            if m["moves"] in spec.load_cell(c)["end_to_end"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert "device" in layers


@pytest.fixture
def copy_of_folder(tmp_path):
    dst = tmp_path / "benchmark"
    shutil.copytree(spec.ROOT, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return str(dst)


def test_a_new_cell_config_and_metric_are_found_from_their_files(
        copy_of_folder):
    root = copy_of_folder
    cell = spec.load_cell("fusion-train-b256", root)
    cell.pop("name")
    cell.update(batch=16, traffic="train-b16",
                why="B=16 steps, the reference's batch")
    with open(os.path.join(root, "workloads", "fusion-train-b16.json"),
              "w") as f:
        json.dump(cell, f)
    cfg = spec.load_config("fusion", root)
    cfg["name"] = "fusion_copy"
    with open(os.path.join(root, "configs", "fusion_copy.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "metrics", "step.count.train.py"),
              "w") as f:
        f.write('UNIT = "steps"\nMOVES = "train_samples_per_s.fusion"\n'
                '\n\ndef read(run):\n    return run.window.units\n')
    assert "fusion-train-b16" in spec.cells(root)
    assert spec.load_cell("fusion-train-b16", root)["batch"] == 16
    assert "fusion_copy" in spec.configs(root)
    assert spec.load_config("fusion_copy", root)["preset"] == "fusion"
    readers = spec.metric_readers(root)
    assert readers["step.count.train"].UNIT == "steps"
    # the folder the test copied from is untouched
    assert "fusion-train-b16" not in spec.cells()
    assert "step.count.train" not in spec.metric_readers()


def test_unknown_workload_fails(capsys):
    rc = bench_run.main(["--workload", "no-such-cell", "--seed", "1",
                         "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "unknown workload" in err


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal needs its absence")
    rc = bench_run.main(["--workload", "fusion-train-b256", "--seed",
                         "2718281828459", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "fusion-train-b256", "--seed", "5", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "program is missing" in proc.stderr


def test_forbidden_modules_compare_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ecgmm_tpu_like", object())
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", object())
    assert bench_run.forbidden_modules() == ["flax.core"]
