"""The port stands alone: `ecgmm_torch` and `chip_smoke.py` import neither
JAX (nor flax/optax/orbax) nor anything of `ecgmm_tpu`, nor Pillow,
pandas, matplotlib, openpyxl, wfdb or scikit-learn (the card's machine
has none), import without nvcc or a GPU, and their entry points do not
fall back to the CPU. The scan and the blocked import walk every module
of the package, the explainers of `ecgmm_torch/explain/` and the XAI CLI,
the record readers and writers of the real-data path and the CV
harnesses (`train/cv.py`, `train/cv_parallel.py`), the parallel package
(`parallel/*`), the collective report (`tools/tp_report.py`), the AOT
bundle (`serve/export.py`) and the tools (`tools/flax_msgpack.py`,
`convert_pth`, `export_pth`, `trace_report`, `digitize_batch`,
`digitize_envelope`, `eda`, `ocr`, `rows_cap_probe`, `train/profiler.py`)
among them. The msgpack package is refused as well: the port reads and
writes flax's format with its own codec; so are tensorboard and
tensorflow, since the port writes TensorBoard's event files itself."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ecgmm_tpu", "PIL",
             "pandas", "matplotlib", "openpyxl", "wfdb", "sklearn",
             "msgpack", "tensorboard", "tensorflow")
XAI_MODULES = ("deep_shap", "gradcam", "lime_fusion", "run_xai",
               "shap_fusion", "tabnet_masks")
REAL_DATA_MODULES = ("data.sources", "data.align", "data.pipeline",
                     "data.preprocess", "tools.records", "train.report",
                     "train.cv", "train.cv_parallel", "data.splits")
PARALLEL_MODULES = ("parallel.collectives", "parallel.mesh",
                    "parallel.launch", "parallel.tp", "tools.tp_report")
TOOL_MODULES = ("serve.export", "tools.flax_msgpack", "tools.convert_pth",
                "tools.export_pth", "train.profiler", "tools.trace_report",
                "tools.digitize_batch", "tools.digitize_envelope",
                "tools.eda", "tools.ocr", "tools.rows_cap_probe",
                "tools.export_times")
PORT_MODULES = REAL_DATA_MODULES + PARALLEL_MODULES + TOOL_MODULES


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ecgmm_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_no_forbidden_import_in_source():
    files = _port_files()
    for name in XAI_MODULES:
        assert os.path.join(REPO, "ecgmm_torch", "explain",
                            f"{name}.py") in files
    for name in PORT_MODULES:
        assert os.path.join(REPO, "ecgmm_torch",
                            *name.split(".")) + ".py" in files
    bad = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_imports_with_jax_blocked():
    """Every module of the port, and chip_smoke as a module, import in a
    fresh interpreter where importing JAX (or the JAX package) fails."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {REPO!r})
        import ecgmm_torch
        mods = [m.name for m in pkgutil.walk_packages(
            ecgmm_torch.__path__, "ecgmm_torch.")]
        for m in mods:
            importlib.import_module(m)
        assert all(f"ecgmm_torch.explain.{{n}}" in mods
                   for n in {XAI_MODULES!r})
        assert all(f"ecgmm_torch.{{n}}" in mods
                   for n in {PORT_MODULES!r})
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", {os.path.join(REPO, "chip_smoke.py")!r})
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.main)
        leaked = [k for k, v in sys.modules.items() if v is not None
                  and k.split(".")[0] in {FORBIDDEN!r}]
        assert not leaked, leaked
        print(len(mods))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every submodule was walked


def test_demo_defaults_to_the_card():
    """ServingPipeline.demo() with no device argument serves on CUDA: where
    there is no card it raises instead of quietly using the CPU."""
    from ecgmm_torch.serve.pipeline import ServingPipeline

    if torch.cuda.is_available():
        pipe = ServingPipeline.demo()
        assert pipe.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingPipeline.demo()


def test_train_cli_runs_on_cpu_with_jax_blocked(tmp_path):
    """`python -m ecgmm_torch.workloads.run --preset ptbxl_af --device cpu
    --epochs 1 --n-synth 48` trains the full-width model on the CPU, with
    JAX and the JAX package blocked, and writes its checkpoints, metric
    log (metrics.jsonl and a TensorBoard event file) and best/last
    reports, the confusion and ROC PNGs among them."""
    code = textwrap.dedent(f"""
        import runpy, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {REPO!r})
        sys.argv = ["run", "--preset", "ptbxl_af", "--device", "cpu",
                    "--epochs", "1", "--n-synth", "48",
                    "--run-dir", "checkpoints/r"]
        runpy.run_module("ecgmm_torch.workloads.run", run_name="__main__")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr
    assert "epoch 1/1" in out.stdout
    assert "[best]" in out.stdout and "[last]" in out.stdout
    for path in ("checkpoints/r/best.pt", "checkpoints/r/last.pt",
                 "checkpoints/r/calibration.pt", "runs/r/metrics.jsonl",
                 "output/r/report_best.txt", "output/r/report_last.txt",
                 "output/r/confusion_best.png", "output/r/roc_last.png"):
        assert (tmp_path / path).is_file(), path
    # the TensorBoard event file beside the metric log, as JAX's run
    # writes one
    assert len(list((tmp_path / "runs/r").glob("events.out.tfevents.*"))) == 1


def test_train_cli_defaults_to_the_card():
    """Without --device the CLI trains on CUDA: where there is no card it
    raises instead of quietly using the CPU. `--data-dir` is a real-data
    request: a directory without the preset's manifest raises, naming it,
    instead of training on the synthetic cohort."""
    from ecgmm_torch.workloads import run

    argv = ["--preset", "ptbxl_af", "--epochs", "1", "--n-synth", "48"]
    if torch.cuda.is_available():
        assert run._device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            run.main(argv)
    with pytest.raises(FileNotFoundError,
                       match="ptbxl_database.csv not found"):
        run.main(argv + ["--data-dir", "/nonexistent", "--device", "cpu"])


def test_cv_cli_defaults_to_the_card():
    """Without --device the CV CLI trains on CUDA: where there is no card
    it raises instead of quietly using the CPU, in every mode."""
    from ecgmm_torch.train import cv
    from ecgmm_torch.workloads import run

    for argv in (["nested", "--n-synth", "48", "--epochs", "1"],
                 ["exhaustive", "--fold-parallel", "--n-synth", "48"]):
        if torch.cuda.is_available():
            assert run._device("cuda").type == "cuda"
            continue
        with pytest.raises(RuntimeError, match="--device cpu"):
            cv.main(argv)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, chip_smoke.py fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
