"""The port stands alone: `ecgmm_torch` and `chip_smoke.py` import neither
JAX (nor flax/optax/orbax) nor anything of `ecgmm_tpu`, import without
nvcc or a GPU, and their entry points do not fall back to the CPU."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ecgmm_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ecgmm_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_no_forbidden_import_in_source():
    bad = []
    for path in _port_files():
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


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, chip_smoke.py fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
