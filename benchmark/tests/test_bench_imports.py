"""What the command runs loads no JAX: in a fresh interpreter, import the
command, every job, every metric reader, every reference module and the
modules of the port that the jobs call, then look at `sys.modules` by
whole top-level names. The reference imports nothing of the program, and
nothing under the benchmark reads the JAX-era files."""

import ast
import glob
import json
import os
import subprocess
import sys

from benchmark.harness import spec

ROOT = os.path.dirname(spec.ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ecgmm_tpu")
PORT_MODULES = ("ecgmm_torch.workloads.run", "ecgmm_torch.train.engine",
                "ecgmm_torch.train.state", "ecgmm_torch.data.pipeline",
                "ecgmm_torch.precision")

PROBE = """
import importlib, json, sys
sys.path.insert(0, {root!r})
import runpy
runpy.run_path({run!r}, run_name="bench_run_probe")
from benchmark.harness import spec
for name in {jobs!r}:
    spec.job(name)
spec.metric_readers()
for mod in {refs!r} + {port!r}:
    importlib.import_module(mod)
print(json.dumps(sorted(sys.modules)))
"""


def _reference_modules():
    return sorted("benchmark.reference." + os.path.basename(p)[:-3]
                  for p in glob.glob(os.path.join(spec.ROOT, "reference",
                                                  "*.py"))
                  if not p.endswith("__init__.py"))


def test_no_jax_in_the_process():
    jobs = sorted(os.path.basename(p)[:-3] for p in
                  glob.glob(os.path.join(spec.ROOT, "jobs", "*.py")))
    code = PROBE.format(root=ROOT, run=os.path.join(spec.ROOT, "run.py"),
                        jobs=jobs, refs=_reference_modules(),
                        port=list(PORT_MODULES))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".", 1)[0] in FORBIDDEN]
    assert bad == []
    assert "ecgmm_torch" in {m.split(".", 1)[0] for m in loaded}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    paths = glob.glob(os.path.join(spec.ROOT, "reference", "*.py"))
    assert paths
    for path in paths:
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not tops & {"ecgmm_torch", *FORBIDDEN}, path
    code = ("import sys; sys.path.insert(0, %r); import importlib\n"
            "for m in %r: importlib.import_module(m)\n"
            "print(sorted({k.split('.')[0] for k in sys.modules}))"
            % (ROOT, _reference_modules()))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tops = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    assert "ecgmm_torch" not in tops
    assert not set(tops) & set(FORBIDDEN)


def test_nothing_reads_the_jax_era_files():
    names = ("bench.py", "chip_smoke", "BENCH_", "MULTICHIP_",
             "BASELINE.json")
    for path in glob.glob(os.path.join(spec.ROOT, "**", "*.py"),
                          recursive=True):
        if os.sep + "tests" + os.sep in path:
            continue
        with open(path) as f:
            text = f.read()
        for name in names:
            assert name not in text, (path, name)
