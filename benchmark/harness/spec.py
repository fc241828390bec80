"""The benchmark's files, found by name: a configuration is
`configs/<name>.json`, a cell is `workloads/<name>.json` (its
configuration, its traffic parameters, the end-to-end metrics it reports,
its limits and its why), a job is
`jobs/<job>.py` and a per-layer metric is `metrics/<name>.py`, a reader
with `UNIT`, `MOVES` (the end-to-end metric it should move: it is read in
the cells that report that one) and `read(run)`. An end-to-end metric's
name is the job's quantity, with what follows its first `.` naming the
cells that report it apart (`train_samples_per_s.fusion`). Adding a
configuration, a cell or a metric is adding its file."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class SpecError(ValueError):
    """A cell, configuration or reader that is missing or malformed."""


def _names(root: str, sub: str, ext: str) -> List[str]:
    d = os.path.join(root, sub)
    return sorted(f[:-len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def _json(path: str, what: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"no {what} file {path}") from None


def cells(root: str = ROOT) -> List[str]:
    return _names(root, "workloads", ".json")


def configs(root: str = ROOT) -> List[str]:
    return _names(root, "configs", ".json")


def metric_names(root: str = ROOT) -> List[str]:
    return _names(root, "metrics", ".py")


def load_cell(name: str, root: str = ROOT) -> dict:
    if name not in cells(root):
        raise SpecError(f"unknown workload {name!r}; the cells are "
                        f"{cells(root)}")
    cell = _json(os.path.join(root, "workloads", name + ".json"), "cell")
    cell["name"] = name
    for key in ("config", "job", "chips", "end_to_end", "limits", "why"):
        if key not in cell:
            raise SpecError(f"cell {name!r} has no {key!r}")
    return cell


def load_config(name: str, root: str = ROOT) -> dict:
    cfg = _json(os.path.join(root, "configs", name + ".json"), "config")
    if cfg.get("name") != name:
        raise SpecError(f"configs/{name}.json names itself {cfg.get('name')!r}")
    return cfg


def _module(path: str, name: str) -> ModuleType:
    """The module of the file at `path`, loaded once a file (registered
    under a name that holds the file's place, so that two copies of the
    folder load apart)."""
    name = f"{name}_{hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:12]}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def metric_readers(root: str = ROOT) -> Dict[str, ModuleType]:
    """{metric name: its reader module}."""
    out = {}
    for name in metric_names(root):
        mod = _module(os.path.join(root, "metrics", name + ".py"),
                      "benchmark_metric_" + name.replace(".", "_"))
        for attr in ("UNIT", "MOVES", "read"):
            if not hasattr(mod, attr):
                raise SpecError(f"metrics/{name}.py has no {attr}")
        out[name] = mod
    return out


def job(name: str, root: str = ROOT) -> ModuleType:
    path = os.path.join(root, "jobs", name + ".py")
    if not os.path.exists(path):
        raise SpecError(f"no job {name!r} ({path})")
    return _module(path, "benchmark_job_" + name)
