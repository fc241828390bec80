"""One run of one cell: the job named by the cell's file sets up, measures
its window, traces a stretch where asked, and checks its outputs; this
module turns that into the result's line.

With `trace` off the metrics are the end-to-end ones the cell's file
lists (`end_to_end`), each the job's quantity named by the part of its
name before the first `.`; with it on, the per-layer readers'
(`metrics/*.py`) whose `MOVES` the cell lists, each given the `Run`: a
reader that finds nothing to read returns None and its metric is left
out."""

from __future__ import annotations

import dataclasses
import math
import tempfile
from typing import Dict, Optional

import torch

from benchmark.harness import judge, spec
from benchmark.harness.clock import Window
from benchmark.harness.trace import Trace


@dataclasses.dataclass
class Ctx:
    """What a job is given."""

    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float      # the process's start on the host clock
    workdir: str        # a temporary directory under TMPDIR


@dataclasses.dataclass
class Run:
    """What a job hands back, and what the per-layer readers read."""

    job: str
    cell: dict
    config: dict
    window: Window
    end_to_end: Dict[str, tuple]          # quantity -> (value, unit)
    numbers: Dict[str, float]             # the compared numbers
    attempted: int
    failed: int
    memory_peak_bytes: int
    flops_per_unit: float = 0.0
    peak: str = "float32"
    trace: Optional[Trace] = None


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def device_info(device: torch.device, run: Run) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device), "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = int(run.memory_peak_bytes)
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info


def per_layer(run: Run, root: str = spec.ROOT) -> Dict[str, dict]:
    out = {}
    for name, reader in spec.metric_readers(root).items():
        if reader.MOVES not in run.cell["end_to_end"]:
            continue
        value = reader.read(run)
        if value is not None:
            out[name] = {"value": float(value), "unit": reader.UNIT}
    return out


def execute(cell: dict, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float,
            root: str = spec.ROOT) -> dict:
    """The result's line of one run, as a dict (its last key `checks`)."""
    config = spec.load_config(cell["config"], root)
    job = spec.job(cell["job"], root)
    with tempfile.TemporaryDirectory(prefix="bench-") as workdir:
        run = job.run(Ctx(cell, config, seed, seconds, trace, device,
                          t_start, workdir))
    correct, checks = judge.verdict(run.numbers, cell["limits"])
    if trace:
        metrics = per_layer(run, root)
    else:
        metrics = {}
        for name in cell["end_to_end"]:
            value, unit = run.end_to_end[name.split(".", 1)[0]]
            metrics[name] = {"value": float(value), "unit": unit}
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics,
              "device": device_info(device, run)}
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.top_ops(10),
                               "idle_gaps": run.trace.idle_gaps(10)}
    result["checks"] = checks
    return _finite(result)
