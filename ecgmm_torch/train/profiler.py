"""Tracing and profiling utilities (port of `ecgmm_tpu/train/profiler.py`).

  * `trace(logdir)`: a context manager around `torch.profiler` (CPU and,
    where there is a card, CUDA activities) that writes the Chrome trace
    as `<logdir>/plugins/profile/<ts>/<host>.pt.trace.json.gz`, the
    layout `tools/trace_report.py` reads;
  * `StepTimer`: a wall-clock samples/s meter with a warmup discard; given
    a CUDA device it synchronises the device when a step closes, so a
    step's time includes its kernels;
  * `live_buffer_bytes()` / `device_memory_stats()`: the allocator's
    figures on the card (`torch.cuda.memory_allocated`,
    `torch.cuda.memory_stats`), 0 and {} plus the live bytes on the CPU;
  * `compiled_flops(fn, *args)`: the FLOPs of one call, counted by
    `torch.utils.flop_counter.FlopCounterMode` (matmuls and convolutions,
    forward and backward), None where it cannot count.
"""

from __future__ import annotations

import contextlib
import gzip
import os
import shutil
import socket
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body with `torch.profiler` and write its Chrome trace
    under `<logdir>/plugins/profile/<ts>/`; yields the profiler. Where
    there is a card the CUDA activity is recorded too. The trace can miss
    the first kernels launched after it starts: run a warm-up step first,
    inside a `torch.profiler.record_function` that synchronises the
    device before it closes, and read the trace with `trace_report
    --after` that annotation's name."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    stamp = time.strftime("%Y_%m_%d_%H_%M_%S")
    out_dir = os.path.join(logdir, "plugins", "profile", stamp)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{socket.gethostname()}.pt.trace.json.gz")
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        raw = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(raw)
        with open(raw, "rb") as src, gzip.open(path, "wb") as dst:
            shutil.copyfileobj(src, dst)


class StepTimer:
    """Accumulates per-step wall times after a warmup discard; reports
    samples/s. With a CUDA `device` each step synchronises the device on
    exit, so the time covers the step's kernels."""

    def __init__(self, warmup: int = 3, device=None):
        self.warmup = warmup
        self.device = None if device is None else torch.device(device)
        self._times = []
        self._t0: Optional[float] = None
        self._seen = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self._times.append(dt)

    def samples_per_sec(self, batch_size: int) -> float:
        if not self._times:
            return float("nan")
        return batch_size / float(np.mean(self._times))

    @property
    def mean_step_ms(self) -> float:
        return (float(np.mean(self._times)) * 1e3 if self._times
                else float("nan"))


def live_buffer_bytes(device=None) -> int:
    """Bytes of live tensors on the card (`torch.cuda.memory_allocated`);
    0 without one."""
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.memory_allocated(device))


def device_memory_stats(device=None) -> Dict[str, int]:
    """The allocator's counters of `device` (`torch.cuda.memory_stats`:
    allocated, reserved, peaks ...) plus `live_buffer_bytes`; on the CPU
    only `live_buffer_bytes` (0)."""
    dev = torch.device("cuda" if device is None and
                       torch.cuda.is_available() else device or "cpu")
    stats: Dict[str, int] = {}
    if dev.type == "cuda":
        stats = {k: int(v) for k, v in torch.cuda.memory_stats(dev).items()
                 if isinstance(v, (int, float))}
        stats["live_buffer_bytes"] = live_buffer_bytes(dev)
    else:
        stats["live_buffer_bytes"] = 0
    return stats


def compiled_flops(fn, *args) -> Optional[float]:
    """FLOPs of one call of `fn(*args)` (its backward too, where the call
    runs one), from `FlopCounterMode`; None where counting fails."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        counter = FlopCounterMode(display=False)
        with counter:
            fn(*args)
        return float(counter.get_total_flops())
    except Exception:
        return None
