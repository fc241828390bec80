"""The traced stretch and its reduction: `torch.profiler` over a
synchronising warm-up and then a stretch of units, the trace's device
events (kernels, copies, sets) inside the stretch, the device's busy time
as the union of their intervals, the idle gaps named by the host's CUDA
calls, and the events by category.

On the card the profiler records CUDA activity alone (the kernels and the
host's runtime calls): recording every host operation as well costs the
host about as much as a host-paced step itself (a B=256 fusion step read
38 ms untraced and 66 ms traced so), and the idle share would read the
profiler's cost. Two synchronous copies of MARK_BYTES bytes bound the
stretch on the device's timeline: after the warm-up, which a trace needs
because it can miss the first kernels launched after it starts, and after
the stretch's closing synchronise.
Off the card (the CPU tests) the host's operations are recorded and the
annotations bound the stretch.

The categories and the port's kernel names follow the classification of
the program's own trace report: the first pattern that matches wins."""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
# the kernels of the port's CUDA sources, longest first so that
# se_bwd_params is not taken for se_bwd
PORT_KERNELS = ("fusion_bwd_params", "fusion_bwd_rows", "se_bwd_params",
                "fusion_fwd", "focal_fwd", "focal_bwd", "se_fwd", "se_bwd")
_KERNEL_RE = re.compile(
    r"(?<![A-Za-z0-9_])(" + "|".join(PORT_KERNELS) + r")(?![A-Za-z0-9_])")
_CATEGORIES = (
    ("batch norm", re.compile(r"batch_?norm|bn_fw|bn_bw|welford", re.I)),
    ("conv", re.compile(r"conv|cudnn|wgrad|dgrad|fprop", re.I)),
    ("gemm", re.compile(r"gemm|cutlass|cublas|xmma|matmul|aten::(add|b)?mm"
                        r"|aten::linear|aten::addmv", re.I)),
    ("reduction", re.compile(r"reduce|aten::(sum|mean|var|max|min|amax"
                             r"|argmax|std|norm)\b", re.I)),
    ("elementwise", re.compile(r"elementwise|aten::", re.I)),
)
WARMUP, STRETCH = "bench.warmup", "bench.stretch"
# the size of the copies that bound the stretch (a prime no step copies)
MARK_BYTES = 7919


def category(name: str, cat: str = "kernel") -> str:
    """The category of one device event."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "memcpy"
    m = _KERNEL_RE.search(name)
    if m:
        return "port " + m.group(1)
    for label, pattern in _CATEGORIES:
        if pattern.search(name):
            return label
    return "other"


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The merged (start, end) intervals of a list of them."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def gaps(busy: List[Tuple[float, float]], start: float, end: float
         ) -> List[Tuple[float, float]]:
    """The idle (start, end) intervals of [start, end] around the merged
    busy ones."""
    out, t = [], start
    for s, e in busy:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


@dataclasses.dataclass
class DeviceEvent:
    name: str
    ts: float      # us
    dur: float     # us
    category: str
    device: int


@dataclasses.dataclass
class Trace:
    """The stretch of a trace: `units` units of work in [start, end] us."""

    events: List[DeviceEvent]
    host: List[Tuple[float, float, str]]
    start: float
    end: float
    units: int

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def devices(self) -> List[int]:
        return sorted({e.device for e in self.events})

    def busy_intervals(self, device: int) -> List[Tuple[float, float]]:
        return union([(max(e.ts, self.start), min(e.ts + e.dur, self.end))
                      for e in self.events if e.device == device])

    @property
    def busy_s(self) -> float:
        """Seconds with an operation running, averaged over the devices."""
        devs = self.devices()
        if not devs:
            return 0.0
        return sum(sum(e - s for s, e in self.busy_intervals(d))
                   for d in devs) / len(devs) / 1e6

    def category_us(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.events:
            out[e.category] = out.get(e.category, 0.0) + e.dur
        return out

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for e in self.events:
            by[e.name] = by.get(e.name, 0.0) + e.dur
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], us / 1e6] for name, us in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The n longest idle gaps of the first device, each named by the
        innermost host event running at its middle, or else by the first
        that starts in the gap ("before cudaLaunchKernel": the device
        waited for the host's next launch)."""
        devs = self.devices()
        if not devs:
            return []
        found = gaps(self.busy_intervals(devs[0]), self.start, self.end)
        found.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in found[:n]:
            mid = 0.5 * (s + e)
            covering = [(he - hs, name) for hs, he, name in self.host
                        if hs <= mid <= he
                        and name not in (WARMUP, STRETCH)]
            if covering:
                name = min(covering)[1]
            else:
                after = [(hs, n) for hs, _, n in self.host if s <= hs <= e]
                name = ("before " + min(after)[1]) if after \
                    else "host: no call"
            out.append([name[:160], (e - s) / 1e6])
        return out


def _bounds(raw: List[dict]) -> Tuple[float, float]:
    """(start, end) us of the stretch: from the end of the first marker
    copy to the start of the last, or else from the end of the warm-up
    annotation to the end of the stretch annotation."""
    marks = sorted((float(e["ts"]), float(e.get("dur", 0.0))) for e in raw
                   if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
                   and (e.get("args") or {}).get("bytes") == MARK_BYTES)
    if len(marks) >= 2:
        return marks[0][0] + marks[0][1], marks[-1][0]
    notes = {e.get("name"): e for e in raw if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") in (WARMUP, STRETCH)}
    if STRETCH not in notes:
        raise ValueError("the trace has no bounds for its stretch")
    end = float(notes[STRETCH]["ts"]) + float(notes[STRETCH]["dur"])
    start = float(notes[STRETCH]["ts"])
    if WARMUP in notes:
        start = max(start, float(notes[WARMUP]["ts"])
                    + float(notes[WARMUP]["dur"]))
    return start, end


def _mark(device: torch.device) -> None:
    """A synchronous host-to-device copy of MARK_BYTES bytes: a device
    event that the host waits for, which bounds the stretch."""
    if device.type == "cuda":
        torch.empty(MARK_BYTES, dtype=torch.uint8, device=device).copy_(
            torch.zeros(MARK_BYTES, dtype=torch.uint8))


def from_events(raw: List[dict], units: int) -> Trace:
    """The stretch of a Chrome trace's events (`export_chrome_trace`)."""
    start, end = _bounds(raw)
    events, host = [], []
    for e in raw:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS and start <= ts < end:
            dev = (e.get("args") or {}).get("device", e.get("pid", 0))
            events.append(DeviceEvent(e.get("name", ""), ts, dur,
                                      category(e.get("name", ""), cat),
                                      int(dev) if str(dev).isdigit() else 0))
        elif cat in HOST_CATS and ts <= end and ts + dur >= start:
            host.append((ts, ts + dur, e.get("name", "")))
    return Trace(events, host, start, end, units)


def profile(units: Callable[[], int], warm: Callable[[], None],
            device: torch.device, workdir: str) -> Trace:
    """Trace `warm()` and a synchronise, a marker copy, `units()` (which
    returns how many units it ran) and a synchronise, and a marker copy."""
    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CUDA if device.type == "cuda"
                  else ProfilerActivity.CPU]
    done = 0
    with torch.profiler.profile(activities=activities) as prof:
        with record_function(WARMUP):
            warm()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        _mark(device)
        with record_function(STRETCH):
            done = units()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        _mark(device)
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        raw = json.load(f).get("traceEvents", [])
    os.remove(path)
    return from_events(raw, done)

