"""The measured window: units of work (train steps, reports) issued back
to back from one host thread, a CUDA event recorded after each, and one
synchronise at the end. A unit's time is the span between consecutive
end-of-unit events, so idle gaps on the device count; the rate is all the
units over the wall time from the window's start to its final
synchronise. Off the card (the CPU tests) the spans are the host's."""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Callable, List

import torch


@dataclasses.dataclass
class Window:
    units: int
    wall_s: float
    spans_ms: List[float]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(unit: Callable[[], None], seconds: float,
            device: torch.device) -> Window:
    """Run `unit` until `seconds` have passed on the host clock (the unit
    in flight then finishes), and time every unit."""
    on_card = device.type == "cuda"
    sync(device)
    marks = []
    t0 = time.perf_counter()
    if on_card:
        first = torch.cuda.Event(enable_timing=True)
        first.record()
        marks.append(first)
    else:
        marks.append(t0)
    while time.perf_counter() - t0 < seconds:
        unit()
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())
    sync(device)
    wall = time.perf_counter() - t0
    if on_card:
        spans = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        spans = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    return Window(units=len(spans), wall_s=wall, spans_ms=spans)


def nearest_rank(values: List[float], pct: float) -> float:
    """The pct-th percentile by nearest rank: the smallest value with at
    least pct% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(pct / 100.0 * len(ordered))) - 1]


def phase(name: str, t_start: float) -> None:
    """A line on standard error: the set-up phase `name` ended this many
    seconds after the process started."""
    print(f"setup {name} {time.perf_counter() - t_start:.3f}",
          file=sys.stderr, flush=True)
