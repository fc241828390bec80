"""The program's spans in the traced stretch, for the readers of span
metrics (`metrics/*.py` that import this file; a name that starts with `_`
is no metric of its own).

While a profiler runs, every boundary of a span of `ecgmm_torch`
(`ecgmm_torch/train/profiler.py`: `span`, `span_log`) is logged with its
wall-clock stamp and, on the card, a CUDA event. The stretch is the log's
last units x (boundaries a step) boundaries, since no span runs after
it. A step's boundaries are read from the log itself: from its last
`ecgmm.gather` enter, the first span of every train step, to its end.
Nothing is guessed: where the log does not repeat that step's names and
kinds step by step, or a boundary carries no CUDA event (a trace off the
card), there is no stretch (None), and so where the program keeps no
span log (a checkout older than its spans, which the traced runs of the
benchmark also read).

The readers take host time between wall stamps, on the host's clock, and
stream time between CUDA events, on the device's. Neither is set against
the trace's timeline: on the card the trace's host and device stamps
drift apart by milliseconds within a stretch (PERF.md §7)."""

from __future__ import annotations

import dataclasses
import statistics
from typing import Iterable, List, Optional

from ecgmm_torch.train import profiler

GATHER = "ecgmm.gather"


@dataclasses.dataclass
class Span:
    name: str
    enter: profiler.Boundary
    exit: profiler.Boundary


def stretch(run) -> Optional[List[Span]]:
    """The stretch's spans in the order they close, or None (the module's
    docstring)."""
    if run.job != "train" or run.trace is None or not run.trace.units:
        return None
    read = getattr(profiler, "span_log", None)
    log = [] if read is None else read()
    starts = [i for i, b in enumerate(log)
              if b.name == GATHER and b.kind == "enter"]
    if not starts:
        return None
    k = len(log) - starts[-1]
    n = run.trace.units * k
    if len(log) < n:
        return None
    tail = log[-n:]
    pattern = [(b.name, b.kind) for b in tail[:k]]
    if any([(b.name, b.kind) for b in tail[i:i + k]] != pattern
           for i in range(k, n, k)) or any(b.event is None for b in tail):
        return None
    opened, spans = {}, []
    for b in tail:
        if b.kind == "enter":
            opened[b.span] = b
        elif b.span in opened:
            spans.append(Span(b.name, opened.pop(b.span), b))
        else:
            return None
    return None if opened else spans


def step_host_ms(run) -> Optional[float]:
    """The median over the stretch's steps of the host's milliseconds of
    the `ecgmm.train_step` span, between its wall stamps; None without a
    stretch."""
    spans = stretch(run)
    if spans is None:
        return None
    return statistics.median((s.exit.wall_ns - s.enter.wall_ns) / 1e6
                             for s in spans if s.name == "ecgmm.train_step")


def device_ms(run, names: Iterable[str]) -> Optional[float]:
    """The stream's milliseconds between the two events of every span
    named in `names`, summed over the stretch, a step; None without a
    stretch or without such spans."""
    spans = stretch(run)
    if spans is None:
        return None
    names = set(names)
    chosen = [s for s in spans if s.name in names]
    if not chosen:
        return None
    return sum(s.enter.event.elapsed_time(s.exit.event)
               for s in chosen) / run.trace.units
