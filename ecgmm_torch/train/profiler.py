"""Tracing and profiling utilities (port of `ecgmm_tpu/train/profiler.py`).

  * `trace(logdir)`: a context manager around `torch.profiler` (CPU and,
    where there is a card, CUDA activities) that writes the Chrome trace
    as `<logdir>/plugins/profile/<ts>/<host>.pt.trace.json.gz`, the
    layout `tools/trace_report.py` reads, and the spans of its body
    beside it as `spans.json`;
  * `span(name)`: a named span of the program (the train step and its
    phases, attention), recorded only while a torch profiler runs;
    `span_log()` and `span_table()` read what was recorded;
  * `live_buffer_bytes()` / `device_memory_stats()`: the allocator's
    figures on the card (`torch.cuda.memory_allocated`,
    `torch.cuda.memory_stats`), 0 and {} plus the live bytes on the CPU.

**Spans.** Tracing is on while a torch profiler runs
(`torch.autograd._profiler_enabled()`), whichever activities it records:
the program's own `trace(...)`, or any `torch.profiler.profile` around
the program. Off, `span` makes that one check and hands back a shared
null context. On, a span
  * enters `torch.profiler.record_function(name)`, so a trace that
    records host operations shows it as a `user_annotation`;
  * records a timing CUDA event on the current stream at its enter and
    at its exit, where CUDA is initialised in the process: a
    `cudaEventRecord` call, which even a trace of CUDA activity alone
    holds, on the trace's clock, and which launches no device operation;
    the events come from a pool that is reused once the log is full;
  * appends each boundary to the span log.

The log is a list of `Boundary` records, oldest first, one at a span's
enter and one at its exit: `span` (the span's number), `name`, `kind`
("enter" or "exit"), `wall_ns` (`time.time_ns()`, the clock of the
profiler's Chrome trace: its `ts` in us plus `baseTimeNanoseconds`),
`parent` (the number of the span it opened inside: the innermost open
span of its thread, else of any thread, as a backward span opened on the
autograd thread lies inside the step's backward), `thread`
(`threading.get_ident()`) and `event` (the CUDA event recorded at that
boundary, or None). It holds the spans since tracing last turned on: it
is cleared at the first span after a span with tracing off, and when
`trace` starts; it keeps the last SPAN_LOG_BOUND boundaries.
`span_table` pairs them into spans with their host, self and device
milliseconds. A span's device milliseconds are the stream's time between
its two events (`Event.elapsed_time`): the device's time for the span's
work only where the stream does not wait for the host inside it.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import json
import os
import shutil
import socket
import tempfile
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.profiler import record_function

# boundaries the span log keeps (and CUDA events its pool holds a device)
SPAN_LOG_BOUND = 8192


class Boundary(NamedTuple):
    """One boundary of a span in the span log (the module's docstring)."""

    span: int
    name: str
    kind: str
    wall_ns: int
    parent: Optional[int]
    thread: int
    event: Optional[torch.cuda.Event]


class _Off:
    """The context `span` hands back with tracing off: it only notes that
    a span ran off, so the next span on starts a new log."""

    __slots__ = ()

    def __enter__(self):
        _SPANS.stale = True

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Spans:
    """The span log, its open spans and its pool of CUDA events."""

    def __init__(self, bound: int = SPAN_LOG_BOUND):
        self.bound = bound
        self.log: collections.deque = collections.deque(maxlen=bound)
        self.open: Dict[int, tuple] = {}   # span -> (thread, parent)
        self.events: Dict[int, List[torch.cuda.Event]] = {}
        self.appended = 0                  # boundaries ever appended
        self.next_span = 0
        self.stale = True
        self.lock = threading.Lock()

    def clear(self) -> None:
        self.log.clear()
        self.open.clear()
        self.stale = False

    def enter(self, name: str) -> int:
        thread = threading.get_ident()
        with self.lock:
            if self.stale:
                self.clear()
            sid = self.next_span
            self.next_span += 1
            parent = next((s for s, (t, _) in reversed(self.open.items())
                           if t == thread), None)
            if parent is None and self.open:
                parent = next(reversed(self.open))
            self.open[sid] = (thread, parent)
            self._append(sid, name, "enter", parent, thread)
        return sid

    def exit(self, sid: int, name: str) -> None:
        with self.lock:
            thread, parent = self.open.pop(sid, (threading.get_ident(),
                                                 None))
            self._append(sid, name, "exit", parent, thread)

    def _append(self, sid, name, kind, parent, thread) -> None:
        # the log's slot k holds pool event k: an event is recorded again
        # only once the boundary that held it has left the log. A device's
        # pool can start at any slot (CUDA initialised, or the device
        # changed, after boundaries were logged): it grows to the slot
        event = None
        wall_ns = time.time_ns()
        if torch.cuda.is_initialized():
            pool = self.events.setdefault(torch.cuda.current_device(), [])
            slot = self.appended % self.bound
            while len(pool) <= slot:
                pool.append(torch.cuda.Event(enable_timing=True))
            event = pool[slot]
            event.record()
        self.appended += 1
        self.log.append(Boundary(sid, name, kind, wall_ns, parent, thread,
                                 event))


_SPANS = _Spans()


class _Span:
    """A span with tracing on (the module's docstring)."""

    __slots__ = ("name", "sid", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.annotation = record_function(self.name)
        self.annotation.__enter__()
        self.sid = _SPANS.enter(self.name)
        return self

    def __exit__(self, *exc):
        _SPANS.exit(self.sid, self.name)
        self.annotation.__exit__(*exc)
        return False

    def backward(self, name: str, output: torch.Tensor,
                 inp: torch.Tensor) -> None:
        """A span `name` over the backward from `output` to `inp`: opened
        by a gradient hook on `output` and closed by one on `inp`, on the
        thread that runs the backward (the autograd thread on the card).
        Nothing is registered where either tensor is a leaf or takes no
        gradient."""
        if not (torch.is_grad_enabled() and output.grad_fn is not None
                and inp.grad_fn is not None):
            return
        opened: List[_Span] = []

        def open_(grad):
            opened.append(_Span(name).__enter__())

        def close(grad):
            if opened:
                opened.pop().__exit__(None, None, None)

        output.register_hook(open_)
        inp.register_hook(close)


def span(name: str):
    """A context manager over a named span of the program: with tracing
    off a shared null context that yields None; with it on a recorded
    span that yields itself (its `backward` adds the matching backward
    span). Names start with `ecgmm.`."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def span_log() -> List[Boundary]:
    """The span log's boundaries, oldest first (the module's docstring)."""
    with _SPANS.lock:
        return list(_SPANS.log)


def _elapsed_ms(a: Optional[torch.cuda.Event],
                b: Optional[torch.cuda.Event]) -> Optional[float]:
    if a is None or b is None:
        return None
    try:
        return float(a.elapsed_time(b))
    except RuntimeError:     # recorded on two devices, or not complete
        return None


def span_table(log: Optional[List[Boundary]] = None) -> List[dict]:
    """The closed spans of `log` (the span log by default) in the order
    they opened: span, name, parent, thread, start_ns, host_ms, self_ms
    (host_ms less the union of its children's intervals) and device_ms
    (None without CUDA events). Read device_ms once the device has
    finished the spans' work."""
    log = span_log() if log is None else log
    enters = {b.span: b for b in log if b.kind == "enter"}
    rows, children = [], collections.defaultdict(list)
    for b in log:
        a = enters.get(b.span) if b.kind == "exit" else None
        if a is None:
            continue
        rows.append({"span": a.span, "name": a.name, "parent": a.parent,
                     "thread": a.thread, "start_ns": a.wall_ns,
                     "end_ns": b.wall_ns,
                     "host_ms": (b.wall_ns - a.wall_ns) / 1e6,
                     "device_ms": _elapsed_ms(a.event, b.event)})
        if a.parent is not None:
            children[a.parent].append((a.wall_ns, b.wall_ns))
    for r in rows:
        covered, t = 0, r["start_ns"]
        for s, e in sorted(children[r["span"]]):
            s, e = max(s, t), min(e, r["end_ns"])
            if e > s:
                covered += e - s
                t = e
        r["self_ms"] = r["host_ms"] - covered / 1e6
        del r["end_ns"]
    rows.sort(key=lambda r: r["span"])
    return rows


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body with `torch.profiler` and write its Chrome trace
    under `<logdir>/plugins/profile/<ts>/`; yields the profiler. Where
    there is a card the CUDA activity is recorded too. The trace can miss
    the first kernels launched after it starts: run a warm-up step first,
    inside a `torch.profiler.record_function` that synchronises the
    device before it closes, and read the trace with `trace_report
    --after` that annotation's name. The body's spans go beside the
    trace as `spans.json`: {"spans": `span_table()`}."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with _SPANS.lock:
        _SPANS.clear()
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
    with open(os.path.join(out_dir, "spans.json"), "w") as f:
        json.dump({"spans": span_table()}, f)


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
