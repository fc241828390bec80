"""Device-trace op report (port of `ecgmm_tpu/tools/trace_report.py`):
per-op and per-category time from a `torch.profiler` trace that
`ecgmm_torch.train.profiler.trace` wrote.

    from ecgmm_torch.train import profiler
    with profiler.trace("/tmp/trace"):
        ...steps...
    python -m ecgmm_torch.tools.trace_report /tmp/trace --steps 3

The device events are the trace's `"cat": "kernel"`, `gpu_memcpy` and
`gpu_memset` events. Their categories: gemm, conv, batch norm,
elementwise, reduction, memcpy, one for each kernel of the port
(`ecgmm se_fwd`, ... the names in `ops/csrc/*.cu`) and other. A trace
taken on the CPU has no device events; `--host-ops` reports its
`cpu_op` events instead. Torch's trace records no bytes accessed per
event, so unlike JAX's report this one has no GB/s column. Trace
layout: <dir>/plugins/profile/<ts>/*.trace.json.gz.

A trace can miss the first kernels launched after it starts (seen on an
H100: 2 of 9 SE forward kernels of the first traced step). So trace a
warm-up step first, inside a `torch.profiler.record_function(name)`
that synchronises the device before it closes, and pass `--after name`:
the report then counts only the events that start after that
annotation ends, and `--steps` counts the steps after it.

`--spans` reports the program's spans instead (`train/profiler.span`:
the train step, its phases, attention): from the `spans.json` that
`profiler.trace` writes beside the trace, each span name's count and its
host, self and device ms a step; and from the trace, the first device's
idle gaps between its first and last event, each named by the innermost
`ecgmm.*` annotation over its middle (the span the host was in while
the device waited), summed by name, and the longest of them. The names
set device stamps against host stamps: on an H100 the trace's two clocks
drift apart by milliseconds within a few seconds, so a gap near a span's
edge can be given to its neighbour. Read the naming as a guide to where
to look, not as a measurement.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the kernels of ops/csrc/*.cu, longest first so that se_bwd_params is
# not taken for se_bwd
ECGMM_KERNELS = ("fusion_bwd_params", "fusion_bwd_rows", "se_bwd_params",
                 "fusion_fwd", "focal_fwd", "focal_bwd", "se_fwd", "se_bwd")
_KERNEL_RE = re.compile(
    r"(?<![A-Za-z0-9_])(" + "|".join(ECGMM_KERNELS) + r")(?![A-Za-z0-9_])")
# (category, pattern), the first match wins
_CATEGORIES = (
    ("batch norm", re.compile(r"batch_?norm|bn_fw|bn_bw|welford", re.I)),
    ("conv", re.compile(r"conv|cudnn|wgrad|dgrad|fprop", re.I)),
    ("gemm", re.compile(r"gemm|cutlass|cublas|xmma|matmul|aten::(add|b)?mm"
                        r"|aten::linear|aten::addmv", re.I)),
    ("reduction", re.compile(r"reduce|aten::(sum|mean|var|max|min|amax"
                             r"|argmax|std|norm)\b", re.I)),
    ("elementwise", re.compile(r"elementwise|aten::", re.I)),
)


def _newest(trace_dir: str) -> str:
    if trace_dir.endswith(".json.gz"):
        return trace_dir
    cands = sorted(glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                             recursive=True))
    if not cands:
        raise FileNotFoundError(f"no *.trace.json.gz under {trace_dir}")
    return cands[-1]


def load_trace(trace_dir: str) -> List[dict]:
    """Every event of the newest trace under trace_dir (the dir, a
    profile/<ts> dir or the .json.gz)."""
    with gzip.open(_newest(trace_dir)) as f:
        return json.load(f).get("traceEvents", [])


def annotation_end(events: List[dict], name: str) -> float:
    """The end (us) of the one host annotation `name`
    (`torch.profiler.record_function`) among a trace's events."""
    found = [e for e in events if e.get("name") == name
             and e.get("cat") == "user_annotation"]
    if len(found) != 1:
        raise ValueError(f"{len(found)} annotations named {name!r} in the "
                         "trace, not one")
    return found[0]["ts"] + found[0]["dur"]


def load_device_events(trace_dir: str, host_ops: bool = False,
                       after: Optional[str] = None) -> List[dict]:
    """The complete ('X') device events of the newest trace under
    trace_dir: kernels, copies and sets; with `host_ops`, the `cpu_op`
    events instead. With `after`, only the events that start after the
    annotation of that name ends (a warm-up step's)."""
    cats = ("cpu_op",) if host_ops else DEVICE_CATS
    events = load_trace(trace_dir)
    cut = -float("inf") if after is None else annotation_end(events, after)
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in cats and e["ts"] >= cut]


def category(event: dict) -> str:
    """The report's category of one event."""
    if event.get("cat") in ("gpu_memcpy", "gpu_memset"):
        return "memcpy"
    name = event.get("name", "")
    m = _KERNEL_RE.search(name)
    if m:
        return f"ecgmm {m.group(1)}"
    if name.startswith("ecgmm::"):
        return name.replace("::", " ")
    for cat, pattern in _CATEGORIES:
        if pattern.search(name):
            return cat
    return "other"


def op_rows(events: List[dict]) -> List[dict]:
    """One row per event: name, dur_us, category, device."""
    return [{"name": e["name"], "dur_us": float(e.get("dur", 0)),
             "category": category(e),
             "device": (e.get("args") or {}).get("device", e.get("pid"))}
            for e in events]


def rollup(rows: List[dict], key: str) -> Dict[str, Tuple[float, int]]:
    """{key: (total_us, count)}."""
    out: Dict[str, Tuple[float, int]] = {}
    for r in rows:
        us, n = out.get(r[key], (0.0, 0))
        out[r[key]] = (us + r["dur_us"], n + 1)
    return out


def launch_counts(rows: List[dict]) -> Dict[str, int]:
    """Launches of each of the port's kernels in the trace, by kernel
    name (`se_fwd`, ...)."""
    counts = collections.Counter()
    for r in rows:
        if r["category"].startswith("ecgmm ") \
                and r["category"][6:] in ECGMM_KERNELS:
            counts[r["category"][6:]] += 1
    return dict(counts)


def print_report(trace_dir: str, steps: int = 1, top: int = 15,
                 host_ops: bool = False, after: Optional[str] = None
                 ) -> None:
    """Per-step time by category and the top ops; `steps` is the number
    of steps the counted events span (after `after`, where it is given)."""
    rows = op_rows(load_device_events(trace_dir, host_ops, after))
    # one plane per device: the report stays per-device time
    n_dev = len({r["device"] for r in rows}) or 1
    div = steps * n_dev
    total_us = sum(r["dur_us"] for r in rows)
    what = "host op" if host_ops else "device op"
    dev_note = f" avg over {n_dev} devices" if n_dev > 1 else ""
    print(f"{what} time: {total_us / div / 1e3:.3f} ms/step "
          f"({len(rows)} {what} events / {steps} steps{dev_note})")
    print("\nby category:")
    for cat, (us, n) in sorted(rollup(rows, "category").items(),
                               key=lambda kv: -kv[1][0]):
        print(f"  {us / div / 1e3:8.3f} ms/step  {n / div:6.1f} ops  {cat}")
    print(f"\ntop {top} ops:")
    for name, (us, n) in sorted(rollup(rows, "name").items(),
                                key=lambda kv: -kv[1][0])[:top]:
        print(f"  {us / div / 1e3:8.3f} ms/step  {n / div:6.1f} calls  "
              f"{name[:70]}")


SPAN_PREFIX = "ecgmm."
OUTSIDE = "outside every span"


def load_spans(trace_dir: str) -> List[dict]:
    """The spans (`profiler.span_table` rows) of the `spans.json` beside
    the newest trace under trace_dir."""
    path = os.path.join(os.path.dirname(_newest(trace_dir)), "spans.json")
    with open(path) as f:
        return json.load(f)["spans"]


def span_rollup(spans: List[dict]) -> Dict[str, dict]:
    """{span name: count, host_ms, self_ms, device_ms}, summed; device_ms
    None where a span of the name has none."""
    out: Dict[str, dict] = {}
    for r in spans:
        row = out.setdefault(r["name"], {"count": 0, "host_ms": 0.0,
                                         "self_ms": 0.0, "device_ms": 0.0})
        row["count"] += 1
        row["host_ms"] += r["host_ms"]
        row["self_ms"] += r["self_ms"]
        if row["device_ms"] is not None and r["device_ms"] is not None:
            row["device_ms"] += r["device_ms"]
        else:
            row["device_ms"] = None
    return out


def idle_gaps(events: List[dict], after: Optional[str] = None
              ) -> List[Tuple[float, float, str]]:
    """(start, end, name) us of the idle gaps of the trace's first device
    between its first and last device event (after the annotation
    `after`, where it is given), each named by the innermost `ecgmm.*`
    annotation over the gap's middle, or OUTSIDE."""
    cut = -float("inf") if after is None else annotation_end(events, after)
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS and e["ts"] >= cut]
    if not device:
        return []
    first = (device[0].get("args") or {}).get("device", device[0].get("pid"))
    busy = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                  for e in device if (e.get("args") or {}).get(
                      "device", e.get("pid")) == first)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
              e["name"]) for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(SPAN_PREFIX)]
    out, t = [], busy[0][1]
    for s, e in busy:
        if s > t:
            mid = 0.5 * (s + t)
            over = [(he - hs, name) for hs, he, name in spans
                    if hs <= mid <= he]
            out.append((t, s, min(over)[1] if over else OUTSIDE))
        t = max(t, e)
    return out


def print_spans(trace_dir: str, steps: int = 1, top: int = 10,
                after: Optional[str] = None) -> None:
    """The span report (the module's docstring), a step of `steps`."""
    rows = span_rollup(load_spans(trace_dir))
    print(f"spans: ms/step over {steps} steps (host, self, device)")
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["host_ms"]):
        dev = "-" if r["device_ms"] is None \
            else f"{r['device_ms'] / steps:8.3f}"
        print(f"  {r['host_ms'] / steps:8.3f} {r['self_ms'] / steps:8.3f} "
              f"{dev:>8}  {r['count'] / steps:5.1f}x  {name}")
    gaps = idle_gaps(load_trace(trace_dir), after)
    by: Dict[str, float] = collections.defaultdict(float)
    for s, e, name in gaps:
        by[name] += e - s
    print(f"\ndevice idle by span: {sum(by.values()) / steps / 1e3:.3f} "
          f"ms/step in {len(gaps)} gaps")
    for name, us in sorted(by.items(), key=lambda kv: -kv[1]):
        print(f"  {us / steps / 1e3:8.3f} ms/step  {name}")
    print(f"\nlongest {top} idle gaps:")
    for s, e, name in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        print(f"  {(e - s) / 1e3:8.3f} ms  {name}")


def main(argv=None):
    p = argparse.ArgumentParser(description="Per-op and per-category "
                                "time of a torch.profiler trace.")
    p.add_argument("trace_dir")
    p.add_argument("--steps", type=int, default=1,
                   help="steps captured inside the trace, after --after's "
                   "annotation where it is given (divisor)")
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--host-ops", action="store_true",
                   help="report the host's cpu_op events (a CPU trace)")
    p.add_argument("--after", default=None, metavar="NAME",
                   help="count only the events that start after the "
                   "record_function annotation NAME ends (a warm-up step "
                   "traced first)")
    p.add_argument("--spans", action="store_true",
                   help="report the program's spans (spans.json) and the "
                   "device's idle gaps by span instead")
    args = p.parse_args(argv)
    if args.spans:
        print_spans(args.trace_dir, steps=args.steps, top=args.top,
                    after=args.after)
        return
    print_report(args.trace_dir, steps=args.steps, top=args.top,
                 host_ops=args.host_ops, after=args.after)


if __name__ == "__main__":
    main()
