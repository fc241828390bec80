"""The span metrics' readers (`metrics/_spans.py` and the two readers
that use it) on hand-made span logs beside hand-made Chrome traces, built
as `test_bench_counts.py::test_idle_share_is_the_union_of_intervals`
builds its trace: the stretch read from the log's last boundaries, a
step's boundaries found from the log itself, the host's step time from
the wall stamps, the sum of attention's event times, and None wherever
the log does not repeat its step or carries no CUDA event."""

import types

import pytest

from benchmark.harness import spec, trace
from benchmark.metrics import _spans
from ecgmm_torch.train import profiler
from ecgmm_torch.train.profiler import Boundary


class Event:
    """A CUDA event's stand-in: its time on the stream, in ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def _log(names, starts, events=True):
    """A span log: for each step start (us), the spans `names` (name,
    enter offset, exit offset, us) opened and closed in offset order, a
    boundary's wall stamp and event (or None) at its offset."""
    log, sid = [], 0
    for t0 in starts:
        marks = []
        for name, a, b in names:
            marks += [(a, sid, name, "enter"), (b, sid, name, "exit")]
            sid += 1
        for off, span, name, kind in sorted(marks):
            ts = t0 + off
            log.append(Boundary(span, name, kind, int(ts * 1e3), None, 1,
                                Event(ts / 1e3) if events else None))
    return log


# a fusion step of 100 us: gather 0-4, the step 5-95 over forward 6-40,
# loss 41-50, backward 50-80, optimizer 81-94
FUSION_STEP = [("ecgmm.gather", 0, 4), ("ecgmm.train_step", 5, 95),
               ("ecgmm.step.forward", 6, 40), ("ecgmm.step.loss", 41, 50),
               ("ecgmm.step.backward", 50, 80),
               ("ecgmm.step.optimizer", 81, 94)]
# a Transformer step of two layers: an attention span each, forward and
# backward
TRANSFORMER_STEP = [
    ("ecgmm.gather", 0, 2), ("ecgmm.train_step", 3, 99),
    ("ecgmm.step.forward", 4, 40), ("ecgmm.attention.forward", 5, 15),
    ("ecgmm.attention.forward", 20, 35), ("ecgmm.step.loss", 41, 44),
    ("ecgmm.step.backward", 45, 90), ("ecgmm.attention.backward", 50, 60),
    ("ecgmm.attention.backward", 70, 88), ("ecgmm.step.optimizer", 91, 98)]


def _card_run(units, end=300.0):
    """A run whose trace is the card's: the stretch's marker copies and
    one kernel over it."""
    ev = [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "ts": ts, "dur": 1.0,
           "args": {"bytes": trace.MARK_BYTES, "device": 0}}
          for ts in (-1.0, end)]
    ev.append({"ph": "X", "cat": "kernel", "name": "k", "ts": 0.0,
               "dur": end, "args": {"device": 0}})
    return types.SimpleNamespace(job="train",
                                 trace=trace.from_events(ev, units))


@pytest.fixture
def log(monkeypatch):
    """Sets the program's span log to the list it is called with."""
    def use(boundaries):
        monkeypatch.setattr(profiler, "span_log", lambda: boundaries)
    return use


def test_the_stretch_is_the_logs_last_steps(log):
    """A warm-up step at -100 us and three traced steps: the stretch is
    the last three steps' spans, the step's 12 boundaries found from the
    last `ecgmm.gather`, and the host's step time is the median
    `ecgmm.train_step` span."""
    log(_log(FUSION_STEP, [-100.0, 0.0, 100.0, 200.0]))
    run = _card_run(3)
    spans = _spans.stretch(run)
    assert len(spans) == 3 * len(FUSION_STEP)
    assert min(s.enter.wall_ns for s in spans) == 0
    step1 = {s.name: (s.enter.wall_ns / 1e3 - 100.0,
                      s.exit.wall_ns / 1e3 - 100.0) for s in spans
             if 100e3 <= s.enter.wall_ns < 200e3}
    assert step1 == {name: (a, b) for name, a, b in FUSION_STEP}
    assert _spans.step_host_ms(run) == pytest.approx(0.090)
    reader = spec.metric_readers()["step.host_ms.fusion"]
    assert reader.read(run) == pytest.approx(0.090)


def test_the_host_step_is_the_median(log):
    """Steps of 90, 60 and 120 us between the step span's stamps: 90."""
    boundaries = _log(FUSION_STEP, [0.0, 100.0, 200.0])
    exits = [i for i, b in enumerate(boundaries)
             if b.name == "ecgmm.train_step" and b.kind == "exit"]
    for i, us in zip(exits, (90, 60, 120)):
        enter = next(b for b in boundaries if b.span == boundaries[i].span)
        boundaries[i] = boundaries[i]._replace(
            wall_ns=enter.wall_ns + us * 1000)
    log(boundaries)
    assert _spans.step_host_ms(_card_run(3)) == pytest.approx(0.090)


@pytest.mark.parametrize("fault", ["swapped", "short", "no_event",
                                   "no_gather", "unpaired", "no_log"])
def test_no_stretch_where_the_log_does_not_hold_it(log, fault, monkeypatch):
    """A name swapped in one step, fewer steps logged than traced, a
    boundary without its CUDA event (a trace off the card), a log without
    a gather, an exit whose span never opened, a program that keeps no
    span log: no stretch, and every span reader reads None."""
    boundaries = _log(FUSION_STEP, [0.0, 100.0, 200.0])
    units = 3
    if fault == "swapped":
        i = len(boundaries) - 15
        boundaries[i] = boundaries[i]._replace(name="ecgmm.other")
    elif fault == "short":
        units = 4
    elif fault == "no_event":
        boundaries[-20] = boundaries[-20]._replace(event=None)
    elif fault == "no_gather":
        boundaries = [b for b in boundaries if b.name != "ecgmm.gather"]
    elif fault == "unpaired":
        # the optimizer's exit of every step names another span
        boundaries = [b._replace(span=-1) if b.name == "ecgmm.step.optimizer"
                      and b.kind == "exit" else b for b in boundaries]
    log(boundaries)
    if fault == "no_log":
        monkeypatch.delattr(profiler, "span_log")
    run = _card_run(units)
    assert _spans.stretch(run) is None
    for name, reader in spec.metric_readers().items():
        if name.startswith(("step.host_ms", "attention.")):
            assert reader.read(run) is None, name


def test_no_stretch_on_a_cpu_trace(log):
    """A CPU trace's steps log no CUDA event: no stretch, whatever else
    the log holds; nor without a trace, or for no unit."""
    log(_log(FUSION_STEP, [0.0], events=False))
    raw = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
            "ts": 0.0, "dur": 100.0},
           {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5.0,
            "dur": 50.0}]
    run = types.SimpleNamespace(job="train",
                                trace=trace.from_events(raw, 1))
    assert _spans.stretch(run) is None
    log(_log(FUSION_STEP, [0.0]))
    assert _spans.stretch(run) is not None
    assert _spans.stretch(types.SimpleNamespace(job="train",
                                                trace=None)) is None
    run.trace.units = 0
    assert _spans.stretch(run) is None


def test_attention_device_ms_sums_its_events(log):
    """A Transformer step with two layers: the step's 20 boundaries found
    from the log, and the stream time between each attention span's
    events, forward and backward, summed, a step; a fusion log holds no
    attention span."""
    log(_log(TRANSFORMER_STEP, [-100.0, 0.0, 100.0]))
    run = _card_run(2)
    assert len(_spans.stretch(run)) == 2 * len(TRANSFORMER_STEP)
    # (10 + 15 + 10 + 18) us a step
    want = 0.053
    reader = spec.metric_readers()["attention.device_ms.transformer"]
    assert reader.read(run) == pytest.approx(want)
    assert _spans.device_ms(run, ["ecgmm.attention.forward"]) == \
        pytest.approx(0.025)
    log(_log(FUSION_STEP, [0.0, 100.0]))
    assert _spans.stretch(run) is not None
    assert reader.read(run) is None
