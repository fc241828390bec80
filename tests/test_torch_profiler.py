"""The port's profiler (`ecgmm_torch/train/profiler.py`) and trace report
(`ecgmm_torch/tools/trace_report.py`) against JAX's
(`tests/test_tools.py:86-100`, `tests/test_trace_report.py`), on the CPU.

The memory probes answer as JAX's do where there is no card (the stats
carry `live_buffer_bytes`); a trace the port writes on the CPU lands
where the report globs and is read back (host ops on the CPU); a device
trace of torch's Chrome layout, made here with kernel, copy and host
events, rolls up into the report's categories, the port's kernels
counted by name. The spans (`profiler.span`) record nothing and register
no hook with no profiler running; under one they log their boundaries
with the right parents beside annotations of the same names, around the
train step's phases and attention, and change no number of a step.
"""

import dataclasses
import gzip
import json
import os
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ecgmm_torch.config import get_preset
from ecgmm_torch.data.pipeline import Arrays
from ecgmm_torch.models.layers import MultiHeadSelfAttention
from ecgmm_torch.tools import trace_report
from ecgmm_torch.train import engine, profiler
from ecgmm_torch.train.state import create_state
from ecgmm_torch.workloads import run as port_run

torch.set_num_threads(2)

PHASES = ["ecgmm.step.forward", "ecgmm.step.loss", "ecgmm.step.backward",
          "ecgmm.step.optimizer"]


def test_profiler_probes():
    if not torch.cuda.is_available():
        assert profiler.live_buffer_bytes() == 0
    stats = profiler.device_memory_stats()
    assert "live_buffer_bytes" in stats


@pytest.fixture(autouse=True)
def off_between_tests():
    """A span with tracing off before each test, as a program runs
    between two traced stretches: the next profiler's spans start a new
    log."""
    with profiler.span("ecgmm.off"):
        pass


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _small_step(name, t, batch=4, seed=0):
    """The preset `name` at signal length `t` (ResNet1D-SE width 8) on the
    CPU: its task, a fresh train state and one batch of signals."""
    cfg = get_preset(name)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, signal_len=t),
        model=dataclasses.replace(cfg.model, signal_base_filters=8),
        train=dataclasses.replace(cfg.train, batch_size=batch))
    model, task, freeze = port_run.build_model_and_task(cfg, "cpu")
    state = create_state(model, cfg.train, 4, freeze=freeze)
    g = torch.Generator().manual_seed(seed)
    arrays = Arrays(images=None, signals=torch.randn(2 * batch, t,
                                                     generator=g),
                    clinical=None,
                    labels=torch.randint(0, 2, (2 * batch,), generator=g),
                    indices=None)
    return task, state, arrays


def _step(task, state, arrays, k=0):
    b = 4
    idx = torch.arange(k * b, (k + 1) * b) % arrays.labels.shape[0]
    return engine.train_step(task, state, engine.gather_batch(
        arrays, idx, torch.ones(b)))


def _table(log):
    return {r["span"]: r for r in profiler.span_table(log)}


def test_spans_off_record_nothing_and_register_no_hook():
    """With no profiler running a span is the shared null context, yields
    None and leaves the log as it was; attention registers no gradient
    hook on its input or output."""
    before = profiler.span_log()
    with profiler.span("ecgmm.test") as s:
        assert s is None
    assert profiler.span("ecgmm.a") is profiler.span("ecgmm.b")
    attn = MultiHeadSelfAttention(16, 4, 0.0)
    x = torch.randn(2, 5, 16, requires_grad=True) * 1.0
    y = attn(x)
    assert x._backward_hooks is None and y._backward_hooks is None
    y.sum().backward()
    assert profiler.span_log() == before
    with _cpu_profile():
        y = attn(x)
    assert x._backward_hooks and y._backward_hooks


def test_nested_spans_log_parents_and_annotations(tmp_path):
    """Nested spans under a CPU profiler: each boundary names its parent
    and its thread, and the exported trace holds a `user_annotation` of
    each span's name within 1 ms of its enter and exit wall stamps (after
    a first span, whose annotation resolves the profiler's operators)."""
    with _cpu_profile():
        with profiler.span("ecgmm.first"):
            pass
    with profiler.span("ecgmm.off"):
        pass
    with _cpu_profile() as prof:
        with profiler.span("ecgmm.outer"):
            with profiler.span("ecgmm.inner"):
                torch.ones(64).sum()
                with profiler.span("ecgmm.leaf"):
                    torch.ones(64).sum()
            with profiler.span("ecgmm.sibling"):
                pass
    log = profiler.span_log()
    assert [(b.name, b.kind) for b in log] == [
        ("ecgmm.outer", "enter"), ("ecgmm.inner", "enter"),
        ("ecgmm.leaf", "enter"), ("ecgmm.leaf", "exit"),
        ("ecgmm.inner", "exit"), ("ecgmm.sibling", "enter"),
        ("ecgmm.sibling", "exit"), ("ecgmm.outer", "exit")]
    ids = {b.name: b.span for b in log}
    parents = {b.name: b.parent for b in log}
    assert parents == {"ecgmm.outer": None, "ecgmm.inner": ids["ecgmm.outer"],
                       "ecgmm.leaf": ids["ecgmm.inner"],
                       "ecgmm.sibling": ids["ecgmm.outer"]}
    assert {b.thread for b in log} == {threading.get_ident()}
    assert all(b.event is None for b in log)
    rows = _table(log)
    outer = rows[ids["ecgmm.outer"]]
    assert outer["self_ms"] == pytest.approx(
        outer["host_ms"] - rows[ids["ecgmm.inner"]]["host_ms"]
        - rows[ids["ecgmm.sibling"]]["host_ms"], abs=1e-6)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        raw = json.load(f)
    base = int(raw.get("baseTimeNanoseconds", 0))
    notes = {e["name"]: e for e in raw["traceEvents"]
             if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("ecgmm.")}
    assert set(notes) == set(ids)
    for b in log:
        e = notes[b.name]
        ts_ns = base + 1000.0 * (e["ts"] + (e["dur"] if b.kind == "exit"
                                             else 0.0))
        assert abs(ts_ns - b.wall_ns) < 1e6, (b.name, b.kind)


def test_train_step_logs_its_phases_in_order():
    """One CPU train step of a small `signal_only` under a profiler: the
    gather's span, then `ecgmm.train_step` over its four phases, in
    order, each phase's parent the step."""
    task, state, arrays = _small_step("signal_only", 256)
    _step(task, state, arrays)
    with _cpu_profile():
        _step(task, state, arrays, 1)
    log = profiler.span_log()
    assert [(b.name, b.kind) for b in log] == (
        [("ecgmm.gather", "enter"), ("ecgmm.gather", "exit"),
         ("ecgmm.train_step", "enter")]
        + [(n, kind) for n in PHASES for kind in ("enter", "exit")]
        + [("ecgmm.train_step", "exit")])
    step = next(b.span for b in log if b.name == "ecgmm.train_step")
    assert all(b.parent == step for b in log if b.name in PHASES)
    rows = profiler.span_table(log)
    assert [r["name"] for r in rows] == ["ecgmm.gather", "ecgmm.train_step"
                                         ] + PHASES
    assert all(r["host_ms"] >= r["self_ms"] >= 0 for r in rows)


def test_transformer_step_logs_attention_pairs():
    """A Transformer step: one `ecgmm.attention.forward` inside the
    forward and one `ecgmm.attention.backward` inside the backward a
    layer, the backward pair on the thread that runs the backward's
    gradient hooks."""
    task, state, arrays = _small_step("physionet_transformer", 64)
    hook_threads = set()
    layer = state.model.transformer_encoder.layers[0]
    layer.register_full_backward_hook(
        lambda *a: hook_threads.add(threading.get_ident()))
    with _cpu_profile():
        _step(task, state, arrays)
    rows = profiler.span_table()
    by = {r["span"]: r for r in rows}
    names = [r["name"] for r in rows]
    n_layers = len(state.model.transformer_encoder.layers)
    assert names.count("ecgmm.attention.forward") == n_layers == 2
    assert names.count("ecgmm.attention.backward") == n_layers
    for r in rows:
        if r["name"].startswith("ecgmm.attention."):
            phase = "forward" if r["name"].endswith("forward") \
                else "backward"
            parent = by[r["parent"]]
            assert parent["name"] == "ecgmm.step." + phase
            assert parent["start_ns"] <= r["start_ns"]
            assert r["start_ns"] + r["host_ms"] * 1e6 <= \
                parent["start_ns"] + parent["host_ms"] * 1e6 + 1
    backward = {r["thread"] for r in rows
                if r["name"] == "ecgmm.attention.backward"}
    assert backward == hook_threads and len(backward) == 1


def test_log_clears_when_tracing_turns_on_again():
    """The log keeps a profiler's spans once it stops, and a span with
    tracing off; the first span under the next profiler starts it anew."""
    with _cpu_profile():
        with profiler.span("ecgmm.first"):
            pass
    with profiler.span("ecgmm.off"):
        pass
    assert [b.name for b in profiler.span_log()] == ["ecgmm.first"] * 2
    with _cpu_profile():
        with profiler.span("ecgmm.second"):
            pass
    assert [b.name for b in profiler.span_log()] == ["ecgmm.second"] * 2


def test_event_pool_grows_to_its_slot(monkeypatch):
    """Boundaries logged before CUDA is initialised, then on one device
    and then on another: each device's pool starts empty at a later slot
    and grows to it, every boundary the log holds has an event of its
    own, recorded once, and a slot's event is reused once the log has
    moved past it."""

    class FakeEvent:
        def __init__(self, enable_timing=False):
            self.records = 0

        def record(self):
            self.records += 1

    device = {"initialised": False, "index": 0}
    monkeypatch.setattr(torch.cuda, "is_initialized",
                        lambda: device["initialised"])
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: device["index"])
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    spans = profiler._Spans(bound=16)

    def spans_on(name, n=1):
        for _ in range(n):
            spans.exit(spans.enter(name), name)

    spans_on("ecgmm.cpu")
    device["initialised"] = True
    spans_on("ecgmm.card0")
    device["index"] = 1
    spans_on("ecgmm.card1", 3)
    log = list(spans.log)
    assert [b.event is None for b in log] == [True] * 2 + [False] * 8
    events = [b.event for b in log[2:]]
    assert len({id(e) for e in events}) == 8
    assert all(e.records == 1 for e in events)
    assert [len(spans.events[0]), len(spans.events[1])] == [4, 10]
    assert log[-1].event is spans.events[1][9]
    # the 21st boundary takes slot 4 of device 1's pool again, once the
    # fifth has left the log
    spans_on("ecgmm.card1", 6)
    assert spans.log[-2].event is spans.events[1][4]
    assert spans.events[1][4].records == 2
    assert len(spans.events[1]) == 16


def test_spans_change_no_number():
    """Two Transformer states from one seed, three steps each, one with
    spans off and one under a profiler: bit-equal losses and
    parameters (dropout draws included)."""
    results = []
    for traced in (False, True):
        task, state, arrays = _small_step("physionet_transformer", 64)
        losses = []
        for k in range(3):
            if traced:
                with _cpu_profile():
                    losses.append(_step(task, state, arrays, k)["loss"])
            else:
                losses.append(_step(task, state, arrays, k)["loss"])
        results.append((torch.stack(losses),
                        {n: p.detach().clone()
                         for n, p in state.model.named_parameters()}))
    (l0, p0), (l1, p1) = results
    assert torch.equal(l0, l1)
    assert p0.keys() == p1.keys()
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


def test_cpu_trace_is_written_where_the_report_reads(tmp_path, capsys):
    """`trace(logdir)` around two steps of a small conv net on the CPU:
    one `<logdir>/plugins/profile/<ts>/<host>.pt.trace.json.gz` and its
    `spans.json` (no span in a net outside the engine); the
    report reads its host ops (convolution and batch norm categories,
    per step) and finds no device events in it."""
    model = torch.nn.Sequential(torch.nn.Conv1d(2, 4, 3),
                                torch.nn.BatchNorm1d(4), torch.nn.ReLU())
    x = torch.randn(8, 2, 30)
    with profiler.trace(str(tmp_path)):
        for _ in range(2):
            model(x).sum().backward()
    profile = tmp_path / "plugins" / "profile"
    (stamp,) = os.listdir(profile)
    names = os.listdir(profile / stamp)
    (name,) = [n for n in names if n != "spans.json"]
    assert name.endswith(".pt.trace.json.gz") and len(names) == 2
    with open(profile / stamp / "spans.json") as f:
        assert json.load(f) == {"spans": []}
    assert trace_report.load_device_events(str(tmp_path)) == []
    rows = trace_report.op_rows(
        trace_report.load_device_events(str(tmp_path), host_ops=True))
    cats = trace_report.rollup(rows, "category")
    assert cats["conv"][1] >= 2 and cats["batch norm"][1] >= 2
    trace_report.print_report(str(tmp_path), steps=2, host_ops=True)
    out = capsys.readouterr().out
    assert "host op time" in out and "conv" in out and "batch norm" in out


def _write_device_trace(tmp_path):
    """torch's Chrome layout: kernels (`cat` "kernel") of the port's
    kernels and of cuDNN, cuBLAS and ATen, a copy, a set, and host
    events that the report leaves out."""
    def kernel(name, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
                "ts": 0, "dur": dur, "args": {"device": 0}}

    events = [
        kernel("void se_fwd<float>(float const*, int)", 10),
        kernel("void se_fwd<float>(float const*, int)", 10),
        kernel("void se_bwd<float>(float const*)", 20),
        kernel("void (anonymous namespace)::se_bwd_params(float const*)", 5),
        kernel("focal_fwd<int>(float const*)", 3),
        kernel("focal_bwd<int>(float const*)", 4),
        kernel("fusion_fwd(float const*)", 6),
        kernel("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize", 300),
        kernel("cudnn::bn_fw_tr_1C11_kernel_NCHW<float>", 50),
        kernel("void implicit_convolve_sgemm<float, float>", 400),
        kernel("void at::native::vectorized_elementwise_kernel<4>", 30),
        kernel("void at::native::reduce_kernel<512, 1>", 40),
        kernel("Memcpy DtoH (Device -> Pinned)", 70, "gpu_memcpy"),
        kernel("Memset (Device)", 2, "gpu_memset"),
        kernel("mystery_kernel", 50),
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
         "tid": 1, "ts": 0, "dur": 5000},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 0, "dur": 8},
    ]
    d = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    os.makedirs(d)
    with gzip.open(d / "host.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def test_device_events_rollups_and_kernel_counts(tmp_path, capsys):
    root = _write_device_trace(tmp_path)
    rows = trace_report.op_rows(trace_report.load_device_events(root))
    assert len(rows) == 15  # host events left out
    cats = trace_report.rollup(rows, "category")
    assert cats["ecgmm se_fwd"] == (20.0, 2)
    assert cats["ecgmm se_bwd"] == (20.0, 1)
    assert cats["ecgmm se_bwd_params"] == (5.0, 1)
    assert cats["gemm"] == (300.0, 1)
    assert cats["conv"] == (400.0, 1)
    assert cats["batch norm"] == (50.0, 1)
    assert cats["elementwise"] == (30.0, 1)
    assert cats["reduction"] == (40.0, 1)
    assert cats["memcpy"] == (72.0, 2)
    assert cats["other"] == (50.0, 1)
    assert trace_report.launch_counts(rows) == {
        "se_fwd": 2, "se_bwd": 1, "se_bwd_params": 1, "focal_fwd": 1,
        "focal_bwd": 1, "fusion_fwd": 1}
    trace_report.print_report(root, steps=2, top=5)
    out = capsys.readouterr().out
    # 1000 us of device time over 2 steps
    assert "device op time: 0.500 ms/step" in out
    assert "ecgmm se_fwd" in out and "by category" in out
    trace_report.main([root, "--steps", "1"])
    assert "1.000 ms/step" in capsys.readouterr().out


def test_report_counts_after_a_warmup_annotation(tmp_path, capsys):
    """`after`: a warm-up step's annotation, its kernels and the counted
    steps' kernels; only the events that start after the annotation ends
    are read, per step of the steps after it. A name that is not one
    annotation of the trace raises."""
    def kernel(name, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                "tid": 7, "ts": ts, "dur": dur, "args": {"device": 0}}

    events = [
        {"ph": "X", "cat": "user_annotation", "name": "warmup", "pid": 1,
         "tid": 1, "ts": 100, "dur": 50},
        kernel("void se_fwd<float>(float const*, int)", 120, 10),
        kernel("void se_fwd<float>(float const*, int)", 200, 10),
        kernel("void se_fwd<float>(float const*, int)", 300, 10),
        kernel("focal_fwd<int>(float const*)", 310, 20),
    ]
    d = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    os.makedirs(d)
    with gzip.open(d / "host.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    root = str(tmp_path)
    rows = trace_report.op_rows(
        trace_report.load_device_events(root, after="warmup"))
    assert trace_report.launch_counts(rows) == {"se_fwd": 2, "focal_fwd": 1}
    assert len(trace_report.load_device_events(root)) == 4
    trace_report.main([root, "--steps", "2", "--after", "warmup"])
    # 40 us of device time after the warm-up over 2 steps
    assert "device op time: 0.020 ms/step (3 device op events / 2 steps)" \
        in capsys.readouterr().out
    with pytest.raises(ValueError, match="0 annotations named 'step'"):
        trace_report.load_device_events(root, after="step")


def test_trace_writes_the_step_spans_beside_the_trace(tmp_path, capsys):
    """`trace(logdir)` around a CPU train step writes its spans as
    `spans.json`; `trace_report --spans` rolls them up by name (no
    device ms and no device gaps on the CPU)."""
    task, state, arrays = _small_step("signal_only", 256)
    with profiler.trace(str(tmp_path)):
        _step(task, state, arrays)
    spans = trace_report.load_spans(str(tmp_path))
    assert [r["name"] for r in spans] == ["ecgmm.gather",
                                          "ecgmm.train_step"] + PHASES
    assert all(r["device_ms"] is None for r in spans)
    rolled = trace_report.span_rollup(spans)
    assert rolled["ecgmm.train_step"]["count"] == 1
    assert rolled["ecgmm.train_step"]["self_ms"] < \
        rolled["ecgmm.train_step"]["host_ms"]
    trace_report.main([str(tmp_path), "--spans"])
    out = capsys.readouterr().out
    assert "ecgmm.step.backward" in out and "in 0 gaps" in out


def test_span_report_names_idle_gaps_by_the_innermost_span(tmp_path,
                                                           capsys):
    """A synthetic device trace with the step's annotations and its
    `spans.json`: each idle gap of the device is named by the innermost
    `ecgmm.*` annotation over its middle (a gap inside the forward is the
    forward's, not the step's; one between steps is outside every span),
    a second device's kernels are left out, and the spans roll up with
    their device ms."""
    def kernel(ts, dur, device=0):
        return {"ph": "X", "cat": "kernel", "name": "k", "pid": 0,
                "tid": 7, "ts": ts, "dur": dur, "args": {"device": device}}

    def note(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name,
                "pid": 1, "tid": 1, "ts": ts, "dur": dur}

    events = [note("ecgmm.train_step", 0, 100),
              note("ecgmm.step.forward", 0, 60),
              note("ecgmm.step.backward", 60, 40),
              note("other", 0, 100),
              kernel(0, 10), kernel(30, 10),      # 20 us in the forward
              kernel(65, 10), kernel(80, 30),     # 5 us in the backward
              kernel(140, 10),                    # 30 us between steps
              kernel(40, 100, device=1)]
    d = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    os.makedirs(d)
    with gzip.open(d / "host.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    spans = [{"span": 0, "name": "ecgmm.train_step", "parent": None,
              "thread": 1, "start_ns": 0, "host_ms": 0.1, "self_ms": 0.0,
              "device_ms": 0.11},
             {"span": 1, "name": "ecgmm.step.forward", "parent": 0,
              "thread": 1, "start_ns": 0, "host_ms": 0.06,
              "self_ms": 0.06, "device_ms": 0.04},
             {"span": 2, "name": "ecgmm.step.backward", "parent": 0,
              "thread": 1, "start_ns": 60000, "host_ms": 0.04,
              "self_ms": 0.04, "device_ms": None}]
    with open(d / "spans.json", "w") as f:
        json.dump({"spans": spans}, f)
    gaps = trace_report.idle_gaps(trace_report.load_trace(str(tmp_path)))
    assert gaps == [(10.0, 30.0, "ecgmm.step.forward"),
                    (40.0, 65.0, "ecgmm.step.forward"),
                    (75.0, 80.0, "ecgmm.step.backward"),
                    (110.0, 140.0, trace_report.OUTSIDE)]
    rolled = trace_report.span_rollup(trace_report.load_spans(
        str(tmp_path)))
    assert rolled["ecgmm.step.forward"]["device_ms"] == 0.04
    assert rolled["ecgmm.step.backward"]["device_ms"] is None
    trace_report.main([str(tmp_path), "--spans", "--steps", "1"])
    out = capsys.readouterr().out
    assert "device idle by span: 0.080 ms/step in 4 gaps" in out
    assert "0.045 ms/step  ecgmm.step.forward" in out
    assert "0.030 ms/step  outside every span" in out
