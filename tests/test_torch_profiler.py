"""The port's profiler (`ecgmm_torch/train/profiler.py`) and trace report
(`ecgmm_torch/tools/trace_report.py`) against JAX's
(`tests/test_tools.py:86-100`, `tests/test_trace_report.py`), on the CPU.

The probes answer as JAX's do where there is no card (FLOPs of a matmul
at least JAX's bar of 2·128³·0.5; the memory stats carry
`live_buffer_bytes`); `StepTimer` gives a finite rate after its warmup; a
trace the port writes on the CPU lands where the report globs and is read
back (host ops on the CPU); a device trace of torch's Chrome layout, made
here with kernel, copy and host events, rolls up into the report's
categories, the port's kernels counted by name.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from ecgmm_torch.tools import trace_report
from ecgmm_torch.train import profiler

torch.set_num_threads(2)


def test_profiler_probes():
    x = torch.ones((128, 128))
    flops = profiler.compiled_flops(lambda a: a @ a, x)
    assert flops is not None and flops >= 2 * 128 ** 3 * 0.5
    assert flops == 2 * 128 ** 3
    assert profiler.compiled_flops(lambda a: a.no_such_method(), x) is None
    if not torch.cuda.is_available():
        assert profiler.live_buffer_bytes() == 0
    stats = profiler.device_memory_stats()
    assert "live_buffer_bytes" in stats


def test_step_timer():
    t = profiler.StepTimer(warmup=1)
    for _ in range(4):
        with t:
            sum(range(1000))
    assert np.isfinite(t.samples_per_sec(32))
    assert np.isfinite(t.mean_step_ms) and len(t._times) == 3
    assert np.isnan(profiler.StepTimer().samples_per_sec(8))


def test_cpu_trace_is_written_where_the_report_reads(tmp_path, capsys):
    """`trace(logdir)` around two steps of a small conv net on the CPU:
    one `<logdir>/plugins/profile/<ts>/<host>.pt.trace.json.gz`; the
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
    (name,) = os.listdir(profile / stamp)
    assert name.endswith(".pt.trace.json.gz")
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
