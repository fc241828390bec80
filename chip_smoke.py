#!/usr/bin/env python3
"""Drive the PyTorch port (`ecgmm_torch`) on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failed check:
  1. device: the card's name and power limit; compute capability 9.0;
  2. build: compile the CUDA kernels from `ecgmm_torch/ops/csrc/`;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the serving and training shapes, values (and the fusion head's
     gradients) within the stated bars, plus per-shape device times;
  4. the slice: `ServingPipeline.demo(device="cuda")` (full-width
     canonical model, 224x224 images, 2476-sample signals, seeded random
     weights) answers 8 requests with the full ResultScreen contract, the
     kernels' launch counters prove the requests ran through them, and 2
     requests match the same pipeline on the CPU;
  5. numbers: request latency and one `kernels` JSON line.

The last line of standard output is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ecgmm_torch.config import ModelConfig  # noqa: E402
from ecgmm_torch.data.synthetic import _render_strip  # noqa: E402
from ecgmm_torch.models import ECGMultimodalModel  # noqa: E402
from ecgmm_torch.ops import _ext, fusion, se  # noqa: E402
from ecgmm_torch.serve.pipeline import ServingPipeline  # noqa: E402

# (HBM bytes/s, non-tensor-core f32 FLOP/s) by card name (NVIDIA data
# sheets; dense rates at the full power limit)
PEAKS = {
    "H100 80GB HBM3": (3.35e12, 67e12),   # H100 SXM
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H200": (4.8e12, 67e12),
}
SE_SHAPES = [(619, 64), (310, 128), (155, 256)]  # (T, C) at signal 2476
SE_EDGE_SHAPES = [(37, 16)]  # odd T, reduction width R = 1
FUSION_DIMS = [(512, 128, 32), (256, 256, 256)]  # canonical, modal balance
RESPONSE_KEYS = ("label", "probability", "ecg_signal", "heatmap",
                 "feature_importance", "gpt_result", "digitization")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no peak rates on record for {name!r}")


def device_us(fn, n: int = 100) -> float:
    """Median device time of one call of fn, in µs: the launches are
    queued behind a sleeping kernel so that the host's launch overhead
    does not land between the timing events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(100_000_000)
    for i in range(n):
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) * 1e3
                             for s, e in zip(starts, ends))


def check_se(gen, peaks):
    """fused_se vs reference_se on the card; returns per-shape records."""
    bw, flops = peaks
    rows = []
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 0.05)):
        for b in (1, 256):
            for t, c in SE_SHAPES + SE_EDGE_SHAPES:
                r = max(1, c // 16)
                x = torch.randn(b, c, t, generator=gen).to("cuda", dtype)
                ws = [torch.randn(r, c, generator=gen) * 0.1,
                      torch.randn(r, generator=gen) * 0.1,
                      torch.randn(c, r, generator=gen) * 0.1,
                      torch.randn(c, generator=gen) * 0.1]
                ws = [w.to("cuda", dtype) for w in ws]
                out = se.fused_se(x, *ws)
                ref = se.reference_se(x, *ws)
                torch.cuda.synchronize()
                if out.dtype != dtype:
                    raise AssertionError(f"fused_se returned {out.dtype}")
                err = (out.float() - ref.float()).abs().max().item()
                if dtype == torch.float32:
                    ok = err <= atol
                else:
                    ok = torch.allclose(out.float(), ref.float(), atol=atol,
                                        rtol=0.05)
                if not ok:
                    raise AssertionError(
                        f"fused_se {dtype} B={b} T={t} C={c}: max err {err}")
                esize = x.element_size()
                nbytes = (2 * x.numel() + sum(w.numel() for w in ws)) * esize
                nflop = 2 * x.numel() + 4 * b * c * r
                rows.append({
                    "B": b, "T": t, "C": c, "dtype": str(dtype)[6:],
                    "max_abs_err": err,
                    "us": device_us(lambda: se.fused_se(x, *ws)),
                    "plain_us": device_us(lambda: se.reference_se(x, *ws)),
                    "bound_us": max(nbytes / bw, nflop / flops) * 1e6,
                    "library_us": None,
                })
                print(f"fused_se {rows[-1]}", flush=True)
    return rows


def check_fusion(gen, peaks):
    """fused_attention_fusion vs the plain version on the card: values,
    soft weights, and the gradients of sum(out**2) w.r.t. all six
    inputs."""
    bw, flops = peaks
    rows = []
    eps = 1e-5
    for b in (1, 8, 32, 256):
        for dims in FUSION_DIMS:
            d = sum(dims)
            ins = [torch.randn(b, w, generator=gen) for w in dims] + [
                torch.randn(3, generator=gen),
                torch.randn(d, generator=gen) + 1,
                torch.randn(d, generator=gen)]
            ins = [t.cuda() for t in ins]
            leaves = [t.clone().requires_grad_(True) for t in ins]
            out, sw = fusion.fused_attention_fusion(*leaves, eps=eps)
            g_kernel = torch.autograd.grad((out ** 2).sum(), leaves)
            ref_leaves = [t.clone().requires_grad_(True) for t in ins]
            ref, ref_sw = fusion.reference_attention_fusion(*ref_leaves,
                                                            eps=eps)
            g_ref = torch.autograd.grad((ref ** 2).sum(), ref_leaves)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            sw_err = (sw - ref_sw).abs().max().item()
            if err > 1e-5 or sw_err > 1e-7:
                raise AssertionError(
                    f"fusion B={b} D={d}: value err {err}, sw err {sw_err}")
            for name, ga, gb in zip(
                    ("img", "sig", "clin", "weights", "scale", "bias"),
                    g_kernel, g_ref):
                # rtol 1e-5 / atol 1e-4 elementwise, except for the three
                # `weights` components: each sums B*D terms that cancel, so
                # its float32 rounding (the plain version's too: 3e-3 off
                # float64 at B=256, D=768 on the CPU) scales with the
                # largest component, and the relative bar is taken
                # against that
                ref_scale = gb.abs().max() if name == "weights" else gb.abs()
                if ((ga - gb).abs() > 1e-4 + 1e-5 * ref_scale).any():
                    raise AssertionError(
                        f"fusion B={b} D={d}: grad {name} max err "
                        f"{(ga - gb).abs().max().item()}")
            with torch.no_grad():
                fused = torch.cat([ref_sw[i] * ins[i] for i in range(3)], -1)
                nbytes = 4 * (2 * b * d + 2 * d + 6)
                rows.append({
                    "B": b, "D": d, "max_abs_err": err, "sw_err": sw_err,
                    "us": device_us(
                        lambda: fusion.fused_attention_fusion(*ins, eps=eps)),
                    "plain_us": device_us(
                        lambda: fusion.reference_attention_fusion(
                            *ins, eps=eps)),
                    "bound_us": max(nbytes / bw, 9 * b * d / flops) * 1e6,
                    "library_us": device_us(
                        lambda: F.layer_norm(fused, (d,), ins[4], ins[5],
                                             eps)),
                })
            print(f"fused_attention_fusion {rows[-1]}", flush=True)
    return rows


def make_requests(n: int, seed: int):
    """n seeded ECG-like strips (250x2500, rendered like the reference's
    lead-II photos) with varied questionnaires and formats."""
    rng = np.random.default_rng(seed)
    t = np.arange(2476) / 250.0
    reqs = []
    for i in range(n):
        hr = rng.uniform(55, 95)
        jitter = 0.25 if i % 2 else 0.02
        phase = np.cumsum((hr / 60.0) * (1 + jitter * rng.standard_normal(
            t.size)) / 250.0)
        sig = (np.exp(-np.square(((phase % 1.0) - 0.5) * 18))
               + 0.2 * np.sin(2 * np.pi * rng.uniform(0.1, 0.5) * t)
               + 0.04 * rng.standard_normal(t.size))
        q = {"age": int(rng.integers(25, 90)),
             "weight": int(rng.integers(45, 100)),
             "gender": str(i % 2)}
        reqs.append((_render_strip(sig, 250, 2500), q,
                     "png" if i % 2 == 0 else "cam"))
    return reqs


def check_response(resp, fmt):
    missing = [k for k in RESPONSE_KEYS if k not in resp]
    if missing:
        raise AssertionError(f"response lacks {missing}")
    if resp["label"] not in ("Normal", "Abnormal"):
        raise AssertionError(f"bad label {resp['label']!r}")
    if not 0.0 <= resp["probability"] <= 1.0:
        raise AssertionError(f"bad probability {resp['probability']}")
    fi = resp["feature_importance"]
    if set(fi) != {"image", "signal", "age", "wt"} or not np.isclose(
            sum(fi.values()), 100.0, atol=1e-2):
        raise AssertionError(f"bad feature_importance {fi}")
    if not all(np.isfinite(v["Voltage (mV)"]) for v in resp["ecg_signal"]):
        raise AssertionError("non-finite ecg_signal")
    if fmt == "png" and not resp["heatmap"]:
        raise AssertionError("empty png heatmap")
    if fmt == "cam":
        cam = np.asarray(resp["heatmap_cam"])
        if cam.shape != (7, 7) or not np.all((cam >= 0) & (cam <= 1)):
            raise AssertionError(f"bad heatmap_cam {cam.shape}")
    if len(resp["gpt_result"]) != 5:
        raise AssertionError("gpt_result lacks sections")


def run_slice():
    """Phase 4: the serving path at full width on the card."""
    pipe = ServingPipeline.demo(device="cuda", seed=0)
    reqs = make_requests(8, seed=1)
    pipe.predict(*reqs[0])  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    se.launches = fusion.launches = 0
    timings = []
    for img, q, fmt in reqs:
        resp = pipe.predict(img, q, fmt)
        check_response(resp, fmt)
        timings.append(dict(pipe.last_timing))
    launches = {"fused_se": se.launches,
                "fused_attention_fusion": fusion.launches}
    print(f"main path launches over {len(reqs)} requests: {launches}",
          flush=True)
    # 3 SE blocks; fusion head at B=1 (prediction), 32 (SHAP), 8 (IG)
    if launches != {"fused_se": 3 * len(reqs),
                    "fused_attention_fusion": 3 * len(reqs)}:
        raise AssertionError("the main path did not run through the kernels")
    device_busy(pipe, reqs[:2],
                statistics.median(t["device_ms"] for t in timings))

    # the same weights on the CPU: cuDNN's TF32 default is turned off so
    # that both sides compute in float32
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_model = ECGMultimodalModel(cfg=ModelConfig(dtype="float32"))
    cpu_pipe = ServingPipeline(
        cpu_model, {k: v.cpu() for k, v in pipe.model.state_dict().items()},
        device="cpu",
    )
    for img, q, _ in make_requests(2, seed=2):
        a = pipe.predict(img, q, "cam")
        b = cpu_pipe.predict(img, q, "cam")
        cam_err = float(np.abs(np.asarray(a["heatmap_cam"])
                               - np.asarray(b["heatmap_cam"])).max())
        fi_err = max(abs(a["feature_importance"][k]
                         - b["feature_importance"][k])
                     for k in a["feature_importance"])
        p_err = abs(a["probability"] - b["probability"])
        print(f"gpu vs cpu: label {a['label']}/{b['label']} prob err "
              f"{p_err:.3g} cam err {cam_err:.3g} importance err "
              f"{fi_err:.3g} pp", flush=True)
        if a["label"] != b["label"] or p_err > 1e-3 or cam_err > 1e-3 \
                or fi_err > 0.5:
            raise AssertionError("GPU and CPU answers disagree")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return launches, timings


def device_busy(pipe, reqs, unprofiled_ms):
    """Device time of every kernel and copy per request (torch.profiler)
    as a share of the device program's event-timed span, with the
    profiler on and against the unprofiled median span, and the kernels
    that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    span_ms = 0.0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for img, q, fmt in reqs:
            pipe.predict(img, q, fmt)
            span_ms += pipe.last_timing["device_ms"]
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0.0:
        print("device busy share: not measured (the profiler saw no "
              "device time)", flush=True)
        return
    n = len(reqs)
    print(f"device busy {busy_ms / n:.3f} ms/request over {n} requests, "
          f"{sum(e.count for e in events) // n} device ops/request; share "
          f"of the device-program span: {busy_ms / span_ms:.3f} profiled "
          f"({span_ms / n:.3f} ms/request), {busy_ms / n / unprofiled_ms:.3f}"
          f" of the unprofiled median ({unprofiled_ms:.3f} ms)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/req "
              f"{e.count // n:5d}x/req  {e.key[:90]}", flush=True)


def summarize(name, source, replaces, launches, rows, serving):
    """One kernel's entry of the `kernels` line: the times are the sum
    over the calls one request makes (`serving` picks those rows)."""
    picked = [r for r in rows if serving(r)]
    lib = [r["library_us"] for r in picked]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r.get("dtype", "float32") == "float32"),
        "ms": sum(r["us"] for r in picked) / 1e3,
        "plain_ms": sum(r["plain_us"] for r in picked) / 1e3,
        "bound_ms": sum(r["bound_us"] for r in picked) / 1e3,
        "bound_by": "bytes",
        "library_ms": None if None in lib else sum(lib) / 1e3,
        "per_request_calls": len(picked),
        "shapes": rows,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # 1. device
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {smi}", flush=True)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability 9.0, found {cap}")
    peaks = peaks_for(name)

    # 2. build
    t0 = time.perf_counter()
    lib = _ext.library()
    print(f"built {_ext._sources()} -> {lib._name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 3. kernels vs plain versions; the floor is what a kernel that does
    # almost nothing measures with device_us
    print(f"timing floor: {device_us(lambda: torch.cuda._sleep(1)):.3f} us "
          f"per launch ({smi})", flush=True)
    gen = torch.Generator().manual_seed(0)
    print("fused_se has no single PyTorch call computing the same function "
          "(library_ms null)", flush=True)
    se_rows = check_se(gen, peaks)
    fusion_rows = check_fusion(gen, peaks)

    # 4. the slice
    launches, timings = run_slice()

    # 5. numbers
    for key in ("total_ms", "host_before_ms", "device_ms", "host_after_ms"):
        vals = sorted(t[key] for t in timings)
        print(f"request {key}: median {statistics.median(vals):.3f} p90 "
              f"{float(np.percentile(vals, 90)):.3f} ({smi})", flush=True)
    kernels = [
        summarize("fused_se", "ecgmm_torch/ops/csrc/se.cu",
                  "ecgmm_tpu/ops/pallas_se.py:85", launches["fused_se"],
                  se_rows,
                  lambda r: r["B"] == 1 and r["dtype"] == "float32"
                  and (r["T"], r["C"]) in SE_SHAPES),
        summarize("fused_attention_fusion", "ecgmm_torch/ops/csrc/fusion.cu",
                  "ecgmm_tpu/ops/pallas_fusion.py:98",
                  launches["fused_attention_fusion"], fusion_rows,
                  lambda r: r["D"] == 672 and r["B"] in (1, 8, 32)),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
