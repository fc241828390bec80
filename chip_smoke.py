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
  5. numbers: request latency;
  6. the training slice: 3 full-width `ptbxl_af` train steps from one
     initial state on the card and on the CPU agree (loss, gradients,
     parameters, BatchNorm buffers), and the same first step with TF32 on
     falls outside the gradient bar; `run()` trains `ptbxl_af` (2 epochs,
     256 synthetic records) and `physionet_multi` (1 epoch, 96 records) on
     the card through the kernels, checkpoints restore, the best/last test
     reports have their keys, and the launch counters equal the batch plan;
  7. numbers: train-step time (CUDA events), samples/s, epoch time, the
     device's busy share (torch.profiler), and one `kernels` JSON line.

The last line of standard output is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ecgmm_torch.config import ModelConfig, get_preset  # noqa: E402
from ecgmm_torch.data import pipeline  # noqa: E402
from ecgmm_torch.data.synthetic import _render_strip  # noqa: E402
from ecgmm_torch.models import ECGMultimodalModel  # noqa: E402
from ecgmm_torch.ops import _ext, fusion, se  # noqa: E402
from ecgmm_torch.ops import losses as focal  # noqa: E402
from ecgmm_torch.serve.pipeline import ServingPipeline  # noqa: E402
from ecgmm_torch.tools import grad_precision as gp  # noqa: E402
from ecgmm_torch.train import engine  # noqa: E402
from ecgmm_torch.train.checkpoint import CheckpointManager  # noqa: E402
from ecgmm_torch.train.state import create_state  # noqa: E402
from ecgmm_torch.workloads import run as train_run  # noqa: E402

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
TRAIN_B = 16  # ptbxl_af batch
# (B, T, C) of the SE blocks on the training paths: ptbxl_af (signal
# 2476, B=16) and physionet_multi (signal 3000, B=8)
SE_TRAIN_SHAPES = ([(TRAIN_B, t, c) for t, c in SE_SHAPES]
                   + [(8, 750, 64), (8, 375, 128), (8, 188, 256)])
# (B, C): ptbxl_af, physionet_multi, the widest class count, a large batch
FOCAL_SHAPES = [(16, 2), (8, 3), (13, 4), (65536, 2)]
FOCAL_MASKS = ("ones", "some_zero", "all_zero")
PTBXL_REPORT_KEYS = {"threshold", "accuracy", "f1", "auroc", "temperature",
                     "test_ece", "test_ece_calibrated"}
MULTI_REPORT_KEYS = {"accuracy", "f1_macro", "auroc_ovr", "temperature",
                     "test_ece", "test_ece_calibrated"}
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


def device_us(fn, n: int = 20) -> float:
    """Median device time of one call of fn, in µs: the launches are
    queued behind a sleeping kernel so that the host's launch overhead
    does not land between the timing events. The sleep lasts at least
    three times as long as an untimed round of the n calls took, and n is
    small enough that n calls of a plain version (up to ~40 launches
    each) fit in the card's launch queue; a longer queue blocks the host
    until the sleep ends, and the rest would be timed at the host's
    pace."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    # cycles at up to 2 GHz
    torch.cuda._sleep(int(max(1e8, 3 * round_s * 2e9)))
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


def _focal_mask(kind: str, b: int, gen) -> torch.Tensor:
    if kind == "ones":
        return torch.ones(b)
    if kind == "all_zero":
        return torch.zeros(b)
    mask = (torch.rand(b, generator=gen) < 0.7).float()
    mask[-1] = 0.0
    return mask


def check_focal(gen, peaks):
    """fused_focal_loss vs reference_focal on the card, with masks of
    ones, with zeros and all zero, and int64 or int32 labels: the value
    within rtol 1e-5, dlogits and dmask within atol 1e-5 (the bars of
    tests/test_pallas_ops.py), and three more launches bit-identical to
    the first (the in-kernel reduction is in a fixed order)."""
    bw, flops = peaks
    rows = []
    for b, c in FOCAL_SHAPES:
        for kind in FOCAL_MASKS:
            ldtype = torch.int32 if kind == "some_zero" else torch.int64
            logits = (torch.randn(b, c, generator=gen) * 2).cuda()
            labels = torch.randint(0, c, (b,), generator=gen).to("cuda",
                                                                 ldtype)
            mask = _focal_mask(kind, b, gen).cuda()

            def fwd_bwd(fn, lg, mk):
                out = fn(lg, labels, mk)
                return out, torch.autograd.grad(out, (lg, mk))

            leaves = [logits.clone().requires_grad_(True),
                      mask.clone().requires_grad_(True)]
            out, g_kernel = fwd_bwd(focal.fused_focal_loss, *leaves)
            ref_leaves = [logits.clone().requires_grad_(True),
                          mask.clone().requires_grad_(True)]
            ref, g_ref = fwd_bwd(focal.reference_focal, *ref_leaves)
            repeats = [focal.fused_focal_loss(logits, labels, mask)
                       for _ in range(3)]
            torch.cuda.synchronize()
            err = abs(out.item() - ref.item())
            if err > 1e-5 * abs(ref.item()):
                raise AssertionError(
                    f"fused_focal_loss B={b} C={c} {kind}: value "
                    f"{out.item()} vs {ref.item()}")
            grad_err = max((a - r).abs().max().item()
                           for a, r in zip(g_kernel, g_ref))
            if grad_err > 1e-5:
                raise AssertionError(
                    f"fused_focal_loss B={b} C={c} {kind}: grad err "
                    f"{grad_err}")
            if not all(torch.equal(r, out.detach()) for r in repeats):
                raise AssertionError(
                    f"fused_focal_loss B={b} C={c} {kind}: repeated "
                    "launches differ")
            row = {"B": b, "C": c, "mask": kind, "labels": str(ldtype)[6:],
                   "max_abs_err": err, "grad_err": grad_err}
            if kind == "some_zero":
                # each input read once, the 0-d result written once; per
                # row 4C + 10 f32 operations (max, shift, exp, sum, log,
                # ce, pt, pow, products and the two sums)
                nbytes = (4 * b * c + labels.element_size() * b + 4 * b
                          + 4)
                nops = b * (4 * c + 10) + 2
                row.update(
                    us=device_us(lambda: focal.fused_focal_loss(
                        logits, labels, mask)),
                    plain_us=device_us(lambda: focal.reference_focal(
                        logits, labels, mask)),
                    fwd_bwd_us=device_us(lambda: fwd_bwd(
                        focal.fused_focal_loss, *leaves)),
                    plain_fwd_bwd_us=device_us(lambda: fwd_bwd(
                        focal.reference_focal, *ref_leaves)),
                    bound_us=max(nbytes / bw, nops / flops) * 1e6,
                    bound_by=("bytes" if nbytes / bw >= nops / flops
                              else "operations"),
                    library_us=None,
                )
            rows.append(row)
            print(f"fused_focal_loss {row}", flush=True)
    return rows


def check_se_train(gen, peaks):
    """fused_se under autograd at the training shapes of ptbxl_af (B=16)
    and physionet_multi (B=8), f32: the output and the gradients of
    sum(out**2) w.r.t. x, w1, b1, w2 and b2 against plain autograd. Both
    backwards run the same plain code on the same saved inputs; they
    differ only through the cotangent 2*out, whose kernel half differs
    from the plain one by the forward's rounding (<= 1e-6), so each
    gradient is held to 1e-5 of its largest component (plus 1e-6)."""
    bw, flops = peaks
    rows = []
    for b, t, c in SE_TRAIN_SHAPES:
        r = max(1, c // 16)
        x = torch.randn(b, c, t, generator=gen).cuda()
        ws = [(torch.randn(*s, generator=gen) * 0.1).cuda()
              for s in ((r, c), (r,), (c, r), (c,))]
        ins = [x] + ws

        def fwd_bwd(fn, leaves):
            out = fn(*leaves)
            return out, torch.autograd.grad((out ** 2).sum(), leaves)

        leaves = [a.clone().requires_grad_(True) for a in ins]
        out, g_kernel = fwd_bwd(se.fused_se, leaves)
        ref_leaves = [a.clone().requires_grad_(True) for a in ins]
        ref, g_ref = fwd_bwd(se.reference_se, ref_leaves)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if err > 1e-5:
            raise AssertionError(
                f"fused_se train B={b} T={t} C={c}: err {err}")
        grad_rel = {}
        for name, a, g in zip(("x", "w1", "b1", "w2", "b2"), g_kernel,
                              g_ref):
            scale = g.abs().max().item()
            gerr = (a - g).abs().max().item()
            grad_rel[name] = gerr / max(scale, 1e-30)
            if gerr > 1e-5 * scale + 1e-6:
                raise AssertionError(
                    f"fused_se train B={b} T={t} C={c}: grad {name} err "
                    f"{gerr} (largest component {scale})")
        nbytes = 4 * (2 * x.numel() + sum(w.numel() for w in ws))
        nflop = 2 * x.numel() + 4 * b * c * r
        row = {
            "B": b, "T": t, "C": c, "dtype": "float32",
            "max_abs_err": err, "grad_err_rel": grad_rel,
            "us": device_us(lambda: se.fused_se(*ins)),
            "plain_us": device_us(lambda: se.reference_se(*ins)),
            "fwd_bwd_us": device_us(lambda: fwd_bwd(se.fused_se, leaves)),
            "plain_fwd_bwd_us": device_us(
                lambda: fwd_bwd(se.reference_se, ref_leaves)),
            "bound_us": max(nbytes / bw, nflop / flops) * 1e6,
            # backward: read x and the cotangent, write dx (the weight
            # gradients are a few kilobytes)
            "fwd_bwd_bound_us": (nbytes + 4 * 3 * x.numel()) / bw * 1e6,
            "library_us": None,
        }
        rows.append(row)
        print(f"fused_se train {row}", flush=True)
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


def _on(arrays, device):
    return arrays._replace(signals=arrays.signals.to(device),
                           labels=arrays.labels.to(device))


def compare_train_steps(n_steps: int = 3):
    """Phase 6a: n_steps train steps of the full-width ptbxl_af model
    (signal 2476, base filters 64, B=16, focal loss, Adam on the one-cycle
    schedule) from one initial state, on the card and on the CPU, over the
    same weighted-sampling batch plan; the third batch holds 10 pad rows.
    Dropout is 0: the card's and the CPU's generators draw different
    masks. TF32 is off (cuDNN's default runs float32 convolutions in TF32,
    about three decimal digits; the CPU computes in float32). The first
    step's gradients are also taken in float64 on the CPU
    (`ecgmm_torch/tools/grad_precision.py`), and both devices' float32
    gradients are read off them.

    Bars, and why:
      * loss at every step: rtol 1e-4;
      * float32 gradients of the first step, card vs CPU: 2e-3 of each
        tensor's largest component. Op by op, each float32 backward on the
        card is within 4e-6 of float64, as on the CPU (grad_precision).
        The whole step on the card reads 8.6e-4 off float64 (the CPU
        5e-6) because one ReLU input of the card's float32 forward lies
        on the other side of zero than in float64, which reroutes its
        channel's gradient; the line printed below names such flipped
        choices. With TF32 on, the same step reads 5e-2 off: a TF32
        control of the first step on the card must exceed the bar;
      * the convolution biases are left out of that: every convolution
        feeds a BatchNorm, which removes the bias, so their gradient is
        zero in exact arithmetic and float32 noise of either sign; Adam
        moves each such bias by up to the learning rate in the noise's
        direction at every step, so they are held to 2 * sum(lr);
      * other parameters after the steps: a tenth of sum(lr), the largest
        move Adam can make in these steps (the card's gradient error can
        turn the step of an element whose gradient is near zero);
      * BatchNorm running mean: 1e-5 plus 2 * sum(lr) (a drifting bias
        shifts the batch mean of the BatchNorm after it); running
        variance: 1e-5 relative (a shift leaves it unchanged)."""
    cfg, train, idx, mask, cpu_model, task = gp.batch_plan(64)
    t = cfg.train
    if idx.shape[0] < n_steps or mask[n_steps - 1].min() != 0.0:
        raise AssertionError(f"batch plan {idx.shape} lacks a padded batch "
                             f"within {n_steps} steps")
    first = gp.plan_batch(train, idx, mask, 0)
    grads64, _ = gp.grads64(cpu_model, first)
    choices64 = gp.decisions(cpu_model, first, "cpu", torch.float64)
    flipped = {dev: gp.flips(gp.decisions(cpu_model, first, dev,
                                          torch.float32), choices64)
               for dev in ("cuda", "cpu")}
    old = gp.apply_setting("tf32")
    try:
        grads_tf32 = gp.step_grads32(cpu_model, first, task, "cuda")
    finally:
        gp.restore_setting(old)
    models = {"cuda": copy.deepcopy(cpu_model).cuda(), "cpu": cpu_model}
    conv_biases = gp.conv_biases(cpu_model)
    losses, grads, states = {}, {}, {}
    for dev, model in models.items():
        st = create_state(model, t, idx.shape[0])
        arrays = _on(train, dev)
        idx_d = torch.from_numpy(idx.astype(np.int64)).to(dev)
        mask_d = torch.from_numpy(mask).to(dev)
        losses[dev] = []
        for i in range(n_steps):
            mets = engine.train_step(
                task, st, engine.gather_batch(arrays, idx_d[i], mask_d[i]))
            losses[dev].append(float(mets["loss"]))
            if i == 0:
                grads[dev] = {k: p.grad.detach().cpu()
                              for k, p in model.named_parameters()}
        states[dev] = {k: v.detach().cpu()
                       for k, v in model.state_dict().items()}
        sum_lr = sum(st.optimizer.schedule(k) for k in range(n_steps))
    print(f"train steps gpu vs cpu: losses {losses['cuda']} vs "
          f"{losses['cpu']}", flush=True)

    worst, failed = {}, []

    def note(kind, err, name, bar):
        worst[kind] = max(worst.get(kind, (0.0, "")), (err, name))
        if bar is not None and err > bar:
            failed.append(f"{kind} {name}: {err:.3g} > {bar:.3g}")

    for i, (a, b) in enumerate(zip(losses["cuda"], losses["cpu"])):
        note("loss_rel", abs(a - b) / abs(b), f"step {i + 1}", 1e-4)
    for name, g64 in grads64.items():
        if name in conv_biases:
            continue
        note("grad_rel", gp.rel(grads["cuda"][name], grads["cpu"][name]),
             name, 2e-3)
        note("gpu32_vs_f64_rel", gp.rel(grads["cuda"][name], g64), name,
             None)
        note("cpu32_vs_f64_rel", gp.rel(grads["cpu"][name], g64), name, None)
        note("gpu_tf32_vs_cpu_rel", gp.rel(grads_tf32[name],
                                           grads["cpu"][name]), name, None)
    print(f"first step, forward choices off float64: card {flipped['cuda']}"
          f", cpu {flipped['cpu']}", flush=True)
    if worst["gpu_tf32_vs_cpu_rel"][0] <= 2e-3:
        failed.append(f"the TF32 control reads {worst['gpu_tf32_vs_cpu_rel']}"
                      ", within the float32 bar 2e-3")
    params = dict(cpu_model.named_parameters())
    for name, want in states["cpu"].items():
        got = states["cuda"][name]
        if name.endswith("num_batches_tracked"):
            if not torch.equal(got, want):
                failed.append(f"{name}: {got} vs {want}")
            continue
        err = (got - want).abs().max().item()
        if name in conv_biases:
            note("conv_bias", err, name, 2 * sum_lr)
        elif name in params:
            note("param", err, name, 0.1 * sum_lr)
        elif name.endswith("running_mean"):
            note("bn_mean", err, name, 1e-5 + 2 * sum_lr)
        elif name.endswith("running_var"):
            note("bn_var_rel", err / want.abs().max().item(), name, 1e-5)
        else:
            failed.append(f"unexpected state entry {name}")
    print(f"train steps gpu vs cpu, worst (err, tensor): {worst}; "
          f"sum(lr) = {sum_lr:.3g}", flush=True)
    if failed:
        raise AssertionError(f"gpu vs cpu after {n_steps} steps: {failed}")
    return {"losses": losses, "worst": worst}


def run_training(tmp: str, name: str, n_synth: int, epochs: int):
    """Phase 6b: `run()` on the card, as `python -m
    ecgmm_torch.workloads.run --preset <name>` runs it, with the launch
    counters set to 0 just before and read just after."""
    cfg = get_preset(name)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=epochs,
        checkpoint_dir=os.path.join(tmp, "checkpoints"),
        log_dir=os.path.join(tmp, "runs"),
        output_dir=os.path.join(tmp, "output")))
    t = cfg.train
    data = train_run.load_data(cfg, n_synth, device="cuda")
    nb = {s: pipeline.num_batches(getattr(data, s).n, t.batch_size)
          for s in ("train", "val", "test")}
    # one loss per train step and per eval batch: every epoch trains and
    # evaluates val; the test protocol evaluates test and val for best
    # and for last. Three SE blocks per forward.
    n_loss = epochs * (nb["train"] + nb["val"]) + 2 * (nb["test"] + nb["val"])
    want = {"fused_focal_loss": n_loss, "fused_se": 3 * n_loss,
            "fused_attention_fusion": 0}
    run_dir = os.path.join(tmp, name)
    torch.cuda.synchronize()
    focal.launches = se.launches = fusion.launches = 0
    result, reports = train_run.run(cfg, data, run_dir=run_dir,
                                    device="cuda")
    torch.cuda.synchronize()
    launches = {"fused_focal_loss": focal.launches, "fused_se": se.launches,
                "fused_attention_fusion": fusion.launches}
    print(f"{name}: splits {[getattr(data, s).n for s in nb]}, batches "
          f"{nb}; launches {launches} (batch plan {want})", flush=True)
    if launches != want:
        raise AssertionError(f"{name}: launches {launches} != {want}")

    log_path = os.path.join(t.log_dir, name, "metrics.jsonl")
    with open(log_path) as f:
        logged = [json.loads(line) for line in f]
    if len(logged) != epochs or not all(
            np.isfinite(rec[k]) for rec in logged
            for k in ("Loss/Train", "Loss/Val")):
        raise AssertionError(f"{name}: bad metric log {logged}")
    keys = PTBXL_REPORT_KEYS if name == "ptbxl_af" else MULTI_REPORT_KEYS
    out_dir = os.path.join(t.output_dir, name)
    for tag in ("best", "last"):
        if not keys <= set(reports[tag]):
            raise AssertionError(f"{name} [{tag}] lacks "
                                 f"{keys - set(reports[tag])}")
        if not os.path.isfile(os.path.join(out_dir, f"report_{tag}.txt")):
            raise AssertionError(f"{name}: report_{tag}.txt missing")
    # best and last restore into a fresh state; `run` leaves `last` in
    # result.state
    ckpt = CheckpointManager(run_dir)
    for tag, epoch in (("best", result.best_epoch + 1), ("last", epochs)):
        model, task = train_run.build_model_and_task(cfg, "cuda")
        st = ckpt.restore(tag, create_state(model, t, nb["train"]))
        if st.epoch != epoch:
            raise AssertionError(f"{name} {tag}: epoch {st.epoch} != {epoch}")
        ev = engine.evaluate(task, st, data.test, t.batch_size)
        if not np.all(np.isfinite(ev.logits)):
            raise AssertionError(f"{name} {tag}: non-finite test logits")
        if tag == "last":
            live = result.state.model.state_dict()
            for k, v in model.state_dict().items():
                if not torch.equal(v, live[k]):
                    raise AssertionError(f"{name} last: {k} differs")
    return result, launches


def measure_train_step(n: int = 30):
    """Phase 7: steady-state ptbxl_af train steps at full width on the
    card (TF32 defaults, dropout 0.3): per-step CUDA-event spans, host
    wall time, and the device's busy share under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    cfg = get_preset("ptbxl_af")
    t = cfg.train
    data = train_run.load_data(cfg, 256, device="cuda")
    model, task = train_run.build_model_and_task(cfg, "cuda")
    idx, mask = engine.epoch_indices(data.train.n, t.batch_size,
                                     shuffle=True, seed=t.seed, epoch=0)
    state = create_state(model, t, idx.shape[0])
    idx_d = torch.from_numpy(idx.astype(np.int64)).cuda()
    mask_d = torch.from_numpy(mask).cuda()
    full = idx.shape[0] - 1  # the full batches; the last one is padded

    def step(i):
        return engine.train_step(task, state, engine.gather_batch(
            data.train, idx_d[i % full], mask_d[i % full]))

    for i in range(5):
        step(i)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(n):
        step(i)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    spans = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    out = {"steps": n, "batch": t.batch_size,
           "median_ms": statistics.median(spans),
           "p90_ms": float(np.percentile(spans, 90)),
           "wall_ms_per_step": wall_ms,
           "samples_per_s": t.batch_size * 1e3 / wall_ms}

    k = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(k):
            step(i)
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    # a user annotation (`Optimizer.step#Adam.step`) spans the kernels it
    # encloses on the device timeline: counting it would count them twice
    averages = prof.key_averages()
    dev_events = [e for e in averages
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    if busy_ms == 0.0:
        out["busy_share"] = "not measured (the profiler saw no device time)"
    else:
        out.update(busy_ms_per_step=busy_ms / k,
                   device_ops_per_step=sum(e.count for e in dev_events) // k,
                   profiled_step_ms=span_ms / k,
                   busy_share=busy_ms / span_ms,
                   busy_share_of_unprofiled=busy_ms / k / wall_ms)
        top = sorted(dev_events, key=lambda e: -e.self_device_time_total)
        out["top"] = [(e.key[:80], e.self_device_time_total / 1e3 / k,
                       e.count // k) for e in top[:8]]
    host = sorted((e for e in averages
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    out["host_ops_per_step"] = sum(e.count for e in host) // k
    out["host_top"] = [(e.key[:60], e.self_cpu_time_total / 1e3 / k,
                        e.count // k) for e in host[:10]]
    return out


def summarize(name, source, replaces, launches_by_path, rows, picked, per,
              bound_by="bytes"):
    """One kernel's entry of the `kernels` line: the times are the sum
    over the calls that `per` names (the `picked` rows); `launches` is the
    sum over the main paths this script drove."""
    lib = [r["library_us"] for r in picked]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": sum(launches_by_path.values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r.get("dtype", "float32") == "float32"),
        "ms": sum(r["us"] for r in picked) / 1e3,
        "plain_ms": sum(r["plain_us"] for r in picked) / 1e3,
        "bound_ms": sum(r["bound_us"] for r in picked) / 1e3,
        "bound_by": bound_by,
        "library_ms": None if None in lib else sum(lib) / 1e3,
        "per": per,
        "launches_by_path": launches_by_path,
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
    print("fused_focal_loss has no single PyTorch call computing the same "
          "function (library_ms null)", flush=True)
    focal_rows = check_focal(gen, peaks)
    se_train_rows = check_se_train(gen, peaks)

    # 4. the slice
    launches, timings = run_slice()

    # 5. numbers
    for key in ("total_ms", "host_before_ms", "device_ms", "host_after_ms"):
        vals = sorted(t[key] for t in timings)
        print(f"request {key}: median {statistics.median(vals):.3f} p90 "
              f"{float(np.percentile(vals, 90)):.3f} ({smi})", flush=True)

    # 6. the training slice: first the algorithm against the CPU in
    # float32 (TF32 off), then the runs with the defaults a user gets
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    compare_train_steps()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    with tempfile.TemporaryDirectory() as tmp:
        ptbxl, ptbxl_launches = run_training(tmp, "ptbxl_af", 256, 2)
        _, multi_launches = run_training(tmp, "physionet_multi", 96, 1)

    # 7. numbers
    for h in ptbxl.history:
        print(f"ptbxl_af epoch {h['epoch'] + 1} time "
              f"{h['Time/Epoch'] * 1e3:.3f} ms (train + val, n_synth 256; "
              f"{smi})", flush=True)
    step = measure_train_step()
    print(f"ptbxl_af train step ({smi}): {json.dumps(step)}", flush=True)
    paths = {
        "serve": launches,
        "train_ptbxl_af": ptbxl_launches,
        "train_physionet_multi": multi_launches,
    }

    def by_path(kernel):
        return {p: n[kernel] for p, n in paths.items() if n.get(kernel)}

    focal_picked = [r for r in focal_rows
                    if (r["B"], r["C"]) == (TRAIN_B, 2) and "us" in r]
    kernels = [
        summarize("fused_se", "ecgmm_torch/ops/csrc/se.cu",
                  "ecgmm_tpu/ops/pallas_se.py:85", by_path("fused_se"),
                  se_rows + se_train_rows,
                  [r for r in se_train_rows if r["B"] == TRAIN_B],
                  "ptbxl_af train step: 3 forward calls at B=16"),
        summarize("fused_attention_fusion", "ecgmm_torch/ops/csrc/fusion.cu",
                  "ecgmm_tpu/ops/pallas_fusion.py:98",
                  by_path("fused_attention_fusion"), fusion_rows,
                  [r for r in fusion_rows
                   if r["D"] == 672 and r["B"] in (1, 8, 32)],
                  "serving request: B=1, 32 and 8 at D=672"),
        summarize("fused_focal_loss", "ecgmm_torch/ops/csrc/focal.cu",
                  "ecgmm_tpu/ops/pallas_losses.py:66",
                  by_path("fused_focal_loss"), focal_rows, focal_picked,
                  "ptbxl_af train step: 1 call at (16, 2)",
                  bound_by=focal_picked[0]["bound_by"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
