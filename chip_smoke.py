#!/usr/bin/env python3
"""Drive the PyTorch port (`ecgmm_torch`) on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failed check:
  1. device: the card's name and power limit; compute capability 9.0;
  2. build: compile the CUDA kernels from `ecgmm_torch/ops/csrc/`;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the serving and training shapes (the signal_only stage's B=8
     among them): values, and the gradients of the
     SE, fusion and focal backward kernels against autograd and their
     closed forms, within the stated bars, with bit-identical relaunches;
     a profiled focal backward of a train step runs one device kernel;
     plus per-shape device times of forward, backward and both, beside
     the parent's path (kernel forward, plain backward) and the bounds,
     the focal forward's cluster sweep, and the SE forward alone in bf16
     (the frozen signal encoder's form) at the fusion presets' B=16 and
     bench.py's B=256;
  4. the slice: `ServingPipeline.demo(device="cuda")` (full-width
     canonical model, 224x224 images, 2476-sample signals, seeded random
     weights) answers 8 requests with the full ResultScreen contract, the
     kernels' launch counters (forward and backward) prove the requests
     ran through them, and 2 requests match the same pipeline on the CPU;
  5. numbers: request latency;
  6. the training slices: 3 full-width `ptbxl_af` train steps from one
     initial state on the card and on the CPU agree (loss, gradients,
     parameters, BatchNorm buffers), and the same first step with TF32 on
     falls outside the gradient bar; 3 full-width `fusion` train steps
     (f32, frozen encoders in train mode, the third batch padded) agree
     on the card and the CPU (loss, gradients, trainable parameters, the
     encoders' BatchNorm statistics, frozen weights bit-equal), with 3 SE
     forwards, no SE backward and one fusion forward and backward a step;
     so do 3 full-width `image_only` steps (ResNet-18's backward), 3
     clinical-probe steps (TabNet's backward) and the cached path
     (`calibrate_bn_stats` buffers, `encode_raw` of the train split, 3
     head steps, frozen weights bit-equal), all in float32 with TF32 off
     as `run()` sets it; so do 3 full-width steps of
     `physionet_transformer` (B=8, T=3000), `physionet_crnn` (B=16) and
     `signal_12lead` (B=8), whose first step with TF32 on is read too (the
     Transformer's must fall outside the float32 bar), and the CRNN's
     LSTM alone with cuDNN's TF32 off and on; `run()` trains `ptbxl_af`
     (2 epochs, 256 synthetic records), `physionet_multi` (1 epoch, 96
     records), `fusion` (bf16, 2 epochs, 256 records; its train loss must
     fall),
     `fusion_modal_balance` (1 epoch, 96 records), `fusion_cached` (bf16,
     2 epochs, 256 records; its train loss must fall), `image_only` and
     `signal_only`, `signal_arr`, `signal_12lead`, `physionet_crnn` and
     `physionet_transformer` (1 epoch, 96 records) and `signal_af` (1
     epoch, 60 records: no val split) on the card through the kernels,
     checkpoints restore, the best/last test reports and the logged
     scalars (`VarLoss/Val`, `AttentionWeights/*` for fusion) have their
     keys, and the launch counters equal the batch plan; `run_pipeline`
     (one epoch a stage, 96 records, cached) warm-starts stage 4 from
     each stage's best under the three filters, and its launches equal
     each stage's plan;
  7. numbers: train-step times (CUDA events) of `ptbxl_af` at B=16,
     `fusion` and `fusion_cached` (head steps, after a timed calibration
     and encoding of the train split) at B=16 and 256, `image_only` at
     B=16, `ptbxl_af` and `image_only` also with cuDNN's TF32 on,
     `physionet_transformer` at B=8 and `physionet_crnn` at B=16,
     samples/s, peak device memory, epoch time, the device's busy share
     and the top host ops (torch.profiler), and one `kernels` JSON line
     whose `launches_by_path` names every path driven.

The last line of standard output is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
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
from ecgmm_torch.models import (  # noqa: E402
    CRNN, ECGMultimodalModel, TabNetEncoder)
from ecgmm_torch.models.crnn import GemmConv2d  # noqa: E402
from ecgmm_torch.models.layers import Dropout, flax_init_  # noqa: E402
from ecgmm_torch.ops import _ext, fusion, se  # noqa: E402
from ecgmm_torch.ops import losses as focal  # noqa: E402
from ecgmm_torch.serve.pipeline import ServingPipeline  # noqa: E402
from ecgmm_torch.tools import grad_precision as gp  # noqa: E402
from ecgmm_torch.tools.kernel_times import device_us, host_us  # noqa: E402
from ecgmm_torch.train import embed, engine  # noqa: E402
from ecgmm_torch.train.checkpoint import CheckpointManager  # noqa: E402
from ecgmm_torch.train.optim import Optimizer  # noqa: E402
from ecgmm_torch.train.state import create_state  # noqa: E402
from ecgmm_torch.workloads import pretrain  # noqa: E402
from ecgmm_torch.workloads import run as train_run  # noqa: E402
from ecgmm_torch.workloads.tasks import (  # noqa: E402
    make_clinical_task, make_fusion_head_task)

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
SIGNAL_ONLY_B = 8  # the signal_only preset's batch (pretraining stage 2)
# (B, T, C) of the SE blocks on the training paths: ptbxl_af (signal
# 2476, B=16), physionet_multi (signal 3000, B=8) and signal_only (signal
# 2476, B=8)
SE_TRAIN_SHAPES = ([(TRAIN_B, t, c) for t, c in SE_SHAPES]
                   + [(8, 750, 64), (8, 375, 128), (8, 188, 256)]
                   + [(SIGNAL_ONLY_B, t, c) for t, c in SE_SHAPES])
# (B, C): ptbxl_af, physionet_multi, the widest class count, a large
# batch, signal_only
FOCAL_SHAPES = [(16, 2), (8, 3), (13, 4), (65536, 2), (SIGNAL_ONLY_B, 2)]
FOCAL_MASKS = ("ones", "some_zero", "all_zero", "single")
FUSION_B = 16  # the fusion presets' batch
BENCH_B = 256  # bench.py's flagship batch, where TabNet's ghost BN splits
FUSION_REPORT_KEYS = {"accuracy", "f1", "auroc", "temperature", "test_ece",
                      "test_ece_calibrated"}
REPORT_KEYS = {
    "ptbxl_af": FUSION_REPORT_KEYS | {"threshold"},
    "physionet_multi": {"accuracy", "f1_macro", "auroc_ovr", "temperature",
                        "test_ece", "test_ece_calibrated"},
    "fusion": FUSION_REPORT_KEYS,
    "fusion_modal_balance": FUSION_REPORT_KEYS,
    "fusion_cached": FUSION_REPORT_KEYS,
    "image_only": FUSION_REPORT_KEYS,
    "signal_only": FUSION_REPORT_KEYS | {"threshold"},
    "signal_arr": FUSION_REPORT_KEYS | {"threshold"},
    "signal_12lead": FUSION_REPORT_KEYS | {"threshold"},
    "physionet_crnn": FUSION_REPORT_KEYS | {"threshold"},
    "physionet_transformer": FUSION_REPORT_KEYS | {"threshold"},
    # 60 records: no val split, so no temperature and no ECE
    "signal_af": {"threshold", "accuracy", "f1", "auroc"},
}
# the signal presets whose models hold no SE block
NO_SE = ("physionet_crnn", "physionet_transformer")
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


SE_GRADS = ("x", "w1", "b1", "w2", "b2")


def se_row(gen, b, t, c, dtype, peaks, backward=True):
    """fused_se at one shape on the card against the plain versions: the
    output against `reference_se` (f32: 1e-5; bf16: atol and rtol 5e-2),
    and, with `backward`, each gradient through the kernels for a random
    cotangent against autograd of `reference_se` in f32
    (`reference_backward`) and against the closed form
    (`reference_se_backward`), within 1e-5 (bf16: 5e-2) of the
    reference's largest component plus 1e-6, and three more launches of
    the backward bit-identical to the one autograd ran (both sums over
    the batch go in a fixed order). Returns the row with the cluster
    sizes, the load path and the device times: forward (`us`) and, with
    `backward`, backward kernels alone (`bwd_us`), forward plus backward
    under autograd through the kernels (`fwd_bwd_us`), through the plain
    op (`plain_fwd_bwd_us`) and through the parent's path, the kernel
    forward with the plain backward (`parent_fwd_bwd_us`). Without
    `backward` it is the forward-only form a frozen encoder runs."""
    bw, flops = peaks
    f32 = dtype == torch.float32
    r = max(1, c // 16)
    x = torch.randn(b, c, t, generator=gen).to("cuda", dtype)
    ws = [(torch.randn(*s, generator=gen) * 0.1).to("cuda", dtype)
          for s in ((r, c), (r,), (c, r), (c,))]
    g = torch.randn(b, c, t, generator=gen).to("cuda", dtype)
    ins = [x] + ws

    def fwd_bwd(fn, leaves):
        out = fn(*leaves)
        return out, torch.autograd.grad(out, leaves, g)

    where = f"fused_se {str(dtype)[6:]} B={b} T={t} C={c}"
    if backward:
        leaves = [a.clone().requires_grad_(True) for a in ins]
        ref_leaves = [a.clone().requires_grad_(True) for a in ins]
        out, g_kernel = fwd_bwd(se.fused_se, leaves)
    else:
        where += " forward only"
        out = se.fused_se(*ins)
    ref = se.reference_se(*ins)
    torch.cuda.synchronize()
    if out.dtype != dtype:
        raise AssertionError(f"{where}: returned {out.dtype}")
    err = (out.float() - ref.float()).abs().max().item()
    if (err > 1e-5) if f32 else not torch.allclose(
            out.float(), ref.float(), atol=0.05, rtol=0.05):
        raise AssertionError(f"{where}: max err {err}")

    esize = x.element_size()
    n = x.numel()
    w_bytes = sum(w.numel() for w in ws) * esize
    state_bytes = 2 * b * c * 4  # the f32 means and gate
    # forward: read x and the weights, write out and the state; backward:
    # read x, g, w1, b1, w2 and the state, write dx and the weight
    # gradients
    fwd_bytes = 2 * n * esize + w_bytes + state_bytes
    fwd_ops = 2 * n + 4 * b * c * r
    k_fwd = se.cluster_size(b, c, t, r, esize)
    row = {
        "B": b, "T": t, "C": c, "dtype": str(dtype)[6:], "k_fwd": k_fwd,
        "loads_fwd": "16-byte" if se.vector_loads(
            c, t, k_fwd, esize, x.data_ptr()) else "element",
        "max_abs_err": err,
        "us": device_us(lambda: se.fused_se(*ins)),
        "plain_us": device_us(lambda: se.reference_se(*ins)),
        "bound_us": max(fwd_bytes / bw, fwd_ops / flops) * 1e6,
        "bound_by": "bytes" if fwd_bytes / bw >= fwd_ops / flops
        else "operations",
        "library_us": None,
    }
    if b <= TRAIN_B:  # the main paths' batches: device work < launches
        row["host_us"] = host_us(lambda: se.fused_se(*ins))
    if not backward:
        print(f"{where} {row}", flush=True)
        return row

    g_auto = se.reference_backward([a.float() for a in ins], g.float())
    g_closed = se.reference_se_backward(ins, g)
    _, state = se._launch(*ins)

    def launch_bwd():
        return se.launch_backward(x, ws[0], ws[1], ws[2], state, g)

    repeats = [launch_bwd() for _ in range(3)]
    torch.cuda.synchronize()
    bar = 1e-5 if f32 else 5e-2
    grad_rel = {}
    for name, got, auto, closed in zip(SE_GRADS, g_kernel, g_auto,
                                       g_closed):
        for kind, want in (("autograd", auto), ("closed", closed)):
            scale = want.float().abs().max().item()
            gerr = (got.float() - want.float()).abs().max().item()
            grad_rel[f"{name}_{kind}"] = gerr / max(scale, 1e-30)
            if gerr > bar * scale + 1e-6:
                raise AssertionError(
                    f"{where}: grad {name} vs {kind} err {gerr} (largest "
                    f"component {scale})")
    if not all(torch.equal(a, w) for rep in repeats
               for a, w in zip(rep, g_kernel)):
        raise AssertionError(f"{where}: repeated backward launches differ")
    bwd_bytes = 3 * n * esize + (2 * r * c + r) * esize + state_bytes \
        + w_bytes
    bwd_ops = 4 * n + 8 * b * c * r
    k_bwd = se.cluster_size(b, c, t, r, esize, backward=True)
    row.update({
        "k_bwd": k_bwd,
        "loads_bwd": "16-byte" if se.vector_loads(
            c, t, k_bwd, esize, x.data_ptr(), g.data_ptr()) else "element",
        "grad_err_rel": grad_rel,
        "bwd_us": device_us(launch_bwd),
        "fwd_bwd_us": device_us(lambda: fwd_bwd(se.fused_se, leaves)),
        "plain_fwd_bwd_us": device_us(
            lambda: fwd_bwd(se.reference_se, ref_leaves)),
        "parent_fwd_bwd_us": device_us(
            lambda: (se.fused_se(*ins), se.reference_backward(ins, g))),
        "bwd_bound_us": max(bwd_bytes / bw, bwd_ops / flops) * 1e6,
    })
    row["fwd_bwd_bound_us"] = row["bound_us"] + row["bwd_bound_us"]
    if b <= TRAIN_B:
        row.update(
            bwd_host_us=host_us(launch_bwd),
            fwd_bwd_host_us=host_us(lambda: fwd_bwd(se.fused_se, leaves)),
            parent_fwd_bwd_host_us=host_us(
                lambda: (se.fused_se(*ins), se.reference_backward(ins, g))))
    print(f"{where} {row}", flush=True)
    return row


def check_se(gen, peaks):
    """fused_se at the serving shapes (B=1), a large batch (B=256) and the
    edge shape (odd T, R=1), in f32 and bf16 (`se_row`)."""
    return [se_row(gen, b, t, c, dtype, peaks)
            for dtype in (torch.float32, torch.bfloat16) for b in (1, 256)
            for t, c in SE_SHAPES + SE_EDGE_SHAPES]


def check_fusion(gen, peaks):
    """fused_attention_fusion vs the plain version on the card: values,
    soft weights (to the bit), the forward's (mu, rstd) residual against
    `reference_fusion_stats` (atol 1e-6 + rtol 1e-5), three more forward
    launches bit-identical, and the gradients of sum(out**2) w.r.t. all
    six inputs (through the backward kernels) against plain autograd."""
    bw, flops = peaks
    rows = []
    eps = 1e-5
    for b in (1, 8, 16, 32, 256):
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
            _, _, stats = fusion._launch(*fusion._prepare(*ins), eps,
                                         keep_stats=True)
            want_stats = fusion.reference_fusion_stats(*ins[:4], eps)
            repeats = [fusion.fused_attention_fusion(*ins, eps=eps)
                       for _ in range(3)]
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            sw_err = (sw - ref_sw).abs().max().item()
            stats_diff = (stats - want_stats).abs()
            stats_err = stats_diff.max().item()
            if err > 1e-5 or sw_err != 0.0 or (
                    stats_diff > 1e-6 + 1e-5 * want_stats.abs()).any():
                raise AssertionError(
                    f"fusion B={b} D={d}: value err {err}, sw err {sw_err}, "
                    f"(mu, rstd) err {stats_err}")
            if not all(torch.equal(o, out) and torch.equal(w, sw)
                       for o, w in repeats):
                raise AssertionError(
                    f"fusion B={b} D={d}: repeated launches differ")
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
                    "stats_err": stats_err,
                    "layout": fusion.layout(b, dims),
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


FUSION_GRADS = ("img", "sig", "clin", "weights", "scale", "bias")
FROZEN = (True, True, True, False, False, False)
ALL6 = (True,) * 6
# (B, dims, kind, inputs that need a gradient): the serving request's SHAP
# (B=32, the three embeddings) and IG (B=8, the clinical one) at D=672,
# and every input, as a fusion head in training needs: both serving
# batches, the fusion preset's B=16 and bench.py's B=256, at D=672 and
# (B=16 and 256) at the modal-balance D=768
FUSION_BWD_CASES = [
    (32, FUSION_DIMS[0], "shap", FROZEN), (32, FUSION_DIMS[0], "all", ALL6),
    (8, FUSION_DIMS[0], "ig", (False, False, True, False, False, False)),
    (8, FUSION_DIMS[0], "all", ALL6),
] + [(b, dims, "all", ALL6) for dims in FUSION_DIMS for b in (16, 256)]


def check_fusion_backward(gen, peaks):
    """fused_attention_fusion's backward kernels at FUSION_BWD_CASES:
    the gradients of the inputs that need one, for random
    cotangents on the output and (where `weights` needs a gradient) the
    soft weights, against autograd of the plain version and the closed
    form (rtol 1e-5 / atol 1e-4; `weights` against its largest
    component, ROADMAP.md section 3); three more launches bit-identical;
    device times of the backward alone, of forward plus backward under
    autograd through the kernels, the plain op and the parent's path
    (kernel forward, plain backward of all six inputs), and of
    `native_layer_norm_backward` as the library yardstick (it leaves out
    the soft weights and the concatenation)."""
    bw, flops = peaks
    rows = []
    eps = 1e-5
    for b, dims, kind, needs in FUSION_BWD_CASES:
        d = sum(dims)
        ins = [torch.randn(b, w, generator=gen) for w in dims] + [
            torch.randn(3, generator=gen),
            torch.randn(d, generator=gen) + 1,
            torch.randn(d, generator=gen)]
        ins = [a.cuda() for a in ins]
        go = torch.randn(b, d, generator=gen).cuda()
        gsw = torch.randn(3, generator=gen).cuda() if needs[3] else None

        def fwd_bwd(fn, leaves):
            out, sw = fn(*leaves, eps=eps)
            outs, cots = [out], [go]
            if gsw is not None:
                outs.append(sw)
                cots.append(gsw)
            return torch.autograd.grad(
                outs, [a for a in leaves if a.requires_grad], cots)

        leaves = [a.clone().requires_grad_(n) for a, n in zip(ins, needs)]
        ref_leaves = [a.clone().requires_grad_(n)
                      for a, n in zip(ins, needs)]
        g_kernel = fwd_bwd(fusion.fused_attention_fusion, leaves)
        g_auto = [a for a, n in zip(
            fusion.reference_backward(ins, eps, go, gsw), needs) if n]
        g_closed = [a for a in fusion.reference_fusion_backward(
            ins, eps, go, gsw, needs) if a is not None]
        prepared = fusion._prepare(*ins)
        _, _, stats = fusion._launch(*prepared, eps, keep_stats=True)

        def backward():
            return fusion.launch_backward(prepared, stats, go, gsw, needs)

        repeats = [[a for a in backward() if a is not None]
                   for _ in range(3)]
        torch.cuda.synchronize()
        names = [nm for nm, n in zip(FUSION_GRADS, needs) if n]
        where = f"fusion backward B={b} D={d} {kind}"
        errs = {}
        for name, got, auto, closed in zip(names, g_kernel, g_auto,
                                           g_closed):
            for ref_kind, want in (("autograd", auto), ("closed", closed)):
                ref_scale = want.abs().max() if name == "weights" \
                    else want.abs()
                diff = (got - want).abs()
                errs[f"{name}_{ref_kind}"] = diff.max().item()
                if (diff > 1e-4 + 1e-5 * ref_scale).any():
                    raise AssertionError(
                        f"{where}: grad {name} vs {ref_kind} max err "
                        f"{diff.max().item()}")
        if not all(torch.equal(a, w) for rep in repeats
                   for a, w in zip(rep, g_kernel)):
            raise AssertionError(f"{where}: repeated launches differ")
        # forward: read the three inputs, logits, scale and bias, write
        # out and sw; backward: read the three inputs, logits, scale and
        # the output cotangent, write the input gradients, and where a
        # parameter needs one read gsw and write dweights, dscale, dbias
        fwd_bytes = 4 * (2 * b * d + 2 * d + 6)
        bwd_bytes = 4 * (2 * b * d + d + 3 + sum(
            b * w for w, n in zip(dims, needs) if n))
        if any(needs[3:]):
            bwd_bytes += 4 * (3 + 3 + 2 * d)
        fwd_ops, bwd_ops = 9 * b * d, 16 * b * d
        with torch.no_grad():
            sw_ref = torch.softmax(ins[3], 0)
            fused = torch.cat([sw_ref[i] * ins[i] for i in range(3)], -1)
            _, mean, rstd = torch.ops.aten.native_layer_norm(
                fused, [d], ins[4], ins[5], eps)
        mask = [True, needs[4], needs[5]]
        row = {
            "B": b, "D": d, "needs": kind, "grad_err": errs,
            "layout": fusion.layout(b, dims, backward=True),
            "param_groups": fusion.param_groups(b) if any(needs[3:]) else 0,
            "bwd_us": device_us(backward),
            "fwd_bwd_us": device_us(
                lambda: fwd_bwd(fusion.fused_attention_fusion, leaves)),
            "plain_fwd_bwd_us": device_us(
                lambda: fwd_bwd(fusion.reference_attention_fusion,
                                ref_leaves)),
            "parent_fwd_bwd_us": device_us(lambda: (
                fusion.fused_attention_fusion(*ins, eps=eps),
                fusion.reference_backward(ins, eps, go, gsw))),
            "library_bwd_us": device_us(
                lambda: torch.ops.aten.native_layer_norm_backward(
                    go, fused, [d], mean, rstd, ins[4], ins[5], mask)),
            "bwd_bound_us": max(bwd_bytes / bw, bwd_ops / flops) * 1e6,
            "fwd_bwd_bound_us": (max(fwd_bytes / bw, fwd_ops / flops)
                                 + max(bwd_bytes / bw, bwd_ops / flops))
            * 1e6,
            "bwd_host_us": host_us(backward),
            "fwd_bwd_host_us": host_us(
                lambda: fwd_bwd(fusion.fused_attention_fusion, leaves)),
            "parent_fwd_bwd_host_us": host_us(lambda: (
                fusion.fused_attention_fusion(*ins, eps=eps),
                fusion.reference_backward(ins, eps, go, gsw))),
        }
        rows.append(row)
        print(f"{where} {row}", flush=True)
    return rows


def fusion_layout_sweep(gen):
    """The forward and the rows backward (SHAP's needs) at D=672 with W =
    1, 2, 3 and 6 warps per row (`_launch`'s and `launch_backward`'s
    override), beside the W that `warps_per_row` picks: the measurement
    behind SLOTS_PER_WARP. Each W is held to the plain version first (value
    atol 1e-5, gradients rtol 1e-5 / atol 1e-4)."""
    eps = 1e-5
    dims = FUSION_DIMS[0]
    d = sum(dims)
    sweep = []
    for b in (1, 8, 32, 256, 1024, 4096):
        ins = [torch.randn(b, w, generator=gen) for w in dims] + [
            torch.randn(3, generator=gen), torch.randn(d, generator=gen) + 1,
            torch.randn(d, generator=gen)]
        ins = fusion._prepare(*(a.cuda() for a in ins))
        go = torch.randn(b, d, generator=gen).cuda()
        ref, _ = fusion.reference_attention_fusion(*ins, eps=eps)
        want = fusion.reference_fusion_backward(ins, eps, go, None, FROZEN)
        fwd, bwd = {}, {}
        for w in (1, 2, 3, 6):
            out, _, stats = fusion._launch(*ins, eps, keep_stats=True,
                                           warps=w)
            got = fusion.launch_backward(ins, stats, go, None, FROZEN,
                                         warps=w)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            if err > 1e-5 or any(
                    ((g - r).abs() > 1e-4 + 1e-5 * r.abs()).any()
                    for g, r in zip(got[:3], want[:3])):
                raise AssertionError(f"fusion B={b} W={w}: value err {err} "
                                     "or a gradient off the plain version")
            fwd[w] = device_us(lambda: fusion._launch(*ins, eps, warps=w))
            bwd[w] = device_us(lambda: fusion.launch_backward(
                ins, stats, go, None, FROZEN, warps=w))
        sweep.append({"B": b, "D": d, "picked": fusion.warps_per_row(b, dims),
                      "fwd_us_by_w": fwd, "bwd_us_by_w": bwd})
        print(f"fusion layout sweep {sweep[-1]}", flush=True)
    return sweep


def _focal_mask(kind: str, b: int, gen) -> torch.Tensor:
    if kind == "ones":
        return torch.ones(b)
    if kind == "all_zero":
        return torch.zeros(b)
    if kind == "single":  # sum(mask) = 1: max(sum(mask), 1) ties
        return (torch.arange(b) == b // 2).float()
    mask = (torch.rand(b, generator=gen) < 0.7).float()
    mask[-1] = 0.0
    return mask


def _focal_backward_check(where, inputs):
    """The backward kernel alone, for a cotangent other than 1 and each
    gamma of the tests: (dlogits, dmask) against the closed form
    (`reference_focal_backward`) and autograd of `reference_focal`, atol
    1e-5; dmask left out (None) where the mask needs no gradient; three
    more launches bit-identical. Returns the worst error."""
    worst = 0.0
    cot = torch.tensor(-1.3, device="cuda")
    for gamma in (0.0, 1.5, 2.0):
        alpha = 0.7
        _, res_g = focal._launch(*inputs, alpha, gamma)
        auto = focal.reference_backward(inputs, alpha, gamma, cot)
        for needs in ((True, True), (True, False)):
            got = focal.launch_backward(inputs, res_g, alpha, gamma, cot,
                                        needs)
            closed = focal.reference_focal_backward(inputs, alpha, gamma,
                                                    cot, needs)
            repeats = [focal.launch_backward(inputs, res_g, alpha, gamma,
                                             cot, needs) for _ in range(3)]
            torch.cuda.synchronize()
            if not needs[1] and got[1] is not None:
                raise AssertionError(f"{where}: dmask written unasked")
            for k, need in enumerate(needs):
                if not need:
                    continue
                for kind, want in (("closed", closed[k]),
                                   ("autograd", auto[k])):
                    err = (got[k] - want).abs().max().item()
                    worst = max(worst, err)
                    if err > 1e-5:
                        raise AssertionError(
                            f"{where} gamma={gamma} needs={needs}: "
                            f"{('dlogits', 'dmask')[k]} vs {kind} err {err}")
                if not all(torch.equal(r[k], got[k]) for r in repeats):
                    raise AssertionError(
                        f"{where}: repeated backward launches differ")
    return worst


def focal_profiled_backward(gen):
    """The training path's backward (dlogits only, the cotangent given)
    under torch.profiler: it must run exactly one device kernel, the
    CUDA backward, and no op of `reference_focal`."""
    from torch.profiler import ProfilerActivity, profile

    b, c = TRAIN_B, 2
    logits = (torch.randn(b, c, generator=gen) * 2).cuda().requires_grad_()
    labels = torch.randint(0, c, (b,), generator=gen).cuda()
    mask = _focal_mask("some_zero", b, gen).cuda()
    out = focal.fused_focal_loss(logits, labels, mask)
    one = torch.ones((), device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(out, logits, one)
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               for _ in range(e.count)
               if e.device_type == torch.autograd.DeviceType.CUDA]
    host_ops = sorted({e.key for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CPU
                       and e.key.startswith("aten::")})
    print(f"focal training-path backward, profiled: device kernels "
          f"{kernels}; host aten ops {host_ops}", flush=True)
    if len(kernels) != 1 or "focal_bwd" not in kernels[0]:
        raise AssertionError(f"focal backward ran {kernels}, not one kernel")
    plain = {"aten::logsumexp", "aten::gather", "aten::pow", "aten::exp",
             "aten::softmax", "aten::_softmax"}
    if plain & set(host_ops):
        raise AssertionError(f"focal backward ran plain ops {host_ops}")
    return kernels


def focal_cluster_sweep(gen):
    """The forward at C=2 and B from 512 to 65536 on K = 1..16 blocks
    (`_launch`'s override), beside the K that `cluster_size` picks: the
    measurement behind BLOCK_ELEMS."""
    sweep = []
    for b in (512, 1024, 2048, 4096, 16384, 65536):
        logits = torch.randn(b, 2, generator=gen).cuda()
        labels = torch.randint(0, 2, (b,), generator=gen).cuda()
        mask = torch.ones(b, device="cuda")
        times = {k: device_us(lambda: focal._launch(
            logits, labels, mask, 1.0, 2.0, k=k)) for k in (1, 2, 4, 8, 16)}
        sweep.append({"B": b, "C": 2, "picked": focal.cluster_size(b, 2),
                      "us_by_k": times})
        print(f"focal forward cluster sweep {sweep[-1]}", flush=True)
    return sweep


def check_focal(gen, peaks):
    """fused_focal_loss vs reference_focal on the card at every
    FOCAL_SHAPES entry, with masks of ones, with zeros, all zero and a
    single one, and int64 or int32 labels: the value within rtol 1e-5,
    dlogits and dmask through autograd within atol 1e-5 of autograd of
    `reference_focal` and of the closed form (the bars of
    tests/test_pallas_ops.py), the backward kernel alone at three gammas
    (`_focal_backward_check`), and three more forward launches
    bit-identical to the first (the in-kernel reduction is in a fixed
    order). Timed where the mask has zeros: forward, backward kernel
    alone, forward plus backward through autograd w.r.t. logits and mask
    (`fwd_bwd_us`, its meaning unchanged) and w.r.t. the logits only as a train
    step takes it (`train_fwd_bwd_us`), the plain op, and the parent's
    path (kernel forward, plain autograd backward)."""
    bw, flops = peaks
    rows = []
    one = torch.ones((), device="cuda")
    for b, c in FOCAL_SHAPES:
        for kind in FOCAL_MASKS:
            ldtype = (torch.int32 if kind in ("some_zero", "single")
                      else torch.int64)
            logits = (torch.randn(b, c, generator=gen) * 2).cuda()
            labels = torch.randint(0, c, (b,), generator=gen).to("cuda",
                                                                 ldtype)
            mask = _focal_mask(kind, b, gen).cuda()
            inputs = (logits, labels, mask)

            def fwd_bwd(fn, lg, mk):
                out = fn(lg, labels, mk)
                return out, torch.autograd.grad(
                    out, [a for a in (lg, mk) if a.requires_grad])

            leaves = [logits.clone().requires_grad_(True),
                      mask.clone().requires_grad_(True)]
            out, g_kernel = fwd_bwd(focal.fused_focal_loss, *leaves)
            ref_leaves = [logits.clone().requires_grad_(True),
                          mask.clone().requires_grad_(True)]
            ref, g_ref = fwd_bwd(focal.reference_focal, *ref_leaves)
            g_closed = focal.reference_focal_backward(inputs, 1.0, 2.0, one)
            repeats = [focal.fused_focal_loss(*inputs) for _ in range(3)]
            torch.cuda.synchronize()
            where = f"fused_focal_loss B={b} C={c} {kind}"
            err = abs(out.item() - ref.item())
            if err > 1e-5 * abs(ref.item()):
                raise AssertionError(
                    f"{where}: value {out.item()} vs {ref.item()}")
            grad_err = max((a - r).abs().max().item()
                           for want in (g_ref, g_closed)
                           for a, r in zip(g_kernel, want))
            if grad_err > 1e-5:
                raise AssertionError(f"{where}: grad err {grad_err}")
            if not all(torch.equal(r, out.detach()) for r in repeats):
                raise AssertionError(f"{where}: repeated launches differ")
            bwd_err = _focal_backward_check(where, inputs)
            row = {"B": b, "C": c, "mask": kind, "labels": str(ldtype)[6:],
                   "k_fwd": focal.cluster_size(b, c),
                   "blocks_bwd": focal.backward_blocks(b),
                   "max_abs_err": err, "grad_err": grad_err,
                   "bwd_kernel_err": bwd_err}
            if kind == "some_zero":
                # each input read once, the 0-d result written once; per
                # row 4C + 10 f32 operations (max, shift, exp, sum, log,
                # ce, pt, pow, products and the two sums)
                nbytes = (4 * b * c + labels.element_size() * b + 4 * b
                          + 4)
                nops = b * (4 * c + 10) + 2
                # backward: read logits, labels, mask, the residual and the
                # 0-d cotangent, write dlogits and dmask; per row 6C + 12
                # operations (softmax, the focal term's derivative)
                bwd_bytes = (8 * b * c + labels.element_size() * b + 8 * b
                             + 12)
                bwd_ops = b * (6 * c + 12)
                train_leaf = logits.clone().requires_grad_(True)
                _, res = focal._launch(*inputs, 1.0, 2.0)

                def backward():
                    return focal.launch_backward(inputs, res, 1.0, 2.0, one,
                                                 (True, False))

                def parent_fwd_bwd():
                    return (focal.fused_focal_loss(*inputs),
                            focal.reference_backward(inputs, 1.0, 2.0, one))

                row.update(
                    us=device_us(lambda: focal.fused_focal_loss(*inputs)),
                    plain_us=device_us(lambda: focal.reference_focal(
                        *inputs)),
                    bwd_us=device_us(backward),
                    fwd_bwd_us=device_us(lambda: fwd_bwd(
                        focal.fused_focal_loss, *leaves)),
                    train_fwd_bwd_us=device_us(lambda: fwd_bwd(
                        focal.fused_focal_loss, train_leaf, mask)),
                    plain_fwd_bwd_us=device_us(lambda: fwd_bwd(
                        focal.reference_focal, *ref_leaves)),
                    parent_fwd_bwd_us=device_us(parent_fwd_bwd),
                    bound_us=max(nbytes / bw, nops / flops) * 1e6,
                    bwd_bound_us=max(bwd_bytes / bw, bwd_ops / flops) * 1e6,
                    bound_by=("bytes" if nbytes / bw >= nops / flops
                              else "operations"),
                    library_us=None,
                )
                row["fwd_bwd_bound_us"] = row["bound_us"] + row["bwd_bound_us"]
                if b <= TRAIN_B:  # host cost where the device work is small
                    row.update(
                        bwd_host_us=host_us(backward),
                        train_fwd_bwd_host_us=host_us(lambda: fwd_bwd(
                            focal.fused_focal_loss, train_leaf, mask)),
                        parent_fwd_bwd_host_us=host_us(parent_fwd_bwd))
            rows.append(row)
            print(f"fused_focal_loss {row}", flush=True)
    return rows


def check_se_train(gen, peaks):
    """fused_se at the training shapes of ptbxl_af (B=16) and
    physionet_multi (B=8), f32 (`se_row`)."""
    return [se_row(gen, b, t, c, torch.float32, peaks)
            for b, t, c in SE_TRAIN_SHAPES]


def check_se_fusion(gen, peaks):
    """fused_se in the forward-only form the frozen signal encoder of the
    fusion presets runs, in its compute dtype (bf16): at the preset's B=16
    and bench.py's B=256 (`se_row`)."""
    return [se_row(gen, b, t, c, torch.bfloat16, peaks, backward=False)
            for b in (FUSION_B, BENCH_B) for t, c in SE_SHAPES]


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
    se.backward_launches = fusion.backward_launches = 0
    timings = []
    for img, q, fmt in reqs:
        resp = pipe.predict(img, q, fmt)
        check_response(resp, fmt)
        timings.append(dict(pipe.last_timing))
    launches = {"fused_se": se.launches,
                "fused_attention_fusion": fusion.launches,
                "fused_se_backward": se.backward_launches,
                "fused_attention_fusion_backward": fusion.backward_launches}
    print(f"main path launches over {len(reqs)} requests: {launches}",
          flush=True)
    # 3 SE blocks, forward only; fusion head forward at B=1 (prediction),
    # 32 (SHAP) and 8 (IG), backward under SHAP and IG
    if launches != {"fused_se": 3 * len(reqs),
                    "fused_attention_fusion": 3 * len(reqs),
                    "fused_se_backward": 0,
                    "fused_attention_fusion_backward": 2 * len(reqs)}:
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
    return arrays._replace(**{
        f: getattr(arrays, f).to(device)
        for f in ("images", "signals", "clinical", "labels")
        if getattr(arrays, f) is not None})


def _launch_counts():
    return {"fused_focal_loss": focal.launches, "fused_se": se.launches,
            "fused_attention_fusion": fusion.launches,
            "fused_focal_loss_backward": focal.backward_launches,
            "fused_se_backward": se.backward_launches,
            "fused_attention_fusion_backward": fusion.backward_launches}


NO_LAUNCHES = {k: 0 for k in ("fused_focal_loss", "fused_se",
                              "fused_attention_fusion",
                              "fused_focal_loss_backward",
                              "fused_se_backward",
                              "fused_attention_fusion_backward")}


def _zero_launch_counts():
    focal.launches = se.launches = fusion.launches = 0
    focal.backward_launches = se.backward_launches = 0
    fusion.backward_launches = 0


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


def compare_fusion_steps(n_steps: int = 3, n_synth: int = 48):
    """Phase 6c: n_steps train steps of the full-width `fusion` model
    (images 224x224 uint8, signal 2476, base filters 64, TabNet on 2
    features, the 512/128/32 head, B=16, CE + 0.1 var_loss, constant Adam
    1e-4) from one initial state, on the card and on the CPU, over the
    first epoch's batch plan of the preset's synthetic cohort (48 records:
    38 train rows, so the third batch holds 10 pad rows). Float32 (the
    preset's bf16 autocast off), TF32 off, dropout 0 (the card's and the
    CPU's generators draw different masks); the encoders are frozen and in
    train mode, so their BatchNorm statistics move. On the card the SE
    gate runs 3 forwards a step and no backward, the fusion head one
    forward and one backward with all six gradients.

    Bars, and why (as tests/test_torch_fusion_train.py holds the port
    against JAX on the CPU):
      * loss: rtol 1e-4 at the first step (the frozen encoders' float32
        rounding, summed in other orders by cuDNN and the CPU), 1e-3 later
        (the parameters below carry it);
      * float32 gradients of the first step: 1e-3 of each trainable
        tensor's largest component: each sums the embeddings' noise over
        the batch, where terms cancel;
      * trainable parameters: within 1e-6, except that Adam's first update
        moves an element by about lr whatever the size of its gradient, so
        an element whose gradient lies within the noise of zero moves
        either way: at most 1 in 2000 elements may differ, by at most
        2 * sum(lr);
      * BatchNorm running statistics of the frozen encoders: rtol and atol
        1e-4 (values of order 1 carrying the forward's noise);
      * frozen parameters: bit-equal to the initial state on both
        devices."""
    cfg = get_preset("fusion")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32", dropout=0.0))
    t = cfg.train
    train = train_run.load_data(cfg, n_synth, device="cpu").train
    idx, mask = engine.epoch_indices(train.n, t.batch_size, shuffle=True,
                                     seed=t.seed, epoch=0)
    cpu_model, task, freeze = train_run.build_model_and_task(cfg, "cpu")
    for m in cpu_model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    init, out = _steps_on_both(cpu_model, task, t, train, idx, mask, n_steps,
                               freeze=freeze)
    want_launches = dict(NO_LAUNCHES, fused_se=3 * n_steps,
                         fused_attention_fusion=n_steps,
                         fused_attention_fusion_backward=n_steps)
    return _check_both("fusion steps", init, out, _trainable(cpu_model),
                       n_steps * t.lr, 1e-3, 1e-4, want_launches)


def _trainable(model):
    """The state-dict names of the parameters that require a gradient
    (every name of a Linear shared by several modules, as TabNet's)."""
    return {k for k, p in model.named_parameters(remove_duplicate=False)
            if p.requires_grad}


def _steps_on_both(model, task, cfg, arrays, idx, mask, n_steps,
                   freeze=None):
    """n_steps train steps of `model` (on the CPU, float32) from one
    initial state on the card and on the CPU, over the batch plan
    (idx, mask). Returns the initial state dict and, per device, the
    losses, the first step's gradients, the final state dict and (card)
    the kernels' launches over the steps."""
    if idx.shape[0] < n_steps or mask[n_steps - 1].min() != 0.0:
        raise AssertionError(f"batch plan {idx.shape} lacks a padded batch "
                             f"within {n_steps} steps")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    models = {"cuda": copy.deepcopy(model).cuda(), "cpu": model}
    out = {}
    for dev, m in models.items():
        st = create_state(m, cfg, idx.shape[0], freeze=freeze)
        a = _on(arrays, dev)
        idx_d = torch.from_numpy(idx.astype(np.int64)).to(dev)
        mask_d = torch.from_numpy(mask).to(dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            _zero_launch_counts()
        losses, grads = [], {}
        for i in range(n_steps):
            mets = engine.train_step(
                task, st, engine.gather_batch(a, idx_d[i], mask_d[i]))
            losses.append(float(mets["loss"]))
            if i == 0:
                grads = {k: p.grad.detach().cpu()
                         for k, p in m.named_parameters()
                         if p.grad is not None}
        launches = None
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = _launch_counts()
        out[dev] = (losses, grads,
                    {k: v.detach().cpu() for k, v in m.state_dict().items()},
                    launches)
    return init, out


def _check_both(where, init, out, trainable, sum_lr, grad_bar, stat_bar,
                want_launches, count_turned=True, later_loss_bar=1e-3,
                noise=None):
    """The card against the CPU after `_steps_on_both`: losses (rtol 1e-4
    at the first step, `later_loss_bar` later), the first step's gradients
    within `grad_bar` of each tensor's largest component (None: held
    elsewhere), the trainable
    parameters within 2 sum(lr) (Adam moves an element by about lr
    whatever its gradient's size, so one whose gradient lies within the
    noise of zero moves either way) and, with `count_turned`, within 1e-6
    for all but 1 in 2000 elements; the BatchNorm
    buffers within `stat_bar` (relative and absolute); frozen parameters
    bit-equal to the initial state on both devices; the launches.
    `noise` ({name: slice}) names the parameter elements whose gradient is
    zero in exact arithmetic (`_zero_gradient_entries`): their gradients
    are float32 noise of either sign, left out of the gradient bar, and
    Adam moves each by about lr either way, so they are held to 2 sum(lr)
    alone and not counted."""
    noise = noise or {}
    losses = {d: o[0] for d, o in out.items()}
    grads = {d: o[1] for d, o in out.items()}
    states = {d: o[2] for d, o in out.items()}
    launches = out["cuda"][3]
    worst, failed = {}, []

    def note(kind, err, name, bar):
        worst[kind] = max(worst.get(kind, (0.0, "")), (err, name))
        if err > bar:
            failed.append(f"{kind} {name}: {err:.3g} > {bar:.3g}")

    if launches != want_launches:
        failed.append(f"launches {launches} != {want_launches}")
    for i, (a, b) in enumerate(zip(losses["cuda"], losses["cpu"])):
        note("loss_rel", abs(a - b) / abs(b), f"step {i + 1}",
             1e-4 if i == 0 else later_loss_bar)
    if set(grads["cuda"]) != set(grads["cpu"]) or not set(
            grads["cpu"]) <= trainable:
        failed.append(f"gradients of {sorted(grads['cuda'])} vs "
                      f"{sorted(grads['cpu'])}")
    for name, g in grads["cpu"].items():
        got = grads["cuda"][name]
        if name in noise:
            got, g = got.clone(), g.clone()
            got[noise[name]] = g[noise[name]] = 0.0
        note("grad_rel", gp.rel(got, g), name,
             math.inf if grad_bar is None else grad_bar)
    n_off = n_all = 0
    for name, want in states["cpu"].items():
        got = states["cuda"][name]
        if name.endswith("num_batches_tracked"):
            if not torch.equal(got, want):
                failed.append(f"{name}: {got} vs {want}")
        elif "running_" in name:
            err = ((got - want).abs() / (stat_bar
                                         + stat_bar * want.abs())).max()
            note("bn_stat_over_bar", err.item(), name, 1.0)
        elif name in trainable:
            diff = (got - want).abs()
            note("param", diff.max().item(), name, 2 * sum_lr + 1e-7)
            if name in noise:
                diff[noise[name]] = 0.0
            n_off += int((diff > 1e-6).sum())
            n_all += diff.numel()
        elif not (torch.equal(got, init[name])
                  and torch.equal(want, init[name])):
            failed.append(f"frozen {name} moved")
    if count_turned and n_off > n_all // 2000:
        failed.append(f"{n_off} of {n_all} trainable elements off by > 1e-6")
    print(f"{where} gpu vs cpu: losses {losses['cuda']} vs {losses['cpu']};"
          f" worst (err, tensor): {worst}; {n_off} of {n_all} trainable "
          f"elements off by > 1e-6; sum(lr) = {sum_lr:.3g}; card launches "
          f"{launches}", flush=True)
    if failed:
        raise AssertionError(f"{where} gpu vs cpu: {failed}")
    return {"losses": losses, "worst": worst, "launches": launches}


def _zero_gradient_entries(model):
    """{state-dict name: slice} of the parameter elements whose gradient
    is zero in exact arithmetic: the bias of every convolution that feeds
    a BatchNorm (the ResNet1D-SE's and the CRNN's; the BatchNorm removes
    it) and the key third of each attention's packed bias (the softmax
    over the keys removes it)."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d)) and (
                type(model).__name__ != "ECGTransformer1D"):
            out[f"{name}.bias"] = slice(None)
        if hasattr(m, "in_proj_bias"):
            d = m.in_proj_bias.shape[0] // 3
            out[f"{name}.in_proj_bias"] = slice(d, 2 * d)
    return out


def compare_signal_steps(name: str, n_synth: int, count_turned: bool = True,
                         n_steps: int = 3):
    """Phase 6h: n_steps full-width float32 train steps of preset `name`
    (`physionet_transformer`: B=8, T=3000, 2 layers of (8, 4, 3000, 3000)
    attention; `physionet_crnn`: B=16 spectrograms (33, 95) through the
    convolutions and the 3-layer bidirectional LSTM, the LSTM's second
    biases frozen; `signal_12lead`: the ResNet1D-SE on 12 leads of 2476
    samples, B=8), focal loss, the preset's Adam schedule, from one
    initial state on the card and on the CPU, TF32 off as `run()` sets
    it, dropout 0 (the devices' generators draw different masks), over
    the first epoch's plan of `n_synth` records (the third batch padded).
    The first step is also taken on the card with TF32 on in cuDNN and
    cuBLAS: its gradients against the CPU's are printed, and the
    Transformer's (cuBLAS products alone) must fall outside the gradient
    bar, as `ptbxl_af`'s do.

    Bars (`_check_both`): loss rtol 1e-4 at the first step, 1e-3 later;
    the first step's gradients within 2e-3 of each tensor's largest
    component, as for `ptbxl_af` (a ReLU or max-pool input within float32
    rounding of its threshold reroutes its gradient,
    `tools/grad_precision`), the zero-gradient elements
    (`_zero_gradient_entries`) left out; parameters 2 sum(lr) and, with
    `count_turned`, at most 1 in 2000 elements off by more than 1e-6
    (without it, as for `image_only`: Adam's first update is lr times the
    gradient's sign, so every element whose gradient lies within float32
    noise of zero turns, and a model fresh from its init has many:
    `signal_12lead` read 706 and 3114 of 471390 in two runs on the H100,
    as cuDNN's choices vary); BatchNorm buffers
    1e-4; frozen tensors bit-equal; one focal forward and backward a
    step, and 3 SE forwards and backwards for the ResNet. The CRNN's
    first step is also read against float64 on the CPU, beside the same
    step on the card with cuDNN's convolutions in place of the model's
    im2col products (`GemmConv2d`)."""
    grad_bar = 2e-3
    cfg = get_preset(name)
    t = cfg.train
    train = train_run.load_data(cfg, n_synth, device="cpu").train
    idx, mask = engine.epoch_indices(train.n, t.batch_size, shuffle=True,
                                     seed=t.seed, epoch=0)
    model, task, freeze = train_run.build_model_and_task(cfg, "cpu")
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    first = engine.gather_batch(train, torch.from_numpy(
        idx[0].astype(np.int64)), torch.from_numpy(mask[0]))
    old = gp.apply_setting("tf32")
    try:
        g_tf32 = gp.step_grads32(model, first, task, "cuda")
    finally:
        gp.restore_setting(old)
    noise = _zero_gradient_entries(model)
    if name == "physionet_crnn":  # before the steps train the CPU model
        m64 = copy.deepcopy(model).double().train()
        gp.focal64(m64(first.signals.double()), first.labels,
                   first.mask).backward()
        g64 = {k: p.grad for k, p in m64.named_parameters()
               if p.grad is not None and k not in noise}
        library = copy.deepcopy(model)
        for mod in library.modules():
            if isinstance(mod, GemmConv2d):
                mod.__class__ = torch.nn.Conv2d
        g_library = gp.step_grads32(library, first, task, "cuda")
    init, out = _steps_on_both(model, task, t, train, idx, mask, n_steps,
                               freeze=freeze)
    if name == "physionet_crnn":
        print(f"{name} first step against float64, worst (err, tensor): "
              f"card {gp.worst(out['cuda'][1], g64)}, CPU "
              f"{gp.worst(out['cpu'][1], g64)}, card with cuDNN's "
              f"convolutions {gp.worst(g_library, g64)}", flush=True)
    tf32 = (0.0, "")
    for k, g in out["cpu"][1].items():
        got = g_tf32[k]
        if k in noise:
            got, g = got.clone(), g.clone()
            got[noise[k]] = g[noise[k]] = 0.0
        tf32 = max(tf32, (gp.rel(got, g), k))
    print(f"{name} first step, TF32 on against the CPU, worst (err, "
          f"tensor): {tf32} (float32 bar {grad_bar})", flush=True)
    if name == "physionet_transformer" and tf32[0] <= grad_bar:
        raise AssertionError(f"{name}: the TF32 control reads {tf32}, "
                             f"within the float32 bar {grad_bar}")
    se_calls = 0 if name in NO_SE else 3 * n_steps
    want = dict(NO_LAUNCHES, fused_focal_loss=n_steps,
                fused_focal_loss_backward=n_steps, fused_se=se_calls,
                fused_se_backward=se_calls)
    lr = (Optimizer(
        [torch.nn.Parameter(torch.zeros(1))], t, idx.shape[0]).schedule
        or (lambda k: t.lr))
    res = _check_both(f"{name} steps", init, out, _trainable(model),
                      sum(lr(k) for k in range(n_steps)), grad_bar, 1e-4,
                      want, count_turned=count_turned, noise=noise)
    res["tf32"] = tf32
    return res


def lstm_tf32_check(batch: int = 16, steps: int = 11, seed: int = 0):
    """Phase 6h: the CRNN's 3-layer bidirectional LSTM alone (input 512,
    hidden 200) at the `physionet_crnn` step's shape (B=16, 11 frames
    after the convolutions): output and weight gradients on the card with
    cuDNN's TF32 off (`no_tf32`, as `run()` runs) and on, each against the
    CPU, relative to each tensor's largest component. TF32 off must stay
    within 1e-4 (float32 sums in other orders over 11 steps); the TF32
    reading shows whether cuDNN's RNN math follows the flag."""
    model = flax_init_(CRNN(2), torch.Generator().manual_seed(seed))
    lstm = model.bilstm
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, steps, lstm.input_size, generator=gen)
    w = torch.randn(batch, steps, 2 * lstm.hidden_size, generator=gen)

    def run(device, tf32):
        m = copy.deepcopy(lstm).to(device)
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            out, _ = m(x.to(device))
            (out * w.to(device)).sum().backward()
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        return {"output": out.detach().cpu(), **{
            k: p.grad.cpu() for k, p in m.named_parameters()
            if p.grad is not None}}

    want = run("cpu", False)
    reading = {}
    for label, tf32 in (("tf32_off", False), ("tf32_on", True)):
        got = run("cuda", tf32)
        reading[label] = max((gp.rel(got[k], v), k) for k, v in want.items())
    print(f"LSTM (B={batch}, {steps} steps) card against CPU, worst (err, "
          f"tensor): {reading}", flush=True)
    if reading["tf32_off"][0] > 1e-4:
        raise AssertionError(f"LSTM with TF32 off: {reading['tf32_off']}")
    return reading


def _image_choices(model, images, device, dtype):
    """ResNet-18's discrete forward choices in train mode: the sign of
    each ReLU's input (the stem's BatchNorm and every block's `bn1`; a
    block's output is its ReLU's) and the max-pool's argmax with its
    maximum (`tools/grad_precision.flips` compares them)."""
    m = copy.deepcopy(model).to(device, dtype).train()
    seen, hooks = {}, []
    for name, mod in m.named_modules():
        if isinstance(mod, torch.nn.MaxPool2d):
            def fwd(mod, inp, out, name=name):
                val, idx = F.max_pool2d(inp[0], mod.kernel_size, mod.stride,
                                        mod.padding, return_indices=True)
                seen[name] = (idx.cpu(), val.cpu())
        elif (name == "bn1" or name.endswith(".bn1")
              or type(mod).__name__ == "BasicBlock2D"):
            def fwd(mod, inp, out, name=name):
                seen[name] = (out > 0).cpu()
        else:
            continue
        hooks.append(mod.register_forward_hook(fwd))
    with torch.no_grad():
        m(images.to(device, dtype) if dtype == torch.float64
          else images.to(device))
    for h in hooks:
        h.remove()
    return seen


def _image_grads(model, task, batch, device):
    """The first image step's float32 gradients on `device`."""
    m = copy.deepcopy(model).to(device).train()
    b = batch._replace(images=batch.images.to(device),
                       labels=batch.labels.to(device),
                       mask=batch.mask.to(device))
    loss, _ = task.loss(task.apply(m, b), b)
    loss.backward()
    return {k: p.grad.cpu() for k, p in m.named_parameters()}


def compare_image_steps(n_steps: int = 3, n_synth: int = 48):
    """Phase 6d: n_steps `image_only` train steps (ResNet18 with 2
    classes, float32, 224x224 uint8 images, B=16, CE, constant Adam 1e-4:
    ResNet-18's first backward on the card) from one initial state on the
    card and the CPU, TF32 off, over the first epoch's plan of the
    preset's cohort (38 train rows: the third batch holds 10 pad rows).
    No kernel of the port lies on this path (ResNet-18 runs through cuDNN
    and ATen).

    Each device's first-step float32 gradients are read against float64
    on the CPU, beside the forward's discrete choices (ReLU signs,
    max-pool argmax) that differ from float64's: at 224x224 and B=16 a
    few of the ~3e7 ReLU and max-pool inputs lie within float32 rounding
    of their threshold, and each one that flips reroutes its position's
    gradient, most in the 7x7 maps of layer4, where one position weighs
    most: on either device a few flips move a weight gradient by
    percents of its largest component (PERF.md section 6, PR 6). So the
    card's float32 is held to float64 by the choices it flips, at most
    100, and its gradients within 0.1 of each tensor's largest component;
    a TF32 control of the first step must flip more than 1000. Later losses differ by what the turned elements' Adam
    steps move (rtol 5e-3); parameters 2 sum(lr); the BatchNorm buffers
    1e-3 (`_check_both`)."""
    cfg = get_preset("image_only")
    t = cfg.train
    train = train_run.load_data(cfg, n_synth, device="cpu").train
    idx, mask = engine.epoch_indices(train.n, t.batch_size, shuffle=True,
                                     seed=t.seed, epoch=0)
    model, task, _ = train_run.build_model_and_task(cfg, "cpu")
    first = engine.gather_batch(train, torch.from_numpy(
        idx[0].astype(np.int64)), torch.from_numpy(mask[0]))
    if first.mask.min() != 1.0:
        raise AssertionError("the first image batch is padded")
    x64 = first.images.double() / 127.5 - 1.0
    m64 = copy.deepcopy(model).double().train()
    F.cross_entropy(m64.fc(m64.features(x64).mean(dim=(2, 3))),
                    first.labels).backward()
    g64 = {k: p.grad for k, p in m64.named_parameters()}
    c64 = _image_choices(model, x64, "cpu", torch.float64)
    reading, flipped = {}, {}
    for label, dev, setting in (("cpu", "cpu", None), ("card", "cuda", None),
                                ("card_tf32", "cuda", "tf32")):
        old = gp.apply_setting(setting) if setting else None
        try:
            g = _image_grads(model, task, first, dev)
            c = _image_choices(model, first.images, dev, torch.float32)
        finally:
            if old is not None:
                gp.restore_setting(old)
        reading[label] = gp.worst(g, g64)
        flipped[label] = sum(n for n, _ in gp.flips(c, c64).values())
    print(f"image_only first step against float64, worst (err, tensor): "
          f"{reading}; forward choices off float64: {flipped}", flush=True)
    if (reading["card"][0] > 0.1 or flipped["card"] > 100
            or flipped["card_tf32"] <= 1000):
        raise AssertionError(
            f"image_only first step against float64: {reading}, flips "
            f"{flipped} (bars: card 0.1 and 100 flips; TF32 over 1000)")
    init, out = _steps_on_both(model, task, t, train, idx, mask, n_steps)
    return _check_both("image_only steps", init, out, _trainable(model),
                       n_steps * t.lr, None, 1e-3, NO_LAUNCHES,
                       count_turned=False, later_loss_bar=5e-3)


def compare_clinical_steps(n_steps: int = 3, n_synth: int = 48):
    """Phase 6e: n_steps clinical-probe steps (TabNet on the canonical
    cohort's 2 features under a linear probe, float32, B=16, CE + 1e-3
    m_loss, the fusion preset's constant Adam 1e-4, as the pipeline's
    stage 3: TabNet's first backward on the card) on the card and the
    CPU, TF32 off, over the first epoch's plan. Bars as the image steps';
    no kernel of the port lies on this path."""
    cfg = get_preset("fusion")
    t = dataclasses.replace(cfg.train, freeze_encoders=False)
    train = train_run.load_data(cfg, n_synth, device="cpu").train
    idx, mask = engine.epoch_indices(train.n, t.batch_size, shuffle=True,
                                     seed=t.seed, epoch=0)
    task, probe = make_clinical_task(
        TabNetEncoder(cfg.model.clinical_in_features,
                      out_dim=cfg.model.clinical_dim), t,
        cfg.model.num_classes)
    flax_init_(probe, torch.Generator().manual_seed(t.seed))
    init, out = _steps_on_both(probe, task, t, train, idx, mask, n_steps)
    return _check_both("clinical probe steps", init, out, _trainable(probe),
                       n_steps * t.lr, 2e-3, 1e-3, NO_LAUNCHES)


def compare_cached(n_steps: int = 3, n_synth: int = 48):
    """Phase 6f: the cached path at full width (the canonical model,
    float32, dropout 0, frozen encoders) on the card and the CPU, TF32
    off: `calibrate_bn_stats` over the train split's full batches at eval
    batch 16 (38 rows: 2 batches, 3 passes), then every BatchNorm buffer
    (rtol and atol 1e-4, as the fusion steps hold them); `encode_raw` of
    every batch of the train split (`precompute_fusion_embeddings`: the
    first batch is `encode_raw` of one batch) within 1e-4 of each
    embedding's largest component (eval-mode float32 convolutions summed
    in other orders); then n_steps head steps (`make_fusion_head_task`)
    over the cached embeddings, held as the fusion steps are (losses,
    gradients 1e-3, parameters, frozen weights bit-equal). On the card the
    calibration runs 3 SE forwards and one fusion forward a batch, the
    encoding 3 SE forwards a batch and no fusion kernel, a head step one
    fusion forward and one six-gradient backward."""
    cfg = get_preset("fusion_cached")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32", dropout=0.0))
    t = cfg.train
    train = train_run.load_data(cfg, n_synth, device="cpu").train
    model, _, freeze = train_run.build_model_and_task(cfg, "cpu")
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    init = {k: v.clone() for k, v in model.state_dict().items()}
    idx, mask = engine.epoch_indices(train.n, t.batch_size, shuffle=True,
                                     seed=t.seed, epoch=0)
    task = make_fusion_head_task(t)
    models = {"cuda": copy.deepcopy(model).cuda(), "cpu": model}
    calibrated, cached, res = {}, {}, {}
    for dev, m in models.items():
        st = create_state(m, t, idx.shape[0], freeze=freeze)
        a = _on(train, dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            _zero_launch_counts()
        embed.calibrate_bn_stats(st, a, t.eval_bs)
        calibrated[dev] = {k: v.detach().cpu()
                           for k, v in m.state_dict().items()}
        c = embed.precompute_fusion_embeddings(m, a, t.eval_bs)
        cached[dev] = c
        idx_d = torch.from_numpy(idx.astype(np.int64)).to(dev)
        mask_d = torch.from_numpy(mask).to(dev)
        losses, grads = [], {}
        for i in range(n_steps):
            mets = engine.train_step(
                task, st, engine.gather_batch(c, idx_d[i], mask_d[i]))
            losses.append(float(mets["loss"]))
            if i == 0:
                grads = {k: p.grad.detach().cpu()
                         for k, p in m.named_parameters()
                         if p.grad is not None}
        launches = None
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = _launch_counts()
        res[dev] = (losses, grads, {k: v.detach().cpu()
                                    for k, v in m.state_dict().items()},
                    launches)
    failed = []
    for name, want in calibrated["cpu"].items():
        if "running_" in name:
            got = calibrated["cuda"][name]
            moved = not torch.equal(want, init[name])
            if not moved or ((got - want).abs()
                             > 1e-4 + 1e-4 * want.abs()).any():
                failed.append(f"calibrated {name}: moved {moved}, err "
                              f"{(got - want).abs().max().item():.3g}")
    emb_err = {}
    for f in ("images", "signals", "clinical"):
        want = getattr(cached["cpu"], f)
        emb_err[f] = gp.rel(getattr(cached["cuda"], f), want)
        if emb_err[f] > 1e-4 or want.shape[0] != train.n:
            failed.append(f"embeddings {f}: {emb_err[f]:.3g}")
    n_full = train.n // t.eval_bs
    n_enc = -(-train.n // t.eval_bs)
    want_launches = dict(NO_LAUNCHES, **{
        "fused_se": 3 * (3 * n_full + n_enc),
        "fused_attention_fusion": 3 * n_full + n_steps,
        "fused_attention_fusion_backward": n_steps})
    print(f"cached path gpu vs cpu: calibrated buffers checked, embedding "
          f"error relative to the largest component {emb_err}", flush=True)
    if failed:
        raise AssertionError(f"cached path gpu vs cpu: {failed}")
    return _check_both("cached head steps", init, res, _trainable(model),
                       n_steps * t.lr, 1e-3, 1e-4, want_launches)


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
    # one forward per train step and per eval batch: every epoch trains
    # and evaluates val; the test protocol evaluates test and val for best
    # and for last. Three SE blocks per forward.
    n_fwd = epochs * (nb["train"] + nb["val"]) + 2 * (nb["test"] + nb["val"])
    steps = epochs * nb["train"]
    if t.cache_embeddings:
        # calibration: 3 passes of whole-model forwards over the train
        # split's full batches at eval_bs; encoding: every batch of each
        # split once, the encoders only (3 SE forwards, no fusion head);
        # then the head alone at every step and eval batch
        calib = 3 * (data.train.n // t.eval_bs)
        enc = sum(pipeline.num_batches(getattr(data, s).n, t.eval_bs)
                  for s in nb)
        want = {"fused_focal_loss": 0, "fused_se": 3 * (calib + enc),
                "fused_attention_fusion": calib + n_fwd,
                "fused_focal_loss_backward": 0, "fused_se_backward": 0,
                "fused_attention_fusion_backward": steps}
    elif name == "image_only":  # ResNet-18 alone: no kernel of the port
        want = dict(NO_LAUNCHES)
    elif name in train_run.FUSION_FAMILIES:
        # the fusion head forward and its backward (all six gradients) at
        # every step; the frozen signal encoder runs no SE backward
        want = {"fused_focal_loss": 0, "fused_se": 3 * n_fwd,
                "fused_attention_fusion": n_fwd,
                "fused_focal_loss_backward": 0, "fused_se_backward": 0,
                "fused_attention_fusion_backward": steps}
    else:  # the SE and focal backwards run at every train step
        se = 0 if name in NO_SE else 3
        want = {"fused_focal_loss": n_fwd, "fused_se": se * n_fwd,
                "fused_attention_fusion": 0,
                "fused_focal_loss_backward": steps,
                "fused_se_backward": se * steps,
                "fused_attention_fusion_backward": 0}
    run_dir = os.path.join(tmp, name)
    torch.cuda.synchronize()
    _zero_launch_counts()
    result, reports = train_run.run(cfg, data, run_dir=run_dir,
                                    device="cuda")
    torch.cuda.synchronize()
    launches = _launch_counts()
    print(f"{name}: splits {[getattr(data, s).n for s in nb]}, batches "
          f"{nb}; launches {launches} (batch plan {want})", flush=True)
    if launches != want:
        raise AssertionError(f"{name}: launches {launches} != {want}")

    log_path = os.path.join(t.log_dir, name, "metrics.jsonl")
    with open(log_path) as f:
        logged = [json.loads(line) for line in f]
    # an empty val split (signal_af at 60 records) logs a NaN val loss,
    # as in JAX; the run then saves no `best`
    log_keys = ("Loss/Train", "Loss/Val") if data.val.n else ("Loss/Train",)
    if not data.val.n and not all(np.isnan(rec["Loss/Val"])
                                  for rec in logged):
        raise AssertionError(f"{name}: a val loss without a val split")
    if name in train_run.FUSION_FAMILIES:
        log_keys += ("VarLoss/Val", "AttentionWeights/Image_w",
                     "AttentionWeights/Signal_w",
                     "AttentionWeights/Clinical_w")
    if len(logged) != epochs or not all(
            np.isfinite(rec[k]) for rec in logged for k in log_keys):
        raise AssertionError(f"{name}: bad metric log {logged}")
    if name in ("fusion", "fusion_cached") and not (
            logged[-1]["Loss/Train"] < logged[0]["Loss/Train"]):
        raise AssertionError(f"{name}: the bf16 train loss did not fall: "
                             f"{[rec['Loss/Train'] for rec in logged]}")
    keys = REPORT_KEYS[name]
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
    if ckpt.exists("best") != (result.best_epoch >= 0):
        raise AssertionError(f"{name}: best epoch {result.best_epoch}, "
                             f"best checkpoint {ckpt.exists('best')}")
    for tag, epoch in (("best", result.best_epoch + 1), ("last", epochs)):
        if not ckpt.exists(tag):
            continue
        model, task, freeze = train_run.build_model_and_task(cfg, "cuda")
        st = ckpt.restore(tag, create_state(model, t, nb["train"],
                                            freeze=freeze))
        if st.epoch != epoch:
            raise AssertionError(f"{name} {tag}: epoch {st.epoch} != {epoch}")
        ev = engine.evaluate(task, st, data.test, t.eval_bs)
        if not np.all(np.isfinite(ev.logits)):
            raise AssertionError(f"{name} {tag}: non-finite test logits")
        if tag == "last":
            live = result.state.model.state_dict()
            for k, v in model.state_dict().items():
                if not torch.equal(v, live[k]):
                    raise AssertionError(f"{name} last: {k} differs")
    return result, launches


def run_pretrain_pipeline(tmp: str, n_synth: int = 96):
    """Phase 6g: `run_pipeline` at full width on the card, as `python -m
    ecgmm_torch.workloads.pretrain --cache-embeddings` runs it, one epoch
    a stage, with the launch counters set to 0 just before and read just
    after, and read between the stages too (around `pretrain._fit_stage`).
    The launches must equal each stage's batch plan: none for image_only
    and the clinical probe; a signal_only step 3 SE forwards and
    backwards and one focal forward and backward, a val batch the
    forwards; in stage 4 a calibration batch 3 SE forwards and one fusion
    forward, an encoded batch 3 SE forwards, a head step one fusion
    forward and one six-gradient backward, an eval batch one fusion
    forward. Stage 4's encoder weights must equal each stage's `best`
    checkpoint under the three filters, and the filtered tensors the
    fusion model's initial ones."""
    cfg = get_preset("fusion")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=1, cache_embeddings=True))
    t = cfg.train
    data = train_run.load_data(cfg, n_synth, device="cuda")
    run_dir = os.path.join(tmp, "pipeline")
    stages = []
    fit_stage = pretrain._fit_stage

    def counted(*args, **kwargs):
        torch.cuda.synchronize()
        before = _launch_counts()
        out = fit_stage(*args, **kwargs)
        torch.cuda.synchronize()
        after = _launch_counts()
        stages.append((os.path.basename(args[4]), args[3],
                       {k: after[k] - before[k] for k in after}))
        return out

    pretrain._fit_stage = counted
    try:
        torch.cuda.synchronize()
        _zero_launch_counts()
        result, ev = pretrain.run_pipeline(cfg, data, run_dir,
                                           stage_epochs=1, device="cuda")
        torch.cuda.synchronize()
        launches = _launch_counts()
    finally:
        pretrain._fit_stage = fit_stage
    n = {s: getattr(data, s).n for s in ("train", "val", "test")}

    def nbat(split, bs):
        return pipeline.num_batches(n[split], bs)

    want, got = {}, {}
    for stage, tcfg, counts in stages:
        got[stage] = counts
        if stage == "signal_only":
            steps, val = nbat("train", tcfg.batch_size), nbat("val",
                                                               tcfg.eval_bs)
            want[stage] = dict(NO_LAUNCHES, **{
                "fused_se": 3 * (steps + val), "fused_se_backward": 3 * steps,
                "fused_focal_loss": steps + val,
                "fused_focal_loss_backward": steps})
        else:
            want[stage] = dict(NO_LAUNCHES)
    got["fusion"] = {k: launches[k] - sum(c[k] for *_, c in stages)
                     for k in launches}
    calib = 3 * (n["train"] // t.eval_bs)
    enc = sum(nbat(s, t.eval_bs) for s in n)
    steps = nbat("train", t.batch_size)
    want["fusion"] = dict(NO_LAUNCHES, **{
        "fused_se": 3 * (calib + enc),
        "fused_attention_fusion": calib + steps + nbat("val", t.eval_bs)
        + nbat("test", t.eval_bs),
        "fused_attention_fusion_backward": steps})
    print(f"pretrain pipeline: splits {n}; launches by stage {got} (batch "
          f"plan {want}); fusion test accuracy {ev.accuracy:.4f}",
          flush=True)
    if got != want or [s for s, *_ in stages] != [
            "image_only", "signal_only", "clinical"]:
        raise AssertionError(f"pretrain launches {got} != {want}")
    if not (np.isfinite(ev.loss) and np.all(np.isfinite(ev.logits))
            and ev.logits.shape == (n["test"], 2)):
        raise AssertionError(f"pretrain: bad test evaluation {ev.loss}")

    init = flax_init_(ECGMultimodalModel(cfg.model),
                      torch.Generator().manual_seed(t.seed)).state_dict()
    model = result.state.model
    checked = {}
    for stage, prefix, sub in (("image_only", "image_encoder.", ""),
                               ("signal_only", "signal_encoder.", ""),
                               ("clinical", "clinical_encoder.", "encoder.")):
        best = CheckpointManager(os.path.join(run_dir, stage)).load(
            "best")["model"]
        excluded = pretrain.WARM_START_FILTERS[stage.split("_")[0]][1]
        n_warm = n_init = 0
        for name, p in model.named_parameters():
            if not name.startswith(prefix):
                continue
            key = name[len(prefix):]
            if p.requires_grad:
                raise AssertionError(f"pretrain: {name} is not frozen")
            if key.startswith(excluded):
                ok, n_init = torch.equal(p.cpu(), init[name]), n_init + 1
            else:
                ok, n_warm = torch.equal(p.cpu(), best[sub + key].cpu()), \
                    n_warm + 1
            if not ok:
                raise AssertionError(f"pretrain: {name} is not the "
                                     "warm start")
        checked[stage] = (n_warm, n_init)
    print(f"pretrain warm start: (tensors from the stage's best, tensors "
          f"kept from the fusion init) {checked}", flush=True)
    return result, launches


def measure_train_step(name: str, batch_size: int, n_synth: int = 256,
                       n: int = 30, tf32: bool = False):
    """Phase 7: steady-state train steps of preset `name` at full width on
    the card as `run()` takes them (TF32 off; with `tf32`, PyTorch's
    defaults instead: cuDNN's TF32 on, cuBLAS's off), dropout live, the
    preset's compute dtype, at `batch_size`: per-step CUDA-event spans,
    host wall time, and the device's busy share under torch.profiler. The
    batches are the first epoch's full batches of the preset's synthetic
    cohort of `n_synth` records, or, where the train split is smaller than
    `batch_size`, rows drawn with replacement. A cached preset first
    calibrates the frozen encoders' BatchNorm statistics on the train
    split and encodes it at `batch_size` (both timed, `calibrate_ms` and
    `encode_ms`), then times the head steps over the cached embeddings."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _measure_steps(name, batch_size, n_synth, n, tf32)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _measure_steps(name, batch_size, n_synth, n, tf32):
    from torch.profiler import ProfilerActivity, profile

    cfg = get_preset(name)
    t = dataclasses.replace(cfg.train, batch_size=batch_size)
    data = train_run.load_data(cfg, n_synth, device="cuda")
    model, task, freeze = train_run.build_model_and_task(cfg, "cuda")
    train = data.train
    full = train.n >= batch_size
    state = create_state(model, t, train.n // batch_size if full else 8,
                         freeze=freeze)
    out = {"preset": name, "steps": n, "batch": batch_size,
           # the signal and image presets' models run in float32
           "dtype": (cfg.model.dtype if name in train_run.FUSION_FAMILIES
                     else "float32"),
           "cudnn_tf32": tf32}
    if t.cache_embeddings:
        rounds = {}
        for key, fn in (
                ("calibrate_ms", lambda: embed.calibrate_bn_stats(
                    state, train, t.eval_bs)),
                ("encode_ms", lambda: embed.precompute_fusion_embeddings(
                    model, train, t.eval_bs))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rounds[key] = fn()
            torch.cuda.synchronize()
            out[key] = (time.perf_counter() - t0) * 1e3
        out["calibrate_batches"] = 3 * max(train.n // t.eval_bs, 1)
        out["encode_batches"] = pipeline.num_batches(train.n, t.eval_bs)
        train = rounds["encode_ms"]
        task = make_fusion_head_task(t)
    if full:
        idx, mask = engine.epoch_indices(train.n, batch_size,
                                         shuffle=True, seed=t.seed, epoch=0)
        idx = idx[mask.min(axis=1) == 1.0]
    else:
        idx = np.random.default_rng(t.seed).integers(
            0, train.n, (8, batch_size))
    idx_d = torch.from_numpy(idx.astype(np.int64)).cuda()
    ones = torch.ones(batch_size, device="cuda")
    torch.cuda.reset_peak_memory_stats()

    def step(i):
        return engine.train_step(task, state, engine.gather_batch(
            train, idx_d[i % idx.shape[0]], ones))

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
    out.update({"median_ms": statistics.median(spans),
                "p90_ms": float(np.percentile(spans, 90)),
                "wall_ms_per_step": wall_ms,
                "samples_per_s": batch_size * 1e3 / wall_ms,
                "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9})

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
    out["host_fused_backward_ms"] = {
        e.key: e.self_cpu_time_total / 1e3 / k for e in host
        if e.key.startswith("_Fused") and e.key.endswith("Backward")}
    out["host_top"] = [(e.key[:60], e.self_cpu_time_total / 1e3 / k,
                        e.count // k) for e in host[:10]]
    return out


def summarize(name, source, replaces, launches_by_path, rows, picked, per,
              bound_by="bytes", backward=None):
    """One kernel's entry of the `kernels` line: the times are the sum
    over the calls that `per` names (the `picked` rows); `launches` is the
    sum over the main paths this script drove. `backward`, for a kernel
    with a backward kernel, is (backward launches by path, the rows of
    the calls that run it, what those calls are): `fwd_bwd_ms` and its
    bound sum forward plus backward over those calls."""
    lib = [r["library_us"] for r in picked]
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": sum(launches_by_path.values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if "max_abs_err" in r
                           and r.get("dtype", "float32") == "float32"),
        "ms": sum(r["us"] for r in picked) / 1e3,
        "plain_ms": sum(r["plain_us"] for r in picked) / 1e3,
        "bound_ms": sum(r["bound_us"] for r in picked) / 1e3,
        "bound_by": bound_by,
        "library_ms": None if None in lib else sum(lib) / 1e3,
        "per": per,
        "launches_by_path": launches_by_path,
        "shapes": rows,
    }
    if backward is not None:
        by_path, bwd_rows, bwd_per = backward
        entry.update({
            "bwd_launches": sum(by_path.values()),
            "fwd_bwd_ms": sum(r["fwd_bwd_us"] for r in bwd_rows) / 1e3,
            "fwd_bwd_bound_ms": sum(r["fwd_bwd_bound_us"]
                                    for r in bwd_rows) / 1e3,
            "bwd_ms": sum(r["bwd_us"] for r in bwd_rows) / 1e3,
            "plain_fwd_bwd_ms": sum(r["plain_fwd_bwd_us"]
                                    for r in bwd_rows) / 1e3,
            "parent_fwd_bwd_ms": sum(r["parent_fwd_bwd_us"]
                                     for r in bwd_rows) / 1e3,
            "fwd_bwd_per": bwd_per,
            "bwd_launches_by_path": by_path,
        })
    return entry


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
    dev = torch.device("cuda")

    def stream_object():  # what the wrappers did per launch before
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    def raw_stream():
        context, stream = _ext.launch_target(dev)
        with context:
            return stream

    print(f"launch glue, host us per launch: device context and stream "
          f"object {host_us(stream_object, 2000):.3f}, "
          f"`_ext.launch_target` {host_us(raw_stream, 2000):.3f} ({smi})",
          flush=True)
    gen = torch.Generator().manual_seed(0)
    print("fused_se has no single PyTorch call computing the same function "
          "(library_ms null)", flush=True)
    se_rows = check_se(gen, peaks)
    fusion_rows = check_fusion(gen, peaks)
    fusion_bwd_rows = check_fusion_backward(gen, peaks)
    fusion_sweep = fusion_layout_sweep(gen)
    print("fused_focal_loss has no single PyTorch call computing the same "
          "function (library_ms null)", flush=True)
    focal_rows = check_focal(gen, peaks)
    focal_profiled_backward(gen)
    focal_sweep = focal_cluster_sweep(gen)
    se_train_rows = check_se_train(gen, peaks)
    se_fusion_rows = check_se_fusion(gen, peaks)

    # 4. the slice
    launches, timings = run_slice()

    # 5. numbers
    for key in ("total_ms", "host_before_ms", "device_ms", "host_after_ms"):
        vals = sorted(t[key] for t in timings)
        print(f"request {key}: median {statistics.median(vals):.3f} p90 "
              f"{float(np.percentile(vals, 90)):.3f} ({smi})", flush=True)

    # 6. the training slices: first the algorithm against the CPU in
    # float32 (TF32 off, as `run()` sets it), then the runs through the
    # entry points
    with train_run.no_tf32():
        compare_train_steps()
        compare_fusion_steps()
        compare_image_steps()
        compare_clinical_steps()
        compare_cached()
        compare_signal_steps("physionet_transformer", 24)
        compare_signal_steps("physionet_crnn", 48, count_turned=False)
        compare_signal_steps("signal_12lead", 24, count_turned=False)
        lstm_tf32_check()
    with tempfile.TemporaryDirectory() as tmp:
        ptbxl, ptbxl_launches = run_training(tmp, "ptbxl_af", 256, 2)
        _, multi_launches = run_training(tmp, "physionet_multi", 96, 1)
        fusion_run, fusion_launches = run_training(tmp, "fusion", 256, 2)
        _, balance_launches = run_training(tmp, "fusion_modal_balance", 96,
                                           1)
        cached_run, cached_launches = run_training(tmp, "fusion_cached", 256,
                                                   2)
        _, image_launches = run_training(tmp, "image_only", 96, 1)
        _, signal_launches = run_training(tmp, "signal_only", 96, 1)
        _, pretrain_launches = run_pretrain_pipeline(tmp)
        new_launches = {
            name: run_training(tmp, name, 60 if name == "signal_af" else 96,
                               1)[1]
            for name in ("signal_af", "signal_arr", "signal_12lead",
                         "physionet_crnn", "physionet_transformer")}

    # 7. numbers
    for run_name, res in (("ptbxl_af", ptbxl), ("fusion", fusion_run),
                          ("fusion_cached", cached_run)):
        for h in res.history:
            print(f"{run_name} epoch {h['epoch'] + 1} time "
                  f"{h['Time/Epoch'] * 1e3:.3f} ms (train + val, n_synth "
                  f"256; {smi})", flush=True)
    for run_name, b, tf32 in (("ptbxl_af", TRAIN_B, False),
                              ("ptbxl_af", TRAIN_B, True),
                              ("fusion", FUSION_B, False),
                              ("fusion", BENCH_B, False),
                              ("fusion_cached", FUSION_B, False),
                              ("fusion_cached", BENCH_B, False),
                              ("image_only", FUSION_B, False),
                              ("image_only", FUSION_B, True),
                              ("physionet_transformer", 8, False),
                              ("physionet_crnn", 16, False)):
        step = measure_train_step(run_name, b, tf32=tf32)
        print(f"{run_name} train step B={b} cudnn_tf32={tf32} ({smi}): "
              f"{json.dumps(step)}", flush=True)
    paths = {
        "serve": launches,
        "train_ptbxl_af": ptbxl_launches,
        "train_physionet_multi": multi_launches,
        "train_fusion": fusion_launches,
        "train_fusion_modal_balance": balance_launches,
        "train_fusion_cached": cached_launches,
        "train_signal_only": signal_launches,
        "train_image_only": image_launches,
        "pretrain": pretrain_launches,
        **{f"train_{name}": n for name, n in new_launches.items()},
    }

    def by_path(kernel):
        return {p: n.get(kernel, 0) for p, n in paths.items()}

    focal_picked = [r for r in focal_rows
                    if (r["B"], r["C"]) == (TRAIN_B, 2) and "us" in r]
    se_picked = [r for r in se_train_rows if r["B"] == TRAIN_B]
    kernels = [
        summarize("fused_se", "ecgmm_torch/ops/csrc/se.cu",
                  "ecgmm_tpu/ops/pallas_se.py:85", by_path("fused_se"),
                  se_rows + se_train_rows, se_picked,
                  "ptbxl_af train step: 3 forward calls at B=16",
                  backward=(by_path("fused_se_backward"), se_picked,
                            "ptbxl_af train step: 3 calls at B=16")),
        summarize("fused_attention_fusion", "ecgmm_torch/ops/csrc/fusion.cu",
                  "ecgmm_tpu/ops/pallas_fusion.py:98",
                  by_path("fused_attention_fusion"),
                  fusion_rows + fusion_bwd_rows,
                  [r for r in fusion_rows
                   if r["D"] == 672 and r["B"] in (1, 8, 32)],
                  "serving request: B=1, 32 and 8 at D=672",
                  backward=(by_path("fused_attention_fusion_backward"),
                            [r for r in fusion_bwd_rows
                             if r["needs"] in ("shap", "ig")],
                            "serving request: SHAP (B=32, the three "
                            "embeddings) and IG (B=8, clin) at D=672")),
        summarize("fused_focal_loss", "ecgmm_torch/ops/csrc/focal.cu",
                  "ecgmm_tpu/ops/pallas_losses.py:66",
                  by_path("fused_focal_loss"), focal_rows, focal_picked,
                  "ptbxl_af train step: 1 call at (16, 2)",
                  bound_by=focal_picked[0]["bound_by"],
                  backward=(by_path("fused_focal_loss_backward"),
                            focal_picked,
                            "ptbxl_af train step: 1 call at (16, 2)")),
    ]
    kernels[1]["layout_sweep"] = fusion_sweep
    kernels[2]["cluster_sweep"] = focal_sweep
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
