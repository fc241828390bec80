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
     the focal forward's cluster sweep, the SE forward alone in bf16
     (the frozen signal encoder's form) at the fusion presets' B=16 and
     bench.py's B=256, and the shapes of the batched request program: the
     SE forward in f32 at B = 2 ... 16, the fusion forward at b, 8b and
     32b rows and its backward at 8b (IG) and 32b (SHAP) rows, up to 512;
     and the XAI path's shapes: the SE forward in f32 at B=32, the fusion
     forward alone at 205,000 rows (LIME) and forward and input backward
     at 13,120 rows (gradient SHAP); and the self-attention kernels
     (`ops/attention`, no TPU counterpart) at the `physionet_transformer`
     step's (B, T, D) = (8, 3000, 128), 4 heads, dropout 0.1, against the
     unfused path with the same draws: the forward, and the forward
     without autograd in train and eval mode, equal to the bit, the
     softmax pass equal to torch.softmax to the bit, every gradient
     within 2e-5 in relative norm, one forward and one backward launch,
     and device times against the FFMA bounds;
  4. the slice: `ServingPipeline.demo(device="cuda")` (full-width
     canonical model, 224x224 images, 2476-sample signals, seeded random
     weights) answers 8 requests with the full ResultScreen contract, the
     kernels' launch counters (forward and backward) prove the requests
     ran through them, and 2 requests match the same pipeline on the CPU
     with the card's TF32 flags at torch's defaults (the request program
     turns TF32 off itself);
  9. (run after phase 4, before phases 5 and 8) the request's host
     kernels (`ecgmm_torch/native/*.cpp`, built by g++ in phase 2 beside
     nvcc; the build prints the machine's `uname -m`, its core count and
     the zlib link): each against its plain version on the committed
     fixtures (decoded by the port), the scene's served crop and seeded
     noise, bit-equal (darkness map, column and row maxima, gridness at
     pool 1 and 2, valid mask, CAM overlay, resize), the centroid within
     1e-3 px and the hospital filter within 1e-9 of scipy; the served
     digitizer's waveform of each fixture and the JPEG heatmap of the
     strip against the SHA-256 of the JAX package's native result and of
     Pillow's bytes (`serve/fixtures/host_kernels_sha256.json`); the PNG
     decodes to its overlay; each host stage of a request (digitize,
     filter, resize, overlay, PNG, JPEG, report), native and plain, on the
     strip and the scene, with 1 and 16 threads calling at once (host
     clock), and a `host_kernels` JSON line;
  5. numbers: request latency;
  8. (run after phase 5) the front end: the upload decoder turns the
     committed fixtures (JPEG: baseline, arithmetic-coded sequential and
     progressive, lossless, block-smoothed progressive; WebP: lossy, VP8X
     with EXIF, lossless, animated; TIFF: YCbCr 2x2 JPEG-in-TIFF, Group 4,
     tiled LZW with predictor 2; PPM) into Pillow's bytes (SHA-256) and
     refuses the arithmetic-coded strip Pillow refuses (past the 64 KiB
     it hands libjpeg at once), and each fixture's decode ms is printed
     beside the JPEG strip's; the HTTP server
     (`serve(ServingPipeline.demo(device="cuda"), port=0,
     background=True)`) with the micro-batcher on (20 ms window, buckets
     1-16) answers 16 client threads posting the hammer's JPEG, then the
     same strip as WebP, every response checked, with the launch counters
     equal to dispatches x (3 SE forwards, 3 fusion forwards, 2 fusion
     backwards), then one request posting the strip as JPEG-in-TIFF
     (checked, one dispatch of the plan), coalescence above 1 in /stats
     and /metrics parsed; a
     b=16 dispatch matches the CPU with TF32 at torch's defaults (and a
     TF32 control is read); requests/s and p50/p90 at 1, 4 and 16 clients
     batched and unbatched, device ms per bucket, the busy share; a drain
     with 16 requests in flight loses none;
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
     LSTM alone with cuDNN's TF32 off and on; 3 `physionet_transformer`
     train steps as `run()` takes them (dropout live), the attention
     counters zeroed before them reading 2 forwards and 2 backwards a
     step and no fallback; `run()` trains `ptbxl_af`
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
     keys, the TensorBoard event file beside each metrics.jsonl has valid
     TFRecord CRCs and one scalar event per logged value (parsed here,
     `check_event_file`), and the launch counters equal the batch plan;
     `run_pipeline`
     (one epoch a stage, 96 records, cached) warm-starts stage 4 from
     each stage's best under the three filters, and its launches equal
     each stage's plan;
  10. (run after phase 6) the XAI batch path at full width
     (`run_xai_phase`): shap, deep_shap and lime reports of the `fusion`
     preset's float32 model over 2048 synthetic records, Grad-CAM and
     TabNet-mask reports, Grad-CAM of the standalone ResNet-18 and
     ResNet1D-SE; launches against the plan, the CSV contract, the PNGs
     decoded, the first 16 test rows against the CPU, per-method wall and
     CUDA-event times;
  11. (run after phase 10) the real-data path (`run_real_data_phase`):
     a hospital directory (256 patients: labels.xlsx, clinical.csv,
     ecg_signals.csv at 2476 samples, 2500x250 strips, three of them CMYK
     JPEG, three known-missing patients without a folder), a PTB-XL
     layout (512 records, 12 leads, 5000 samples at 500 Hz, format 16)
     and a CinC 2017 layout (256 v4 MAT records behind 16+24 headers),
     written with numpy and the native JPEG encoder; `load_data` of each
     timed (host ms); `fusion`, `ptbxl_af` and `physionet_multi` trained
     one epoch each through `python -m ecgmm_torch.workloads.run
     --data-dir`, three subprocesses at once, launches against each batch
     plan, the
     checkpoints, reports and PNGs checked; then the hospital directory
     through `--split-cache` under a 1 MiB `ECGMM_HBM_BUDGET_BYTES`, the
     splits streamed from the memory-mapped cache in chunks of 4 batches:
     saved, reopened, each run's per-step losses and final parameters
     against a resident run's (bit-equal expected, above 1e-6 fails), a
     changed fingerprint refused; streamed and resident step times and
     busy shares;
  12. (run after phase 11) the CV path (`run_cv_phase`): the fold-axis
     kernels (`fused_se` at (4*16, C, T) for the three SE widths,
     `fused_attention_fusion` at 15*16 and 90*16 rows of D = 672,
     `fused_focal_loss` at (4*16, 2)) against loops over folds of their
     plain versions with phase 3's bars, forward and backward, times and
     bounds; the fold program (`cv_parallel.run_fold_parallel`) against
     each fold's sequential fit with JAX's tests/test_cv_parallel.py bars
     in float32 at full width: (a) `signal_only` at B = 16, 4 folds of a
     2x2 nested split, the last with a NaN val split; (b) raw `fusion`
     (224 x 224 images, frozen train-mode encoders), 4 folds; (c)
     `fusion` over cached embeddings, the 15 folds of nested 5x3; the
     launches of each against its plan (each kernel once per vmapped op,
     never once per fold); `python -m ecgmm_torch.train.cv` nested,
     nested --fold-parallel --cache-embeddings, exhaustive --k 10
     --max-pairs 10 --fold-parallel --cache-embeddings and cross --pth in four
     subprocesses at once (finite summaries, wall times); the peak memory
     of raw `fusion` and `signal_only` waves at two wave sizes and the
     rows cap it gives;
  13. (run after phase 12) parallel (`run_parallel_phase`): torchrun,
     data and tensor parallelism, mesh serving, the fold program over the
     data axis, each rank's launches against its plan;
  14. (run after phase 13) the AOT bundle and the tools
     (`run_bundle_phase`): (a) the full-width demo pipeline exported with
     `serve/export.export_bundle` for the card (b = 1 and bucket 8) and
     the CPU (b = 1; trace, export and save seconds, bytes, each saved
     program's `ecgmm.*` nodes against the serving plan); (b)
     `ServingPipeline.from_exported(device="cuda")` answers 8 requests,
     interleaved with the live pipeline, each answer within
     tests/test_export.py's bars of the live one, the launch counters up
     by the plan at every dispatch, the request split of both; (c) the
     HTTP server on the bundle, 16 clients batched over bucket 8, the
     launches equal to the dispatches times the plan, a response against
     the unbatched bundle's, `--n-data 2 --bundle` refused; (d) the CPU
     program against the live CPU pipeline; (e) `train/profiler.trace`
     around a warm-up and 3 counted `ptbxl_af` steps at B=16,
     `tools/trace_report`'s kernel launches of the counted steps equal
     to the counters, the memory stats; (f) a checkpoint through
     `convert_pth --export`, the import direction and the codec back to
     a bit-equal state dict,
     `cv cross --ckpt x.msgpack`, `digitize_batch` over 8 strips and one
     rows-cap probe trial of 256 rows in a child process;
  7. numbers: train-step times (CUDA events) of `ptbxl_af` at B=16,
     `fusion` and `fusion_cached` (head steps, after a timed calibration
     and encoding of the train split) at B=16 and 256, `image_only` at
     B=16, `ptbxl_af` and `image_only` also with cuDNN's TF32 on,
     `physionet_transformer` at B=8 and `physionet_crnn` at B=16,
     samples/s, peak device memory, epoch time, the device's busy share
     and the top host ops (torch.profiler), and one `kernels` JSON line
     whose `launches_by_path` names every path driven (the attention
     kernels' entry: phase 3's times and phase 6's train-step launches).

The last line of standard output is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import csv
import dataclasses
import hashlib
import io
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ecgmm_torch import native  # noqa: E402
from ecgmm_torch.config import get_preset  # noqa: E402
from ecgmm_torch.data import (  # noqa: E402
    pipeline, preprocess, splits, synthetic)
from ecgmm_torch.data.sources import read_csv  # noqa: E402
from ecgmm_torch.data.synthetic import _render_strip  # noqa: E402
from ecgmm_torch.explain import run_xai  # noqa: E402
from ecgmm_torch.explain.deep_shap import explain_fusion_deep  # noqa: E402
from ecgmm_torch.explain.gradcam import (  # noqa: E402
    _jet_lut, grad_cam_fusion_image, grad_cam_image, grad_cam_signal,
    overlay_heatmap)
from ecgmm_torch.explain.lime_fusion import (  # noqa: E402
    draw_lime_noise, lime_tabular)
from ecgmm_torch.explain.shap_fusion import (  # noqa: E402
    draw_shap_samples, explain_fusion, modality_contributions)
from ecgmm_torch.explain.tabnet_masks import (  # noqa: E402
    CELL_H, STRIP_W, tabnet_masks, viridis_rgb)
from ecgmm_torch.models import (  # noqa: E402
    CRNN, ECGMultimodalModel, ResNet18, ResNet1DSE, TabNetEncoder)
from ecgmm_torch.models.crnn import GemmConv2d  # noqa: E402
from ecgmm_torch.models.layers import Dropout, flax_init_  # noqa: E402
from ecgmm_torch.ops import _ext, attention, fusion, se  # noqa: E402
from ecgmm_torch.ops import losses as focal  # noqa: E402
from ecgmm_torch.precision import no_tf32  # noqa: E402
from ecgmm_torch.serve import digitize  # noqa: E402
from ecgmm_torch.serve import http as serve_http  # noqa: E402
from ecgmm_torch.serve import pipeline as serve_pipeline  # noqa: E402
from ecgmm_torch.serve import request as request_host  # noqa: E402
from ecgmm_torch.serve.imdecode import (  # noqa: E402
    decode_image, decode_upload)
from ecgmm_torch.serve.wire import BadRequest  # noqa: E402
from ecgmm_torch.serve.pipeline import ServingPipeline  # noqa: E402
from ecgmm_torch.serve.report import rule_based_report  # noqa: E402
from ecgmm_torch.serve.wire import ENDPOINT  # noqa: E402
from ecgmm_torch.tools import fusion_rounding  # noqa: E402
from ecgmm_torch.tools import grad_precision as gp  # noqa: E402
from ecgmm_torch.tools import serve_hammer  # noqa: E402
from ecgmm_torch.tools.kernel_times import device_us, host_us  # noqa: E402
from ecgmm_torch.tools import convert_pth, digitize_batch  # noqa: E402
from ecgmm_torch.tools import trace_report  # noqa: E402
from ecgmm_torch.tools.weights import from_jax_resnet1d_se  # noqa: E402
from ecgmm_torch.serve import export as bundle_export_mod  # noqa: E402
from ecgmm_torch.train import profiler as train_profiler  # noqa: E402
from ecgmm_torch.train import (  # noqa: E402
    cv, cv_parallel, embed, engine)
from ecgmm_torch.train.checkpoint import CheckpointManager  # noqa: E402
from ecgmm_torch.train.optim import Optimizer  # noqa: E402
from ecgmm_torch.config import MeshConfig  # noqa: E402
from ecgmm_torch.parallel import collectives as par_collectives  # noqa: E402
from ecgmm_torch.parallel import launch as par_launch  # noqa: E402
from ecgmm_torch.parallel import mesh as par_mesh  # noqa: E402
from ecgmm_torch.parallel import tp as par_tp  # noqa: E402
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
# the micro-batcher's buckets: a dispatch of b requests runs the SE blocks
# at B=b, the fusion head's forward at b, 32*b (SHAP) and 8*b (IG) rows
# and its backward at 32*b and 8*b rows
SERVE_BUCKETS = (1, 2, 4, 8, 16)
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
# phase 10, the XAI batch path at `python -m ecgmm_torch.explain.run_xai`'s
# full width: the fusion preset in float32 over 2048 synthetic records,
# whose 8:1:1 split holds 1638 train and 205 test rows; 64 SHAP draws and
# 1000 LIME perturbations a test row, the first 16 test rows also on the
# CPU
XAI_N_SYNTH = 2048
XAI_TEST_ROWS = 205
XAI_SHAP_SAMPLES = 64
XAI_CPU_ROWS = 16
XAI_LIME_ROWS = XAI_TEST_ROWS * run_xai.LIME_SAMPLES
XAI_SHAP_ROWS = XAI_TEST_ROWS * XAI_SHAP_SAMPLES
XAI_EMBED_B = 32  # compute_embeddings' batch
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
    six inputs (through the backward kernels) against plain autograd
    (`_fusion_grads_agree`)."""
    bw, flops = peaks
    rows = []
    eps = 1e-5
    cases = [(b, dims) for b in (1, 8, 16, 32, 256) for dims in FUSION_DIMS]
    # b, 8b and 32b rows for the buckets b of SERVE_BUCKETS, at D=672, and
    # the XAI path's SHAP forward (64 draws of each of 205 test rows)
    cases += [(b, FUSION_DIMS[0])
              for b in (2, 4, 64, 128, 512, XAI_SHAP_ROWS)]
    for b, dims in cases:
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
        grad_err = _fusion_grads_agree(f"fusion B={b} D={d}", g_kernel,
                                       g_ref, ins, eps)
        with torch.no_grad():
            fused = torch.cat([ref_sw[i] * ins[i] for i in range(3)], -1)
            nbytes = 4 * (2 * b * d + 2 * d + 6)
            rows.append({
                "B": b, "D": d, "max_abs_err": err, "sw_err": sw_err,
                "stats_err": stats_err, "grad_err": grad_err,
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


def _fusion_grads_agree(where, g_kernel, g_plain, ins, eps):
    """The kernels' gradients of sum(out**2) w.r.t. the six inputs: `img`,
    `sig`, `clin`, `scale` and `bias` against plain autograd in float32 on
    the card (rtol 1e-5 / atol 1e-4 elementwise); `weights` against
    float64 (plain autograd on the CPU) within 1e-4 + 1e-6 * S, S the size
    of the terms its sums cancel (`tools/fusion_rounding.py`). Float32
    rounding, the kernel's and plain autograd's alike, stays near 1e-7 * S
    (PERF.md section 6), while a row left out or summed twice moves the
    gradient by that row's own sum. Returns, per gradient, the max abs
    errors (kernel vs plain, kernel vs float64, plain vs float64) and S."""
    g64, s_sw = fusion_rounding.float64_grads(ins, eps)
    errs = {}
    for name, ga, gb, g in zip(FUSION_GRADS, g_kernel, g_plain, g64):
        diff = (ga - gb).abs()
        k64 = (ga.cpu().double() - g).abs()
        errs[name] = (diff.max().item(), k64.max().item(),
                      (gb.cpu().double() - g).abs().max().item())
        if name == "weights":
            errs["weights_S"] = s_sw
            bad = (k64 > 1e-4 + 1e-6 * s_sw).any()
        else:
            bad = (diff > 1e-4 + 1e-5 * gb.abs()).any()
        if bad:
            raise AssertionError(
                f"{where}: grad {name} max err (vs plain, kernel vs "
                f"float64, plain vs float64) {errs[name]}")
    return errs


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
] + [(b, dims, "all", ALL6) for dims in FUSION_DIMS for b in (16, 256)] + [
    # the batched request program: SHAP at 32*b and IG at 8*b rows for the
    # buckets b = 2, 4, 8, 16
    (32 * b, FUSION_DIMS[0], "shap", FROZEN) for b in SERVE_BUCKETS[1:]
] + [(8 * b, FUSION_DIMS[0], "ig", (False, False, True, False, False, False))
     for b in SERVE_BUCKETS[1:]] + [
    # the XAI path's gradient SHAP: 64 draws of each of 205 test rows
    (XAI_SHAP_ROWS, FUSION_DIMS[0], "shap", FROZEN)]


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


def check_se_serving(gen, peaks):
    """fused_se in float32, forward only, at the serving widths for the
    micro-batcher's buckets above 1 (B = 2 ... 16), as a batched dispatch
    of the request program runs it (`se_row`)."""
    return [se_row(gen, b, t, c, torch.float32, peaks, backward=False)
            for b in SERVE_BUCKETS[1:] for t, c in SE_SHAPES]


def check_se_xai(gen, peaks):
    """fused_se in float32, forward only, at the XAI path's encoder batch
    (`run_xai.compute_embeddings`, B=32) at the three widths (`se_row`)."""
    return [se_row(gen, XAI_EMBED_B, t, c, torch.float32, peaks,
                   backward=False) for t, c in SE_SHAPES]


def check_fusion_lime(gen, peaks):
    """fused_attention_fusion's forward alone at the XAI path's LIME batch
    (1000 perturbations of each of 205 test rows, D=672, no autograd): the
    values against the plain version (atol 1e-5), the soft weights to the
    bit, three more launches bit-identical; device times of the kernel,
    the plain version and `F.layer_norm` of the scaled concat (the
    library yardstick) beside the bound."""
    bw, flops = peaks
    b, dims, eps = XAI_LIME_ROWS, FUSION_DIMS[0], 1e-5
    d = sum(dims)
    ins = [torch.randn(b, w, generator=gen) for w in dims] + [
        torch.randn(3, generator=gen), torch.randn(d, generator=gen) + 1,
        torch.randn(d, generator=gen)]
    ins = [t.cuda() for t in ins]
    with torch.no_grad():
        out, sw = fusion.fused_attention_fusion(*ins, eps=eps)
        ref, ref_sw = fusion.reference_attention_fusion(*ins, eps=eps)
        repeats = [fusion.fused_attention_fusion(*ins, eps=eps)
                   for _ in range(3)]
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        sw_err = (sw - ref_sw).abs().max().item()
        where = f"fusion forward B={b} D={d} (LIME)"
        if err > 1e-5 or sw_err != 0.0:
            raise AssertionError(f"{where}: value err {err}, sw err "
                                 f"{sw_err}")
        if not all(torch.equal(o, out) and torch.equal(w, sw)
                   for o, w in repeats):
            raise AssertionError(f"{where}: repeated launches differ")
        del ref, repeats
        fused = torch.cat([ref_sw[i] * ins[i] for i in range(3)], -1)
        nbytes = 4 * (2 * b * d + 2 * d + 6)
        row = {
            "B": b, "D": d, "max_abs_err": err, "sw_err": sw_err,
            "layout": fusion.layout(b, dims),
            "us": device_us(
                lambda: fusion.fused_attention_fusion(*ins, eps=eps)),
            "plain_us": device_us(
                lambda: fusion.reference_attention_fusion(*ins, eps=eps)),
            "bound_us": max(nbytes / bw, 9 * b * d / flops) * 1e6,
            "library_us": device_us(
                lambda: F.layer_norm(fused, (d,), ins[4], ins[5], eps)),
        }
    print(f"fused_attention_fusion {row}", flush=True)
    return [row]


ATTENTION_SHAPE = (8, 3000, 128, 4)  # B, T, D, heads: the Transformer step
ATTENTION_P = 0.1  # the preset's dropout
ATTENTION_BAR = 2e-5  # the transformer-train-b8 cell's grad_gap limit


def _norm_rel(a, b) -> float:
    """|a - b| / |b| in the Frobenius norm."""
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _attend(attn, x, fused):
    """`attn`'s attention of x through `ops/attention` (`_attend_fused`)
    or the unfused path (the routing held to it)."""
    if fused:
        return attn._attend_fused(x)
    reason = attention.unfused_reason
    attention.unfused_reason = lambda *_: "chip_smoke"
    try:
        return attn._attend(x)
    finally:
        attention.unfused_reason = reason


def _attention_pass(attn, x, gy, fused):
    """Output, the gradients of x and every parameter, and the dropout
    generator's state after a forward and backward of `attn` (seeded
    alike every call), fused or unfused (`_attend`)."""
    attn.dropout.generator = torch.Generator(x.device).manual_seed(11)
    attn.zero_grad()
    x = x.clone().requires_grad_(True)
    y = _attend(attn, x, fused)
    y.backward(gy)
    grads = {"x": x.grad, **{n: q.grad for n, q in attn.named_parameters()}}
    return y.detach(), grads, attn.dropout.generator.get_state()


def check_attention():
    """Phase 3: `ops/attention` (no TPU counterpart: the JAX package
    leaves flax's attention to XLA) at the `physionet_transformer` step's
    shape (B=8, T=3000, D=128, 4 heads), dropout 0.1, TF32 off, against
    the unfused path of `MultiHeadSelfAttention` on the same inputs with
    the dropout generator seeded alike: the same draws; the forward equal
    to the bit; every gradient (x, in_proj_*, out_proj) within the cell's
    grad_gap limit (2e-5) in relative norm; the forward without autograd,
    in train mode (the same mask) and in eval mode, equal to the bit;
    `softmax_drop` on the layer's own scores equal to torch.softmax, and
    to its dropout with the mask, to the bit (it copies the layout of
    torch's `cunn_SoftMaxForwardReg`, so a torch upgrade shows here); one
    forward and one backward launch, no fallback; then device times
    (`tools/kernel_times.attention_times`) against the FFMA bounds."""
    from ecgmm_torch.models.layers import MultiHeadSelfAttention
    from ecgmm_torch.tools.kernel_times import attention_times

    b, t, d, heads = ATTENTION_SHAPE
    p = ATTENTION_P
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(23)
    attn = flax_init_(MultiHeadSelfAttention(d, heads, p), gen)
    with torch.no_grad():  # non-zero biases, so their gradients count
        attn.in_proj_bias.normal_(generator=gen)
        attn.out_proj.bias.uniform_(-0.1, 0.1, generator=gen)
    attn = attn.to(dev).train()
    x = torch.randn(b, t, d, generator=gen).to(dev)
    gy = torch.randn(b, t, d, generator=gen).to(dev)
    failed = []
    with no_tf32():
        if attention.unfused_reason(x, attn) is not None:
            raise AssertionError("attention: the step's shape takes the "
                                 f"unfused path "
                                 f"({attention.unfused_reason(x, attn)})")
        counts = (attention.launches, attention.backward_launches,
                  attention.fallbacks)
        got = _attention_pass(attn, x, gy, fused=True)
        torch.cuda.synchronize()
        moved = (attention.launches - counts[0],
                 attention.backward_launches - counts[1],
                 attention.fallbacks - counts[2])
        want = _attention_pass(attn, x, gy, fused=False)
        if moved != (1, 1, 0):
            failed.append(f"launches, backward launches, fallbacks {moved} "
                          "!= (1, 1, 0)")
        if not torch.equal(got[2], want[2]):
            failed.append("the dropout generators' states differ")
        if not torch.equal(got[0], want[0]):
            failed.append("forward not equal to the bit: relative "
                          f"{_norm_rel(got[0], want[0]):.3g}")
        gaps = {n: _norm_rel(got[1][n], w) for n, w in want[1].items()}
        worst = max(gaps.items(), key=lambda kv: kv[1])
        if worst[1] >= ATTENTION_BAR:
            failed.append(f"gradient {worst[0]} {worst[1]:.3g} >= "
                          f"{ATTENTION_BAR}")
        attn.dropout.generator = torch.Generator(dev).manual_seed(11)
        with torch.no_grad():
            if not torch.equal(attn._attend_fused(x), want[0]):
                failed.append("the forward without autograd (train mode) "
                              "not equal to the bit")
            attn.eval()
            fused_eval = _attend(attn, x, True)
            plain_eval = _attend(attn, x, False)
            if not torch.equal(fused_eval, plain_eval):
                failed.append("the eval forward not equal to the bit: "
                              "relative "
                              f"{_norm_rel(fused_eval, plain_eval):.3g}")
            attn.train()
            q, k, _ = (attention._heads(z.contiguous(), heads)
                       for z in F.linear(x, attn.in_proj_weight,
                                         attn.in_proj_bias).chunk(3, -1))
            scores = torch.matmul(q / math.sqrt(q.shape[-1]),
                                  k.transpose(-1, -2)).contiguous()
            keep = torch.empty((1, 1, t, t), device=dev).bernoulli_(
                1 - p, generator=torch.Generator(dev).manual_seed(5))
            plain = torch.softmax(scores, dim=-1)
            mismatched = {}
            for label, bits, c, w in (
                    ("mask", attention.pack_keep(keep),
                     attention.drop_scale(p), plain * (keep / (1.0 - p))),
                    ("no_mask", None, 1.0, plain)):
                mine = scores.clone()
                attention._launch_softmax_drop(mine, bits, c)
                mismatched[label] = int((mine != w).sum())
                del mine
            del scores, plain
            if any(mismatched.values()):
                failed.append(f"softmax_drop against torch.softmax: "
                              f"{mismatched} elements differ")
        torch.cuda.empty_cache()
        times = attention_times(attention, torch.Generator().manual_seed(0))
    print(f"attention (B, T, D, heads) {ATTENTION_SHAPE} p={p}: forward "
          f"equal {torch.equal(got[0], want[0])}, gradient gaps "
          f"{json.dumps({n: float(f'{g:.3g}') for n, g in gaps.items()})} "
          f"(bar {ATTENTION_BAR}), softmax_drop mismatches {mismatched}, "
          f"launches {moved}; torch {torch.__version__}", flush=True)
    print(f"attention times, us: {json.dumps(times)}", flush=True)
    if failed:
        raise AssertionError(f"attention: {failed}")
    return {"gaps": gaps, "times": times, "launches": moved}


def attention_train_steps(n_steps: int = 3, n_synth: int = 48):
    """Phase 6h: the main path's `physionet_transformer` train steps on
    the card as `run()` takes them (B=8, T=3000, float32, TF32 off,
    dropout 0.1 live): the attention counters zeroed just before n_steps
    steps read 2 forwards and 2 backwards a step and no fallback."""
    cfg = get_preset("physionet_transformer")
    t = cfg.train
    train = train_run.load_data(cfg, "synthetic", n_synth,
                                device="cuda").train
    model, task, freeze = train_run.build_model_and_task(cfg, "cuda")
    state = create_state(model, t, train.n // t.batch_size, freeze=freeze)
    idx, mask = engine.epoch_indices(train.n, t.batch_size, shuffle=True,
                                     seed=t.seed, epoch=0)
    idx_d = torch.from_numpy(idx.astype(np.int64)).cuda()
    mask_d = torch.from_numpy(mask).cuda()
    attention.launches = attention.backward_launches = 0
    attention.fallbacks = 0
    for i in range(n_steps):
        engine.train_step(task, state, engine.gather_batch(
            train, idx_d[i], mask_d[i]))
    torch.cuda.synchronize()
    got = {"fused_self_attention": attention.launches,
           "fused_self_attention_backward": attention.backward_launches,
           "fallbacks": attention.fallbacks}
    want = {"fused_self_attention": 2 * n_steps,
            "fused_self_attention_backward": 2 * n_steps, "fallbacks": 0}
    print(f"physionet_transformer {n_steps} train steps, attention "
          f"launches {got}", flush=True)
    if got != want:
        raise AssertionError(f"physionet_transformer train steps: attention "
                             f"launches {got} != {want}")
    return got


def attention_summary(checked, steps):
    """The attention kernels' entry of the `kernels` line: device ms a
    call at the step's shape (forward, backward kernels, the softmax
    pass, packing), the plain version's and the FFMA bounds, the launches
    of phase 6h's train steps."""
    tm = checked["times"]
    return {
        "name": "fused_self_attention", "route": "cuda",
        "source": "ecgmm_torch/ops/csrc/attention.cu",
        "replaces": None,  # flax's attention under XLA, no Pallas kernel
        "launches": steps["fused_self_attention"],
        "bwd_launches": steps["fused_self_attention_backward"],
        "fallbacks": steps["fallbacks"],
        "max_rel_err": max(checked["gaps"].values()),
        "ms": tm["exact_fwd_us"] / 1e3,
        "bwd_ms": tm["bwd_us"] / 1e3,
        "fwd_bwd_ms": (tm["exact_fwd_us"] + tm["bwd_us"]) / 1e3,
        "softmax_drop_ms": tm["softmax_drop_us"] / 1e3,
        "pack_ms": tm["pack_us"] / 1e3,
        "plain_ms": tm["plain_fwd_us"] / 1e3,
        "plain_fwd_bwd_ms": tm["plain_fwd_bwd_us"] / 1e3,
        "bound_ms": tm["bound_fwd_us"] / 1e3,
        "fwd_bwd_bound_ms": (tm["bound_fwd_us"] + tm["bound_bwd_us"]) / 1e3,
        "bound_by": "float32 FMAs at 67 TFLOP/s",
        "library_ms": None,
        "per": "physionet_transformer train step: 2 calls at "
               "(8, 4, 3000, 32), p = 0.1; the times are one call's",
        "launches_by_path": {"train_physionet_transformer_steps":
                             steps["fused_self_attention"]},
    }


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

    # the same weights on the CPU; the card's TF32 flags stay at torch's
    # defaults: the request program turns TF32 off itself
    print(f"TF32 flags while serving: cudnn {torch.backends.cudnn.allow_tf32}"
          f" matmul {torch.backends.cuda.matmul.allow_tf32}", flush=True)
    cpu_pipe = _cpu_twin(pipe)
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


def _cpu_twin(pipe):
    """The pipeline's weights and draws in a pipeline on the CPU."""
    cpu_model = ECGMultimodalModel(cfg=pipe.model.cfg)
    return ServingPipeline(
        cpu_model, {k: v.cpu() for k, v in pipe.model.state_dict().items()},
        background_embeddings=pipe.background.cpu().numpy(),
        signal_len=pipe.signal_len, img_hw=pipe.img_hw,
        temperature=pipe.temperature, device="cpu",
        shap_draws=(pipe.shap_bidx.cpu().numpy(),
                    pipe.shap_alphas.cpu().numpy()))


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ecgmm_torch", "serve", "fixtures")
HTTP_WINDOW_MS = 20.0
SERVE_PLAN = {"fused_se": 3, "fused_attention_fusion": 3,
              "fused_se_backward": 0, "fused_attention_fusion_backward": 2,
              "fused_focal_loss": 0, "fused_focal_loss_backward": 0}


WEBP_STRIP = os.path.join(FIXTURES, "strip_q80.webp")
TIFF_STRIP = os.path.join(FIXTURES, "strip_ycbcr22.tif")
# the uploads phase 8 posts one at a time: (launch path, file, what it is)
SINGLE_UPLOADS = (
    ("serve_http_tiff", TIFF_STRIP, "YCbCr 2x2 JPEG-in-TIFF"),
    ("serve_http_ojpeg", os.path.join(FIXTURES, "strip_ojpeg.tif"),
     "YCbCr 2x2 old-style JPEG TIFF"),
    ("serve_http_tga", os.path.join(FIXTURES, "strip.tga"),
     "run-length TGA"),
    ("serve_http_jp2", os.path.join(FIXTURES, "strip_layers.jp2"),
     "JPEG 2000, three reversible layers"),
    ("serve_http_jp2_97", os.path.join(FIXTURES, "strip_97.jp2"),
     "JPEG 2000, three irreversible 9/7 layers with the ICT"))


def check_decoder(smi):
    """The upload decoder where the script runs: each committed fixture
    (JPEG: baseline, arithmetic-coded sequential and progressive, lossless,
    block-smoothed progressive; WebP; TIFF: JPEG, Group 4, LZW, LZMA,
    ZSTD, word-aligned RLE, ThunderScan, old-style JPEG; PPM; TGA; QOI;
    PSD; DIB; ICO; CUR; JPEG 2000: the JP2 strip in reversible and in
    irreversible (9/7 and ICT) layers, a tiled PCRL
    codestream, a 9/7 codestream with code-block styles, an LA JP2)
    decodes to the SHA-256
    that Pillow's decode gave where the fixtures were made, and the one
    Pillow refuses (an arithmetic-coded scan past the 64 KiB Pillow hands
    libjpeg at once) is refused with BadRequest; decode time of the
    hammer's JPEG strip and of each other fixture (host clock, median of
    20). Returns
    {file: ms}."""
    with open(os.path.join(FIXTURES, "pillow_rgb_sha256.json")) as f:
        hashes = json.load(f)
    for name, want in hashes.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        if want.get("refused"):
            try:
                decode_upload(data)
            except BadRequest as e:
                print(f"decode {name} ({len(data)} bytes): refused as Pillow "
                      f"refuses it: {e}", flush=True)
                continue
            raise AssertionError(f"{name}: decoded, where Pillow refuses it "
                                 f"({want['refused']})")
        rgb = decode_upload(data)
        got = hashlib.sha256(rgb.tobytes()).hexdigest()
        print(f"decode {name}: {rgb.shape} sha256 {got}", flush=True)
        if list(rgb.shape) != want["shape"] or got != want["rgb_sha256"]:
            raise AssertionError(f"{name}: the decode differs from Pillow's "
                                 f"(sha256 {want['rgb_sha256']})")
    out = {}
    for name in ["strip.jpg"] + sorted(n for n in hashes if n != "strip.jpg"
                                       and n != "scene_exif6.jpg"
                                       and not hashes[n].get("refused")):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        times = []
        for _ in range(20):
            t = time.perf_counter()
            rgb = decode_upload(data)
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = statistics.median(times)
        print(f"decode {name} ({len(data)} bytes, {rgb.shape[0]}x"
              f"{rgb.shape[1]}): median {out[name]:.3f} ms (host clock; "
              f"{smi})", flush=True)
    return out


# ------------------------------------------------ the request's host kernels

HOST_FIXTURE = os.path.join(FIXTURES, "host_kernels_sha256.json")
# the served request's host stages: (stage, the native kernels it runs,
# their source, what they replace in the JAX package)
HOST_STAGES = (
    ("digitize", ("darkness_map", "colmax", "gridness", "trace_centroid"),
     "ecgmm_torch/native/digitize.cpp",
     "ecgmm_tpu/native/digitize.cpp:109,213,252,348"),
    ("filter", ("preprocess_hospital",), "ecgmm_torch/native/preprocess.cpp",
     "ecgmm_tpu/native/preprocess.cpp:130"),
    ("resize", ("resize_bilinear_u8",), "ecgmm_torch/native/resize.cpp",
     "ecgmm_tpu/serve/request.py:80 (Pillow's resize)"),
    ("overlay", ("cam_overlay",), "ecgmm_torch/native/heatmap.cpp",
     "ecgmm_tpu/native/heatmap.cpp:123"),
    ("png_encode", ("png_encode",), "ecgmm_torch/native/heatmap.cpp",
     "ecgmm_tpu/native/heatmap.cpp:175"),
    ("jpeg_encode", ("jpeg_encode",), "ecgmm_torch/native/jpegenc.cpp",
     "ecgmm_tpu/serve/request.py:150 (Pillow's JPEG save)"),
    ("report", (), "ecgmm_torch/serve/report.py (Python, no kernel)",
     "ecgmm_tpu/serve/report.py"),
)


def build_host_library(smi):
    """Phase 2's host half: the request's C++ kernels built by g++ (one
    process a source, beside nvcc's), and the machine they run on."""
    t0 = time.perf_counter()
    lib = native.library()
    print(f"built host library g++ {' '.join(native.FLAGS)} "
          f"{' '.join(native.LIBS)} {native._sources()} -> {lib._name} in "
          f"{time.perf_counter() - t0:.2f} s; uname -m {os.uname().machine},"
          f" nproc {os.cpu_count()}; zlib: linked (-lz; zlib.h and libz "
          f"found on this machine) ({smi})", flush=True)


def _same(where, got, want):
    if not np.array_equal(got, want):
        n = int(np.sum(np.asarray(got) != np.asarray(want))) \
            if np.shape(got) == np.shape(want) else -1
        raise AssertionError(f"{where}: the native kernel differs from its "
                             f"plain version ({n} elements)")


def _fixture_bytes(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _served_crop(img, info):
    if info["crop"] is None:
        return img
    y0, y1, x0, x1 = info["crop"]
    return np.ascontiguousarray(img[y0:y1, x0:x1])


def check_host_kernels():
    """Each host kernel against its plain version on the committed photos
    (decoded by the port), the scene's served crop and seeded noise; the
    served digitizer's waveform and the JPEG heatmap against the SHA-256
    of the JAX package's and Pillow's results
    (`host_kernels_sha256.json`, written by the CPU tests)."""
    with open(HOST_FIXTURE) as f:
        fixture = json.load(f)
    rng = np.random.default_rng(0)
    photos = {name: decode_upload(_fixture_bytes(name))
              for name in ("strip.jpg", "scene_exif6.jpg")}
    images = dict(photos, noise=rng.integers(0, 256, (300, 400, 3),
                                             dtype=np.uint8))
    lut = _jet_lut()
    worst = {"centroid_px": 0.0, "filter": 0.0}
    for name, img in images.items():
        rel, col_max, row_max = native.darkness_map(img)
        plain = digitize.darkness_map(img, impl="plain")
        _same(f"{name} darkness map", rel, plain)
        _same(f"{name} column maxima", col_max, plain.max(axis=0))
        _same(f"{name} row maxima", row_max, plain.max(axis=1))
        _same(f"{name} colmax", native.colmax(plain), plain.max(axis=0))
        _same(f"{name} gridness pool 1", native.gridness(img, 1, 32)[0],
              digitize.gridness_map(img, impl="plain"))
        g2, bright2 = native.gridness(img, 2, 16)
        pg2, pbright2 = digitize._grid_analysis(img, impl="plain")[:2]
        _same(f"{name} gridness pool 2", g2, pg2)
        _same(f"{name} pooled brightness", bright2, pbright2)
        c, v = digitize.extract_trace(img)
        pc, pv = digitize.extract_trace(img, impl="plain")
        _same(f"{name} valid mask", v, pv)
        err = float(np.abs(c - pc).max())
        worst["centroid_px"] = max(worst["centroid_px"], err)
        if err > 1e-3:
            raise AssertionError(f"{name}: centroid {err} px off the plain "
                                 "path (bar 1e-3)")
        cam = rng.uniform(0, 1, (7, 7)).astype(np.float32)
        _same(f"{name} cam overlay", native.cam_overlay(img, cam, lut),
              overlay_heatmap(img, request_host.resize_bilinear_f32(
                  cam, img.shape[:2])))
        _same(f"{name} resize", native.resize_bilinear_u8(img, (224, 224)),
              request_host.resize_bilinear_u8(img, (224, 224)))
    signals = [rng.normal(size=(4, 2476)).astype(np.float32)]
    for name, img in photos.items():
        mv, info = digitize.digitize_lead2_info(img, target_len=2476)
        want = fixture["digitize"][name]
        got = hashlib.sha256(mv.tobytes()).hexdigest()
        print(f"served digitizer {name}: {info} mv sha256 {got}", flush=True)
        if got != want["mv_sha256"] or info != want["info"]:
            raise AssertionError(f"{name}: the served waveform differs from "
                                 "the JAX package's native digitizer's")
        pmv = digitize.digitize_lead2_info(img, target_len=2476,
                                           impl="plain")[0]
        print(f"  plain digitizer against it: max |d mv| "
              f"{float(np.abs(mv - pmv).max()):.3g}", flush=True)
        crop = _served_crop(img, info)
        _same(f"{name} crop resize",
              native.resize_bilinear_u8(crop, (224, 224)),
              request_host.resize_bilinear_u8(crop, (224, 224)))
        signals.append(mv[None])
    for x in signals:
        err = float(np.abs(native.preprocess_hospital(x) - preprocess
                           .hospital_filter(x, impl="plain")).max())
        worst["filter"] = max(worst["filter"], err)
        if err > 1e-9:
            raise AssertionError(f"hospital filter {err} off scipy (1e-9)")
    strip = photos["strip.jpg"]
    cam = np.random.default_rng(
        fixture["jpeg_heatmap"]["cam_seed"]).uniform(0, 1, (7, 7)).astype(
            np.float32)
    overlay = native.cam_overlay(strip, cam, lut)
    _same("png round trip", decode_upload(native.png_encode(overlay)),
          overlay)
    for where, data in (
            ("jpeg_encode", native.jpeg_encode(overlay)),
            ("render_heatmap", base64.b64decode(request_host.render_heatmap(
                strip, cam, "jpeg")[0]))):
        if hashlib.sha256(data).hexdigest() != \
                fixture["jpeg_heatmap"]["sha256"]:
            raise AssertionError(f"{where}: the JPEG heatmap is not Pillow's "
                                 "bytes")
    print(f"host kernels meet their plain versions: maps, maxima, masks, "
          f"overlays and resizes bit-equal; centroid within "
          f"{worst['centroid_px']:.3g} px (bar 1e-3), filter within "
          f"{worst['filter']:.3g} (bar 1e-9); the served waveforms and the "
          f"JPEG heatmap meet their SHA-256; the PNG decodes to the "
          f"overlay", flush=True)


def _host_stages(img):
    """Each stage of one served request's host work on a photo, native and
    plain (None where the port has no plain version: the JPEG encoder's is
    Pillow's, absent here), and the kernel calls a request makes."""
    mv, info = digitize.digitize_lead2_info(img, target_len=2476)
    crop = _served_crop(img, info)
    sig = mv[None]
    cam = np.random.default_rng(0).uniform(0, 1, (7, 7)).astype(np.float32)
    lut = _jet_lut()
    overlay = native.cam_overlay(crop, cam, lut)

    def report():
        return rule_based_report(mv, abnormal=True, probability=0.7,
                                 age=60.0, sex=None)

    return {
        "digitize": (
            lambda: digitize.digitize_lead2_info(img, target_len=2476),
            lambda: digitize.digitize_lead2_info(img, target_len=2476,
                                                 impl="plain")),
        "filter": (lambda: preprocess.preprocess_hospital(sig),
                   lambda: preprocess.preprocess_hospital(sig, impl="plain")),
        "resize": (lambda: native.resize_bilinear_u8(crop, (224, 224)),
                   lambda: request_host.resize_bilinear_u8(crop, (224, 224))),
        "overlay": (lambda: native.cam_overlay(crop, cam, lut),
                    lambda: overlay_heatmap(
                        crop, request_host.resize_bilinear_f32(
                            cam, crop.shape[:2]))),
        "png_encode": (lambda: native.png_encode(overlay, 1),
                       lambda: request_host.encode_png(overlay, 1)),
        "jpeg_encode": (lambda: native.jpeg_encode(overlay), None),
        "report": (report, report),
    }


def _kernel_calls(img):
    """The native kernel calls of one served request's host work on img
    (prepare_inputs and a png and a jpeg render), by kernel."""
    names = [k for _, ks, _, _ in HOST_STAGES for k in ks]
    counts = dict.fromkeys(names, 0)
    saved = {k: getattr(native, k) for k in names}

    def counted(k):
        def call(*args, **kwargs):
            counts[k] += 1
            return saved[k](*args, **kwargs)
        return call

    pipe = type("HostOnly", (), {"signal_len": 2476, "ecg_scaler": None,
                                 "img_hw": (224, 224), "n_clin": 2,
                                 "clinical_scaler": None})()
    cam = np.zeros((7, 7), np.float32)
    try:
        for k in names:
            setattr(native, k, counted(k))
        crop = request_host.prepare_inputs(pipe, img, {"age": 60})[-1]
        request_host.render_heatmap(crop, cam, "png")
        request_host.render_heatmap(crop, cam, "jpeg")
    finally:
        for k, fn in saved.items():
            setattr(native, k, fn)
    return counts


def _time_1(fn, n):
    fn()  # warm: first-touch pages, coefficient tables
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _time_16(fn, reps):
    """16 threads calling fn reps times each, all at once: (median ms per
    call, wall ms per call = wall / calls)."""
    lat = []
    lock = threading.Lock()
    start = threading.Barrier(16)

    def worker():
        start.wait()
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            with lock:
                lat.append((time.perf_counter() - t) * 1e3)

    threads = [threading.Thread(target=worker) for _ in range(16)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise AssertionError("a host-stage thread did not finish")
    wall = (time.perf_counter() - t0) * 1e3
    return statistics.median(lat), wall / len(lat)


def time_host_stages(smi):
    """Each host stage of the served request, native and plain, on the
    strip and the scene (host clock): the median of single calls, and the
    median latency and wall time a call with 16 threads calling at once.
    Returns the host-kernel entries of the JSON line."""
    photos = {"strip": decode_upload(_fixture_bytes("strip.jpg")),
              "scene": decode_upload(_fixture_bytes("scene_exif6.jpg"))}
    calls = {name: _kernel_calls(img) for name, img in photos.items()}
    print(f"native kernel calls per request (prepare_inputs and a png and "
          f"a jpeg heatmap): {json.dumps(calls)}", flush=True)
    rows = {stage: {} for stage, *_ in HOST_STAGES}
    for name, img in photos.items():
        for stage, (nat, plain) in _host_stages(img).items():
            row = rows[stage]
            row[f"native_ms_{name}"] = _time_1(nat, 9)
            row[f"native_ms_16_{name}"], row[f"native_wall_ms_16_{name}"] = \
                _time_16(nat, 4)
            if plain is None:
                row[f"plain_ms_{name}"] = None
                row[f"plain_ms_16_{name}"] = row[
                    f"plain_wall_ms_16_{name}"] = None
            else:
                row[f"plain_ms_{name}"] = _time_1(plain, 5)
                row[f"plain_ms_16_{name}"], row[
                    f"plain_wall_ms_16_{name}"] = _time_16(plain, 2)

            def fmt(v):
                return "n/a" if v is None else f"{v:.3f}"

            print(f"host stage {stage} on the {name} ({img.shape[0]}x"
                  f"{img.shape[1]}): native {fmt(row[f'native_ms_{name}'])} "
                  f"ms, 16 threads p50 "
                  f"{fmt(row[f'native_ms_16_{name}'])} ms (wall "
                  f"{fmt(row[f'native_wall_ms_16_{name}'])} ms/call); plain "
                  f"{fmt(row[f'plain_ms_{name}'])} ms, 16 threads p50 "
                  f"{fmt(row[f'plain_ms_16_{name}'])} ms (wall "
                  f"{fmt(row[f'plain_wall_ms_16_{name}'])} ms/call) "
                  f"(host clock; {smi})", flush=True)
    entries = []
    for stage, kernels, source, replaces in HOST_STAGES:
        entries.append({
            "name": stage, "kernels": list(kernels), "source": source,
            "replaces": replaces,
            "calls_per_request": {name: {k: calls[name][k] for k in kernels}
                                  for name in photos},
            "threads_per_call": "up to 8" if kernels else "1",
            **rows[stage]})
    return entries


def compare_batched_with_cpu(pipe, cpu_pipe):
    """A b=16 dispatch of 16 distinct requests on the card against the
    same pipeline on the CPU, with the card's TF32 flags at torch's
    defaults, within phase 4's bars (probability and CAM 1e-3, feature
    importance 0.5 points, label equal); then the same dispatch with the
    request program's TF32 section taken out (the parent's served path) as
    a control, which must miss at least one of those bars: else the
    comparison could not tell whether the section takes effect."""
    rows = []
    for img, q, _ in make_requests(16, seed=3):
        img_norm, sig, clin = request_host.prepare_inputs(pipe, img, q)[:3]
        rows.append((img_norm[0].transpose(2, 0, 1), sig[0], clin[0]))
    ins = [np.stack([r[i] for r in rows]) for i in range(3)]
    want, _ = cpu_pipe._dispatch(*ins)

    def errors(got):
        p_err = cam_err = fi_err = 0.0
        flips = 0
        for g, w in zip(got, want):
            gp, gpred, gcam, gattr, gca = pipe._unpack(g)
            wp, wpred, wcam, wattr, wca = pipe._unpack(w)
            flips += gpred != wpred
            p_err = max(p_err, float(np.abs(gp - wp).max()))
            cam_err = max(cam_err, float(np.abs(gcam - wcam).max()))
            fi_err = max(fi_err, float(np.abs(
                _importance(pipe, gattr, gca)
                - _importance(pipe, wattr, wca)).max()))
        return {"pred_flips": int(flips), "prob_err": p_err,
                "cam_err": cam_err, "importance_err_pp": fi_err}

    def within_bars(e):
        return not e["pred_flips"] and e["prob_err"] <= 1e-3 \
            and e["cam_err"] <= 1e-3 and e["importance_err_pp"] <= 0.5

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    got, _ = pipe._dispatch(*ins)
    off = errors(got)
    print(f"batched b=16 card vs cpu, TF32 flags {flags} (torch's "
          f"defaults): {off}", flush=True)
    if not within_bars(off):
        raise AssertionError("batched GPU and CPU answers disagree")
    # the control: the parent's served path, cuDNN's TF32 at its default
    saved = serve_pipeline.no_tf32
    serve_pipeline.no_tf32 = contextlib.nullcontext
    try:
        torch.backends.cudnn.allow_tf32 = True
        control = errors(pipe._dispatch(*ins)[0])
    finally:
        serve_pipeline.no_tf32 = saved
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    print(f"TF32 control (the request program without its TF32 section, "
          f"cudnn TF32 on) b=16 card vs cpu: {control}", flush=True)
    if within_bars(control):
        raise AssertionError(
            "the TF32 control meets the bars: the comparison cannot tell "
            "whether the request program turns TF32 off")
    return off, control


def _importance(pipe, attr, ca):
    """The response's four feature-importance percentages."""
    contrib = modality_contributions(attr, pipe.dims)
    share = np.abs(ca) / max(float(np.abs(ca).sum()), 1e-30)
    clin = float(contrib["Clinical_%"][0])
    return np.array([float(contrib["Image_%"][0]),
                     float(contrib["Signal_%"][0]),
                     clin * share[0], clin * share[1]])


def bucket_device_ms(pipe, smi):
    """The request program's device ms per bucket (CUDA events around
    `_predict_many`, median of 5 after one warm-up)."""
    out = {}
    for b in SERVE_BUCKETS:
        zeros = pipe._zeros(b)
        pipe._dispatch(*zeros)
        out[b] = statistics.median(pipe._dispatch(*zeros)[1]
                                   for _ in range(5))
    print(f"device ms per dispatch by bucket: {out} ({smi})", flush=True)
    return out


def hammer_window(url, clients, seconds, pipe,
                  photo=serve_hammer.STRIP_JPEG):
    """`serve_hammer.hammer` (uploads of `photo`) with every response
    checked against the contract, and the dispatches' device ms summed
    over the window."""
    spans = []
    inner = pipe._dispatch

    def timed(*args):
        rows, ms = inner(*args)
        spans.append(ms)
        return rows, ms

    pipe._dispatch = timed
    try:
        t = time.perf_counter()
        res = serve_hammer.hammer(
            url, clients, seconds,
            on_response=lambda b: check_response(json.loads(b), "png"),
            photo=photo)
        wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        del pipe._dispatch
    res["device_program_share"] = sum(spans) / wall_ms
    res["dispatches"] = len(spans)
    if res["errors"]:
        raise AssertionError(f"{res['errors']} requests failed: {res}")
    return res


def profiled_busy(url, clients, seconds, smi):
    """The device's busy share under `clients` hammering clients: the
    kernels' and copies' device time (torch.profiler) over the window's
    wall time, and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        res = serve_hammer.hammer(url, clients, seconds)
        wall_ms = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0.0:
        print("front end busy share: not measured (the profiler saw no "
              "device time)", flush=True)
        return None
    share = busy_ms / wall_ms
    print(f"front end busy share, {clients} clients batched: {share:.4f} "
          f"({busy_ms:.3f} ms busy over {wall_ms:.3f} ms, "
          f"{res['requests']} requests, profiled; {smi})", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}", flush=True)
    return share


def drain_in_flight(pipe, n=16):
    """A graceful shutdown with n requests in flight loses none: n
    connections send all but the last bytes of an upload, the drain
    fires (the accept loop exits), then the rest arrives and every one of
    them is answered 200 before server_close() returns."""
    import socket

    httpd = serve_http.GracefulHTTPServer(("127.0.0.1", 0),
                                          serve_http.make_handler(pipe))
    loop = threading.Thread(target=httpd.serve_forever)
    loop.start()
    body, ctype = serve_hammer.request_body("png")
    head = (f"POST {ENDPOINT} HTTP/1.1\r\nHost: t\r\nContent-Type: {ctype}"
            f"\r\nContent-Length: {len(body)}\r\n\r\n").encode()
    socks = [socket.create_connection(("127.0.0.1", httpd.server_address[1]),
                                      timeout=120) for _ in range(n)]
    try:
        for s in socks:
            s.sendall(head + body[:-64])
        time.sleep(0.5)
        threading.Thread(target=httpd.shutdown, daemon=True).start()
        loop.join(timeout=30)
        if loop.is_alive():
            raise AssertionError("the accept loop did not stop")
        codes = []
        for s in socks:
            s.sendall(body[-64:])
        for s in socks:
            chunks = []
            while True:
                c = s.recv(1 << 16)
                if not c:
                    break
                chunks.append(c)
            raw = b"".join(chunks)
            codes.append(raw[:12])
            if raw.startswith(b"HTTP/1.0 200"):
                check_response(json.loads(raw.split(b"\r\n\r\n", 1)[1]),
                               "png")
    finally:
        for s in socks:
            s.close()
        httpd.server_close()
    ok = sum(c.startswith(b"HTTP/1.0 200") for c in codes)
    print(f"graceful drain: {ok} of {n} in-flight requests answered 200",
          flush=True)
    if ok != n:
        raise AssertionError(f"the drain lost requests: {codes}")


def run_front_end(smi):
    """Phase 8: the serving front end on the card. The decoder's
    fixtures; `serve(ServingPipeline.demo(device="cuda"), port=0,
    background=True)` with the micro-batcher on (window 20 ms, buckets
    1-16) under 16 client threads posting the hammer's JPEG, then the
    same strip as WebP, every response checked, with the launch counters
    equal to dispatches times the plan (3 SE forwards, 3 fusion forwards,
    2 fusion backwards); one request each posting the strip as YCbCr 2x2
    JPEG-in-TIFF, as old-style JPEG TIFF, as TGA and as a JPEG 2000 JP2
    (5/3, and 9/7 with the ICT), checked, each one dispatch of the plan; /stats and /metrics; a b=16 dispatch against the
    CPU; requests/s and latency at 1, 4 and 16 clients batched and
    unbatched; device ms per bucket; the drain. Returns the launches of
    the two batched HTTP runs by path."""
    decode_ms = check_decoder(smi)
    pipe = ServingPipeline.demo(device="cuda", seed=0)
    pipe.enable_batching(HTTP_WINDOW_MS, max_batch=max(SERVE_BUCKETS),
                         buckets=SERVE_BUCKETS)
    pipe.warmup()
    pipe.warmup_batched()
    httpd = serve_http.serve(pipe, port=0, background=True)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    url = base + ENDPOINT
    try:
        before = pipe.stats()["batching"]["dispatches"]
        _zero_launch_counts()
        res16 = hammer_window(url, 16, 6.0, pipe)
        launches = _launch_counts()
        stats = json.load(urllib.request.urlopen(base + "/stats",
                                                 timeout=60))
        dispatches = stats["batching"]["dispatches"] - before
        print(f"http batched 16 clients: {res16['requests']} requests in "
              f"{dispatches} dispatches, launches {launches}, /stats "
              f"batching {stats['batching']}", flush=True)
        if launches != {k: n * dispatches for k, n in SERVE_PLAN.items()}:
            raise AssertionError("the batched front end did not run through "
                                 "the kernels' plan per dispatch")
        if not stats["batching"]["mean_coalescence"] > 1:
            raise AssertionError("16 clients did not coalesce")
        m = serve_hammer._scrape_metrics(base)
        if m["ecgmm_batching_enabled"] != 1 or \
                m["ecgmm_request_latency_seconds_count"] != stats["requests"] \
                or "ecgmm_live_buffer_bytes" not in m:
            raise AssertionError(f"/metrics does not agree with /stats: {m}")
        print(f"/metrics: {m}", flush=True)
        before = pipe.stats()["batching"]["dispatches"]
        _zero_launch_counts()
        webp16 = hammer_window(url, 16, 4.0, pipe, photo=WEBP_STRIP)
        webp_launches = _launch_counts()
        webp_dispatches = pipe.stats()["batching"]["dispatches"] - before
        print(f"http batched 16 clients posting {os.path.basename(WEBP_STRIP)}"
              f": {webp16['requests']} requests in {webp_dispatches} "
              f"dispatches, launches {webp_launches}, "
              f"{webp16['req_per_sec']:.3f} req/s, p50 "
              f"{webp16['latency_median_ms']:.3f} ms ({smi})", flush=True)
        if webp_launches != {k: n * webp_dispatches
                             for k, n in SERVE_PLAN.items()}:
            raise AssertionError("the WebP uploads did not run through the "
                                 "kernels' plan per dispatch")
        single = {}
        for path, photo, what in SINGLE_UPLOADS:
            before = pipe.stats()["batching"]["dispatches"]
            _zero_launch_counts()
            body, ctype = serve_hammer.request_body(photo=photo)
            t = time.perf_counter()
            resp = json.loads(serve_hammer._post(url, body, ctype))
            ms = (time.perf_counter() - t) * 1e3
            check_response(resp, "png")
            single[path] = (_launch_counts(), ms)
            dispatched = pipe.stats()["batching"]["dispatches"] - before
            print(f"http posting {os.path.basename(photo)} ({what}): "
                  f"{ms:.3f} ms, {dispatched} dispatch, launches "
                  f"{single[path][0]}, label {resp['label']} p "
                  f"{resp['probability']:.4f} ({smi})", flush=True)
            if dispatched != 1 or single[path][0] != SERVE_PLAN:
                raise AssertionError(f"the {what} upload did not run "
                                     "through the kernels' plan in one "
                                     "dispatch")
        busy = profiled_busy(url, 16, 2.0, smi)
        cpu_pipe = _cpu_twin(pipe)
        tf32 = compare_batched_with_cpu(pipe, cpu_pipe)
        served = {"batched": {16: res16}, "unbatched": {}}
        for clients in (1, 4):
            served["batched"][clients] = hammer_window(url, clients, 4.0,
                                                       pipe)
        pipe.close_batching()
        for clients in (1, 4, 16):
            served["unbatched"][clients] = hammer_window(url, clients, 4.0,
                                                         pipe)
        for mode, by_clients in served.items():
            for clients, r in sorted(by_clients.items()):
                print(f"served {mode} {clients} clients: "
                      f"{r['req_per_sec']:.3f} req/s, p50 "
                      f"{r['latency_median_ms']:.3f} ms, p90 "
                      f"{r['latency_p90_ms']:.3f} ms, device-program share "
                      f"{r['device_program_share']:.3f} ({r['requests']} "
                      f"requests, {r['dispatches']} dispatches; {smi})",
                      flush=True)
        device_ms = bucket_device_ms(pipe, smi)
        pipe.enable_batching(HTTP_WINDOW_MS, max_batch=max(SERVE_BUCKETS),
                             buckets=SERVE_BUCKETS)
        drain_in_flight(pipe)
    finally:
        httpd.shutdown()
        httpd.server_close()
        pipe.close_batching()
    print(json.dumps({"front_end": {
        "device": smi, "decode_ms": decode_ms, "busy_share_16": busy,
        "single_request_ms": {p: v[1] for p, v in single.items()},
        "webp_batched_16": {k: webp16[k] for k in (
            "req_per_sec", "latency_median_ms", "latency_p90_ms",
            "device_program_share", "requests", "dispatches")},
        "bucket_device_ms": device_ms, "tf32_off": tf32[0],
        "tf32_control": tf32[1],
        "served": {mode: {c: {k: r[k] for k in (
            "req_per_sec", "latency_median_ms", "latency_p90_ms",
            "device_program_share", "requests", "dispatches")}
            for c, r in by.items()} for mode, by in served.items()}}}),
        flush=True)
    return {"serve_http_batched": launches, "serve_http_webp": webp_launches,
            **{p: v[0] for p, v in single.items()}}


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
    for m in (focal, se, fusion):
        m.launches = m.backward_launches = 0
        m.fold_launches = m.fold_backward_launches = 0


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
    train = train_run.load_data(cfg, "synthetic", n_synth, device="cpu").train
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
    train = train_run.load_data(cfg, "synthetic", n_synth, device="cpu").train
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
    train = train_run.load_data(cfg, "synthetic", n_synth, device="cpu").train
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
    train = train_run.load_data(cfg, "synthetic", n_synth, device="cpu").train
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
    train = train_run.load_data(cfg, "synthetic", n_synth, device="cpu").train
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


def launch_plan(name: str, t, data, epochs: int) -> dict:
    """The kernels' launches of `run()` of preset `name` over `data` for
    `epochs` epochs, from the batch plan."""
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
        return {"fused_focal_loss": 0, "fused_se": 3 * (calib + enc),
                "fused_attention_fusion": calib + n_fwd,
                "fused_focal_loss_backward": 0, "fused_se_backward": 0,
                "fused_attention_fusion_backward": steps}
    if name == "image_only":  # ResNet-18 alone: no kernel of the port
        return dict(NO_LAUNCHES)
    if name in train_run.FUSION_FAMILIES:
        # the fusion head forward and its backward (all six gradients) at
        # every step; the frozen signal encoder runs no SE backward
        return {"fused_focal_loss": 0, "fused_se": 3 * n_fwd,
                "fused_attention_fusion": n_fwd,
                "fused_focal_loss_backward": 0, "fused_se_backward": 0,
                "fused_attention_fusion_backward": steps}
    # the SE and focal backwards run at every train step
    se = 0 if name in NO_SE else 3
    return {"fused_focal_loss": n_fwd, "fused_se": se * n_fwd,
            "fused_attention_fusion": 0,
            "fused_focal_loss_backward": steps,
            "fused_se_backward": se * steps,
            "fused_attention_fusion_backward": 0}


def _crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c ^= b
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
    return c ^ 0xFFFFFFFF


def _masked_crc32c(data: bytes) -> int:
    c = _crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _proto_fields(buf: bytes):
    """(field, wire type, value) of a protobuf message: varints as ints,
    fixed64/fixed32 as their 8/4 bytes, length-delimited as bytes."""
    pos, out = 0, []
    while pos < len(buf):
        key, shift = 0, 0
        while True:
            b = buf[pos]
            pos += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                break
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, shift = 0, 0
            while True:
                b = buf[pos]
                pos += 1
                val |= (b & 0x7F) << shift
                shift += 7
                if b < 0x80:
                    break
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            val, pos = buf[pos:pos + n], pos + n
        elif wire == 2:
            n, shift = 0, 0
            while True:
                b = buf[pos]
                pos += 1
                n |= (b & 0x7F) << shift
                shift += 7
                if b < 0x80:
                    break
            val, pos = buf[pos:pos + n], pos + n
        else:
            raise AssertionError(f"protobuf wire type {wire}")
        out.append((field, wire, val))
    return out


def check_event_file(log_dir: str, logged) -> None:
    """The run's TensorBoard event file (`events.out.tfevents.*` beside
    metrics.jsonl), read with this script's own TFRecord and protobuf
    parsing: every record's length and data CRC-32C (masked) hold, the
    first event is the file version, and the scalar events are, in order,
    each metrics.jsonl line's values (tag, step, float32 value)."""
    names = [n for n in os.listdir(log_dir)
             if n.startswith("events.out.tfevents.")]
    if len(names) != 1:
        raise AssertionError(f"{log_dir}: {len(names)} event files")
    with open(os.path.join(log_dir, names[0]), "rb") as f:
        data = f.read()
    events, pos = [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        body = data[pos + 12:pos + 12 + n]
        if struct.unpack("<I", data[pos + 8:pos + 12])[0] != \
                _masked_crc32c(header) or struct.unpack(
                    "<I", data[pos + 12 + n:pos + 16 + n])[0] != \
                _masked_crc32c(body):
            raise AssertionError(f"{names[0]}: bad CRC at byte {pos}")
        events.append(_proto_fields(body))
        pos += 16 + n
    if not any(f == 3 and v == b"brain.Event:2" for f, _, v in events[0]):
        raise AssertionError(f"{names[0]}: no file version first")
    got = []
    for ev in events[1:]:
        step = next((v for f, _, v in ev if f == 2), 0)
        for f, _, summary in ev:
            if f != 5:
                continue
            for _, _, value in _proto_fields(summary):
                fields = {vf: vv for vf, _, vv in _proto_fields(value)}
                got.append((fields[1].decode(), step,
                            np.frombuffer(fields[2], "<f4")[0]))
    with np.errstate(over="ignore"):  # float32, as the writer rounds
        want = [(k, rec["step"], np.float32(v)) for rec in logged
                for k, v in rec.items() if k not in ("step", "time")]
    if len(got) != len(want) or any(
            (a[0], a[1]) != (b[0], b[1]) or not (
                a[2] == b[2] or (np.isnan(a[2]) and np.isnan(b[2])))
            for a, b in zip(got, want)):
        raise AssertionError(f"{names[0]}: scalar events {got[:4]}... do not "
                             f"match metrics.jsonl {want[:4]}...")
    print(f"{names[0]}: {len(events)} records, CRCs valid, {len(got)} scalar "
          f"events = the metrics.jsonl values", flush=True)


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
    data = train_run.load_data(cfg, "synthetic", n_synth, device="cuda")
    nb = {s: pipeline.num_batches(getattr(data, s).n, t.batch_size)
          for s in ("train", "val", "test")}
    want = launch_plan(name, t, data, epochs)
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
    check_event_file(os.path.dirname(log_path), logged)
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
    data = train_run.load_data(cfg, "synthetic", n_synth, device="cuda")
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
    data = train_run.load_data(cfg, "synthetic", n_synth, device="cuda")
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


def _rows(arrays, n, device):
    """The split's first n rows on `device`."""
    return arrays._replace(
        indices=arrays.indices[:n],
        **{f: getattr(arrays, f)[:n].to(device)
           for f in ("images", "signals", "clinical", "labels")})


def _close(where, got, want, rel, atol=0.0):
    """|got - want| <= rel * max|want| + atol elementwise; returns the max
    abs error."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    bar = rel * float(np.abs(want).max()) + atol
    if not err <= bar:
        raise AssertionError(f"{where}: max err {err} above {bar}")
    return err


def _check_csvs(out_dir, method, test, frames):
    """Each class's CSV: the contract columns, one row per test sample in
    the split's order, each row summing to 100 within 1e-3, read back
    equal to the returned columns."""
    for c, frame in frames.items():
        path = os.path.join(out_dir, method,
                            f"fusion_{method}_fusion_class{c}.csv")
        with open(path, newline="") as f:
            header, *rows = list(csv.reader(f))
        if tuple(header) != run_xai.CSV_COLUMNS:
            raise AssertionError(f"{path}: columns {header}")
        vals = np.array(rows, np.float64)
        if vals.shape != (test.n, 4) or not np.array_equal(
                vals[:, 0], test.indices):
            raise AssertionError(f"{path}: rows {vals.shape}")
        sums = vals[:, 1:].sum(1)
        if np.abs(sums - 100.0).max() > 1e-3:
            raise AssertionError(f"{path}: row sums {sums.min()} "
                                 f"{sums.max()}")
        for k, col in zip(run_xai.CSV_COLUMNS[1:], vals[:, 1:].T):
            want = np.asarray(frame[k])  # written in its own float type
            if not np.array_equal(col.astype(want.dtype), want):
                raise AssertionError(f"{path}: {k} differs from the report")


def _timed(fn):
    """(fn(), wall ms, CUDA-event ms) of one call on the card."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def run_xai_phase(smi):
    """Phase 10: the XAI batch path (`ecgmm_torch.explain.run_xai`) on the
    card at its full width: the `fusion` preset's model in float32 from
    the seeded init, 2048 synthetic records (1638 train, 205 test rows),
    64 SHAP draws and 1000 LIME perturbations a test row. Each method runs
    twice through its report entry point (the second pass warm), with the
    launch counters set to 0 just before and read just after each and
    held to the plan: 3 SE forwards per encoded batch of 32 (train and
    test), and shap 2 fusion forwards and 2 input backwards (a class
    each, 13,120 rows), lime 1 fusion forward (205,000 rows, both classes
    from one set of perturbations), deep_shap none (plain ops, as in
    JAX), gradcam and tabnet_masks none. The CSVs hold the contract; the
    Grad-CAM PNGs decode (the port's decoder) to the overlays of the
    card's CAMs; the four mask PNGs decode to the masks' viridis strips.
    Grad-CAM of the standalone ResNet-18 (224x224) and ResNet1D-SE (base
    64, 2476 samples) runs at B=4. Then the same functions on the CPU, on
    the same weights, embeddings, background and draws, for the first 16
    test rows; bars: embeddings atol 1e-4; SHAP and Deep-SHAP attributions
    and LIME coefficients 1e-4 of the largest |value| + 1e-6; percentages
    atol 1e-3 points; CAMs atol 1e-3 (phase 4's) and logits 1e-4; masks
    1e-5. Returns the launches of every call on the card."""
    cfg = run_xai.xai_config()
    dims = (cfg.model.image_dim, cfg.model.signal_dim,
            cfg.model.clinical_dim)
    d = sum(dims)
    data = train_run.load_data(cfg, "synthetic", XAI_N_SYNTH, device="cuda")
    train, test = data.train, data.test
    if test.n != XAI_TEST_ROWS:
        raise AssertionError(f"xai: {test.n} test rows, phase 3 timed "
                             f"{XAI_TEST_ROWS}")
    model = run_xai.xai_model(cfg, "cuda")
    cpu_model = copy.deepcopy(model).cpu()
    labels = train.labels.cpu().numpy()
    n_bg = len(run_xai.class_balanced_background(
        np.zeros((train.n, 1)), labels))
    draws = {
        "shap": {c: draw_shap_samples(test.n, XAI_SHAP_SAMPLES, n_bg,
                                      torch.Generator().manual_seed(c))
                 for c in range(2)},
        "deep_shap": None,
        "lime": draw_lime_noise(test.n, run_xai.LIME_SAMPLES, d,
                                torch.Generator().manual_seed(0)),
    }
    batches = (-(-train.n // XAI_EMBED_B)) + (-(-test.n // XAI_EMBED_B))
    encode = {"fused_se": 3 * batches}
    plan = {
        "shap": {**encode, "fused_attention_fusion": 2,
                 "fused_attention_fusion_backward": 2},
        "deep_shap": encode,
        "lime": {**encode, "fused_attention_fusion": 1},
        "gradcam": {}, "tabnet_masks": {},
        "grad_cam_image": {}, "grad_cam_signal": {"fused_se": 3},
    }
    total = dict(NO_LAUNCHES)
    times, attrs, frames = {}, {}, {}

    def counted(name, fn):
        _zero_launch_counts()
        out, wall, event = _timed(fn)
        got = _launch_counts()
        want = {**NO_LAUNCHES, **plan[name]}
        if got != want:
            raise AssertionError(f"xai {name}: launches {got}, plan {want}")
        for k, n in got.items():
            total[k] += n
        times.setdefault(name, []).append(
            {"wall_ms": wall, "event_ms": event})
        return out

    with tempfile.TemporaryDirectory() as out_dir:
        for method in ("shap", "deep_shap", "lime"):
            for _ in range(2):
                torch.cuda.reset_peak_memory_stats()
                frames[method], attrs[method] = counted(
                    method, lambda: run_xai.xai_report(
                        model, train, test, dims, method=method,
                        out_dir=out_dir, n_samples=XAI_SHAP_SAMPLES,
                        draws=draws[method], return_attributions=True))
                times[method][-1]["peak_gb"] = \
                    torch.cuda.max_memory_allocated() / 1e9
            _check_csvs(out_dir, method, test, frames[method])
        cam_paths = counted("gradcam", lambda: run_xai.gradcam_report(
            model, test, out_dir))
        mask_paths = counted("tabnet_masks",
                             lambda: run_xai.tabnet_masks_report(
                                 model, test, out_dir))
        pngs = {p: open(p, "rb").read() for p in cam_paths + mask_paths}

    # the standalone encoders' Grad-CAM at full width, B=4
    gen = torch.Generator().manual_seed(10)
    resnet = ResNet18(num_classes=2)
    flax_init_(resnet, gen)
    signal_model = ResNet1DSE(num_classes=2)
    flax_init_(signal_model, gen)
    imgs = torch.randint(0, 256, (4, 3, 224, 224), generator=gen,
                         dtype=torch.uint8)
    sigs = torch.randn(4, cfg.data.signal_len, generator=gen)
    standalone = {}
    with no_tf32():
        for name, fn, net, x in (("grad_cam_image", grad_cam_image, resnet,
                                  imgs),
                                 ("grad_cam_signal", grad_cam_signal,
                                  signal_model, sigs)):
            on_card = copy.deepcopy(net).cuda().eval()
            card = counted(name, lambda: fn(on_card, x.cuda()))
            standalone[name] = (card, fn(net.eval(), x))
    print(f"xai launches on the card ({smi}): {total}", flush=True)
    for name, runs in times.items():
        print(f"xai {name} ({smi}): {json.dumps(runs)}", flush=True)

    # the same functions on the CPU for the first rows, on the card's
    # embeddings, background and draws
    k = XAI_CPU_ROWS
    errs = {}
    with no_tf32():
        emb_train = run_xai.compute_embeddings(model, train)
        emb_test = run_xai.compute_embeddings(model, test)
        cpu_test = _rows(test, k, "cpu")
        errs["embeddings"] = _close(
            "xai embeddings", run_xai.compute_embeddings(cpu_model, cpu_test),
            emb_test[:k], 0.0, 1e-4)
        bg = run_xai.class_balanced_background(emb_train, labels)
        shap_draws = {c: tuple(a[:k] for a in draws["shap"][c])
                      for c in range(2)}
        cpu = {
            "shap": explain_fusion(cpu_model, emb_test[:k], bg, dims,
                                   n_samples=XAI_SHAP_SAMPLES,
                                   draws=shap_draws,
                                   return_attributions=True),
            "deep_shap": explain_fusion_deep(cpu_model, emb_test[:k], bg,
                                             dims, return_attributions=True),
        }
        std = torch.as_tensor(emb_train.std(axis=0) + 1e-8)

        def predict(e):
            return torch.softmax(cpu_model.fuse_embeddings(
                e[:, :dims[0]], e[:, dims[0]:dims[0] + dims[1]],
                e[:, dims[0] + dims[1]:]), dim=-1)

        with torch.no_grad():
            coefs = lime_tabular(predict, torch.as_tensor(emb_test[:k]),
                                 std, (0, 1), noise=draws["lime"][:k])
        lime_attrs = {c: coefs[c].numpy() for c in range(2)}
        cpu["lime"] = ({c: modality_contributions(a, dims)
                        for c, a in lime_attrs.items()}, lime_attrs)
        for method, (contrib, attr) in cpu.items():
            for c in range(2):
                where = f"xai {method} class {c}"
                errs[f"{method}_attr_{c}"] = _close(
                    where, attr[c], attrs[method][c][:k], 1e-4, 1e-6)
                errs[f"{method}_pct_{c}"] = max(_close(
                    f"{where} {key}", contrib[c][key],
                    frames[method][c][key][:k], 0.0, 1e-3)
                    for key in run_xai.CSV_COLUMNS[1:])

        # Grad-CAM through the fusion image branch: the card's CAMs against
        # the CPU's, and the PNGs against the overlays of the card's CAMs
        n_cam = len(cam_paths)
        cam, logits = grad_cam_fusion_image(model, test.images[:n_cam])
        cpu_cam, cpu_logits = grad_cam_fusion_image(
            cpu_model, test.images[:n_cam].cpu())
        errs["gradcam_cam"] = _close("xai gradcam CAM", cam.cpu(), cpu_cam,
                                     0.0, 1e-3)
        errs["gradcam_logits"] = _close("xai gradcam logits", logits.cpu(),
                                        cpu_logits, 0.0, 1e-4)
        imgs_u8 = test.images[:n_cam].permute(0, 2, 3, 1).cpu().numpy()
        preds = logits.argmax(-1).cpu().numpy()
        for i, path in enumerate(cam_paths):
            if os.path.basename(path) != (f"sample{test.indices[i]}_class"
                                          f"{preds[i]}.png"):
                raise AssertionError(f"xai gradcam: {path}")
            want = overlay_heatmap(imgs_u8[i], cam[i].cpu().numpy())
            if not np.array_equal(decode_upload(pngs[path]), want):
                raise AssertionError(f"xai gradcam: {path} does not decode "
                                     "to its overlay")
        for name, ((c_cam, c_logits), (p_cam, p_logits)) in \
                standalone.items():
            errs[f"{name}_cam"] = _close(f"xai {name} CAM", c_cam.cpu(),
                                         p_cam, 0.0, 1e-3)
            errs[f"{name}_logits"] = _close(f"xai {name} logits",
                                            c_logits.cpu(), p_logits, 0.0,
                                            1e-4)

        # TabNet masks: the card's against the CPU's; each PNG is the
        # strip of its mask row
        m_explain, masks = tabnet_masks(model.clinical_encoder,
                                        test.clinical)
        cpu_explain, cpu_masks = tabnet_masks(cpu_model.clinical_encoder,
                                              test.clinical.cpu())
        errs["tabnet_masks"] = max(
            _close("xai tabnet mask", a, b, 0.0, 1e-5)
            for a, b in zip([m_explain] + masks, [cpu_explain] + cpu_masks))
        rows = [m.mean(0) for m in masks]
        rows.append(np.mean(rows, axis=0))
        names = [f"mask_M[{i + 1}].png" for i in range(len(masks))]
        if [os.path.basename(p) for p in mask_paths] != names + [
                "mask_M_agg.png"]:
            raise AssertionError(f"xai tabnet_masks: {mask_paths}")
        for path, row in zip(mask_paths, rows):
            pix = decode_upload(pngs[path])
            w = max(8, STRIP_W // len(row))
            want = np.repeat(viridis_rgb(row), w, axis=0)[None]
            if pix.shape != (CELL_H, len(row) * w, 3) or not (
                    pix == want).all():
                raise AssertionError(f"xai tabnet_masks: {path}")
    print(f"xai card vs CPU, first {k} test rows ({smi}): "
          f"{json.dumps(errs)}", flush=True)
    return total


def summarize(name, source, replaces, launches_by_path, rows, picked, per,
              bound_by="bytes", backward=None, fold=None):
    """One kernel's entry of the `kernels` line: the times are the sum
    over the calls that `per` names (the `picked` rows); `launches` is the
    sum over the main paths this script drove, the fold-axis launches of
    the CV paths included. `backward`, for a kernel with a backward
    kernel, is (backward launches by path, the rows of the calls that run
    it, what those calls are): `fwd_bwd_ms` and its bound sum forward plus
    backward over those calls. `fold` is (fold-axis forward launches by
    path, backward launches by path, the fold-axis rows of phase 12)."""
    lib = [r["library_us"] for r in picked]
    fold_fwd = sum(fold[0].values()) if fold else 0
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(launches_by_path.values()) + fold_fwd,
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
    if fold is not None:
        fwd_paths, bwd_paths, fold_rows = fold
        entry.update({
            "fold_launches": fold_fwd,
            "fold_bwd_launches": sum(bwd_paths.values()),
            "fold_launches_by_path": fwd_paths,
            "fold_bwd_launches_by_path": bwd_paths,
            "fold_shapes": fold_rows,
        })
    return entry


# phase 11, the real-data path: record directories written here at the
# reference's sizes (a hospital directory of 256 patients with 2500x250
# lead-II strips and 2476-sample signals; 512 PTB-XL records of 12 leads,
# 5000 samples at 500 Hz; 256 CinC 2017 records of 9000 samples at 300
# Hz), each trained one epoch through the CLI at full width
REAL_HOSPITAL_N = 256
REAL_PTBXL_N = 512
REAL_CINC_N = 256
REAL_CMYK = (3, 4, 130)          # patients whose strips are CMYK JPEGs
REAL_ABSENT = (17, 43, 115)      # known-missing patients without a folder
REAL_CHUNK = 4                   # batches a streamed chunk holds
REAL_BUDGET = 1 << 20            # bytes: no split fits, all three stream
REAL_CLI = (("fusion", "hospital"), ("ptbxl_af", "ptbxl"),
            ("physionet_multi", "cinc"))
LAUNCH_MARK = "LAUNCHES "


def write_real_records(root: str, seed: int = 42) -> dict:
    """The three record layouts under `root`, written with numpy, scipy
    and the port's native JPEG encoder (`ecgmm_torch.tools.records`);
    returns their directories."""
    from ecgmm_torch.data.synthetic import make_cohort
    from ecgmm_torch.tools import records

    rng = np.random.default_rng(seed)
    dirs = {k: os.path.join(root, k) for k in ("hospital", "ptbxl", "cinc")}
    t0 = time.perf_counter()
    c = make_cohort(n=REAL_HOSPITAL_N, signal_len=2476, img_hw=None,
                    seed=seed)
    labels = np.where(c.labels == 1, "Abnormal", "Normal").astype(object)
    labels[np.arange(REAL_HOSPITAL_N) % 8 == 5] = "Borderline"
    images = {int(i): _render_strip(sig, 250, 2500)
              for i, sig in zip(c.indices, c.signals)
              if i not in REAL_ABSENT}
    records.write_hospital(dirs["hospital"], c.indices, labels, c.signals,
                           {"AGE": c.clinical[:, 0],
                            "Wt": c.clinical[:, 1]}, images,
                           cmyk=REAL_CMYK)
    t1 = time.perf_counter()
    p = make_cohort(n=REAL_PTBXL_N, signal_len=5000, img_hw=None,
                    seed=seed + 1)
    gains = rng.uniform(0.5, 1.5, (1, 1, 12))
    digital = np.clip(np.round(p.signals[:, :, None] * gains * 1000),
                      -32768, 32767).astype(np.int16)
    codes = [("{'SR': 100.0, 'NORM': 100.0}", "{'AFIB': 100.0}")[lab]
             if k % 7 else "{'NORM': 100.0}"
             for k, lab in enumerate(p.labels)]
    records.write_ptbxl(dirs["ptbxl"], digital, codes,
                        rng.uniform(20, 90, REAL_PTBXL_N),
                        rng.uniform(45, 110, REAL_PTBXL_N))
    t2 = time.perf_counter()
    q = make_cohort(n=REAL_CINC_N, signal_len=9000, img_hw=None,
                    seed=seed + 2)
    names = [f"A{k:05d}" for k in range(1, REAL_CINC_N + 1)]
    cinc_labels = [("N", "A", "O")[(lab + k) % 3] if k % 11 else "~"
                   for k, lab in enumerate(q.labels)]
    records.write_cinc2017(dirs["cinc"], names, cinc_labels,
                           np.clip(np.round(q.signals * 1000), -32768,
                                   32767).astype(np.int16))
    t3 = time.perf_counter()
    print(f"phase 11: wrote the hospital directory ({REAL_HOSPITAL_N} "
          f"patients, 250x2500 strips, {len(REAL_CMYK)} CMYK) in "
          f"{(t1 - t0) * 1e3:.1f} ms, PTB-XL ({REAL_PTBXL_N} records) in "
          f"{(t2 - t1) * 1e3:.1f} ms, CinC 2017 ({REAL_CINC_N} records) in "
          f"{(t3 - t2) * 1e3:.1f} ms (host)", flush=True)
    return dirs


def _real_cfg(name: str, directory: str, **train):
    cfg = get_preset(name)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, data_dir=directory,
                                      ptbxl_dir=directory,
                                      physionet_dir=directory),
        train=dataclasses.replace(cfg.train, num_epochs=1, **train))


def run_cli(argv, cwd: str):
    """`python -m ecgmm_torch.workloads.run ARGV` in a subprocess from
    `cwd`, with the launch counters set to 0 just before the CLI runs and
    read just after (printed by the subprocess). Returns the counts and
    the CLI's epoch and report lines."""
    repo = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import json, runpy, sys, torch\n"
        f"sys.path.insert(0, {repo!r})\n"
        "from ecgmm_torch.ops import fusion, se, losses\n"
        f"sys.argv = ['run'] + {list(argv)!r}\n"
        "for m in (fusion, se, losses):\n"
        "    m.launches = m.backward_launches = 0\n"
        "runpy.run_module('ecgmm_torch.workloads.run', run_name='__main__')\n"
        "torch.cuda.synchronize()\n"
        f"print({LAUNCH_MARK!r} + json.dumps({{\n"
        "    'fused_focal_loss': losses.launches,\n"
        "    'fused_se': se.launches,\n"
        "    'fused_attention_fusion': fusion.launches,\n"
        "    'fused_focal_loss_backward': losses.backward_launches,\n"
        "    'fused_se_backward': se.backward_launches,\n"
        "    'fused_attention_fusion_backward': fusion.backward_launches}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=cwd, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"the CLI {argv} failed:\n{out.stdout[-3000:]}"
                           f"\n{out.stderr[-6000:]}")
    lines = out.stdout.splitlines()
    shown = [line for line in lines
             if line.startswith(("epoch ", "[best]", "[last]", "streaming"))]
    counts = json.loads(next(line for line in lines
                             if line.startswith(LAUNCH_MARK))[
                                 len(LAUNCH_MARK):])
    return counts, shown


def _png_text(path: str) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    decode_image(data)  # a PNG the port's decoder reads
    out, pos = {}, 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"tEXt":
            key, value = data[pos + 8:pos + 8 + n].split(b"\0", 1)
            out[key.decode()] = value.decode("latin-1")
        pos += 12 + n
    return out


def check_cli_outputs(name: str, cwd: str, run_dir: str, test_n: int,
                      num_classes: int) -> None:
    """The run's checkpoints, metric log and reports: the text reports,
    the confusion PNGs whose counts sum to the test split, the ROC PNGs
    for two classes (points from (0, 0) to (1, 1))."""
    stamp = os.path.basename(run_dir)
    for f in ("best.pt", "last.pt", "calibration.pt"):
        if not os.path.isfile(os.path.join(run_dir, f)):
            raise AssertionError(f"{name}: checkpoint {f} missing")
    with open(os.path.join(cwd, "runs", stamp, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    if len(logged) != 1 or not np.isfinite(logged[0]["Loss/Train"]):
        raise AssertionError(f"{name}: bad metric log {logged}")
    out = os.path.join(cwd, "output", stamp)
    for tag in ("best", "last"):
        with open(os.path.join(out, f"report_{tag}.txt")) as f:
            report = json.loads(f.read().split("\n\n", 1)[1])
        if not REPORT_KEYS[name] - {"temperature", "test_ece",
                                    "test_ece_calibrated"} <= set(report):
            raise AssertionError(f"{name}: report_{tag} {report}")
        text = _png_text(os.path.join(out, f"confusion_{tag}.png"))
        counts = np.asarray(json.loads(text["counts"]))
        if counts.shape != (num_classes,) * 2 or counts.sum() != test_n:
            raise AssertionError(f"{name}: confusion_{tag} {counts}")
        roc = os.path.join(out, f"roc_{tag}.png")
        if (num_classes == 2) != os.path.isfile(roc):
            raise AssertionError(f"{name}: roc_{tag}.png for "
                                 f"{num_classes} classes")
        if num_classes == 2:
            text = _png_text(roc)
            fpr, tpr = json.loads(text["fpr"]), json.loads(text["tpr"])
            if len(fpr) != test_n or fpr[-1] != 1.0 or tpr[-1] != 1.0:
                raise AssertionError(f"{name}: roc_{tag} points")


def real_step_times(cfg, host_train, device_train, smi) -> dict:
    """Train-step time of one epoch over the hospital train split, streamed
    in chunks of REAL_CHUNK from the memory-mapped cache and resident on
    the card (CUDA events over the epoch after a warm one; a fresh state
    each), and the card's busy share over a profiled epoch of each."""
    from torch.profiler import ProfilerActivity, profile

    t = cfg.train
    out = {}
    for mode, split in (("streamed", host_train), ("resident", device_train)):
        model, task, freeze = train_run.build_model_and_task(cfg, "cuda")
        state = create_state(model, t, pipeline.num_batches(split.n,
                                                            t.batch_size),
                             freeze=freeze)

        def epoch(k):
            idx, mask = engine.epoch_indices(split.n, t.batch_size,
                                             shuffle=True, seed=t.seed,
                                             epoch=k)
            if mode == "streamed":
                batches = engine._chunk_batches(pipeline.prefetch_chunks(
                    split, idx, mask, REAL_CHUNK, device="cuda"))
            else:
                idx_d, mask_d = engine._plan_on_device(idx, mask, "cuda")
                batches = (engine.gather_batch(split, idx_d[i], mask_d[i])
                           for i in range(idx.shape[0]))
            for b in batches:
                engine.train_step(task, state, b)
            return idx.shape[0]

        with no_tf32():
            epoch(0)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            steps = epoch(1)
            end.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                epoch(2)
                torch.cuda.synchronize()
                prof_wall = (time.perf_counter() - t1) * 1e3
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        out[mode] = {"ms_per_step": start.elapsed_time(end) / steps,
                     "wall_ms_per_step": wall / steps, "steps": steps,
                     "busy_share": busy / prof_wall if busy else None}
        how = (f"streamed in chunks of {REAL_CHUNK} batches"
               if mode == "streamed" else "resident")
        print(f"phase 11: fusion train step over the hospital split, "
              f"{how}: {json.dumps(out[mode])} ({smi})", flush=True)
    return out


def run_real_data_phase(smi: str) -> dict:
    """Phase 11: the real-data path on the card. Writes the three record
    layouts; times `load_data` of each (host ms); trains `fusion` on the
    hospital directory, `ptbxl_af` on PTB-XL and `physionet_multi` on CinC
    2017 for one epoch through the CLI at full width, three subprocesses
    at once, whose launches must each equal the batch plan; checks their
    checkpoints, reports and PNGs. Then, in this process, the hospital
    directory through `--split-cache` under a budget no split fits
    (ECGMM_HBM_BUDGET_BYTES) in chunks of REAL_CHUNK batches: the first
    run saves the cache, the second reopens it, and both streamed runs'
    per-step losses and final parameters must equal a resident run's
    (bit-equal expected; above 1e-6 fails); a cache asked for with a
    changed fingerprint is refused. Prints the streamed and resident step
    times and busy shares. Returns the launches by path."""
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = write_real_records(tmp)
        sizes = {}
        for name, layout in REAL_CLI:
            cfg = _real_cfg(name, dirs[layout])
            t0 = time.perf_counter()
            data = train_run.load_data(cfg, "hospital", 0, device="cuda")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            sizes[name] = (cfg, data)
            n = [getattr(data, s).n for s in ("train", "val", "test")]
            print(f"phase 11: load_data {layout} for {name}: {ms:.1f} ms "
                  f"(host, to the card), splits {n}, signals "
                  f"{tuple(data.train.signals.shape[1:])}", flush=True)
            if not all(torch.isfinite(getattr(data, s).signals).all()
                       for s in ("train", "val", "test")):
                raise AssertionError(f"{layout}: non-finite signals")
        hosp = sizes["fusion"][1]
        kept = set(np.concatenate([getattr(hosp, s).indices
                                   for s in ("train", "val", "test")]))
        if not set(REAL_CMYK) <= kept or kept & set(get_preset(
                "fusion").data.known_missing):
            raise AssertionError(f"hospital cohort {sorted(kept)}")
        if tuple(hosp.train.images.shape[1:]) != (3, 224, 224):
            raise AssertionError(f"images {hosp.train.images.shape}")

        # the three CLI runs at once, each a process of its own
        runs = {}

        def cli(name, layout):
            cwd = os.path.join(tmp, f"cli_{name}")
            os.makedirs(cwd)
            run_dir = os.path.join(cwd, "checkpoints", name)
            argv = ["--preset", name, "--data-dir", dirs[layout],
                    "--epochs", "1", "--run-dir", run_dir]
            if name == "fusion":
                argv[2:2] = ["--data", "hospital"]
            t0 = time.perf_counter()
            try:
                runs[name] = (argv, cwd, run_dir, *run_cli(argv, cwd),
                              time.perf_counter() - t0)
            except Exception as e:  # raised again below
                runs[name] = e

        workers = [threading.Thread(target=cli, args=pair)
                   for pair in REAL_CLI]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        for name, _ in REAL_CLI:
            if isinstance(runs[name], Exception):
                raise runs[name]
            argv, cwd, run_dir, got, shown, secs = runs[name]
            cfg, data = sizes[name]
            want = launch_plan(name, cfg.train, data, 1)
            print(f"phase 11: python -m ecgmm_torch.workloads.run "
                  f"{' '.join(argv)}: {secs:.1f} s (three CLI runs at "
                  f"once); launches {got} (batch plan {want})", flush=True)
            for line in shown:
                print(f"  {line}", flush=True)
            if got != want:
                raise AssertionError(f"{name}: launches {got} != {want}")
            check_cli_outputs(name, cwd, run_dir, data.test.n,
                              cfg.model.num_classes)
            launches[f"real_{name}"] = got
        del sizes

        launches["real_fusion_streamed"] = check_streaming(dirs, tmp, smi)
    return launches


def check_streaming(dirs, tmp, smi) -> dict:
    """Phase 11's streaming check (see `run_real_data_phase`)."""
    cache = os.path.join(tmp, "split_cache")
    base = ["--preset", "fusion", "--data", "hospital", "--data-dir",
            dirs["hospital"], "--epochs", "1", "--device", "cuda"]
    losses = {}
    real_step = engine.train_step

    def run_main(tag, argv, env):
        recorded = []

        def step(task, state, batch, *a):
            mets = real_step(task, state, batch, *a)
            recorded.append(mets["loss"].detach().clone())
            return mets

        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        engine.train_step = step
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                train_run.main(argv + ["--run-dir",
                                       os.path.join(tmp, "ckpt", tag)])
        finally:
            engine.train_step = real_step
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        losses[tag] = torch.stack(recorded).float().cpu()
        return buf.getvalue()

    stream_env = {"ECGMM_HBM_BUDGET_BYTES": str(REAL_BUDGET),
                  "ECGMM_STREAM_CHUNK_BATCHES": str(REAL_CHUNK)}
    torch.cuda.synchronize()
    _zero_launch_counts()
    first = run_main("streamed_saved", base + ["--split-cache", cache],
                     stream_env)
    torch.cuda.synchronize()
    launched = _launch_counts()
    cfg = _real_cfg("fusion", dirs["hospital"])
    host = pipeline.load_materialized(cache, device=None)
    want = launch_plan("fusion", cfg.train, host, 1)
    print(f"phase 11: fusion streamed from the split cache: launches "
          f"{launched} (batch plan {want})", flush=True)
    if launched != want:
        raise AssertionError(f"streamed fusion: launches {launched} != "
                             f"{want}")
    second = run_main("streamed_reopened", base + ["--split-cache", cache],
                      stream_env)
    resident = run_main("resident", base, {})
    for text, want in ((first, "saved materialized splits"),
                       (second, "reopened materialized splits"),
                       (first + second, f"streaming in chunks of "
                                        f"{REAL_CHUNK} batches")):
        if want not in text:
            raise AssertionError(f"streaming: '{want}' not printed")
    if "streaming" in resident:
        raise AssertionError("the resident run streamed")
    ref = CheckpointManager(os.path.join(tmp, "ckpt", "resident"))
    for tag in ("streamed_saved", "streamed_reopened"):
        if losses[tag].shape != losses["resident"].shape:
            raise AssertionError(f"{tag}: {losses[tag].shape[0]} steps, "
                                 f"resident {losses['resident'].shape[0]}")
        loss_diff = float((losses[tag] - losses["resident"]).abs().max())
        got = CheckpointManager(os.path.join(tmp, "ckpt", tag)).load(
            "last")["model"]
        want = ref.load("last")["model"]
        param_diff = max(float((got[k].double() - want[k].double()).abs()
                               .max()) if got[k].numel() else 0.0
                         for k in want)
        print(f"phase 11: {tag} against resident: {losses[tag].shape[0]} "
              f"step losses, largest difference {loss_diff!r}; final "
              f"parameters and buffers, largest difference {param_diff!r} "
              f"({'' if loss_diff == param_diff == 0 else 'not '}"
              "bit-equal)", flush=True)
        if loss_diff > 1e-6 or param_diff > 1e-6:
            raise AssertionError(f"{tag}: streamed run differs from the "
                                 f"resident one")
    try:
        train_run.main(base + ["--n-synth", "7", "--split-cache", cache])
    except ValueError as e:
        if "n_synth: cached=128 requested=7" not in str(e):
            raise
        print(f"phase 11: a changed fingerprint is refused: {e}", flush=True)
    else:
        raise AssertionError("a stale split cache was reopened")

    resident_train = pipeline.promote(host.train, "cuda")
    real_step_times(cfg, host.train, resident_train, smi)
    return launched


# ----------------------------------------------------------------- phase 12
# phase 12, the CV path (`python -m ecgmm_torch.train.cv`): the fold-axis
# kernels at the fold program's shapes against their plain versions (loops
# over folds of the phase-3 plain versions), the fold program against the
# sequential fits at full width on the card, the CLI, and the rows cap
CV_B = 16  # the CV presets' batch
CV_SIGNAL_FOLDS = 4  # the 2x2 nested split of configuration (a)
CV_FUSION_FOLDS = (15, 90)  # nested 5x3; exhaustive k = 10
CV_NAN_ROWS = 6  # the NaN val split of configuration (a)'s last fold
CV_CLI_N = 128  # the CLI's --n-synth
CV_WAVES = (2, 6)  # folds of the two raw waves whose peak memory is read
CV_N = 96  # records of configurations (a) and (b)
CV_SIGNAL_LEN = 2476  # the CV presets' full width
CV_IMG = (224, 224)
CV_DEVICE = "cuda"


def _fold_counts():
    return {"fused_se_fold": se.fold_launches,
            "fused_se_fold_backward": se.fold_backward_launches,
            "fused_attention_fusion_fold": fusion.fold_launches,
            "fused_attention_fusion_fold_backward":
                fusion.fold_backward_launches,
            "fused_focal_loss_fold": focal.fold_launches,
            "fused_focal_loss_fold_backward": focal.fold_backward_launches}


def _grads_within(where, got, want, bar):
    """Each gradient within bar * its largest component + 1e-6 (phase 3's
    bar for the SE backward, and for the fusion and focal ones where the
    reference is a closed form in float32)."""
    errs = {}
    for name, g, w in zip(("g%d" % i for i in range(len(got))), got, want):
        if g is None and w is None:
            continue
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        errs[name] = err / max(scale, 1e-30)
        if err > bar * scale + 1e-6:
            raise AssertionError(f"{where}: {name} err {err} (largest "
                                 f"component {scale})")
    return errs


# the plain fold-axis versions loop the plain op over the folds. At n=5
# the loops over 4 folds and the 15-fold fusion forward fit in the card's
# launch queue and read device time; the 15-fold fusion forward+backward
# and the 90-fold loops (up to ~150 ms a call) overflow it and read the
# host's pace. Two rounds of 5 keep those calls short.
PLAIN_FOLD_TIMING = {"n": 5, "rounds": 2}


def fold_se_row(gen, folds, t, c, peaks):
    """The fold-axis SE kernels at (folds * 16, C, T) with per-fold weights:
    the forward within phase 3's 1e-5, each gradient against autograd of
    the plain loop and against the closed form within 1e-5 of its largest
    component plus 1e-6, the backward bit-identical on three more
    launches; device times of the kernels and of the plain loop."""
    bw, flops = peaks
    b, r = folds * CV_B, max(1, c // 16)
    x = torch.randn(b, c, t, generator=gen).cuda()
    ws = [(torch.randn(folds, *s, generator=gen) * 0.1).cuda()
          for s in ((r, c), (r,), (c, r), (c,))]
    g = torch.randn(b, c, t, generator=gen).cuda()
    leaves = [a.clone().requires_grad_(True) for a in [x] + ws]
    out = se._FoldSE.apply(*leaves)[0]
    g_kernel = torch.autograd.grad(out, leaves, g)
    ref_leaves = [a.clone().requires_grad_(True) for a in [x] + ws]
    ref = se.reference_fold_se(*ref_leaves)
    g_auto = torch.autograd.grad(ref, ref_leaves, g)
    g_closed = se.reference_fold_se_backward([x] + ws, g)
    _, state = se._launch(x, *ws, folds=folds)

    def backward():
        return se.launch_backward(x, ws[0], ws[1], ws[2], state, g,
                                  folds=folds)

    repeats = [backward() for _ in range(3)]
    torch.cuda.synchronize()
    where = f"fused_se fold axis F={folds} T={t} C={c}"
    err = (out - ref).abs().max().item()
    if err > 1e-5:
        raise AssertionError(f"{where}: max err {err}")
    grad_err = {k: _grads_within(f"{where} vs {k}", g_kernel, want, 1e-5)
                for k, want in (("autograd", g_auto), ("closed", g_closed))}
    if not all(torch.equal(a, w) for rep in repeats
               for a, w in zip(rep, g_kernel)):
        raise AssertionError(f"{where}: repeated backward launches differ")
    n = x.numel()
    w_bytes = 4 * sum(w.numel() for w in ws)
    fwd_bytes = 8 * n + w_bytes + 8 * b * c
    bwd_bytes = 12 * n + 2 * w_bytes + 8 * b * c
    fwd_ops, bwd_ops = 2 * n + 4 * b * c * r, 4 * n + 8 * b * c * r

    def fwd_bwd(fn, lv):
        o = fn(*lv)
        return torch.autograd.grad(o, lv, g)

    row = {
        "F": folds, "B": CV_B, "T": t, "C": c, "max_abs_err": err,
        "grad_err_rel": grad_err,
        "k_fwd": se.cluster_size(b, c, t, r, 4),
        "us": device_us(lambda: se._launch(x, *ws, folds=folds)),
        "plain_us": device_us(lambda: se.reference_fold_se(x, *ws),
                              **PLAIN_FOLD_TIMING),
        "bwd_us": device_us(backward),
        "fwd_bwd_us": device_us(lambda: fwd_bwd(
            lambda *a: se._FoldSE.apply(*a)[0], leaves)),
        "plain_fwd_bwd_us": device_us(lambda: fwd_bwd(
            se.reference_fold_se, ref_leaves), **PLAIN_FOLD_TIMING),
        "bound_us": max(fwd_bytes / bw, fwd_ops / flops) * 1e6,
        "bwd_bound_us": max(bwd_bytes / bw, bwd_ops / flops) * 1e6,
        "bound_by": "bytes", "library_us": None,
    }
    row["fwd_bwd_bound_us"] = row["bound_us"] + row["bwd_bound_us"]
    print(f"{where} {row}", flush=True)
    return row


def fold_fusion_row(gen, folds, peaks, dims=FUSION_DIMS[0]):
    """The fold-axis fusion kernels at (folds * 16, D) with per-fold
    weights (F, 3), scale and bias (F, D): the values within phase 3's
    1e-5, the soft weights to the bit against the plain loop, all six
    gradients for random cotangents on the output and the soft weights
    against the plain loop's closed form and autograd (rtol 1e-5 / atol
    1e-4, `weights` against its largest component: phase 3's bars), three
    more backward launches bit-identical; device times."""
    bw, flops = peaks
    b, d, eps = folds * CV_B, sum(dims), 1e-5
    ins = [torch.randn(b, w, generator=gen) for w in dims] + [
        torch.randn(folds, 3, generator=gen),
        torch.randn(folds, d, generator=gen) + 1,
        torch.randn(folds, d, generator=gen)]
    ins = [a.cuda() for a in ins]
    go = torch.randn(b, d, generator=gen).cuda()
    gsw = torch.randn(folds, 3, generator=gen).cuda()

    def fwd_bwd(fn, lv):
        out, sw = fn(*lv)
        return out, sw, torch.autograd.grad((out, sw), lv, (go, gsw))

    def kernel(*a):
        out, sw, _ = fusion._FoldAttentionFusion.apply(*a, eps, True,
                                                       folds)
        return out, sw

    def plain(*a):
        return fusion.reference_fold_attention_fusion(*a, eps=eps)

    leaves = [a.clone().requires_grad_(True) for a in ins]
    ref_leaves = [a.clone().requires_grad_(True) for a in ins]
    out, sw, g_kernel = fwd_bwd(kernel, leaves)
    ref, ref_sw, g_auto = fwd_bwd(plain, ref_leaves)
    g_closed = fusion.reference_fold_fusion_backward(ins, eps, go, gsw)
    prepared = fusion._prepare(*ins, folds=folds)
    _, _, stats = fusion._launch(*prepared, eps, keep_stats=True,
                                 folds=folds)

    def backward():
        return fusion.launch_backward(prepared, stats, go, gsw,
                                      folds=folds)

    repeats = [backward() for _ in range(3)]
    torch.cuda.synchronize()
    where = f"fused_attention_fusion fold axis F={folds} D={d}"
    err = (out - ref).abs().max().item()
    sw_err = (sw - ref_sw).abs().max().item()
    if err > 1e-5 or sw_err != 0.0:
        raise AssertionError(f"{where}: value err {err}, sw err {sw_err}")
    errs = {}
    for name, got, auto, closed in zip(FUSION_GRADS, g_kernel, g_auto,
                                       g_closed):
        for ref_kind, want in (("autograd", auto), ("closed", closed)):
            ref_scale = want.abs().max() if name == "weights" \
                else want.abs()
            diff = (got - want).abs()
            errs[f"{name}_{ref_kind}"] = diff.max().item()
            if (diff > 1e-4 + 1e-5 * ref_scale).any():
                raise AssertionError(f"{where}: grad {name} vs {ref_kind} "
                                     f"max err {diff.max().item()}")
    if not all(torch.equal(a, w) for rep in repeats
               for a, w in zip(rep, g_kernel)):
        raise AssertionError(f"{where}: repeated backward launches differ")
    fwd_bytes = 4 * (2 * b * d + folds * (2 * d + 6))
    bwd_bytes = 4 * (2 * b * d + b * d + folds * (d + 3)) \
        + 4 * (b * d + folds * (3 + 3 + 2 * d))
    row = {
        "F": folds, "B": CV_B, "D": d, "max_abs_err": err, "sw_err": sw_err,
        "grad_err": errs, "layout": fusion.layout(b, dims),
        "param_groups": fusion.param_groups(CV_B),
        "us": device_us(lambda: fusion._launch(*prepared, eps,
                                               folds=folds)),
        "plain_us": device_us(lambda: plain(*ins), **PLAIN_FOLD_TIMING),
        "bwd_us": device_us(backward),
        "fwd_bwd_us": device_us(lambda: fwd_bwd(kernel, leaves)),
        "plain_fwd_bwd_us": device_us(lambda: fwd_bwd(plain, ref_leaves),
                                      **PLAIN_FOLD_TIMING),
        "bound_us": max(fwd_bytes / bw, 9 * b * d / flops) * 1e6,
        "bwd_bound_us": max(bwd_bytes / bw, 16 * b * d / flops) * 1e6,
        "bound_by": "bytes", "library_us": None,
    }
    row["fwd_bwd_bound_us"] = row["bound_us"] + row["bwd_bound_us"]
    print(f"{where} {row}", flush=True)
    return row


def fold_focal_row(gen, folds, peaks, c=2):
    """The fold-axis focal kernels at (folds * 16, C) with a mask of pad
    rows in one fold and the sum(mask) = 1 tie in another: the (F,)
    values within phase 3's rtol 1e-5, dlogits and dmask for an (F,)
    cotangent within atol 1e-5 of autograd of the plain loop and of the
    closed form, three more forward launches bit-identical; times."""
    bw, flops = peaks
    b = folds * CV_B
    logits = (torch.randn(b, c, generator=gen) * 2).cuda()
    labels = torch.randint(0, c, (b,), generator=gen).cuda()
    mask = torch.ones(b)
    mask[CV_B - 5:CV_B] = 0.0          # fold 0: a padded last batch
    if folds > 1:
        mask[CV_B + 1:2 * CV_B] = 0.0  # fold 1: sum(mask) = 1
    mask = mask.cuda()
    g = torch.randn(folds, generator=gen).cuda()
    inputs = (logits, labels, mask)

    def kernel(lg, mk):
        return focal._FoldFocalLoss.apply(lg, labels, mk, folds, 1.0,
                                          2.0)[0]

    def plain(lg, mk):
        return focal.reference_fold_focal(lg, labels, mk.view(folds, -1))

    def fwd_bwd(fn, lg, mk):
        out = fn(lg, mk)
        return out, torch.autograd.grad(out, (lg, mk), g)

    leaves = [logits.clone().requires_grad_(True),
              mask.clone().requires_grad_(True)]
    ref_leaves = [logits.clone().requires_grad_(True),
                  mask.clone().requires_grad_(True)]
    out, g_kernel = fwd_bwd(kernel, *leaves)
    ref, g_ref = fwd_bwd(plain, *ref_leaves)
    g_closed = focal.reference_fold_focal_backward(inputs, 1.0, 2.0, g)
    repeats = [focal._launch(*inputs, 1.0, 2.0, folds=folds)[0]
               for _ in range(3)]
    torch.cuda.synchronize()
    where = f"fused_focal_loss fold axis F={folds} ({CV_B}, {c})"
    err = (out - ref).abs().max().item()
    if (out - ref).abs().gt(1e-5 * ref.abs()).any():
        raise AssertionError(f"{where}: values {out} vs {ref}")
    grad_err = max((a - r).abs().max().item()
                   for want in (g_ref, g_closed)
                   for a, r in zip(g_kernel, want))
    if grad_err > 1e-5:
        raise AssertionError(f"{where}: grad err {grad_err}")
    if not all(torch.equal(r, out.detach()) for r in repeats):
        raise AssertionError(f"{where}: repeated launches differ")
    _, res = focal._launch(*inputs, 1.0, 2.0, folds=folds)

    def backward():
        return focal.launch_backward(inputs, res, 1.0, 2.0, g,
                                     (True, False), folds=folds)

    nbytes = 4 * b * c + 8 * b + 4 * b + 4 * folds
    nops = b * (4 * c + 10) + 2 * folds
    bwd_bytes = 8 * b * c + 8 * b + 8 * b + 12 * folds
    row = {
        "F": folds, "B": CV_B, "C": c, "max_abs_err": err,
        "grad_err": grad_err,
        "us": device_us(lambda: focal._launch(*inputs, 1.0, 2.0,
                                              folds=folds)),
        "plain_us": device_us(lambda: plain(logits, mask),
                              **PLAIN_FOLD_TIMING),
        "bwd_us": device_us(backward),
        "fwd_bwd_us": device_us(lambda: fwd_bwd(kernel, *leaves)),
        "plain_fwd_bwd_us": device_us(lambda: fwd_bwd(plain, *ref_leaves),
                                      **PLAIN_FOLD_TIMING),
        "bound_us": max(nbytes / bw, nops / flops) * 1e6,
        "bwd_bound_us": max(bwd_bytes / bw, b * (6 * c + 12) / flops) * 1e6,
        "bound_by": "bytes" if nbytes / bw >= nops / flops else "operations",
        "library_us": None,
    }
    row["fwd_bwd_bound_us"] = row["bound_us"] + row["bwd_bound_us"]
    print(f"{where} {row}", flush=True)
    return row


def check_fold_kernels(gen, peaks):
    """Phase 12.1: each fold-axis kernel at the fold program's shapes."""
    return {
        "fused_se": [fold_se_row(gen, CV_SIGNAL_FOLDS, t, c, peaks)
                     for t, c in SE_SHAPES],
        "fused_attention_fusion": [fold_fusion_row(gen, f, peaks)
                                   for f in CV_FUSION_FOLDS],
        "fused_focal_loss": [fold_focal_row(gen, CV_SIGNAL_FOLDS, peaks)],
    }


def _cv_signal_cfg():
    """Configuration (a): JAX's test_fold_parallel_matches_sequential_signal
    (`signal_only`, constant schedule, focal loss, early stop and plateau
    decay) at full width: signal 2476, base filters 64, B = 16, f32."""
    cfg = get_preset("signal_only")
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=CV_B, num_epochs=6, lr=1e-3,
        schedule="constant", patience=2, plateau_patience=1))


def _cv_fusion_cfg(cached: bool, epochs: int):
    """Configurations (b) and (c): `fusion` at full width (224 x 224
    images, 2476-sample signals) in float32, frozen encoders in train
    mode; (c) with cached embeddings."""
    cfg = get_preset("fusion")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype="float32"),
        train=dataclasses.replace(cfg.train, num_epochs=epochs, patience=2,
                                  plateau_patience=1, lr=1e-3,
                                  cache_embeddings=cached))


def _cv_sequential(cfg, arrays):
    """`cv._fold_auc`'s protocol on one fold's splits, history kept."""
    res, ev = cv.fit_fold(train_run.build_model_and_task,
                          dict(zip(("train", "val", "test"), arrays)), cfg,
                          CV_DEVICE)
    return res, ev, cv._softmax_auc(ev.logits, ev.labels)


def compare_fold_program(name, cfg, cohort, folds, smi, raw_arrays=None,
                         nan_folds=()):
    """Phase 12.2: the fold program (`run_fold_parallel`) against each
    fold's sequential fit on the card, with JAX's tests/test_cv_parallel.py
    bars: val-loss history rtol/atol 1e-3, best and stopped-at epochs
    equal, test logits within 5e-3 and AUC within 1e-3. The counters are
    set to 0 just before the program and read just after: each fold-axis
    kernel launches once per vmapped op of the plan (per train step and
    eval batch), never once per fold. Returns the launches and times."""
    _zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_tf32():  # the cached pack's calibration and encoding
        task, state0, pack = cv_parallel.prepare_folds(
            train_run.build_model_and_task, cohort, folds, cfg,
            apply_filter=False, device=CV_DEVICE)
    t1 = time.perf_counter()
    _zero_launch_counts()
    with no_tf32():
        par = cv_parallel.run_fold_parallel(task, state0, pack, cfg.train,
                                            verbose=False)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = {**_launch_counts(), **_fold_counts()}
    steps, evals = par.train_steps, par.eval_batches
    plans = {
        "signal": dict(fused_se_fold=3 * (steps + evals),
                       fused_se_fold_backward=3 * steps,
                       fused_focal_loss_fold=steps + evals,
                       fused_focal_loss_fold_backward=steps,
                       fused_se=3),  # the dropout probe: fold 0 alone
        "fusion_raw": dict(fused_se=3 * (steps + evals) + 3,
                           fused_attention_fusion_fold=steps + evals,
                           fused_attention_fusion_fold_backward=steps,
                           fused_attention_fusion=1),
        "fusion_cached": dict(fused_attention_fusion_fold=steps + evals,
                              fused_attention_fusion_fold_backward=steps,
                              fused_attention_fusion=1),
    }
    want = {k: 0 for k in counts}
    want.update(plans[name])
    if counts != want:
        raise AssertionError(f"phase 12 {name}: launches {counts}, the plan "
                             f"({steps} steps, {evals} eval batches) "
                             f"{want}")
    t3 = time.perf_counter()
    with no_tf32():
        for f in range(pack.n_folds):
            arrays = (raw_arrays(f) if raw_arrays is not None
                      else pack.fold_arrays(f, CV_DEVICE))
            res, ev, auc = _cv_sequential(cfg, arrays)
            seq = np.asarray([h["Loss/Val"] for h in res.history])
            where = f"phase 12 {name} fold {f}"
            if f in nan_folds:
                if not (np.isnan(seq).all()
                        and np.isnan(par.val_history[f]).all()):
                    raise AssertionError(f"{where}: val losses not NaN")
            elif not np.allclose(par.val_history[f][:len(seq)], seq,
                                 rtol=1e-3, atol=1e-3):
                raise AssertionError(f"{where}: val {par.val_history[f]} "
                                     f"vs {seq}")
            stop = len(res.history) if res.stopped_early else -1
            if (par.best_epochs[f], par.stopped_at[f]) != (res.best_epoch,
                                                           stop):
                raise AssertionError(
                    f"{where}: best/stop {par.best_epochs[f]}/"
                    f"{par.stopped_at[f]} vs {res.best_epoch}/{stop}")
            lerr = np.abs(par.logits[f] - ev.logits).max()
            if not np.allclose(par.logits[f], ev.logits, rtol=5e-3,
                               atol=5e-3) or abs(par.aucs[f] - auc) > 1e-3:
                raise AssertionError(f"{where}: logits err {lerr}, AUC "
                                     f"{par.aucs[f]} vs {auc}")
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    out = {"folds": pack.n_folds, "train_steps": steps,
           "eval_batches": evals, "launches": counts,
           "prepare_s": t1 - t0, "fold_program_s": t2 - t1,
           "sequential_s": t4 - t3, "aucs": par.aucs,
           "best_epochs": par.best_epochs, "stopped_at": par.stopped_at}
    print(f"phase 12 {name} fold program against sequential ({smi}): "
          f"{json.dumps(out)}", flush=True)
    return out


def run_cv_cli(smi, tmp):
    """Phase 12.3: the CV CLI in four subprocesses at once on a synthetic
    cohort of CV_CLI_N records, 2 epochs: nested (sequential), nested
    --fold-parallel --cache-embeddings, exhaustive --k 10 (10 of its 90
    pairs, to keep the script's time) --fold-parallel
    --cache-embeddings, and cross --pth on a ResNet1D-SE
    state dict written here by torch.save. Each summary must be finite
    JSON; prints each run's wall time."""
    pth = os.path.join(tmp, "resnet1d_se.pth")
    model = ResNet1DSE(num_classes=2)
    flax_init_(model, torch.Generator().manual_seed(7))
    torch.save(model.state_dict(), pth)
    common = ["--n-synth", str(CV_CLI_N), "--epochs", "2", "--device",
              CV_DEVICE]
    runs = {
        "nested": ["nested", "--preset", "fusion", *common],
        "nested_fold_parallel": ["nested", "--preset", "fusion", *common,
                                 "--fold-parallel", "--cache-embeddings"],
        "exhaustive_fold_parallel": [
            "exhaustive", "--preset", "fusion", "--k", "10",
            "--max-pairs", "10", *common, "--fold-parallel",
            "--cache-embeddings"],
        "cross": ["cross", "--pth", pth, "--n-synth", "64", "--device",
                  CV_DEVICE],
    }
    repo = os.path.dirname(os.path.abspath(__file__))
    done = {}

    def run(key, argv):
        t0 = time.perf_counter()
        p = subprocess.Popen(
            [sys.executable, "-m", "ecgmm_torch.train.cv", *argv], cwd=tmp,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": repo})
        stdout, stderr = p.communicate(timeout=600)
        done[key] = (time.perf_counter() - t0, p.returncode, stdout, stderr)

    threads = [threading.Thread(target=run, args=item)
               for item in runs.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    out = {}
    for key in runs:
        wall, code, stdout, stderr = done[key]
        if code != 0:
            raise RuntimeError(f"phase 12 CLI {runs[key]} failed:\n"
                               f"{stdout[-2000:]}\n{stderr[-4000:]}")
        summary = json.loads(stdout[stdout.rindex("\n{") + 1:]
                             if "\n{" in stdout else stdout)
        values = [v for v in summary.values() if not isinstance(v, list)]
        values += [x for v in summary.values() if isinstance(v, list)
                   for x in v]
        if not all(isinstance(v, (int, float)) and np.isfinite(v)
                   for v in values):
            raise AssertionError(f"phase 12 CLI {key}: {summary}")
        out[key] = {"wall_s": wall, "summary": summary}
        print(f"phase 12 CLI {key}: {wall:.1f} s (four at once; {smi}) "
              f"{json.dumps(summary)}", flush=True)
    return out


def wave_peak_bytes(cfg, cohort, folds):
    """The peak device memory of one train step of a raw wave of
    len(folds) folds (forward, backward, Adam) above what the wave's
    state and data hold before it."""
    task, state0, pack = cv_parallel.prepare_folds(
        train_run.build_model_and_task, cohort, folds, cfg,
        apply_filter=False, device=CV_DEVICE)
    program = cv_parallel.make_fold_program(task, state0, cfg.train)
    w = pack.n_folds
    data = cv_parallel._wave_data(pack, list(range(w)), CV_DEVICE)
    gather = cv_parallel._Gather(data, w, CV_DEVICE)
    idx, mask, _ = cv_parallel.stack_fold_plans(
        [r[0] for r in pack.rows], cfg.train.batch_size, shuffle=True,
        seed=0, epochs=1)
    fields = gather(torch.from_numpy(idx[:, 0, 0]).to(CV_DEVICE),
                    torch.from_numpy(mask[:, 0, 0]).to(CV_DEVICE))
    wave = program._new_wave(w)
    program._probe_draws(fields)
    active = np.ones(w, bool)
    with no_tf32():
        program._train_step(wave, fields, active)  # allocator warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        program._train_step(wave, fields, active)
        torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def rows_cap(smi):
    """Phase 12.4: the peak memory of a raw `fusion` wave (float32, 224 x
    224 images) and of a `signal_only` wave at W * 16 rows for the two W
    of CV_WAVES; the bytes a row adds (the slope) and the cap
    `cv_parallel._act_rows_cap` derives from the card's budget."""
    cohort = synthetic.make_cohort(n=64, signal_len=CV_SIGNAL_LEN,
                                   img_hw=CV_IMG)
    folds = [splits.Split(np.arange(i, 64, 4)[:CV_B],
                          np.arange(i, 64, 4)[CV_B:], np.arange(i, 64, 4))
             for i in range(4)]
    out = {}
    for name, cfg in (("fusion", _cv_fusion_cfg(False, 1)),
                      ("signal_only", _cv_signal_cfg())):
        peaks = {w: wave_peak_bytes(cfg, cohort, [folds[i % 4]
                                                  for i in range(w)])
                 for w in CV_WAVES}
        lo, hi = CV_WAVES
        per_row = (peaks[hi] - peaks[lo]) / ((hi - lo) * CV_B)
        budget = pipeline.resolve_hbm_budget(CV_DEVICE)
        out[name] = {"peak_bytes": peaks, "bytes_per_row": per_row,
                     "budget": budget,
                     "cap_rows": int(budget // max(per_row, 1.0))}
        print(f"phase 12 rows cap {name}: {json.dumps(out[name])} ({smi})",
              flush=True)
    constants = {"fusion": cv_parallel.IMAGE_ROW_BYTES,
                 "signal_only": cv_parallel.SIGNAL_ROW_BYTES}
    for name, row_bytes in constants.items():
        print(f"phase 12 rows cap {name}: the module's {row_bytes} bytes a "
              f"row against {out[name]['bytes_per_row']:.0f} measured",
              flush=True)
    return out


def run_cv_phase(smi, peaks):
    """Phase 12, the CV path on the card (see the functions above).
    Returns the fold-kernel rows and the launches of each CV path."""
    t0 = time.perf_counter()
    lap = [t0]
    sub = {}

    def part(name):  # phase 12's parts' walls, s
        now = time.perf_counter()
        sub[name] = round(now - lap[0], 3)
        lap[0] = now

    gen = torch.Generator().manual_seed(12)
    rows = check_fold_kernels(gen, peaks)
    part("fold_kernels")
    paths = {}
    # (a) signal: 4 folds of a 2x2 nested split, the last one's val split
    # replaced by NaN rows of no other fold (JAX's NaN-val test)
    n = CV_N
    cohort = synthetic.make_cohort(n=n + CV_NAN_ROWS,
                                   signal_len=CV_SIGNAL_LEN, img_hw=None)
    cohort.signals[n:] = np.nan
    folds = [s for _, _, inner in splits.nested_kfold(
        cohort.labels[:n], 2, 2, 42) for s in inner]
    folds[-1] = folds[-1]._replace(val=np.arange(n, n + CV_NAN_ROWS))
    paths["cv_signal"] = compare_fold_program(
        "signal", _cv_signal_cfg(), cohort, folds, smi,
        nan_folds={len(folds) - 1})
    part("a_signal")
    # (b) fusion raw, 4 folds
    cohort = synthetic.make_cohort(n=n, signal_len=CV_SIGNAL_LEN,
                                   img_hw=CV_IMG)
    folds = [s for _, _, inner in splits.nested_kfold(cohort.labels, 2, 2,
                                                      42) for s in inner]
    paths["cv_fusion_raw"] = compare_fold_program(
        "fusion_raw", _cv_fusion_cfg(False, 2), cohort, folds, smi)
    part("b_fusion_raw")
    # (c) fusion cached, the 15 folds of nested 5x3
    cfg = _cv_fusion_cfg(True, 4)
    cohort = synthetic.make_cohort(n=CV_CLI_N, signal_len=CV_SIGNAL_LEN,
                                   img_hw=CV_IMG)
    folds = [s for _, _, inner in splits.nested_kfold(cohort.labels, 5, 3,
                                                      42) for s in inner]
    n_clin = min(cfg.model.clinical_in_features, cohort.clinical.shape[1])

    def raw(f):
        s = folds[f]
        es = preprocess.Scaler.fit(cohort.signals[s.train])
        cs = preprocess.Scaler.fit(cohort.clinical[s.train, :n_clin])
        return tuple(cv._build_arrays(cohort, idx, es, cs, False, n_clin,
                                      CV_DEVICE) for idx in s)

    paths["cv_fusion_cached"] = compare_fold_program(
        "fusion_cached", cfg, cohort, folds, smi, raw_arrays=raw)
    part("c_fusion_cached")
    with tempfile.TemporaryDirectory() as tmp:
        cli = run_cv_cli(smi, tmp)
    part("cli")
    cap = rows_cap(smi)
    part("rows_cap")
    print(f"phase 12: {time.perf_counter() - t0:.1f} s, parts "
          f"{json.dumps(sub)}", flush=True)
    return rows, paths, cli, cap


# ---------------------------------------------------------------------------
# 13. parallel: torchrun at one rank, data and tensor parallelism over
# gloo on one card, mesh serving, fold-parallel CV over the data axis

PAR_B = 16  # the global batch of the data-parallel steps
PAR_PAD = 5  # its padded tail rows (mask 0)
PAR_PLANS = {  # kernel launches of one train step on every rank
    "ptbxl_af": dict(NO_LAUNCHES, fused_se=3, fused_se_backward=3,
                     fused_focal_loss=1, fused_focal_loss_backward=1),
    "fusion": dict(NO_LAUNCHES, fused_se=3, fused_attention_fusion=1,
                   fused_attention_fusion_backward=1),
}
PAR_WARM = 3  # steps after the compared one, their median timed
PAR_CV_N = 64  # records of the fold-parallel check
PAR_CV_EPOCHS = 3


def _par_setup(name: str, device):
    """The full-width `name` model from its preset's seed, float32, with
    SGD(1.0) on its trainable parameters (tests/test_parallel.py: the
    update is the gradient), its task and one global batch of PAR_B rows
    from a numpy seed, the last PAR_PAD of them padding."""
    cfg = get_preset(name)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=PAR_B,
                                  schedule="constant", lr=1.0))
    model, task, freeze = train_run.build_model_and_task(cfg, device)
    state = create_state(model, cfg.train, 4, freeze=freeze)
    state.optimizer.adam = torch.optim.SGD(
        [p for p in model.parameters() if p.requires_grad], lr=1.0)
    rng = np.random.default_rng(13)
    mask = np.ones(PAR_B, np.float32)
    mask[-PAR_PAD:] = 0.0
    fields = {
        "signals": rng.normal(size=(PAR_B, cfg.data.signal_len)),
        "labels": rng.integers(0, cfg.model.num_classes, PAR_B),
        "mask": mask}
    if name == "fusion":
        fields["images"] = rng.integers(0, 256, (PAR_B, 3) + CV_IMG,
                                        dtype=np.uint8)
        fields["clinical"] = rng.normal(size=(PAR_B, 2))
    batch = pipeline.Batch(**{
        f: None if f not in fields else torch.from_numpy(
            fields[f].astype(np.float32) if f in ("signals", "clinical")
            else fields[f]).to(device)
        for f in pipeline.Batch._fields})
    return state, task, batch


def _par_step(state, task, batch, mesh=None):
    """One train step with the counters set to 0 just before it and read
    just after; returns the loss, the unsharded model state on the host,
    the launches and the collectives of that step, then the median wall
    ms of PAR_WARM further steps (synchronised; a correctness run's
    figure, not a scaling one)."""
    with no_tf32():
        torch.cuda.synchronize()
        _zero_launch_counts()
        par_collectives.reset_counts()
        mets = engine.train_step(task, state, batch, mesh=mesh)
        torch.cuda.synchronize()
        launches = _launch_counts()
        coll = par_collectives.counts()
        sd = {k: v.detach().cpu().clone()
              for k, v in state.state_dict()["model"].items()}
        times = []
        for _ in range(PAR_WARM):
            t0 = time.perf_counter()
            engine.train_step(task, state, batch, mesh=mesh)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return {"loss": float(mets["loss"]), "sd": sd, "launches": launches,
            "collectives": coll, "ms": statistics.median(times)}


def _par_rank_step(name: str, n_model: int) -> dict:
    """(b) and (c) on a rank: the mesh of the spawned world, its rows of
    the global batch, one step."""
    dev = torch.device("cuda", 0)
    mesh = par_mesh.make_mesh(MeshConfig(n_model=n_model), dev)
    state, task, batch = _par_setup(name, dev)
    par_tp.place_state(state, mesh)
    local = pipeline.Batch(*(None if x is None else
                             par_mesh.local_rows(x, mesh) for x in batch))
    out = _par_step(state, task, local, mesh)
    out["rows"] = int(local.labels.shape[0])
    return out


def par_rank(rank: int, jobs) -> dict:
    """A rank of phase 13 on cuda:0: each job in turn, ("step", preset,
    n_model) or ("cv",); one spawn serves every job of a world size."""
    torch.cuda.set_device(0)
    return {job: _par_rank_step(*job[1:]) if job[0] == "step"
            else _par_rank_cv() for job in jobs}


def _par_agree(where, got, want):
    """tests/test_parallel.py's bars: loss 1e-5, parameters 5e-5, the
    BatchNorm buffers 1e-5 (their step counts equal)."""
    if abs(got["loss"] - want["loss"]) > 1e-5:
        raise AssertionError(f"{where}: loss {got['loss']} vs "
                             f"{want['loss']}")
    worst = {"param": 0.0, "bn": 0.0}
    for k, w in want["sd"].items():
        g = got["sd"][k]
        if g.shape != w.shape:
            raise AssertionError(f"{where}: {k} {g.shape} vs {w.shape}")
        if not w.is_floating_point():
            if not torch.equal(g, w):
                raise AssertionError(f"{where}: {k} {g} vs {w}")
            continue
        kind = "bn" if "running_" in k else "param"
        err = (g - w).abs().max().item() if w.numel() else 0.0
        worst[kind] = max(worst[kind], err)
        if err > (1e-5 if kind == "bn" else 5e-5):
            raise AssertionError(f"{where}: {k} differs by {err}")
    return worst


def par_cli_one_rank(smi, tmp):
    """(a) `torchrun --nproc-per-node 1` (NCCL, one rank: every collective
    is the identity) against the plain CLI on `ptbxl_af` for one epoch,
    the same seed: their metrics.jsonl equal bit for bit but for the wall
    times. Both run the CLI's module through a launcher script that turns
    on PyTorch's deterministic algorithms (cuDNN's weight gradients
    otherwise differ in their last bits from run to run)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(tmp, "deterministic_run.py")
    with open(script, "w") as f:
        f.write("import runpy, sys, torch\n"
                f"sys.path.insert(0, {repo!r})\n"
                "torch.backends.cudnn.deterministic = True\n"
                "torch.backends.cudnn.benchmark = False\n"
                "torch.use_deterministic_algorithms(True)\n"
                "runpy.run_module('ecgmm_torch.workloads.run', "
                "run_name='__main__')\n")
    common = [script, "--preset", "ptbxl_af", "--epochs", "1", "--n-synth",
              "128", "--run-dir", "ck"]
    runs = {"plain": [sys.executable] + common,
            "torchrun": [sys.executable, "-m", "torch.distributed.run",
                         "--standalone", "--nproc-per-node", "1"] + common}
    done = {}

    def run(key):
        cwd = os.path.join(tmp, key)
        os.makedirs(cwd)
        env = dict(os.environ, PYTHONPATH=repo,
                   CUBLAS_WORKSPACE_CONFIG=":4096:8")
        t0 = time.perf_counter()
        done[key] = (subprocess.run(runs[key], capture_output=True,
                                    text=True, cwd=cwd, env=env,
                                    timeout=600),
                     time.perf_counter() - t0)

    threads = [threading.Thread(target=run, args=(k,)) for k in runs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    logs = {}
    for key, (out, wall) in done.items():
        if out.returncode != 0:
            raise RuntimeError(f"phase 13 (a) {key} failed:\n"
                               f"{out.stdout[-3000:]}\n{out.stderr[-6000:]}")
        with open(os.path.join(tmp, key, "runs", "ck", "metrics.jsonl")) as f:
            logs[key] = [{k: v for k, v in json.loads(line).items()
                          if k != "time" and not k.startswith("Time/")}
                         for line in f]
        print(f"phase 13 (a) {key} CLI: {wall:.1f} s (both at once; {smi})",
              flush=True)
    if logs["plain"] != logs["torchrun"] or not logs["plain"]:
        raise AssertionError(f"phase 13 (a): torchrun {logs['torchrun']} "
                             f"vs plain {logs['plain']}")
    print(f"phase 13 (a) metrics.jsonl equal: {json.dumps(logs['plain'])}",
          flush=True)


PAR_JOBS = {2: (("step", "fusion", 1), ("step", "ptbxl_af", 1), ("cv",)),
            4: (("step", "fusion", 2),)}
PAR_PATHS = {("step", "fusion", 1): "train_dp2_fusion",
             ("step", "ptbxl_af", 1): "train_dp2_ptbxl_af",
             ("step", "fusion", 2): "train_dp2tp2_fusion"}


def par_train(smi):
    """(b) two ranks over gloo on cuda:0, each with its 8 rows, the
    `fusion` and the `ptbxl_af` step against the one-process step on the
    card; (c) four ranks as 2 x 2 (data x tensor) for `fusion`. Every
    rank's launches must be the plan of one step on its rows. One spawn a
    world size runs every job of it ((e)'s too). Returns the launches of
    the main paths by path (rank 0's) and the 2-rank world's results."""
    wants = {}
    for name in ("fusion", "ptbxl_af"):
        state, task, batch = _par_setup(name, torch.device("cuda"))
        wants[name] = _par_step(state, task, batch)
        del state
    launches, worlds = {}, {}
    for n, jobs in PAR_JOBS.items():
        t0 = time.perf_counter()
        worlds[n] = par_launch.spawn(par_rank, n, args=(jobs,), threads=0)
        wall = time.perf_counter() - t0
        for job in jobs:
            if job[0] != "step":
                continue
            name, path = job[1], PAR_PATHS[job]
            want = wants[name]
            outs = [w[job] for w in worlds[n]]
            for r, got in enumerate(outs):
                where = f"phase 13 {path} rank {r}"
                if got["launches"] != PAR_PLANS[name] or \
                        want["launches"] != PAR_PLANS[name]:
                    raise AssertionError(
                        f"{where}: launches {got['launches']} (one process "
                        f"{want['launches']}), the plan {PAR_PLANS[name]}")
                worst = _par_agree(where, got, want)
            launches[path] = outs[0]["launches"]
            row = {"ranks": n, "n_model": job[2],
                   "rows_per_rank": outs[0]["rows"],
                   "loss": outs[0]["loss"],
                   "one_process_loss": want["loss"], "worst": worst,
                   "launches_per_rank": outs[0]["launches"],
                   "collectives_rank0": outs[0]["collectives"],
                   "warm_step_ms_per_rank": [o["ms"] for o in outs],
                   "one_process_warm_step_ms": want["ms"],
                   "world_spawn_and_jobs_s": wall}
            print(f"phase 13 {path}: {json.dumps(row)} (a correctness run: "
                  f"{n} ranks share one card over gloo, not a scaling "
                  f"figure; {smi})", flush=True)
    return launches, worlds[2]


def par_serve(smi):
    """(d) mesh serving: `visible_devices` patched to (cuda:0, cuda:0),
    `enable_batching(n_data=2)` served over HTTP, four concurrent uploads
    against the unbatched single-replica answers (tests/test_serve_mesh.py
    bars); every dispatch runs the serving plan once on each replica.
    Returns the launches."""
    real = par_mesh.visible_devices
    par_mesh.visible_devices = lambda device="cuda": [
        torch.device("cuda", 0)] * 2
    ref = ServingPipeline.demo(device="cuda", seed=0)
    pipe = ServingPipeline.demo(device="cuda", seed=0)
    httpd = None
    try:
        pipe.enable_batching(150.0, max_batch=4, buckets=(2, 4), n_data=2)
        pipe.warmup_batched()
        httpd = serve_http.serve(pipe, port=0, background=True)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        qs = [{"age": 50 + 7 * i, "weight": 60 + 5 * i} for i in range(4)]
        bodies = [serve_hammer.request_body("cam", questionnaire=q)
                  for q in qs]
        got = [None] * 4
        barrier = threading.Barrier(4)

        def post(i):
            barrier.wait()
            got[i] = json.loads(serve_hammer._post(base + ENDPOINT,
                                                   *bodies[i]))

        before = pipe.stats()["batching"]["dispatches"]
        torch.cuda.synchronize()
        _zero_launch_counts()
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        launches = _launch_counts()
        stats = json.load(urllib.request.urlopen(base + "/stats",
                                                 timeout=60))
    finally:
        par_mesh.visible_devices = real
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        pipe.close_batching()
    dispatches = stats["batching"]["dispatches"] - before
    if stats["batching"]["n_data"] != 2:
        raise AssertionError(f"phase 13 (d): /stats {stats['batching']}")
    want = {k: 2 * n * dispatches for k, n in SERVE_PLAN.items()}
    if launches != want:
        raise AssertionError(f"phase 13 (d): launches {launches}, the plan "
                             f"{want} ({dispatches} dispatches)")
    with open(serve_hammer.STRIP_JPEG, "rb") as f:
        image = decode_upload(f.read())
    for i, b in enumerate(got):
        check_response(b, "cam")
        a = ref.predict(image, qs[i], "cam")
        if a["label"] != b["label"] or a["ecg_signal"] != b["ecg_signal"] \
                or not np.isclose(a["probability"], b["probability"],
                                  rtol=1e-3, atol=1e-4) \
                or not all(np.isclose(a["feature_importance"][k],
                                      b["feature_importance"][k],
                                      rtol=5e-2, atol=0.5)
                           for k in ("image", "signal", "age", "wt")):
            raise AssertionError(f"phase 13 (d) request {i}: {b} vs {a}")
    print(f"phase 13 serve_http_n_data2: 4 requests in {dispatches} "
          f"dispatches, launches {launches}, /stats batching "
          f"{stats['batching']} (two replicas share one card: a "
          f"correctness run, not a scaling figure; {smi})", flush=True)
    return launches


def _par_cv_inputs():
    cfg = _cv_signal_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=PAR_CV_EPOCHS))
    cohort = synthetic.make_cohort(n=PAR_CV_N, signal_len=CV_SIGNAL_LEN,
                                   img_hw=None)
    folds = [s for _, _, inner in splits.nested_kfold(
        cohort.labels, 2, 2, cfg.train.seed) for s in inner]
    return cfg, cohort, folds


def _par_rank_cv() -> dict:
    """(e) on a rank: the fold program over its block of the folds; every
    rank returns every fold's results."""
    dev = torch.device("cuda", 0)
    mesh = par_mesh.make_mesh(MeshConfig(), dev)
    cfg, cohort, folds = _par_cv_inputs()
    with no_tf32():
        task, state0, pack = cv_parallel.prepare_folds(
            train_run.build_model_and_task, cohort, folds, cfg,
            apply_filter=False, device=dev)
        torch.cuda.synchronize()
        _zero_launch_counts()
        t0 = time.perf_counter()
        par = cv_parallel.run_fold_parallel(task, state0, pack, cfg.train,
                                            verbose=False, mesh=mesh)
        torch.cuda.synchronize()
    return {"res": par, "s": time.perf_counter() - t0,
            "launches": {**_launch_counts(), **_fold_counts()}}


def par_cv(smi, world):
    """(e) the fold program on two ranks (gloo, cuda:0), its 4 folds over
    the data axis, against each fold's sequential fit on the card, with
    phase 12's bars; each rank's launches are its program's plan.
    Returns rank 0's launches."""
    cfg, cohort, folds = _par_cv_inputs()
    outs = [w[("cv",)] for w in world]
    for r, o in enumerate(outs):
        steps, evals = o["res"].train_steps, o["res"].eval_batches
        want = {k: 0 for k in o["launches"]}
        want.update(fused_se_fold=3 * (steps + evals),
                    fused_se_fold_backward=3 * steps,
                    fused_focal_loss_fold=steps + evals,
                    fused_focal_loss_fold_backward=steps, fused_se=3)
        if o["launches"] != want:
            raise AssertionError(f"phase 13 (e) rank {r}: launches "
                                 f"{o['launches']}, the plan {want}")
    par = outs[0]["res"]
    if outs[1]["res"].aucs != par.aucs:
        raise AssertionError("phase 13 (e): the ranks' results differ")
    t0 = time.perf_counter()
    with no_tf32():
        pack = cv_parallel.prepare_folds(
            train_run.build_model_and_task, cohort, folds, cfg,
            apply_filter=False, device="cuda")[2]
        for f in range(len(folds)):
            res, ev, auc = _cv_sequential(cfg, pack.fold_arrays(f, "cuda"))
            seq = np.asarray([h["Loss/Val"] for h in res.history])
            stop = len(res.history) if res.stopped_early else -1
            where = f"phase 13 (e) fold {f}"
            if not np.allclose(par.val_history[f][:len(seq)], seq,
                               rtol=1e-3, atol=1e-3) \
                    or (par.best_epochs[f], par.stopped_at[f]) != (
                        res.best_epoch, stop) \
                    or not np.allclose(par.logits[f], ev.logits, rtol=5e-3,
                                       atol=5e-3) \
                    or abs(par.aucs[f] - auc) > 1e-3:
                raise AssertionError(
                    f"{where}: val {par.val_history[f]} vs {seq}, best/stop "
                    f"{par.best_epochs[f]}/{par.stopped_at[f]} vs "
                    f"{res.best_epoch}/{stop}, AUC {par.aucs[f]} vs {auc}")
    row = {"folds": len(folds), "aucs": par.aucs,
           "best_epochs": par.best_epochs, "stopped_at": par.stopped_at,
           "launches_rank0": outs[0]["launches"],
           "launches_rank1": outs[1]["launches"],
           "program_s_per_rank": [o["s"] for o in outs],
           "sequential_s": time.perf_counter() - t0}
    print(f"phase 13 cv_fold_parallel_dp2: {json.dumps(row)} (two ranks "
          f"share one card: a correctness run; {smi})", flush=True)
    return outs[0]["launches"]


def run_parallel_phase(smi):
    """Phase 13: (a) torchrun at one rank against the plain CLI, (b) and
    (c) the data- and tensor-parallel steps against one process, (d) mesh
    serving, (e) the fold program over the data axis. Returns the
    launches of the main paths by path."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        par_cli_one_rank(smi, tmp)
    launches, world2 = par_train(smi)
    launches["serve_http_n_data2"] = par_serve(smi)
    launches["cv_fold_parallel_dp2"] = par_cv(smi, world2)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    return launches


# ---------------------------------------------------------------- phase 14

BUNDLE_BUCKETS = (8,)  # the bundle's batched program; b = 1 always


def _export_bars(where, a, b):
    """`tests/test_export.py`'s bars: label equal; probability rtol 1e-4,
    atol 1e-5; each feature importance rtol 1e-3, atol 1e-4;
    `ecg_signal` equal; the same keys."""
    ok = (a["label"] == b["label"] and set(a) == set(b)
          and a["ecg_signal"] == b["ecg_signal"]
          and np.isclose(a["probability"], b["probability"], rtol=1e-4,
                         atol=1e-5)
          and all(np.isclose(a["feature_importance"][k],
                             b["feature_importance"][k], rtol=1e-3,
                             atol=1e-4)
                  for k in ("image", "signal", "age", "wt")))
    if not ok:
        raise AssertionError(
            f"{where}: the bundle's answer misses the export bars: "
            f"{a['label']}/{b['label']} p {a['probability']}/"
            f"{b['probability']} importance {a['feature_importance']}/"
            f"{b['feature_importance']}")


def bundle_export(pipe, out, smi):
    """(a) The full-width demo pipeline exported into one bundle for the
    card and the CPU, each at b = 1 and bucket 8; each program's trace,
    export and save seconds and bytes, and its `ecgmm.*` nodes against
    the plan. The host's load and this process's children are printed
    first: the export is host work."""
    children = sum(1 for d in os.listdir("/proc") if d.isdigit()
                   and _ppid(d) == os.getpid())
    print(f"phase 14 host: load average {os.getloadavg()}, {children} "
          f"child processes; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    bundle_export_mod.export_bundle(pipe, out, platforms=("cpu", "cuda"),
                                    batch_buckets=BUNDLE_BUCKETS)
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    if meta["platforms"] != ["cpu", "cuda"]:
        raise AssertionError(f"the bundle's platforms {meta['platforms']}")
    for name, prog in sorted(meta["programs"].items()):
        graph = torch.export.load(os.path.join(out, name)).graph
        nodes = bundle_export_mod.operator_counts(graph)
        print(f"phase 14 export {name}: trace {prog['trace_s']:.3f} s, "
              f"export {prog['export_s']:.3f} s, save {prog['save_s']:.3f} "
              f"s, {prog['bytes']} bytes, nodes {nodes} ({smi})", flush=True)
        if nodes != bundle_export_mod.SERVE_PLAN:
            raise AssertionError(f"{name}: {nodes} != the serving plan")
    print(f"phase 14 export wall {wall:.3f} s for "
          f"{len(meta['programs'])} programs ({smi})", flush=True)


def _ppid(pid: str) -> int:
    """The parent of process `pid` (0 where it has gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return int(f.read().rsplit(")", 1)[1].split()[1])
    except (OSError, IndexError, ValueError):
        return 0


def bundle_requests(bundle, live, smi):
    """(b) The bundle on the card against the live pipeline: 8 requests,
    interleaved (live, bundle) so that both see the same host; each answer
    within the export bars, the launch counters up by the plan at every
    bundle dispatch; the request split's medians of each."""
    aot = ServingPipeline.from_exported(bundle, device="cuda")
    if aot.model is not None:
        raise AssertionError("from_exported rehydrated a model")
    reqs = make_requests(8, seed=1)
    live.predict(*reqs[0])
    aot.predict(*reqs[0])
    torch.cuda.synchronize()
    times = {"bundle": [], "live": []}
    launched = dict(NO_LAUNCHES)
    for img, q, fmt in reqs:
        want = live.predict(img, q, fmt)
        times["live"].append(dict(live.last_timing))
        _zero_launch_counts()
        got = aot.predict(img, q, fmt)
        counts = _launch_counts()
        times["bundle"].append(dict(aot.last_timing))
        plan = {k: n for k, n in SERVE_PLAN.items()}
        if counts != plan:
            raise AssertionError(f"a bundle dispatch launched {counts}, "
                                 f"not the plan {plan}")
        launched = {k: launched[k] + counts[k] for k in launched}
        check_response(got, fmt)
        _export_bars("bundle vs live on the card", got, want)
    split = {}
    for who, ts in times.items():
        split[who] = {k: statistics.median(t[k] for t in ts)
                      for k in ("total_ms", "host_before_ms", "device_ms",
                                "host_after_ms")}
        print(f"phase 14 request p50 {who}: {split[who]} (8 requests, "
              f"interleaved; {smi})", flush=True)
    print(f"phase 14 bundle launches over 8 requests: {launched}",
          flush=True)
    return aot, launched, split


def bundle_http(bundle, smi):
    """(c) `--bundle` over HTTP: 16 clients, batching on over the bundle's
    bucket 8; a response against the unbatched bundle's answer to the
    same upload, the launches equal to the dispatches times the plan; and
    `--n-data 2 --bundle` refused with JAX's message."""
    plain = ServingPipeline.from_exported(bundle, device="cuda")
    served = ServingPipeline.from_exported(bundle, device="cuda")
    served.enable_batching(HTTP_WINDOW_MS, max_batch=max(BUNDLE_BUCKETS))
    served.warmup()
    served.warmup_batched()
    httpd = serve_http.serve(served, port=0, background=True)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        before = served.stats()["batching"]["dispatches"]
        _zero_launch_counts()
        res = hammer_window(base + ENDPOINT, 16, 3.0, served)
        launches = _launch_counts()
        dispatches = served.stats()["batching"]["dispatches"] - before
        body, ctype = serve_hammer.request_body("png")
        got = json.loads(serve_hammer._post(base + ENDPOINT, body, ctype))
    finally:
        httpd.shutdown()
        httpd.server_close()
        served.close_batching()
    with open(serve_hammer.STRIP_JPEG, "rb") as f:
        img = decode_upload(f.read())
    _export_bars("bundle over HTTP, batched vs unbatched", got,
                 plain.predict(img, {"age": 66, "weight": 72}))
    print(f"phase 14 http --bundle 16 clients batched (bucket "
          f"{BUNDLE_BUCKETS}): {res['req_per_sec']:.3f} req/s, p50 "
          f"{res['latency_median_ms']:.3f} ms, {res['requests']} requests "
          f"in {dispatches} dispatches, launches {launches} ({smi})",
          flush=True)
    if launches != {k: n * dispatches for k, n in SERVE_PLAN.items()}:
        raise AssertionError("the bundle's batched server did not run "
                             "through the kernels' plan per dispatch")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            serve_http.main(["--bundle", bundle, "--n-data", "2",
                             "--batch-window-ms", "5"])
        except SystemExit:
            pass
        else:
            raise AssertionError("--n-data 2 --bundle was not refused")
    if "an AOT bundle is a fixed single-device program" not in \
            err.getvalue():
        raise AssertionError(f"--n-data 2 --bundle: {err.getvalue()!r}")
    return launches


def bundle_cpu(bundle, live):
    """(d) The bundle's CPU program: one request against the live
    pipeline's weights on the CPU."""
    aot = ServingPipeline.from_exported(bundle, device="cpu")
    img, q, fmt = make_requests(1, seed=5)[0]
    got = aot.predict(img, q, fmt)
    _export_bars("the CPU program vs the live CPU pipeline", got,
                 _cpu_twin(live).predict(img, q, fmt))
    print(f"phase 14 cpu program: label {got['label']} probability "
          f"{got['probability']:.6f}", flush=True)


def traced_train_steps(tmp, smi):
    """(e) `profiler.trace` around 3 `ptbxl_af` steps at B=16: the trace
    report's kernel launches equal the counters (SE and focal loss,
    forward and backward); the memory stats. Returns the model, its state
    and the launches."""
    cfg = get_preset("ptbxl_af")
    t = dataclasses.replace(cfg.train, batch_size=TRAIN_B)
    data = train_run.load_data(cfg, "synthetic", 64, device="cuda")
    model, task, freeze = train_run.build_model_and_task(cfg, "cuda")
    state = create_state(model, t, data.train.n // TRAIN_B, freeze=freeze)
    idx, _ = engine.epoch_indices(data.train.n, TRAIN_B, shuffle=True,
                                  seed=t.seed, epoch=0)
    idx_d = torch.from_numpy(idx.astype(np.int64)).cuda()
    ones = torch.ones(TRAIN_B, device="cuda")

    def step(i):
        return engine.train_step(task, state, engine.gather_batch(
            data.train, idx_d[i % idx.shape[0]], ones))

    with no_tf32():
        for i in range(4):
            step(i)
        logdir = os.path.join(tmp, "trace")
        torch.cuda.synchronize()
        # a warm-up step inside the trace, its kernels finished before
        # the annotation closes: the counted steps' kernels start after
        # it (a trace may miss kernels right after it starts)
        with train_profiler.trace(logdir):
            with torch.profiler.record_function("phase14_warmup"):
                step(0)
                torch.cuda.synchronize()
            _zero_launch_counts()
            for i in range(1, 4):
                step(i)
        launches = _launch_counts()
    device = trace_report.load_device_events(logdir)
    rows = trace_report.op_rows(trace_report.load_device_events(
        logdir, after="phase14_warmup"))
    print(f"phase 14 trace: {len(device)} device events, "
          f"{len(device) - len(rows)} of them the warm-up step's",
          flush=True)
    seen = trace_report.launch_counts(rows)
    want = {"se_fwd": launches["fused_se"],
            "se_bwd": launches["fused_se_backward"],
            "focal_fwd": launches["fused_focal_loss"],
            "focal_bwd": launches["fused_focal_loss_backward"]}
    print(f"phase 14 traced ptbxl_af: 3 steps B={TRAIN_B} after a warm-up "
          f"step, trace report kernels {seen}, counters {launches}; "
          f"{len(rows)} device events", flush=True)
    if {k: seen.get(k, 0) for k in want} != want or not all(want.values()):
        raise AssertionError(f"the trace report's launches {seen} differ "
                             f"from the counters {want}")
    trace_report.print_report(logdir, steps=3, top=8, after="phase14_warmup")
    stats = train_profiler.device_memory_stats()
    print(f"phase 14 ptbxl_af B={TRAIN_B}: memory allocated "
          f"{stats.get('allocated_bytes.all.current')} peak "
          f"{stats.get('allocated_bytes.all.peak')} live "
          f"{stats['live_buffer_bytes']} ({smi})", flush=True)
    return model, state, launches


def tools_on_the_card(tmp, model, state, smi):
    """(f) The tools where neither flax, msgpack, pandas nor Pillow is
    installed: a port checkpoint -> reference .pth -> .msgpack -> the
    port's state dict, bit for bit; `cv cross --ckpt x.msgpack`; the batch
    digitizer over 8 rendered strips; one rows-cap probe trial."""
    run_dir = os.path.join(tmp, "run")
    CheckpointManager(run_dir).save("best", state)
    pth, tree = os.path.join(tmp, "best.pth"), os.path.join(tmp, "sig.msgpack")
    convert_pth.main([run_dir, "--arch", "resnet1d_se", "--export", "--out",
                      pth])
    convert_pth.main([pth, "--arch", "resnet1d_se", "--out", tree])
    back = from_jax_resnet1d_se(convert_pth.load_converted(tree))
    sd = model.state_dict()
    differ = [k for k, v in sd.items() if "num_batches_tracked" not in k
              and not torch.equal(v.cpu(), back[k].to(v.dtype))]
    if set(back) != set(sd) or differ:
        raise AssertionError(f"checkpoint round trip differs: {differ[:5]} "
                             f"{sorted(set(back) ^ set(sd))[:5]}")
    print(f"phase 14 round trip best.pt -> .pth -> .msgpack -> state dict: "
          f"{len(sd)} entries bit-equal ({os.path.getsize(tree)} bytes)",
          flush=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cv.main(["cross", "--ckpt", tree, "--n-synth", "32"])
    metrics = json.loads(out.getvalue()[out.getvalue().index("{"):])
    print(f"phase 14 cv cross --ckpt .msgpack: {metrics}", flush=True)
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"cv cross gave {metrics}")
    strips = os.path.join(tmp, "strips")
    os.makedirs(strips)
    for i, (img, _, _) in enumerate(make_requests(8, seed=7)):
        with open(os.path.join(strips, f"{i + 1}.png"), "wb") as f:
            f.write(native.png_encode(img))
    csv_path = os.path.join(tmp, "ecg_signals.csv")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        digitize_batch.main([strips, "-o", csv_path])
    table = read_csv(csv_path, index_col=0)
    print(f"phase 14 digitize_batch: {len(table)} strips in "
          f"{time.perf_counter() - t0:.3f} s (host; {smi})", flush=True)
    if len(table) != 8 or len(table.columns) != 2476:
        raise AssertionError("digitize_batch did not write 8 signals")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ecgmm_torch.tools.rows_cap_probe",
         "--trial-rows", "256", "--batch-size", "64", "--preset",
         "signal_only"],
        env={**os.environ, "ECGMM_FOLD_PARALLEL_ROWS_CAP": "0"}, cwd=here,
        capture_output=True, text=True, timeout=600)
    line = [x for x in proc.stdout.splitlines() if "TRIAL_OK" in x]
    print(f"phase 14 rows-cap probe trial 256 rows (4 folds of 64): rc "
          f"{proc.returncode} "
          f"{line} in {time.perf_counter() - t0:.3f} s", flush=True)
    if proc.returncode != 0 or not line:
        raise AssertionError(f"the probe's trial failed: "
                             f"{proc.stderr[-2000:]}")


def run_bundle_phase(smi):
    """Phase 14: the AOT bundle and the tools on the card. Returns the
    launches of the bundle's 8 requests, of its batched HTTP run and of
    the traced `ptbxl_af` steps."""
    t0 = time.perf_counter()
    live = ServingPipeline.demo(device="cuda", seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        bundle = os.path.join(tmp, "bundle")
        bundle_export(live, bundle, smi)
        _, serve_launches, _ = bundle_requests(bundle, live, smi)
        http_launches = bundle_http(bundle, smi)
        bundle_cpu(bundle, live)
        model, state, traced = traced_train_steps(tmp, smi)
        tools_on_the_card(tmp, model, state, smi)
    print(f"phase 14 wall {time.perf_counter() - t0:.3f} s", flush=True)
    return {"serve_bundle": serve_launches,
            "serve_http_bundle": http_launches,
            "train_ptbxl_af_traced": traced}


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
    walls = {}
    lap = [time.perf_counter()]

    def phase_done(phase):
        now = time.perf_counter()
        walls[phase] = round(now - lap[0], 3)
        lap[0] = now

    # 2. build: nvcc for the CUDA kernels, g++ for the host kernels beside
    # it
    host_build = {}

    def build_host():
        try:
            build_host_library(smi)
        except Exception as e:  # re-raised below, after nvcc's build
            host_build["error"] = e

    host_thread = threading.Thread(target=build_host)
    host_thread.start()
    t0 = time.perf_counter()
    lib = _ext.library()
    print(f"built {_ext._sources()} -> {lib._name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    host_thread.join()
    if "error" in host_build:
        raise host_build["error"]
    phase_done("2 build")

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
    sub = {}

    def timed(name, fn, *args):  # phase 3's parts' walls, s
        t = time.perf_counter()
        out = fn(*args)
        sub[name] = round(time.perf_counter() - t, 3)
        return out

    print("fused_se has no single PyTorch call computing the same function "
          "(library_ms null)", flush=True)
    se_rows = timed("se", check_se, gen, peaks)
    fusion_rows = timed("fusion", check_fusion, gen, peaks)
    fusion_bwd_rows = timed("fusion_backward", check_fusion_backward, gen,
                            peaks)
    fusion_sweep = timed("fusion_sweep", fusion_layout_sweep, gen)
    print("fused_focal_loss has no single PyTorch call computing the same "
          "function (library_ms null)", flush=True)
    focal_rows = timed("focal", check_focal, gen, peaks)
    timed("focal_profiled", focal_profiled_backward, gen)
    focal_sweep = timed("focal_sweep", focal_cluster_sweep, gen)
    se_train_rows = timed("se_train", check_se_train, gen, peaks)
    se_fusion_rows = timed("se_fusion", check_se_fusion, gen, peaks)
    se_serving_rows = timed("se_serving", check_se_serving, gen, peaks)
    se_xai_rows = timed("se_xai", check_se_xai, gen, peaks)
    fusion_lime_rows = timed("fusion_lime", check_fusion_lime, gen, peaks)
    attention_checked = timed("attention", check_attention)
    print(f"phase 3 parts, s: {json.dumps(sub)}", flush=True)
    phase_done("3 kernels")

    # 4. the slice
    launches, timings = run_slice()
    phase_done("4 serve")

    # 9. the request's host kernels against their plain versions, and the
    # host stages' times
    check_host_kernels()
    host_kernels = time_host_stages(smi)
    print(json.dumps({"host_kernels": host_kernels}), flush=True)
    phase_done("9 host kernels")

    # 5. numbers
    for key in ("total_ms", "host_before_ms", "device_ms", "host_after_ms"):
        vals = sorted(t[key] for t in timings)
        print(f"request {key}: median {statistics.median(vals):.3f} p90 "
              f"{float(np.percentile(vals, 90)):.3f} ({smi})", flush=True)

    # 8. the front end: decoder, HTTP server, micro-batcher
    http_paths = run_front_end(smi)
    phase_done("8 front end")

    # 6. the training slices: first the algorithm against the CPU in
    # float32 (TF32 off, as `run()` sets it), then the runs through the
    # entry points
    with no_tf32():
        compare_train_steps()
        compare_fusion_steps()
        compare_image_steps()
        compare_clinical_steps()
        compare_cached()
        compare_signal_steps("physionet_transformer", 24)
        attention_steps = attention_train_steps()
        compare_signal_steps("physionet_crnn", 48, count_turned=False)
        compare_signal_steps("signal_12lead", 24, count_turned=False)
        lstm_tf32_check()
    phase_done("6 train against the CPU")
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
    phase_done("6 train runs")

    # 10. the XAI batch path
    xai_launches = run_xai_phase(smi)
    phase_done("10 xai")

    # 11. the real-data path: record directories, the CLI, streaming
    real_launches = run_real_data_phase(smi)
    phase_done("11 real data")

    # 12. the CV path: fold-axis kernels, the fold program against the
    # sequential fits, the CLI, the rows cap
    fold_rows, cv_paths, _, _ = run_cv_phase(smi, peaks)
    phase_done("12 cv")

    # 13. parallel: torchrun, data and tensor parallelism, mesh serving,
    # the fold program over the data axis
    par_launches = run_parallel_phase(smi)
    phase_done("13 parallel")

    # 14. the AOT bundle (export, the card, HTTP, the CPU program), the
    # profiler and trace report, the tools
    bundle_launches = run_bundle_phase(smi)
    phase_done("14 bundle")

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
    phase_done("7 train steps")
    print(f"phase walls, s: {json.dumps(walls)} ({smi})", flush=True)
    paths = {
        "serve": launches,
        **http_paths,
        "train_ptbxl_af": ptbxl_launches,
        "train_physionet_multi": multi_launches,
        "train_fusion": fusion_launches,
        "train_fusion_modal_balance": balance_launches,
        "train_fusion_cached": cached_launches,
        "train_signal_only": signal_launches,
        "train_image_only": image_launches,
        "pretrain": pretrain_launches,
        "xai": xai_launches,
        **real_launches,
        **{f"train_{name}": n for name, n in new_launches.items()},
        **{p: out["launches"] for p, out in cv_paths.items()},
        **par_launches,
        **bundle_launches,
    }

    def by_path(kernel):
        return {p: n.get(kernel, 0) for p, n in paths.items()}

    def fold_paths(kernel):
        return ({p: out["launches"][kernel + "_fold"]
                 for p, out in cv_paths.items()},
                {p: out["launches"][kernel + "_fold_backward"]
                 for p, out in cv_paths.items()}, fold_rows[kernel])

    focal_picked = [r for r in focal_rows
                    if (r["B"], r["C"]) == (TRAIN_B, 2) and "us" in r]
    se_picked = [r for r in se_train_rows if r["B"] == TRAIN_B]
    kernels = [
        summarize("fused_se", "ecgmm_torch/ops/csrc/se.cu",
                  "ecgmm_tpu/ops/pallas_se.py:85", by_path("fused_se"),
                  se_rows + se_train_rows + se_serving_rows + se_xai_rows,
                  se_picked,
                  "ptbxl_af train step: 3 forward calls at B=16",
                  backward=(by_path("fused_se_backward"), se_picked,
                            "ptbxl_af train step: 3 calls at B=16"),
                  fold=fold_paths("fused_se")),
        summarize("fused_attention_fusion", "ecgmm_torch/ops/csrc/fusion.cu",
                  "ecgmm_tpu/ops/pallas_fusion.py:98",
                  by_path("fused_attention_fusion"),
                  fusion_rows + fusion_bwd_rows + fusion_lime_rows,
                  [r for r in fusion_rows
                   if r["D"] == 672 and r["B"] in (1, 8, 32)],
                  "serving request: B=1, 32 and 8 at D=672",
                  backward=(by_path("fused_attention_fusion_backward"),
                            [r for r in fusion_bwd_rows
                             if r["needs"] in ("shap", "ig")],
                            "serving request: SHAP (B=32, the three "
                            "embeddings) and IG (B=8, clin) at D=672"),
                  fold=fold_paths("fused_attention_fusion")),
        summarize("fused_focal_loss", "ecgmm_torch/ops/csrc/focal.cu",
                  "ecgmm_tpu/ops/pallas_losses.py:66",
                  by_path("fused_focal_loss"), focal_rows, focal_picked,
                  "ptbxl_af train step: 1 call at (16, 2)",
                  bound_by=focal_picked[0]["bound_by"],
                  backward=(by_path("fused_focal_loss_backward"),
                            focal_picked,
                            "ptbxl_af train step: 1 call at (16, 2)"),
                  fold=fold_paths("fused_focal_loss")),
    ]
    kernels.append(attention_summary(attention_checked, attention_steps))
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
