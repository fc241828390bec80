"""AOT deployment bundles of the serving pipeline (port of
`ecgmm_tpu/serve/export.py`, through `torch.export`).

`export_bundle` traces the request program, `ServingPipeline._predict_many`,
at b = 1 and at each batch bucket with `make_fx` on real tensors: the
Grad-CAM, SHAP and clinical-IG `autograd.grad` calls are recorded as the
aten operators of their backward, and the two serving kernels as the
`ecgmm::*` operators (`ecgmm_torch.ops.tracing_ops`). `torch.export` then
turns each trace into a program with the weights, the SHAP draws, the IG
alphas and the background as lifted constants, saved as
`predict_many_{b}.{platform}.pt2`. A trace records the device it ran on,
so each platform gets programs of its own, traced on that platform's
device; a program is never moved between devices. Each program carries
its own copy of the weights (about 51 MB at the serving width).

`ServingPipeline.from_exported(path, device)` serves such a bundle
without the model code or a checkpoint (`serve/loaders.py`). TF32 is
global state, not part of a graph: the loaded programs run under
`precision.no_tf32` like the live one. cuDNN chooses its algorithms at
run time, so on the card a bundle is held to bars, not to bits.

    python -m ecgmm_torch.serve.export --out ./bundle --batch-buckets 1,8
"""

from __future__ import annotations

import json
import os
import time
from collections import Counter
from typing import Dict, Optional, Sequence
from unittest import mock

import numpy as np
import torch

from ecgmm_torch.data.preprocess import Scaler

_META = "meta.json"
_HOST = "host_constants.npz"
_JAX_PROGRAM = "predict_all.stablehlo"
_FORMAT_VERSION = 1
PROGRAM_KIND = "torch.export"
# the kernel operators of one traced request program, at any bucket: the
# signal encoder's three SE blocks; the fusion head for the prediction,
# SHAP and IG, and its backward for SHAP and IG
SERVE_PLAN = {"ecgmm.fused_se": 3, "ecgmm.attention_fusion": 3,
              "ecgmm.attention_fusion_backward": 2}


def program_name(b: int, platform: str) -> str:
    return f"predict_many_{b}.{platform}.pt2"


def _device(platform: str) -> torch.device:
    """The device a platform's programs are traced on and run on; 'cuda'
    without a card raises (nothing falls back to the CPU)."""
    if platform not in ("cpu", "cuda"):
        raise ValueError(f"unknown platform {platform!r} (cpu, cuda)")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "platform 'cuda' requested but no CUDA device is available; "
            "export --platforms cpu for the CPU")
    return torch.device(platform)


def operator_counts(graph) -> Dict[str, int]:
    """The `ecgmm.*` operator nodes of a traced or exported graph, by
    operator name (`ecgmm.fused_se`, ...)."""
    names = Counter(str(node.target).rsplit(".", 1)[0]
                    for node in graph.nodes if node.op == "call_function")
    return {k: n for k, n in names.items() if k.startswith("ecgmm.")}


def check_plan(graph, where: str) -> None:
    """Raise unless the graph holds exactly SERVE_PLAN's operator nodes: a
    kernel launched outside an operator leaves only its output's
    allocation in a trace, and the program would return that memory."""
    got = operator_counts(graph)
    if got != SERVE_PLAN:
        raise RuntimeError(f"{where}: the traced program holds the kernel "
                           f"operators {got}, not {SERVE_PLAN}")


def _no_stack_traces():
    """torch.export's tracer (`_ModuleStackTracer`) captures and symbolizes
    the whole Python stack at every graph node and then filters it to the
    user's `forward` frames; of a `make_fx` graph it keeps none. Turning
    the capture off leaves the program the same and takes that work, a
    large share of an export's time, out of it. The tracer sets the
    switch itself when it is made, so a read-only property stands in for
    it."""
    from torch.fx.experimental import proxy_tensor

    return mock.patch.object(
        proxy_tensor._ModuleStackTracer, "record_stack_traces",
        property(lambda self: False, lambda self, value: None))


def trace_program(pipeline, b: int):
    """`pipeline._predict_many` at a bucket of b rows on the pipeline's
    device, traced by `make_fx` on real zero inputs and exported; returns
    (ExportedProgram, trace seconds, export seconds)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from ecgmm_torch.ops import tracing_ops
    from ecgmm_torch.precision import no_tf32

    h, w = pipeline.img_hw
    dev = pipeline.device
    example = (torch.zeros((b, 3, h, w), device=dev),
               torch.zeros((b, pipeline.signal_len), device=dev),
               torch.zeros((b, pipeline.n_clin), device=dev))
    t0 = time.perf_counter()
    with tracing_ops(), no_tf32():
        gm = make_fx(lambda img, sig, clin: pipeline._predict_many(
            img, sig, clin), tracing_mode="real")(*example)
    t1 = time.perf_counter()
    with _no_stack_traces():
        program = torch.export.export(gm, example)
    t2 = time.perf_counter()
    check_plan(program.graph, f"bucket {b} on {dev}")
    return program, t1 - t0, t2 - t1


def export_bundle(pipeline, out_dir: str,
                  platforms: Sequence[str] = ("cuda",),
                  batch_buckets: Optional[Sequence[int]] = None) -> str:
    """Write `pipeline`'s request program at b = 1 and at each of
    `batch_buckets`, for each platform, plus the host constants and
    meta.json, into out_dir; returns out_dir. meta["programs"] records
    each program's trace, export and save seconds and its bytes."""
    if pipeline.model is None:
        raise ValueError("export_bundle needs a live pipeline (a model), "
                         "not a loaded bundle")
    platforms = tuple(platforms)
    devices = [_device(p) for p in platforms]
    sizes = sorted({1, *(int(b) for b in batch_buckets or ())})
    os.makedirs(out_dir, exist_ok=True)
    programs = {}
    for platform, dev in zip(platforms, devices):
        pipe = pipeline
        if pipeline.device.type != dev.type:
            pipe = pipeline._replica(dev)
        for b in sizes:
            program, trace_s, export_s = trace_program(pipe, b)
            name = program_name(b, platform)
            path = os.path.join(out_dir, name)
            t = time.perf_counter()
            torch.export.save(program, path)
            programs[name] = {
                "trace_s": trace_s, "export_s": export_s,
                "save_s": time.perf_counter() - t,
                "bytes": os.path.getsize(path),
            }
    host = {"background": pipeline.background.float().cpu().numpy()}
    for name, scaler in (("ecg_scaler", pipeline.ecg_scaler),
                         ("clinical_scaler", pipeline.clinical_scaler)):
        if scaler is not None:
            host[f"{name}_mean"] = np.asarray(scaler.mean)
            host[f"{name}_scale"] = np.asarray(scaler.scale)
    np.savez(os.path.join(out_dir, _HOST), **host)
    meta = {
        "format_version": _FORMAT_VERSION,
        "program": PROGRAM_KIND,
        "platforms": list(platforms),
        "img_hw": list(pipeline.img_hw),
        "signal_len": int(pipeline.signal_len),
        "clinical_in_features": int(pipeline.n_clin),
        "dims": list(pipeline.dims),
        "num_classes": int(pipeline.num_classes),
        "batch_buckets": sorted(int(b) for b in batch_buckets or ()),
        # informational: the temperature is a constant of the programs
        "temperature": float(pipeline.temperature),
        "torch_version": torch.__version__,
        "programs": programs,
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


def load_scaler(host, name: str) -> Optional[Scaler]:
    if f"{name}_mean" not in host:
        return None
    return Scaler(mean=host[f"{name}_mean"], scale=host[f"{name}_scale"])


def read_meta(bundle_dir: str, device="cuda"):
    """meta.json of a port bundle that holds programs for `device`'s
    platform; raises FileNotFoundError for a missing bundle and
    ValueError for a JAX bundle, another format or a missing platform."""
    meta_path = os.path.join(bundle_dir, _META)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no bundle at {bundle_dir!r} ({_META} "
                                "missing)")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("program") != PROGRAM_KIND:
        if os.path.exists(os.path.join(bundle_dir, _JAX_PROGRAM)):
            raise ValueError(
                f"{bundle_dir!r} is a JAX StableHLO bundle "
                "(ecgmm_tpu.serve.export); export the port's bundle with "
                "python -m ecgmm_torch.serve.export")
        raise ValueError(f"{bundle_dir!r} holds no {PROGRAM_KIND} programs")
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"bundle format {meta.get('format_version')!r} != "
            f"{_FORMAT_VERSION} (re-export with this package version)")
    platform = torch.device(device).type
    if platform not in meta.get("platforms", ()):
        raise ValueError(
            f"bundle {bundle_dir!r} has programs for {meta.get('platforms')}"
            f", not {platform!r}; re-export with --platforms {platform}")
    _device(platform)
    return meta


def _load_program(bundle_dir: str, b: int, platform: str):
    import ecgmm_torch.ops  # noqa: F401  (registers the ecgmm operators)

    path = os.path.join(bundle_dir, program_name(b, platform))
    return torch.export.load(path).module()


def load_bundle(bundle_dir: str, device="cuda"):
    """(program at b = 1, meta, host constants) of a bundle, for
    `device`'s platform. The program takes (img (1, 3, H, W), sig (1, T),
    clin (1, F)) on that device and returns the packed (1, K) row of
    `ServingPipeline._predict_many`."""
    meta = read_meta(bundle_dir, device)
    host = dict(np.load(os.path.join(bundle_dir, _HOST)))
    return _load_program(bundle_dir, 1, torch.device(device).type), meta, host


def load_batched_programs(bundle_dir: str, device="cuda"):
    """{bucket: program} of a bundle exported with batch buckets, for
    `device`'s platform; empty without buckets."""
    meta = read_meta(bundle_dir, device)
    platform = torch.device(device).type
    return {int(b): _load_program(bundle_dir, int(b), platform)
            for b in meta.get("batch_buckets") or ()}


def main(argv=None):
    """python -m ecgmm_torch.serve.export --out DIR [--run-dir R --preset P
    --data D --data-dir X --n-synth N] [--platforms cuda] [--batch-buckets
    1,8]"""
    import argparse

    from ecgmm_torch.serve.pipeline import ServingPipeline

    p = argparse.ArgumentParser(
        description="Export the serving pipeline's request program as a "
                    "torch.export bundle. Each program (b = 1 and each "
                    "batch bucket, per platform) carries its own copy of "
                    "the weights, about 51 MB at the serving width.")
    p.add_argument("--out", required=True)
    p.add_argument("--run-dir", default=None,
                   help="trained run to export (default: demo pipeline)")
    p.add_argument("--data", default="synthetic",
                   help="data source the run was trained on (scalers and "
                        "SHAP background come from its train split)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--preset", default="fusion",
                   help="the preset the --run-dir checkpoint was trained "
                        "with (its model config rebuilds the model)")
    p.add_argument("--n-synth", type=int, default=244)
    p.add_argument("--platforms", default="cuda",
                   help="comma list of cuda, cpu: one set of programs "
                        "each, traced on that device")
    p.add_argument("--batch-buckets", default="",
                   help="comma list: also export the batched request "
                        "program at these batch sizes (each adds one "
                        "program of weights)")
    args = p.parse_args(argv)
    platforms = tuple(s.strip() for s in args.platforms.split(",")
                      if s.strip())
    for platform in platforms:
        _device(platform)
    device = platforms[0] if platforms else "cuda"
    if args.run_dir:
        import dataclasses

        from ecgmm_torch.models import ECGMultimodalModel
        from ecgmm_torch.workloads.run import get_preset, load_data

        cfg = get_preset(args.preset)
        if args.data_dir:
            cfg = dataclasses.replace(cfg, data=dataclasses.replace(
                cfg.data, data_dir=args.data_dir))
        data = load_data(cfg, args.data, args.n_synth, device=device)
        pipe = ServingPipeline.from_run(
            args.run_dir, data, model=ECGMultimodalModel(cfg.model),
            device=device)
    else:
        pipe = ServingPipeline.demo(device=device)
    buckets = tuple(int(b) for b in args.batch_buckets.split(",")
                    if b.strip())
    out = export_bundle(pipe, args.out, platforms=platforms,
                        batch_buckets=buckets or None)
    print(f"exported serving bundle -> {out}")


if __name__ == "__main__":
    main()
