"""Staged training pipeline (port of `ecgmm_tpu/workloads/pretrain.py`):
the reference's workflow of training each branch alone and loading the
resulting checkpoints into the fusion model (multimodal.py:350,370,388):

  1. image-only ResNet18 (train_image_only.py, the `image_only` preset);
  2. signal-only ResNet1D-SE (train_signal_only.py, `signal_only`);
  3. the clinical encoder under a linear probe (the run's own train
     config, encoders unfrozen);
  4. fusion with all three encoders warm-started from the stages' best
     checkpoints and frozen (train.py:35-43); with `cache_embeddings` the
     encoders' BatchNorm statistics are calibrated and each split encoded
     once (`train/embed.py`).

The warm start keeps every tensor of a stage but the reference's
filters, in the port's names:
  * image encoder: all but the fc head `fc.` (multimodal.py:471-499,
    load_fc=False);
  * signal encoder: all but the last classifier layer `classifier.4.`
    (multimodal.py:423-436);
  * clinical encoder: all but TabNet's `tabnet.final_mapping.`
    (multimodal.py:150-168; the MLP encoder has none).
BatchNorm buffers travel with the weights; tensors whose shapes differ
are skipped. Like `run()`, the pipeline runs with TF32 off.

Usage:
    python -m ecgmm_torch.workloads.pretrain --epochs 3 --n-synth 128
    python -m ecgmm_torch.workloads.pretrain --device cpu --epochs 1 \\
        --n-synth 48 --cache-embeddings
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, Mapping, Optional

import torch

from ecgmm_torch.config import Config, get_preset
from ecgmm_torch.data import pipeline
from ecgmm_torch.models import ECGMultimodalModel, ResNet18, ResNet1DSE
from ecgmm_torch.models.clinical import ClinicalMLPEncoder, TabNetEncoder
from ecgmm_torch.models.layers import flax_init_
from ecgmm_torch.parallel.mesh import init_distributed, make_mesh
from ecgmm_torch.precision import no_tf32
from ecgmm_torch.tools.weights import load_partial
from ecgmm_torch.train import embed, engine
from ecgmm_torch.train.checkpoint import CheckpointManager
from ecgmm_torch.train.state import create_state, encoder_freeze_predicate
from ecgmm_torch.workloads import run as run_lib
from ecgmm_torch.workloads.tasks import (make_clinical_task,
                                         make_fusion_task, make_image_task,
                                         make_signal_task)

# (fusion model prefix, the stage tensors left out of the warm start)
WARM_START_FILTERS = {
    "image": ("image_encoder.", ("fc.",)),
    "signal": ("signal_encoder.", ("classifier.4.",)),
    "clinical": ("clinical_encoder.", ("tabnet.final_mapping.",)),
}


def _fit_stage(model, task, data, tcfg, ckpt_dir, device,
               verbose=True, mesh=None) -> Dict[str, torch.Tensor]:
    """Train `model` (initialised like flax from `tcfg.seed`) on `data`
    and return the state dict of its best checkpoint (its last state where
    no epoch improved), unsharded."""
    flax_init_(model, torch.Generator().manual_seed(tcfg.seed))
    state = create_state(model.to(device), tcfg,
                         pipeline.num_batches(data.train.n, tcfg.batch_size))
    ckpt = CheckpointManager(ckpt_dir, writer=_writes(mesh))
    result = engine.fit(task, state, data.train, data.val, tcfg, ckpt=ckpt,
                        verbose=verbose, mesh=mesh)
    if ckpt.exists("best"):
        ckpt.restore("best", result.state)
    return result.state.state_dict()["model"]


def _writes(mesh) -> bool:
    return mesh is None or mesh.is_writer


def warm_start_fusion(
    fusion_sd: Mapping[str, torch.Tensor],
    image_sd: Optional[Mapping[str, torch.Tensor]] = None,
    signal_sd: Optional[Mapping[str, torch.Tensor]] = None,
    clinical_sd: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The fusion model's state dict with each given stage's tensors
    merged into its encoder, under `WARM_START_FILTERS`
    (`tools.weights.load_partial`: excluded and shape-mismatched tensors
    keep the fusion model's)."""
    out = dict(fusion_sd)
    for branch, src in (("image", image_sd), ("signal", signal_sd),
                        ("clinical", clinical_sd)):
        if src is None:
            continue
        prefix, exclude = WARM_START_FILTERS[branch]
        target = {k[len(prefix):]: v for k, v in out.items()
                  if k.startswith(prefix)}
        merged, _ = load_partial(target, src, exclude_prefixes=exclude)
        out.update({prefix + k: v for k, v in merged.items()})
    return out


def run_pipeline(cfg: Config, data: pipeline.MaterializedData, run_dir: str,
                 stage_epochs: Optional[int] = None, verbose: bool = True,
                 device="cuda", mesh=None):
    """image -> signal -> clinical -> warm-started frozen-encoder fusion,
    on `device` (where `data` lies), with TF32 off. Each stage
    checkpoints under `run_dir/<stage>`; returns (the fusion stage's
    FitResult, its EvalResult on the test split). With `mesh` every stage
    trains over its ranks (`engine.fit(mesh=)`)."""
    with no_tf32():
        return _pipeline(cfg, data, run_dir, stage_epochs, verbose,
                         run_lib._device(device), mesh)


def _pipeline(cfg, data, run_dir, stage_epochs, verbose, device, mesh=None):
    verbose = verbose and _writes(mesh)
    t = cfg.train
    st = dataclasses.replace(t, num_epochs=stage_epochs or t.num_epochs,
                             freeze_encoders=False)
    mcfg = cfg.model

    def stage_cfg(preset_name):
        # the stage's own preset, so that its early-stop and plateau
        # rules are its reference trainer's
        pt = get_preset(preset_name).train
        return dataclasses.replace(
            pt, num_epochs=st.num_epochs, seed=st.seed,
            eval_batch_size=st.eval_batch_size,
            checkpoint_dir=st.checkpoint_dir, output_dir=st.output_dir,
            log_dir=st.log_dir)

    # 1. image-only ResNet18 (train_image_only.py)
    st_img = stage_cfg("image_only")
    image_sd = _fit_stage(
        ResNet18(num_classes=mcfg.num_classes), make_image_task(st_img),
        data, st_img, os.path.join(run_dir, "image_only"), device, verbose,
        mesh)

    # 2. signal-only ResNet1D-SE (train_signal_only.py)
    st_sig = stage_cfg("signal_only")
    signal_sd = _fit_stage(
        ResNet1DSE(num_classes=mcfg.num_classes,
                   input_channels=mcfg.signal_input_channels,
                   base_filters=mcfg.signal_base_filters),
        make_signal_task(st_sig), data, st_sig,
        os.path.join(run_dir, "signal_only"), device, verbose, mesh)

    # 3. the clinical encoder under a linear probe
    n_clin = data.train.clinical.shape[-1]
    if mcfg.clinical_encoder == "tabnet":
        enc = TabNetEncoder(n_clin, out_dim=mcfg.clinical_dim)
    else:
        enc = ClinicalMLPEncoder(n_clin, out_dim=mcfg.clinical_dim)
    clin_task, probe = make_clinical_task(enc, st, mcfg.num_classes)
    probe_sd = _fit_stage(probe, clin_task, data, st,
                          os.path.join(run_dir, "clinical"), device, verbose,
                          mesh)
    clinical_sd = {k[len("encoder."):]: v for k, v in probe_sd.items()
                   if k.startswith("encoder.")}

    # 4. fusion with warm-started, frozen encoders (train.py)
    model = ECGMultimodalModel(mcfg)
    flax_init_(model, torch.Generator().manual_seed(t.seed))
    model.load_state_dict(warm_start_fusion(
        model.state_dict(), image_sd, signal_sd, clinical_sd), strict=True)
    state = create_state(
        model.to(device), t, pipeline.num_batches(data.train.n, t.batch_size),
        freeze=encoder_freeze_predicate if t.freeze_encoders else None)
    from ecgmm_torch.parallel import tp

    tp.place_state(state, mesh)
    data, task = embed.cache_run_splits(state, data, t,
                                        frozen=t.freeze_encoders, mesh=mesh)
    task = task or make_fusion_task(t)
    result = engine.fit(task, state, data.train, data.val, t,
                        ckpt=CheckpointManager(os.path.join(run_dir,
                                                            "fusion"),
                                               writer=_writes(mesh)),
                        verbose=verbose, mesh=mesh)
    return result, engine.evaluate(task, result.state, data.test, t.eval_bs,
                                   mesh=mesh)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=3,
                   help="epochs of every stage")
    p.add_argument("--n-synth", type=int, default=128)
    p.add_argument("--run-dir", default="./checkpoints/pipeline")
    p.add_argument("--cache-embeddings", action="store_true",
                   help="stage 4: train the fusion surface over embeddings "
                        "the frozen encoders compute once per split")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--n-model", type=int, default=None,
                   help="model-axis size of the torchrun ranks' mesh "
                        "(>1: tensor-parallel)")
    args = p.parse_args(argv)

    cfg = run_lib.apply_train_overrides(
        get_preset("fusion"), epochs=args.epochs,
        cache_embeddings=args.cache_embeddings)
    if args.n_model is not None:
        cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, n_model=args.n_model))
    device = run_lib._device(args.device)
    device = init_distributed(device=args.device) or device
    mesh = make_mesh(cfg.mesh, device)
    data = run_lib.load_data(cfg, "synthetic", args.n_synth, device=device)
    _, ev = run_pipeline(cfg, data, args.run_dir, device=device, mesh=mesh)
    if _writes(mesh):
        print(f"fusion test accuracy: {ev.accuracy:.4f}")


if __name__ == "__main__":
    main()
