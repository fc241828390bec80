"""ServingPipeline assembly recipes (port of `ecgmm_tpu/serve/loaders.py`):
a trained run's checkpoint, and the self-contained demo. The AOT bundle
(`pipeline_from_exported`) is not ported yet (ROADMAP.md section 1)."""

from __future__ import annotations

import os
import warnings

import torch

from ecgmm_torch.config import ModelConfig
from ecgmm_torch.models import ECGMultimodalModel
from ecgmm_torch.precision import no_tf32
from ecgmm_torch.data.pipeline import HostArrays, promote
from ecgmm_torch.train.checkpoint import CheckpointManager

BACKGROUND_ROWS = 64  # train rows encoded as SHAP's background


def pipeline_from_run(cls, run_dir: str, data, model=None,
                      which: str = "best", device: str = "cuda"):
    """A fusion run that `workloads.run.run` wrote: the `which`
    ("best"/"last") weights through `CheckpointManager`, the temperature
    the run fitted for that tag (its `calibration` entry; 1.0 without
    one), the data's fitted scalers, and SHAP background embeddings from
    the first 64 train rows through the model's `encode`.

    data: the run's `MaterializedData` (`workloads.run.load_data`; a
    host-resident train split gives its first rows).
    model: an `ECGMultimodalModel` of the run's geometry (default: the
    canonical `ModelConfig()`); its compute dtype is the serving one."""
    if not os.path.isfile(os.path.join(run_dir, f"{which}.pt")):
        raise FileNotFoundError(
            f"no {which!r} checkpoint in {run_dir!r}")
    ckpt = CheckpointManager(run_dir)
    state_dict = ckpt.load(which)["model"]
    temperature = 1.0
    if ckpt.exists("calibration"):
        temperature = float(
            ckpt.load("calibration").get(f"temperature_{which}", 1.0))
    model = model if model is not None else ECGMultimodalModel(ModelConfig())
    dev = torch.device(device)
    model.load_state_dict(state_dict, strict=True)
    model.to(dev).eval()
    train = data.train
    n = min(BACKGROUND_ROWS, train.n)
    if isinstance(train, HostArrays):  # a streamed split: its first rows
        train = promote(HostArrays(*(a[:n] for a in train)), dev)
    with torch.no_grad(), no_tf32():
        feats = model.encode(train.images[:n].to(dev),
                             train.signals[:n].to(dev),
                             train.clinical[:n].to(dev))[:3]
    background = torch.cat(feats, dim=1).float().cpu().numpy()
    return cls(
        model, state_dict, ecg_scaler=data.ecg_scaler,
        clinical_scaler=data.clinical_scaler,
        background_embeddings=background,
        signal_len=int(train.signals.shape[-1]),
        img_hw=tuple(int(s) for s in train.images.shape[2:4]),
        temperature=temperature, device=device,
    )


def demo_pipeline(cls, device: str = "cuda", seed: int = 0):
    """Self-contained demo: the canonical full-width fusion model in
    float32 with seeded random weights (PyTorch's default initialisers
    under `torch.manual_seed(seed)`, on the CPU, without disturbing the
    caller's random state)."""
    warnings.warn(
        "demo(): the PTB-XL signal-encoder checkpoint is not in the "
        "repository; serving RANDOM weights (seed "
        f"{seed})"
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ECGMultimodalModel(cfg=ModelConfig(dtype="float32"))
    return cls(model, model.state_dict(), device=device)
