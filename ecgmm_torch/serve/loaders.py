"""ServingPipeline assembly recipes (port of `ecgmm_tpu/serve/loaders.py`):
a trained run's checkpoint, the self-contained demo, and an AOT bundle
(`serve/export.py`)."""

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


def pipeline_from_exported(cls, bundle_dir: str, device: str = "cuda"):
    """A pipeline that serves a bundle's programs for `device`'s platform
    (`serve/export.py`) without the model code: `model` is None, and
    `_predict_many` runs the program of the bucket's size under the
    device lock and `no_tf32` (TF32 is global state, not in the graph).
    The b = 1 program is loaded here; the batched ones when batching is
    enabled, as in JAX."""
    from ecgmm_torch.serve.export import load_bundle, load_scaler

    program, meta, host = load_bundle(bundle_dir, device=device)
    pipe = cls.__new__(cls)
    pipe.model = None
    pipe.device = torch.device(device)
    pipe.ecg_scaler = load_scaler(host, "ecg_scaler")
    pipe.clinical_scaler = load_scaler(host, "clinical_scaler")
    pipe.signal_len = int(meta["signal_len"])
    pipe.img_hw = tuple(meta["img_hw"])
    pipe.cam_hw = (-(-pipe.img_hw[0] // 32), -(-pipe.img_hw[1] // 32))
    pipe.dims = tuple(meta["dims"])
    pipe.n_clin = int(meta["clinical_in_features"])
    pipe.num_classes = int(meta["num_classes"])
    pipe.background = torch.as_tensor(host["background"],
                                      device=pipe.device)
    # informational: the temperature is a constant of the programs
    pipe.temperature = float(meta.get("temperature", 1.0))
    pipe._bundle_dir = bundle_dir
    pipe._programs = {1: program}
    pipe._exported_buckets = tuple(sorted(meta.get("batch_buckets") or ())
                                   ) or None
    pipe._init_serving_state()

    def predict_many(img, sig, clin):
        fn = pipe._programs.get(int(img.shape[0]))
        if fn is None:
            raise ValueError(
                f"bundle has no program for bucket {img.shape[0]} "
                f"(loaded: {sorted(pipe._programs)})")
        with pipe._device_lock, no_tf32():
            return fn(img, sig, clin)

    pipe._predict_many = predict_many
    return pipe
