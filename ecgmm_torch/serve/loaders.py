"""ServingPipeline assembly recipes (port of the demo recipe of
`ecgmm_tpu/serve/loaders.py`)."""

from __future__ import annotations

import warnings

import torch

from ecgmm_torch.config import ModelConfig
from ecgmm_torch.models import ECGMultimodalModel


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
