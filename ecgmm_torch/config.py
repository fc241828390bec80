"""Model geometry (port of `ecgmm_tpu/config.py` ModelConfig).

There is no `use_pallas` switch: an op runs its CUDA kernel when its
tensors lie on a CUDA device and its plain PyTorch version when they lie
on the CPU (see `ecgmm_torch/ops`)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Trimodal fusion model geometry (reference multimodal.py:333-415)."""

    num_classes: int = 2
    # canonical asymmetric dims (multimodal.py:340-342)
    image_dim: int = 512
    signal_dim: int = 128
    clinical_dim: int = 32
    fusion_hidden: int = 128
    dropout: float = 0.3
    signal_base_filters: int = 64
    signal_input_channels: int = 1
    clinical_in_features: int = 2
    # The clinical branch is always TabNet (multimodal.py:109-148): the
    # modal-balance variant's MLP branch is not ported yet (ROADMAP.md).
    # compute dtype of the three encoders; parameters stay float32
    dtype: str = "bfloat16"
