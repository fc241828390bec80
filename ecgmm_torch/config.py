"""Configuration tree and presets (port of `ecgmm_tpu/config.py`).

There is no `use_pallas` switch: an op runs its CUDA kernel when its
tensors lie on a CUDA device and its plain PyTorch version when they lie
on the CPU (see `ecgmm_torch/ops`). There is no mesh either: the port
trains on one card. The presets are those of the signal-only ResNet1D-SE
trainers that run on the synthetic cohort; the others, and the fusion,
CV and streaming knobs, wait for their slices (ROADMAP.md)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input geometry (reference config.py:10-27). The data paths and the
    sample rate come with the real-data slice that reads them
    (ROADMAP.md)."""

    # Hospital digitized lead-II signals: 2476 samples @ 250 Hz
    # (reference evaluation_signal.py:36-38, train_signal_only_ptb.py:32).
    signal_len: int = 2476


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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters (the fields of the JAX TrainConfig
    that the signal-only trainers read)."""

    seed: int = 42
    batch_size: int = 16
    num_epochs: int = 30
    lr: float = 1e-4
    # Early stop / plateau-decay patience; 0 disables the mechanism.
    patience: int = 5  # early stop
    plateau_patience: int = 2  # epochs of no val improvement before LR decay
    plateau_factor: float = 0.1  # LR ÷ 10 (train.py:157-163)
    loss: str = "cross_entropy"  # or "focal"
    focal_alpha: float = 1.0
    focal_gamma: float = 2.0
    schedule: str = "constant"  # or "onecycle"
    onecycle_peak_lr: float = 1e-3
    checkpoint_dir: str = "./checkpoints"
    log_dir: str = "./runs"
    output_dir: str = "./output"
    keep_checkpoints: int = 3


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = DataConfig()
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    name: str = "fusion"


def ptbxl_preset() -> Config:
    """PTB-XL AF-vs-other-rhythm task (reference train_signal_only_ptb.py:
    bs 16, 10 epochs, weighted sampling, 60/20/20 split, len 2476; no
    early-stop counter exists there — best-by-val-loss only, :256-291)."""
    return Config(
        name="ptbxl_af",
        train=TrainConfig(
            batch_size=16,
            num_epochs=10,
            lr=1e-3,
            loss="focal",
            schedule="onecycle",
            patience=0,
        ),
    )


def physionet_preset() -> Config:
    """PhysioNet/CinC 2017 binary task (reference train_physionet.py:
    bs 8 :128-130, OneCycle max 1e-3 over 30 epochs :278-281, focal;
    its early-stop counter is initialised but never incremented :288)."""
    return Config(
        name="physionet",
        data=DataConfig(signal_len=3000),
        train=TrainConfig(
            batch_size=8,
            lr=1e-3,
            loss="focal",
            schedule="onecycle",
            patience=0,
        ),
    )


def physionet_multi_preset() -> Config:
    """PhysioNet 3-class N/AF/O task (reference train_physionet_multi.py)."""
    return dataclasses.replace(
        physionet_preset(),
        name="physionet_multi",
        model=ModelConfig(num_classes=3),
    )


PRESETS = {
    "ptbxl_af": ptbxl_preset,
    "physionet": physionet_preset,
    "physionet_multi": physionet_multi_preset,
}


def get_preset(name: str) -> Config:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available in the port: "
            f"{sorted(PRESETS)} (the others wait, ROADMAP.md)"
        ) from None
