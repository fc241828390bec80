"""Configuration tree and presets (port of `ecgmm_tpu/config.py`).

There is no `use_pallas` switch: an op runs its CUDA kernel when its
tensors lie on a CUDA device and its plain PyTorch version when they lie
on the CPU (see `ecgmm_torch/ops`). `MeshConfig` lays the ranks of a
`torch.distributed` run out as JAX lays its devices out (`parallel/mesh.py`).
The presets are the JAX package's thirteen: the
trimodal fusion trainers (`fusion`, `fusion_modal_balance`,
`fusion_cached`), the pretraining stages (`image_only`, `signal_only`),
the signal-only ResNet1D-SE trainers (`ptbxl_af`, `physionet`,
`physionet_multi`, `signal_af`, `signal_arr`, `signal_12lead`) and the
spectrogram CRNN and 1-D Transformer (`physionet_crnn`,
`physionet_transformer`), on the synthetic cohort or on records read
from `DataConfig`'s directories (`workloads/run.load_data`); the CV knobs
wait for their slice (ROADMAP.md)."""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Data paths and input geometry (reference config.py:10-27)."""

    data_dir: str = "./data"
    image_dirname: str = "images"
    ecg_csv: str = "ecg_signals.csv"
    label_file: str = "labels.xlsx"
    clinical_file: str = "clinical.csv"
    af_label_file: str = "af_labels.xlsx"
    arrhythmia_label_file: str = "arrhythmia_labels.xlsx"
    physionet_dir: str = "./data/physionet"
    ptbxl_dir: str = "./data/ptbxl"

    img_height: int = 224
    img_width: int = 224
    # Hospital digitized lead-II signals: 2476 samples @ 250 Hz
    # (reference evaluation_signal.py:36-38, train_signal_only_ptb.py:32).
    signal_len: int = 2476
    signal_fs: float = 250.0
    clinical_dim: int = 2  # AGE, Wt (reference dataset.py:28,198)

    # Indices known to be missing image folders (reference dataset.py:145).
    known_missing: Tuple[int, ...] = (17, 23, 36, 43, 51, 62, 115, 158)

    @property
    def image_dir(self) -> str:
        return os.path.join(self.data_dir, self.image_dirname)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The (data, model) layout of the ranks of a `torch.distributed` run
    (`parallel/mesh.make_mesh`), with the JAX package's fields and
    defaults: n_data -1 takes every rank (divided by n_model); n_model > 1
    trains tensor-parallel (`parallel/tp.py`)."""

    data_axis: str = "data"
    model_axis: str = "model"
    n_data: int = -1  # -1 = all ranks
    n_model: int = 1


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
    # 'tabnet' (multimodal.py:109-148) or 'mlp'
    # (multimodal_paper_modal_balance.py:256-263)
    clinical_encoder: str = "tabnet"
    # modal-balance variant forces 256/256/256 + MLP clinical encoder
    # (multimodal_paper_modal_balance.py:197-263).
    variant: str = "canonical"
    # compute dtype of the three encoders; parameters stay float32
    dtype: str = "bfloat16"

    @staticmethod
    def modal_balance() -> "ModelConfig":
        return ModelConfig(
            image_dim=256,
            signal_dim=256,
            clinical_dim=256,
            clinical_in_features=24,
            clinical_encoder="mlp",
            variant="modal_balance",
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters (the fields of the JAX TrainConfig
    that the fusion and signal-only trainers read). Defaults mirror the
    reference fusion trainer: bs 16, <=30 epochs, lr 1e-4, early-stop
    patience 5, LR / 10 after 2 non-improving epochs, loss CE(fusion) +
    0.1 var_loss (reference config.py:33-36, train.py:35-43,78,157-167)."""

    seed: int = 42
    batch_size: int = 16
    num_epochs: int = 30
    lr: float = 1e-4
    # coupled decay: the gradient takes wd * p before Adam, as optax's
    # add_decayed_weights chained before adam does
    weight_decay: float = 0.0
    # Early stop / plateau-decay patience; 0 disables the mechanism.
    patience: int = 5  # early stop
    plateau_patience: int = 2  # epochs of no val improvement before LR decay
    plateau_factor: float = 0.1  # LR ÷ 10 (train.py:157-163)
    var_loss_weight: float = 0.1  # train.py:78
    # CE on the three per-branch logits added to the fusion CE: 0 for the
    # canonical trainer (train.py:78), 1.0 for the exhaustive-CV trainer
    # (train_exhausted.py:67-75).
    branch_loss_weight: float = 0.0
    freeze_encoders: bool = True  # train.py:35-40
    loss: str = "cross_entropy"  # or "focal"
    focal_alpha: float = 1.0
    focal_gamma: float = 2.0
    schedule: str = "constant"  # or "onecycle"
    onecycle_peak_lr: float = 1e-3
    checkpoint_dir: str = "./checkpoints"
    log_dir: str = "./runs"
    output_dir: str = "./output"
    keep_checkpoints: int = 3
    eval_batch_size: int = 0  # 0 = same as batch_size
    # For one fit: a NaN or Inf in a train step's loss or gradients raises
    # FloatingPointError (jax_debug_nans in the JAX package); it costs a
    # host sync a step, so it is off by default
    debug_nans: bool = False
    # CV settings (reference config.py:39-40): nested k_outer x k_inner
    # folds (`train/cv.nested_cv`)
    k_outer: int = 5
    k_inner: int = 3
    # Fusion only: encode each split once with the frozen encoders in eval
    # mode and train the surface after them over the cached embeddings
    # (`train/embed.py`). Needs freeze_encoders.
    cache_embeddings: bool = False
    # With cache_embeddings: first fit the frozen encoders' BatchNorm
    # running statistics to the train split (3 train-mode passes, no
    # gradients), as the reference's train-mode encoders keep doing.
    cache_bn_calibrate: bool = True
    # Streaming of splits over the device-memory budget
    # (`data/pipeline.resolve_hbm_budget`): this many planned batches cross
    # to the card per copy (`pipeline.prefetch_chunks`); 0 = per batch in
    # the engine, and in the CLI the size `pipeline.auto_chunk_batches`
    # picks (a chunk at most budget/6, three in flight).
    stream_chunk_batches: int = 0

    @property
    def eval_bs(self) -> int:
        return self.eval_batch_size or self.batch_size


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = DataConfig()
    mesh: MeshConfig = MeshConfig()
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    name: str = "fusion"


def fusion_preset() -> Config:
    """Trimodal fusion training (reference train.py)."""
    return Config(name="fusion")


def fusion_modal_balance_preset() -> Config:
    """Modal-balance fusion variant (reference train_paper_modal_balance.py)."""
    return Config(name="fusion_modal_balance", model=ModelConfig.modal_balance())


def fusion_cached_preset() -> Config:
    """Trimodal fusion over cached frozen-encoder embeddings (JAX
    config.py:203-219): the encoders run once per split in eval mode after
    a BatchNorm calibration, and the epochs train the fusion surface."""
    return Config(name="fusion_cached",
                  train=TrainConfig(cache_embeddings=True))


def image_only_preset() -> Config:
    """Image-only ResNet18 (reference train_image_only.py): bs 16,
    constant lr 1e-4, CE, early stop 5, no plateau decay
    (train_image_only.py:160-174)."""
    return Config(
        name="image_only",
        train=TrainConfig(lr=1e-4, freeze_encoders=False,
                          plateau_patience=0),
    )


def signal_only_preset() -> Config:
    """Signal-only ResNet1D-SE on the trimodal cohort's signals (reference
    train_signal_only.py:115,234-238: bs 8, lr 1e-3, focal, one-cycle;
    early stopping is commented out there, :301-304)."""
    return Config(
        name="signal_only",
        train=TrainConfig(
            batch_size=8,
            lr=1e-3,
            loss="focal",
            schedule="onecycle",
            onecycle_peak_lr=1e-3,
            freeze_encoders=False,
            patience=0,
        ),
    )


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
            freeze_encoders=False,
            patience=0,
        ),
    )


def physionet_preset() -> Config:
    """PhysioNet/CinC 2017 binary task (reference train_physionet.py:
    bs 8 :128-130, OneCycle max 1e-3 over 30 epochs :278-281, focal;
    its early-stop counter is initialised but never incremented :288)."""
    return Config(
        name="physionet",
        data=DataConfig(signal_len=3000, signal_fs=300.0),
        train=TrainConfig(
            batch_size=8,
            lr=1e-3,
            loss="focal",
            schedule="onecycle",
            freeze_encoders=False,
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


def signal_af_preset() -> Config:
    """AF-vs-rest tiny-positive task (reference train_signal_only_af.py:
    manual split, 2 positive train samples)."""
    return dataclasses.replace(signal_only_preset(), name="signal_af")


def signal_arr_preset() -> Config:
    """Arrhythmia(1) vs Abnormal(0) (reference train_signal_only_arr.py)."""
    return dataclasses.replace(signal_only_preset(), name="signal_arr")


def signal_12lead_preset() -> Config:
    """12-lead AF task (reference train_signal_12_af.py:246:
    ResNet1D_SE(input_channels=12)); unlike the other signal trainers its
    early stopping is active (patience 5, train_signal_12_af.py:312-316)."""
    base = signal_only_preset()
    return dataclasses.replace(
        base,
        name="signal_12lead",
        model=ModelConfig(signal_input_channels=12),
        train=dataclasses.replace(base.train, patience=5),
    )


def physionet_crnn_preset() -> Config:
    """Spectrogram CRNN on PhysioNet (reference train_physionet2.py: bs 16
    and lr 1e-4 from its Config :163-170, constant-LR Adam with no
    scheduler and no plateau block; early stopping is commented out
    :226-229)."""
    base = physionet_preset()
    return dataclasses.replace(
        base,
        name="physionet_crnn",
        train=dataclasses.replace(base.train, batch_size=16, lr=1e-4,
                                  schedule="constant", plateau_patience=0),
    )


def physionet_transformer_preset() -> Config:
    """1-D Transformer on PhysioNet (reference train_physionet.py:211)."""
    return dataclasses.replace(physionet_preset(),
                               name="physionet_transformer")


PRESETS = {
    "fusion": fusion_preset,
    "fusion_modal_balance": fusion_modal_balance_preset,
    "fusion_cached": fusion_cached_preset,
    "image_only": image_only_preset,
    "signal_only": signal_only_preset,
    "ptbxl_af": ptbxl_preset,
    "physionet": physionet_preset,
    "physionet_multi": physionet_multi_preset,
    "signal_af": signal_af_preset,
    "signal_arr": signal_arr_preset,
    "signal_12lead": signal_12lead_preset,
    "physionet_crnn": physionet_crnn_preset,
    "physionet_transformer": physionet_transformer_preset,
}


def get_preset(name: str) -> Config:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        ) from None
