"""Trimodal and signal-task materialisation and the epoch plan (port of
the device-resident part of `ecgmm_tpu/data/pipeline.py`).

Each split is preprocessed once on the host and then held on the device
as tensors (images as (N, 3, H, W) uint8); a training epoch gathers its
batches there with `index_select` (`train/engine.py`), so sample data
crosses to the device once per run. HBM budgets, host-resident streaming
splits and split caches are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ecgmm_torch.data import preprocess, splits
from ecgmm_torch.data.synthetic import SyntheticCohort
from ecgmm_torch.ops.spectrogram import log_spectrogram


class Arrays(NamedTuple):
    """One materialised split on the device. Fields may be None for
    unimodal tasks. A cached split (`train/embed.py`) holds the frozen
    encoders' raw (N, D) float32 embeddings in the three modality slots."""

    images: Optional[torch.Tensor]    # (N, 3, H, W) uint8, or (N, D) f32
    signals: Optional[torch.Tensor]   # (N, T), (N, C, T), (N, F, frames)
    #                                   spectrograms, or (N, D) f32
    clinical: Optional[torch.Tensor]  # (N, C), or (N, D) float32
    labels: torch.Tensor              # (N,) int64
    indices: np.ndarray               # (N,) original patient ids (host)

    @property
    def n(self) -> int:
        return int(self.labels.shape[0])


@dataclasses.dataclass
class MaterializedData:
    train: Arrays
    val: Arrays
    test: Arrays
    # the StandardScalers fit on the train split (trimodal tasks only)
    ecg_scaler: Optional[preprocess.Scaler] = None
    clinical_scaler: Optional[preprocess.Scaler] = None


class Batch(NamedTuple):
    images: Optional[torch.Tensor]
    signals: Optional[torch.Tensor]
    clinical: Optional[torch.Tensor]
    labels: torch.Tensor
    # 1.0 for real samples, 0.0 for pad rows (the last batch is padded to
    # the full batch size)
    mask: torch.Tensor


def materialize_trimodal(cohort: SyntheticCohort, cfg,
                         device="cuda") -> MaterializedData:
    """Split, scale and preprocess a trimodal cohort into device tensors,
    as the reference's get_dataloaders (dataset.py:118-213) does:
    stratified 8:1:1 on `cfg.train.seed`, StandardScalers fit on the train
    rows only (the whole ECG matrix; AGE/Wt, or every clinical column for
    the modal-balance variant, dataset_image.py:36), the hospital filter
    on the scaled signals; clinical columns past the scaled ones pass
    unscaled. Images (N, H, W, 3) uint8 are permuted to (N, 3, H, W) on the
    host and cross to `device` once, as every split does."""
    device = torch.device(device)
    sp = splits.stratified_811(cohort.labels, seed=cfg.train.seed)
    n_scaled = (cohort.clinical.shape[1]
                if cfg.model.variant == "modal_balance" else 2)
    ecg_scaler = preprocess.Scaler.fit(cohort.signals[sp.train])
    clin_scaler = preprocess.Scaler.fit(cohort.clinical[sp.train, :n_scaled])

    def build(idx: np.ndarray) -> Arrays:
        sig = preprocess.preprocess_hospital(
            ecg_scaler.transform(cohort.signals[idx]))
        clin = np.concatenate(
            [clin_scaler.transform(cohort.clinical[idx, :n_scaled]),
             np.asarray(cohort.clinical[idx, n_scaled:], np.float32)],
            axis=1)
        images = np.ascontiguousarray(cohort.images[idx].transpose(0, 3, 1, 2))
        return Arrays(
            images=torch.from_numpy(images).to(device),
            signals=torch.from_numpy(np.ascontiguousarray(sig, np.float32)
                                     ).to(device),
            clinical=torch.from_numpy(clin).to(device),
            labels=torch.from_numpy(
                np.asarray(cohort.labels[idx], np.int64)).to(device),
            indices=cohort.indices[idx],
        )

    return MaterializedData(train=build(sp.train), val=build(sp.val),
                            test=build(sp.test), ecg_scaler=ecg_scaler,
                            clinical_scaler=clin_scaler)


def materialize_signal(
    signals: np.ndarray,
    labels: np.ndarray,
    split: splits.Split,
    preprocess_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    spectrogram: bool = False,
    device="cuda",
) -> MaterializedData:
    """Signal-only task materialisation (the reference's
    train_signal_only* / train_physionet* / train_signal_only_ptb
    families): `preprocess_fn` maps a split's (N, ..., T) host signals to
    (N, ..., T'); with `spectrogram` the result becomes (N, F, frames)
    log-spectrograms on the host, for the CRNN (train_physionet2.py);
    then each split moves to `device` once."""
    device = torch.device(device)

    def build(idx: np.ndarray) -> Arrays:
        sig = signals[idx]
        if preprocess_fn is not None:
            sig = preprocess_fn(sig)
        sig = torch.from_numpy(np.ascontiguousarray(sig, np.float32))
        if spectrogram:
            sig = log_spectrogram(sig).contiguous()
        return Arrays(
            images=None,
            signals=sig.to(device),
            clinical=None,
            labels=torch.from_numpy(
                np.asarray(labels[idx], np.int64)).to(device),
            indices=np.asarray(idx),
        )

    return MaterializedData(train=build(split.train), val=build(split.val),
                            test=build(split.test))


def epoch_order(
    n: int, *, shuffle: bool, seed: int, epoch: int,
    sample_weights: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The per-epoch sample order. `sample_weights` turns on weighted
    sampling with replacement, the reference's WeightedRandomSampler
    (train_signal_only_ptb.py:230-241)."""
    rng = np.random.RandomState(seed + epoch)
    if sample_weights is not None:
        p = np.asarray(sample_weights, np.float64)
        p = p / p.sum()
        return rng.choice(n, size=n, replace=True, p=p)
    order = np.arange(n)
    if shuffle:
        rng.shuffle(order)
    return order


def num_batches(n: int, batch_size: int, drop_remainder: bool = False) -> int:
    return n // batch_size if drop_remainder else -(-n // batch_size)
