"""Signal-task materialisation and the epoch plan (port of the
device-resident part of `ecgmm_tpu/data/pipeline.py`).

Each split is preprocessed once on the host and then held on the device
as tensors; a training epoch gathers its batches there with
`index_select` (`train/engine.py`), so sample data crosses to the device
once per run. HBM budgets, host-resident streaming splits and split
caches are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ecgmm_torch.data import splits


class Arrays(NamedTuple):
    """One materialised split on the device. Fields may be None for
    unimodal tasks."""

    images: Optional[torch.Tensor]    # (N, 3, H, W) uint8
    signals: Optional[torch.Tensor]   # (N, T) or (N, C, T) float32
    clinical: Optional[torch.Tensor]  # (N, C) float32
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


class Batch(NamedTuple):
    images: Optional[torch.Tensor]
    signals: Optional[torch.Tensor]
    clinical: Optional[torch.Tensor]
    labels: torch.Tensor
    # 1.0 for real samples, 0.0 for pad rows (the last batch is padded to
    # the full batch size)
    mask: torch.Tensor


def materialize_signal(
    signals: np.ndarray,
    labels: np.ndarray,
    split: splits.Split,
    preprocess_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    device="cuda",
) -> MaterializedData:
    """Signal-only task materialisation (the reference's
    train_signal_only* / train_physionet* / train_signal_only_ptb
    families): `preprocess_fn` maps a split's (N, ..., T) host signals to
    (N, ..., T'), then each split moves to `device` once."""
    device = torch.device(device)

    def build(idx: np.ndarray) -> Arrays:
        sig = signals[idx]
        if preprocess_fn is not None:
            sig = preprocess_fn(sig)
        return Arrays(
            images=None,
            signals=torch.from_numpy(
                np.ascontiguousarray(sig, np.float32)).to(device),
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
