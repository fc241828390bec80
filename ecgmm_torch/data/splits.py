"""Deterministic stratified splits (port of the three-way splits of
`ecgmm_tpu/data/splits.py`) without scikit-learn.

`_train_test_split` is a numpy copy of what sklearn's
`train_test_split(..., stratify=y, random_state=seed)` does, so the index
sets equal sklearn's: `StratifiedShuffleSplit` with integer sizes
(n_test = ceil(test_size * n)), class members by a stable argsort of the
class ids, `_approximate_mode` for the per-class train and test counts, a
`RandomState` permutation within each class, then a permutation of each
side. The nested and exhaustive CV splits wait with CV (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np


class Split(NamedTuple):
    train: np.ndarray
    val: np.ndarray
    test: np.ndarray


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """The per-class counts closest to the multivariate hypergeometric
    mode; ties in the remainders are broken by `rng` (sklearn's
    `utils.extmath._approximate_mode`)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _train_test_split(labels: np.ndarray, test_size: float,
                      seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) positions into `labels`, as sklearn's stratified
    `train_test_split` of `arange(len(labels))` returns them."""
    labels = np.asarray(labels)
    n = labels.shape[0]
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    classes, y_indices, class_counts = np.unique(
        labels, return_inverse=True, return_counts=True
    )
    if np.min(class_counts) < 2:
        raise ValueError(
            "The least populated classes in y have only 1 member, which is "
            "too few: " + str(classes[class_counts < 2].tolist())
        )
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(
            f"train ({n_train}) and test ({n_test}) sizes must each be at "
            f"least the number of classes ({len(classes)})"
        )
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = rng.permutation(class_counts[i])
        members = class_indices[i].take(perm, mode="clip")
        train.extend(members[:n_i[i]])
        test.extend(members[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def _three_way(labels: np.ndarray, first: float, second: float,
               seed: int) -> Split:
    """Hold out `first` of the cohort, then split the held-out part into
    val and test with `second` going to test (the reference's two chained
    `train_test_split` calls)."""
    labels = np.asarray(labels)
    train_idx, temp_idx = _train_test_split(labels, first, seed)
    val_pos, test_pos = _train_test_split(labels[temp_idx], second, seed)
    return Split(train_idx, temp_idx[val_pos], temp_idx[test_pos])


def stratified_811(labels: np.ndarray, seed: int = 42) -> Split:
    """80/10/10 (reference dataset.py:167-173)."""
    return _three_way(labels, 0.2, 0.5, seed)


def stratified_622(labels: np.ndarray, seed: int = 42) -> Split:
    """60/20/20 (reference train_signal_only_ptb.py:227-228)."""
    return _three_way(labels, 0.4, 0.5, seed)


def stratified_712(labels: np.ndarray, seed: int = 42) -> Split:
    """70/10/20 (reference train_physionet_multi.py:91-96)."""
    return _three_way(labels, 0.3, 2 / 3, seed)
