"""Frozen-encoder embeddings for cached fusion training (port of the
device-resident path of `ecgmm_tpu/train/embed.py`).

The fusion trainer freezes the three encoders and trains the surface after
them, yet the `fusion` preset runs the encoders at every step. With
`TrainConfig.cache_embeddings` each split is encoded once instead
(`precompute_fusion_embeddings`, the encoders in eval mode) and the epochs
train the fusion head task over the cached (N, D) embeddings. Eval-mode
encoders use their running statistics, so `calibrate_bn_stats` first fits
them to the train split with a few train-mode passes, as the reference's
train-mode encoders keep doing while frozen. The calibrated buffers stay
in the model, so the checkpoints and serving see what the head was trained
on. Host-resident (streamed) splits and the CV encoders wait for their
slices (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ecgmm_torch.config import TrainConfig
from ecgmm_torch.data.pipeline import Arrays, MaterializedData
from ecgmm_torch.models.fusion import ECGMultimodalModel
from ecgmm_torch.models.layers import set_dropout_generator
from ecgmm_torch.train.engine import Task, epoch_indices
from ecgmm_torch.train.state import TrainState
from ecgmm_torch.workloads.tasks import make_fusion_head_task


def calibrate_bn_stats(state: TrainState, arrays: Arrays, batch_size: int,
                       passes: int = 3) -> TrainState:
    """`passes` train-mode forwards of the whole model over the split's
    full batches in order, without gradients: every BatchNorm folds each
    batch's statistics into its running buffers, and nothing else changes.
    Only full batches run (a padded tail would bias the statistics toward
    its pad row); a split smaller than `batch_size` is one batch of all its
    rows. Dropout draws from a generator of its own seeded 0, as JAX draws
    calibration dropout from a fixed key, so `state.generator` does not
    move. Returns `state`, its model holding the calibrated buffers."""
    n = arrays.n
    model = state.model
    if n == 0:
        return state
    bs = min(batch_size, n)
    n_full = n // bs
    device = arrays.labels.device
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    was_training = model.training
    set_dropout_generator(model, generator)
    try:
        model.train()
        with torch.no_grad():
            for _ in range(passes):
                for j in range(n_full):
                    rows = slice(j * bs, (j + 1) * bs)
                    model(arrays.images[rows], arrays.signals[rows],
                          arrays.clinical[rows])
    finally:
        set_dropout_generator(model, state.generator)
        model.train(was_training)
    return state


def maybe_calibrate_bn_stats(state: TrainState, train_arrays: Arrays,
                             cfg: TrainConfig,
                             frozen: bool = True) -> TrainState:
    """`calibrate_bn_stats` over the train split at `cfg.eval_bs` where the
    cached path applies and `cfg.cache_bn_calibrate` is set; else `state`
    as it is, quietly (`maybe_cache_fusion_embeddings`, called next, warns
    where the flag is set but the path cannot apply)."""
    if not (cfg.cache_bn_calibrate and cfg.cache_embeddings
            and isinstance(state.model, ECGMultimodalModel) and frozen):
        return state
    return calibrate_bn_stats(state, train_arrays, cfg.eval_bs)


def cache_applies(model, cfg: TrainConfig, frozen: bool) -> bool:
    """Whether the cached path applies: `cfg.cache_embeddings` on a fusion
    model with frozen encoders. Where the flag is set but the model or the
    freezing rules it out, warn and take the uncached path."""
    if not cfg.cache_embeddings:
        return False
    if not isinstance(model, ECGMultimodalModel) or not frozen:
        warnings.warn(
            "cache_embeddings=True ignored: the cached path needs a fusion "
            f"model with frozen encoders (got {type(model).__name__}, "
            f"frozen={frozen}); training takes the uncached path.",
            stacklevel=3,
        )
        return False
    return True


def precompute_fusion_embeddings(model: ECGMultimodalModel, arrays: Arrays,
                                 batch_size: int) -> Arrays:
    """`model.encode_raw` over a split in batches of `batch_size` in order
    (the last one padded with row 0, its pad rows dropped), without
    gradients. Returns an Arrays whose image, signal and clinical slots
    hold the raw (N, D) float32 embeddings, for `make_fusion_head_task`.
    An empty split keeps the branch widths: (0, D) each."""
    n = arrays.n
    device = arrays.labels.device
    if n == 0:
        c = model.cfg
        return arrays._replace(**{
            f: torch.zeros((0, d), dtype=torch.float32, device=device)
            for f, d in (("images", c.image_dim), ("signals", c.signal_dim),
                         ("clinical", c.clinical_dim))})
    idx, _ = epoch_indices(n, batch_size, shuffle=False, seed=0, epoch=0)
    idx_d = torch.from_numpy(idx.astype(np.int64)).to(device)
    outs = []
    with torch.no_grad():
        for rows in idx_d:
            outs.append(model.encode_raw(
                *(a.index_select(0, rows)
                  for a in (arrays.images, arrays.signals, arrays.clinical))))
    img, sig, clin = (torch.cat(o)[:n] for o in zip(*outs))
    return arrays._replace(images=img, signals=sig, clinical=clin)


def maybe_cache_fusion_embeddings(
    state: TrainState, splits: Dict[str, Arrays], cfg: TrainConfig,
    frozen: bool = True,
) -> Tuple[Dict[str, Arrays], Optional[Task]]:
    """The wiring point of the cached path: where it applies
    (`cache_applies`), each split encoded at `cfg.eval_bs` and the fusion
    head task, `({name: cached Arrays}, task)`; else `(splits, None)`."""
    if not cache_applies(state.model, cfg, frozen):
        return splits, None
    cached = {name: precompute_fusion_embeddings(state.model, arrays,
                                                 cfg.eval_bs)
              for name, arrays in splits.items()}
    return cached, make_fusion_head_task(cfg)


def cache_run_splits(state: TrainState, data: MaterializedData,
                     cfg: TrainConfig, frozen: bool = True
                     ) -> Tuple[MaterializedData, Optional[Task]]:
    """The cached path of a run (`run()`, the pipeline's fusion stage), as
    JAX's run.py:349-369 wires it: `maybe_calibrate_bn_stats` on the
    train split, then `maybe_cache_fusion_embeddings` over the three
    splits. Returns (the data to train and test on, the head task) where
    the path applies, else (`data`, None)."""
    maybe_calibrate_bn_stats(state, data.train, cfg, frozen=frozen)
    splits, task = maybe_cache_fusion_embeddings(
        state, {"train": data.train, "val": data.val, "test": data.test},
        cfg, frozen=frozen)
    if task is not None:
        data = dataclasses.replace(data, **splits)
    return data, task
