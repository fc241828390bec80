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
on. A host-resident split (a `HostArrays`, over the device-memory
budget) streams through both, batch by batch (`pipeline.prefetch_batches`),
with the resident path's batches and results; the embeddings come back on
the device. The CV harnesses encode per fold: `encode_image_cohort` runs
the image encoder once over a whole cohort, `encode_sigcli_rows` the
signal and clinical encoders over per-fold transformed rows
(`train/cv_parallel.prepare_folds`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ecgmm_torch.config import TrainConfig
from ecgmm_torch.data.pipeline import (Arrays, HostArrays, MaterializedData,
                                       prefetch_batches)
from ecgmm_torch.models.fusion import ECGMultimodalModel
from ecgmm_torch.models.layers import set_dropout_generator
from ecgmm_torch.parallel import collectives, tp
from ecgmm_torch.parallel.mesh import Mesh
from ecgmm_torch.train.engine import (Task, check_divides, gather_outputs,
                                      local_plan, batch_part, row_shard,
                                      epoch_indices)
from ecgmm_torch.train.state import TrainState
from ecgmm_torch.workloads.tasks import make_fusion_head_task


def calibrate_bn_stats(state: TrainState, arrays: Arrays, batch_size: int,
                       passes: int = 3, mesh: Optional[Mesh] = None
                       ) -> TrainState:
    """`passes` train-mode forwards of the whole model over the split's
    full batches in order, without gradients: every BatchNorm folds each
    batch's statistics into its running buffers, and nothing else changes.
    Only full batches run (a padded tail would bias the statistics toward
    its pad row); a split smaller than `batch_size` is one batch of all its
    rows. Dropout draws from a generator of its own seeded 0, as JAX draws
    calibration dropout from a fixed key, so `state.generator` does not
    move. Returns `state`, its model holding the calibrated buffers. With
    `mesh` each rank runs its rows of every batch under the data-parallel
    context (global moments and masks), so every rank's buffers are the
    one-process run's."""
    n = arrays.n
    model = state.model
    if n == 0:
        return state
    bs = min(batch_size, n)
    n_full = n // bs
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    was_training = model.training
    set_dropout_generator(model, generator)
    try:
        model.train()
        with torch.no_grad(), tp.gathered(model), \
                collectives.data_parallel(row_shard(mesh)):
            for _ in range(passes):
                for b in _full_batches(arrays, bs, n_full, device, mesh):
                    model(*b)
    finally:
        set_dropout_generator(model, state.generator)
        model.train(was_training)
    return state


def _full_batches(arrays, bs: int, n_full: int, device, mesh=None):
    """The split's first `n_full` batches of `bs` rows in order, as
    (images, signals, clinical): slices of a device split, or copies of a
    host split's rows; with `mesh`, this rank's rows of each."""
    check_divides(bs, mesh, "calibration batch size")
    part = batch_part(bs, mesh)
    if isinstance(arrays, HostArrays):
        for j, b in enumerate(prefetch_batches(arrays, bs, shuffle=False,
                                               seed=0, device=device,
                                               part=part)):
            if j >= n_full:
                break
            yield b.images, b.signals, b.clinical
        return
    lo, hi = part or (0, bs)
    for j in range(n_full):
        rows = slice(j * bs + lo, j * bs + hi)
        yield (arrays.images[rows], arrays.signals[rows],
               arrays.clinical[rows])


def maybe_calibrate_bn_stats(state: TrainState, train_arrays: Arrays,
                             cfg: TrainConfig, frozen: bool = True,
                             mesh: Optional[Mesh] = None) -> TrainState:
    """`calibrate_bn_stats` over the train split at `cfg.eval_bs` where the
    cached path applies and `cfg.cache_bn_calibrate` is set; else `state`
    as it is, quietly (`maybe_cache_fusion_embeddings`, called next, warns
    where the flag is set but the path cannot apply)."""
    if not (cfg.cache_bn_calibrate and cfg.cache_embeddings
            and isinstance(state.model, ECGMultimodalModel) and frozen):
        return state
    return calibrate_bn_stats(state, train_arrays, cfg.eval_bs, mesh=mesh)


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
                                 batch_size: int,
                                 mesh: Optional[Mesh] = None) -> Arrays:
    """`model.encode_raw` over a split in batches of `batch_size` in order
    (the last one padded with row 0, its pad rows dropped), without
    gradients. Returns an Arrays whose image, signal and clinical slots
    hold the raw (N, D) float32 embeddings, for `make_fusion_head_task`.
    An empty split keeps the branch widths: (0, D) each. With `mesh` each
    rank encodes its rows of every batch and gathers the batch's
    embeddings over the data group, so every rank holds the whole split
    (`ecgmm_tpu/train/embed.py:315-380`)."""
    n = arrays.n
    device = next(model.parameters()).device
    labels = arrays.labels
    if isinstance(arrays, HostArrays):
        labels = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
    if n == 0:
        c = model.cfg
        return Arrays(labels=labels, indices=np.asarray(arrays.indices), **{
            f: torch.zeros((0, d), dtype=torch.float32, device=device)
            for f, d in (("images", c.image_dim), ("signals", c.signal_dim),
                         ("clinical", c.clinical_dim))})
    check_divides(batch_size, mesh, "eval batch size")
    if isinstance(arrays, HostArrays):
        batches = ((b.images, b.signals, b.clinical) for b in
                   prefetch_batches(arrays, batch_size, shuffle=False,
                                    seed=0, device=device,
                                    part=batch_part(batch_size, mesh)))
    else:
        idx, mask = epoch_indices(n, batch_size, shuffle=False, seed=0,
                                  epoch=0)
        idx, _ = local_plan(idx, mask, mesh)
        idx_d = torch.from_numpy(idx.astype(np.int64)).to(device)
        batches = (tuple(a.index_select(0, rows) for a in
                         (arrays.images, arrays.signals, arrays.clinical))
                   for rows in idx_d)
    shard = row_shard(mesh)
    with torch.no_grad(), tp.gathered(model):
        outs = [gather_outputs(model.encode_raw(*b), shard)
                for b in batches]
    img, sig, clin = (torch.cat(o)[:n] for o in zip(*outs))
    return Arrays(images=img, signals=sig, clinical=clin, labels=labels,
                  indices=np.asarray(arrays.indices))


@contextlib.contextmanager
def _eval_encoders(model: ECGMultimodalModel):
    """The three encoders in eval mode (running statistics, no dropout)
    for the block, as `encode_raw` runs them; their modes are restored
    afterwards."""
    encoders = (model.image_encoder, model.signal_encoder,
                model.clinical_encoder)
    modes = [m.training for m in encoders]
    try:
        for m in encoders:
            m.eval()
        yield
    finally:
        for m, mode in zip(encoders, modes):
            m.train(mode)


def _encode_rows(encode, n: int, batch_size: int, device):
    """`encode` (a function of a batch's row indices on `device`) over
    rows 0..n-1 in unshuffled batches of `batch_size`, the last one padded
    with row 0; the outputs' pad rows stripped and the batches
    concatenated (a tuple of outputs, each concatenated)."""
    idx, _ = epoch_indices(n, batch_size, shuffle=False, seed=0, epoch=0)
    idx_d = torch.from_numpy(idx.astype(np.int64)).to(device)
    with torch.no_grad():
        outs = [encode(rows) for rows in idx_d]
    return tuple(torch.cat(o)[:n] for o in zip(*outs))


def encode_image_cohort(model: ECGMultimodalModel, images: torch.Tensor,
                        batch_size: int) -> torch.Tensor:
    """The raw image embeddings (N, image_dim) float32 of a whole cohort
    (N, 3, H, W) uint8 on the model's device: the image encoder in eval
    mode, as `encode_raw` runs it, in unshuffled batches of `batch_size`.
    Each row's embedding depends on that row alone, so gathering a fold's
    rows from it equals encoding the fold."""
    def encode(rows):
        return (model.encode_image(images.index_select(0, rows))[0],)

    with _eval_encoders(model):
        (img,) = _encode_rows(encode, images.shape[0], batch_size,
                              images.device)
    return img


def encode_sigcli_rows(model: ECGMultimodalModel, signals: torch.Tensor,
                       clinical: torch.Tensor, batch_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raw signal and clinical embeddings of (rows, T) signals and
    (rows, C) clinical features on the model's device: both encoders in
    eval mode, as `encode_raw` runs them, in unshuffled batches of
    `batch_size`. The fold-parallel harness passes every fold's
    transformed cohort at once, flattened to (F*N, ...)."""
    with _eval_encoders(model):
        return _encode_rows(
            lambda rows: (
                model.encode_signal(signals.index_select(0, rows)),
                model._encode_clinical_raw(clinical.index_select(0, rows))[0]),
            signals.shape[0], batch_size, signals.device)


def maybe_cache_fusion_embeddings(
    state: TrainState, splits: Dict[str, Arrays], cfg: TrainConfig,
    frozen: bool = True, mesh: Optional[Mesh] = None,
) -> Tuple[Dict[str, Arrays], Optional[Task]]:
    """The wiring point of the cached path: where it applies
    (`cache_applies`), each split encoded at `cfg.eval_bs` and the fusion
    head task, `({name: cached Arrays}, task)`; else `(splits, None)`."""
    if not cache_applies(state.model, cfg, frozen):
        return splits, None
    cached = {name: precompute_fusion_embeddings(state.model, arrays,
                                                 cfg.eval_bs, mesh)
              for name, arrays in splits.items()}
    return cached, make_fusion_head_task(cfg)


def cache_run_splits(state: TrainState, data: MaterializedData,
                     cfg: TrainConfig, frozen: bool = True,
                     mesh: Optional[Mesh] = None
                     ) -> Tuple[MaterializedData, Optional[Task]]:
    """The cached path of a run (`run()`, the pipeline's fusion stage), as
    JAX's run.py:349-369 wires it: `maybe_calibrate_bn_stats` on the
    train split, then `maybe_cache_fusion_embeddings` over the three
    splits. Returns (the data to train and test on, the head task) where
    the path applies, else (`data`, None)."""
    maybe_calibrate_bn_stats(state, data.train, cfg, frozen=frozen,
                             mesh=mesh)
    splits, task = maybe_cache_fusion_embeddings(
        state, {"train": data.train, "val": data.val, "test": data.test},
        cfg, frozen=frozen, mesh=mesh)
    if task is not None:
        data = dataclasses.replace(data, **splits)
    return data, task
