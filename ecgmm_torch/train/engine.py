"""Training engine (port of the device-resident single-device path of
`ecgmm_tpu/train/engine.py`).

The JAX engine runs an epoch as one jitted `lax.scan`; here a Python loop
issues one train step per batch, each batch gathered on the device from
the materialised split with `index_select`. The host reads the device
only at the end of an epoch (the summed losses and counts), so the steps
queue on the card without waiting for it. The control semantics are the
reference's (train.py:55-167), as the JAX engine keeps them:
  * `epoch_indices` pads the last batch with index 0 and mask 0; pad rows
    go through the model, so they enter the BatchNorm batch statistics,
    while the loss and accuracy mask them out;
  * the train loss is the sum of the batch losses over the number of
    batches; the eval loss is the mean of the per-batch losses, the
    padded batch included;
  * a non-finite val loss neither improves `best` nor counts as a stale
    epoch; the counters update before the checkpoints are written; early
    stop and the plateau decay follow the config (0 disables them);
  * on SIGTERM the current epoch finishes, `last` is written, and fit
    returns with `preempted` set.
The mesh, streaming, super-chunks and `keep_best` are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ecgmm_torch.config import TrainConfig
from ecgmm_torch.data.pipeline import Arrays, Batch, epoch_order
from ecgmm_torch.train.checkpoint import CheckpointManager
from ecgmm_torch.train.logging import MetricWriter
from ecgmm_torch.train.state import TrainState


@dataclasses.dataclass(frozen=True)
class Task:
    """Workload contract.

    apply: (model, batch) -> outputs; the engine sets train or eval mode.
    loss:  (outputs, batch) -> (scalar loss tensor, dict of scalar tensors)
    logits:(outputs) -> (B, C) classification logits for accuracy.
    """

    apply: Callable
    loss: Callable
    logits: Callable


class EvalResult(NamedTuple):
    loss: float
    accuracy: float
    logits: np.ndarray
    labels: np.ndarray
    metrics: Dict[str, float]


def _empty_eval() -> EvalResult:
    return EvalResult(float("nan"), float("nan"),
                      np.zeros((0, 2), np.float32),
                      np.zeros((0,), np.int64), {})


def epoch_indices(
    n: int, batch_size: int, *, shuffle: bool, seed: int, epoch: int,
    sample_weights: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side epoch plan: an (n_batches, bs) index matrix and its pad
    mask. Pad positions take index 0 and mask 0."""
    order = epoch_order(n, shuffle=shuffle, seed=seed, epoch=epoch,
                        sample_weights=sample_weights)
    n_batches = -(-n // batch_size)
    padded = n_batches * batch_size
    mask = np.zeros(padded, np.float32)
    mask[:n] = 1.0
    full = np.concatenate([order, np.zeros(padded - n, np.int64)])
    return (full.reshape(n_batches, batch_size).astype(np.int32),
            mask.reshape(n_batches, batch_size))


def gather_batch(arrays: Arrays, idx: torch.Tensor,
                 mask: torch.Tensor) -> Batch:
    """One batch gathered on the device from a materialised split."""
    def take(a):
        return None if a is None else a.index_select(0, idx)

    return Batch(images=take(arrays.images), signals=take(arrays.signals),
                 clinical=take(arrays.clinical), labels=take(arrays.labels),
                 mask=mask)


def _plan_on_device(idx: np.ndarray, mask: np.ndarray, device):
    return (torch.from_numpy(idx.astype(np.int64)).to(device),
            torch.from_numpy(mask).to(device))


def train_step(task: Task, state: TrainState,
               batch: Batch) -> Dict[str, torch.Tensor]:
    """Forward, loss, backward and one Adam update; returns the step's
    metrics as device scalars (no host synchronisation)."""
    model = state.model
    model.train()
    outputs = task.apply(model, batch)
    loss, mets = task.loss(outputs, batch)
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step(state.step)
    state.step += 1
    with torch.no_grad():
        preds = task.logits(outputs).argmax(-1)
        correct = ((preds == batch.labels).float() * batch.mask).sum()
    return {"loss": loss.detach(), "correct": correct,
            "count": batch.mask.sum(), **mets}


def _assemble_eval(losses, logits, labels, extra) -> EvalResult:
    """Batch-averaged loss (the reference averages batch means,
    train.py:95-113), accuracy over real rows, metric means."""
    return EvalResult(
        loss=float(np.mean(np.asarray(losses))),
        accuracy=float((logits.argmax(-1) == labels).mean()),
        logits=logits,
        labels=labels,
        metrics={k: float(np.mean(np.asarray(v))) for k, v in extra.items()},
    )


def evaluate(task: Task, state: TrainState, arrays: Arrays,
             batch_size: int) -> EvalResult:
    """Full-split eval in eval mode without autograd: the JAX
    `evaluate_scan` semantics, read back to the host once."""
    if arrays.n == 0:
        return _empty_eval()
    idx, mask = epoch_indices(arrays.n, batch_size, shuffle=False, seed=0,
                              epoch=0)
    device = arrays.labels.device
    idx_d, mask_d = _plan_on_device(idx, mask, device)
    model = state.model
    model.eval()
    losses, logits, labels = [], [], []
    extra: Dict[str, List[torch.Tensor]] = {}
    with torch.no_grad():
        for i in range(idx.shape[0]):
            batch = gather_batch(arrays, idx_d[i], mask_d[i])
            outputs = task.apply(model, batch)
            loss, mets = task.loss(outputs, batch)
            losses.append(loss)
            logits.append(task.logits(outputs).float())
            labels.append(batch.labels)
            for k, v in mets.items():
                if v.dim() == 0:
                    extra.setdefault(k, []).append(v)
        keep = mask.reshape(-1) > 0
        flat_logits = torch.cat(logits).cpu().numpy()[keep]
        flat_labels = torch.cat(labels).cpu().numpy()[keep]
        return _assemble_eval(
            torch.stack(losses).cpu().numpy(), flat_logits, flat_labels,
            {k: torch.stack(v).cpu().numpy() for k, v in extra.items()},
        )


@dataclasses.dataclass
class FitResult:
    state: TrainState
    history: List[Dict[str, float]]
    best_epoch: int
    stopped_early: bool
    # SIGTERM arrived mid-fit: the epoch finished, `last` was written
    preempted: bool = False


def fit(
    task: Task,
    state: TrainState,
    train_arrays: Arrays,
    val_arrays: Arrays,
    cfg: TrainConfig,
    ckpt: Optional[CheckpointManager] = None,
    writer: Optional[MetricWriter] = None,
    log_prefix: str = "",
    verbose: bool = True,
    train_sample_weights: Optional[np.ndarray] = None,
) -> FitResult:
    """The reference's epoch loop (train.py:55-167) from `state.epoch` to
    `cfg.num_epochs`. On SIGTERM (main thread only) the current epoch
    completes, `last` is saved and the loop stops."""
    preempted = {"flag": False}
    prev_handler = None
    try:
        def _on_term(signum, frame):
            preempted["flag"] = True

        prev_handler = signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass  # not the main thread: no graceful-preemption hook
    try:
        return _fit_loop(task, state, train_arrays, val_arrays, cfg, ckpt,
                         writer, log_prefix, verbose, train_sample_weights,
                         preempted)
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)


def _fit_loop(task, state, train_arrays, val_arrays, cfg, ckpt, writer,
              log_prefix, verbose, train_sample_weights,
              preempted) -> FitResult:
    device = train_arrays.labels.device
    history: List[Dict[str, float]] = []
    best_epoch = -1
    stopped_early = False

    for epoch in range(state.epoch, cfg.num_epochs):
        t0 = time.perf_counter()
        idx, mask = epoch_indices(
            train_arrays.n, cfg.batch_size, shuffle=True, seed=cfg.seed,
            epoch=epoch, sample_weights=train_sample_weights,
        )
        n_batches = idx.shape[0]
        idx_d, mask_d = _plan_on_device(idx, mask, device)
        step_mets = [
            train_step(task, state,
                       gather_batch(train_arrays, idx_d[i], mask_d[i]))
            for i in range(n_batches)
        ]
        if step_mets:
            sums = torch.stack([
                torch.stack([m[k] for m in step_mets]).sum()
                for k in ("loss", "correct", "count")
            ]).cpu().numpy()
        else:
            sums = np.zeros(3, np.float32)
        avg_train_loss = float(sums[0]) / max(n_batches, 1)
        train_acc = float(sums[1]) / max(float(sums[2]), 1.0)

        val = evaluate(task, state, val_arrays, cfg.batch_size)
        epoch_time = time.perf_counter() - t0

        scalars = {
            "Loss/Train": avg_train_loss,
            "Loss/Val": val.loss,
            "Accuracy/Train": train_acc,
            "Accuracy/Val": val.accuracy,
            "Time/Epoch": epoch_time,
        }
        lr = state.optimizer.get_lr()
        if lr is not None:
            scalars["LR"] = lr
        if writer is not None:
            writer.scalars(epoch, {log_prefix + k: v
                                   for k, v in scalars.items()})
        history.append(dict(scalars, epoch=epoch))
        if verbose:
            print(f"epoch {epoch + 1}/{cfg.num_epochs} "
                  f"train_loss={avg_train_loss:.4f} acc={train_acc:.4f} "
                  f"val_loss={val.loss:.4f} val_acc={val.accuracy:.4f} "
                  f"({epoch_time:.1f}s)")

        state.epoch = epoch + 1

        # Early stop and plateau decay (reference train.py:145-167); the
        # counters update before any checkpoint is written, and a
        # non-finite val loss carries no signal either way.
        val_informative = bool(np.isfinite(val.loss))
        improved = val_informative and val.loss < state.best_val_loss
        if improved:
            state.best_val_loss = float(np.float32(val.loss))
            state.early_stop_counter = 0
            state.lr_reduce_counter = 0
            best_epoch = epoch
        elif val_informative:
            state.early_stop_counter += 1
            state.lr_reduce_counter += 1
            if (cfg.plateau_patience > 0
                    and state.lr_reduce_counter >= cfg.plateau_patience
                    and state.optimizer.get_lr() is not None):
                state.optimizer.scale_lr(cfg.plateau_factor)
                state.lr_reduce_counter = 0

        if ckpt is not None:
            ckpt.save("last", state)
            if improved:
                ckpt.save("best", state)
                ckpt.save_epoch(epoch + 1, state)

        if (cfg.patience > 0 and not improved
                and state.early_stop_counter >= cfg.patience):
            stopped_early = True
            break
        if preempted["flag"]:
            break

    return FitResult(state=state, history=history, best_epoch=best_epoch,
                     stopped_early=stopped_early,
                     preempted=preempted["flag"])
