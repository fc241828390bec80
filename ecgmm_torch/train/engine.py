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
    padded batch included; a task's scalar metrics (the fusion task's
    var_loss) are averaged over the eval batches and logged for val
    (`VarLoss/Val`), and the last train step's soft attention weights
    are logged per epoch (`AttentionWeights/*`);
  * a non-finite val loss neither improves `best` nor counts as a stale
    epoch; the counters update before the checkpoints are written; early
    stop and the plateau decay follow the config (0 disables them);
  * on SIGTERM the current epoch finishes, `last` is written, and fit
    returns with `preempted` set;
  * a split over the device-memory budget arrives as a `HostArrays` and
    streams (`data/pipeline.prefetch_batches`, or with
    `stream_chunk_batches` > 1 `prefetch_chunks`); the chunks hold the
    resident plan's batches in its order, so a chunked run gives the
    resident run's losses and parameters; `evaluate_streamed` is the test
    protocol over such a split;
  * `debug_nans` makes a non-finite loss or gradient raise
    FloatingPointError for the length of one fit;
  * `keep_best` returns a copy of the state at the best validation epoch
    (`FitResult.best_state`), for callers that score the best model
    without a checkpoint manager (the CV harnesses, `train/cv.py`).

`fit`, `evaluate`, `evaluate_streamed` and `train_step` take `mesh`
(`parallel/mesh.make_mesh`), as the JAX engine does, and then compute what
one process computes on the same global batch:
  * every rank builds the same global plan and takes its block of each
    batch (`local_rows`), resident or streamed; a batch size the data axis
    does not divide raises;
  * the forward runs under the data-parallel context: BatchNorm takes the
    global moments, Dropout the global mask (`models/layers.py`);
  * the loss and the metrics run on every rank over the gathered rows
    (`collectives.gather_rows`: the logits, the labels and the mask), so
    the focal loss divides by the global sum of the mask and the eval
    metrics are JAX's; the backward keeps each rank's rows, so the
    parameter gradients are partial sums, which one flat, bucketed
    all-reduce over the data group completes (a sum, not DDP's mean);
  * with a model axis the state is column-sharded (`parallel/tp.py`);
  * SIGTERM on any rank stops every rank after the same epoch (the flag
    is all-reduced), and the early stop reads the gathered val loss, the
    same on every rank; the checkpoint manager and the writer the caller
    gives write on rank 0 alone.
"""

from __future__ import annotations

import copy
import dataclasses
import signal
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ecgmm_torch.config import TrainConfig
from ecgmm_torch.data.pipeline import (Arrays, Batch, HostArrays,
                                       epoch_order, prefetch_batches,
                                       prefetch_chunks)
from ecgmm_torch.parallel import collectives, tp
from ecgmm_torch.parallel.mesh import Mesh
from ecgmm_torch.train import profiler
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

    with profiler.span("ecgmm.gather"):
        return Batch(images=take(arrays.images),
                     signals=take(arrays.signals),
                     clinical=take(arrays.clinical),
                     labels=take(arrays.labels), mask=mask)


def _plan_on_device(idx: np.ndarray, mask: np.ndarray, device):
    return (torch.from_numpy(idx.astype(np.int64)).to(device),
            torch.from_numpy(mask).to(device))


def _check_finite(what: str, tensors) -> None:
    """One read of the device: raise FloatingPointError naming the tensors
    that hold a NaN or an Inf."""
    tensors = [(name, t) for name, t in tensors if t is not None]
    if not tensors:
        return
    finite = torch.stack([torch.isfinite(t).all() for _, t in tensors])
    if not bool(finite.all()):
        bad = [name for (name, _), ok in zip(tensors, finite.tolist())
               if not ok]
        raise FloatingPointError(
            f"debug_nans: non-finite {what}: {', '.join(bad[:8])}")


def row_shard(mesh: Optional[Mesh]):
    """The data-parallel context of `mesh` (None for one data rank)."""
    return None if mesh is None or mesh.n_data == 1 else mesh.row_shard()


def check_divides(batch_size: int, mesh: Optional[Mesh], what: str):
    if mesh is not None and batch_size % mesh.n_data:
        raise ValueError(
            f"{what} {batch_size} does not divide over the data axis of "
            f"size {mesh.n_data}")


def local_plan(idx: np.ndarray, mask: np.ndarray, mesh: Optional[Mesh]):
    """This rank's columns of an (n_batches, bs) plan."""
    if mesh is None or mesh.n_data == 1:
        return idx, mask
    k = idx.shape[1] // mesh.n_data
    cols = slice(mesh.data_index * k, (mesh.data_index + 1) * k)
    return idx[:, cols], mask[:, cols]


def gather_outputs(outputs, shard):
    """The task's outputs with every tensor of rank >= 2 (the logits)
    gathered over the data group; scalars and the (3,) soft weights are
    global already."""
    if shard is None:
        return outputs

    def g(t):
        if isinstance(t, torch.Tensor) and t.dim() >= 2:
            return collectives.gather_rows(t, shard.group)
        return t

    if isinstance(outputs, torch.Tensor):
        return g(outputs)
    items = [g(t) for t in outputs]
    return type(outputs)(*items) if hasattr(outputs, "_fields") \
        else type(outputs)(items)


def _global_batch(batch: Batch, shard) -> Batch:
    """The gathered labels and mask (what the losses read)."""
    if shard is None:
        return batch
    return Batch(images=None, signals=None, clinical=None,
                 labels=collectives.gather_rows(batch.labels, shard.group),
                 mask=collectives.gather_rows(batch.mask, shard.group))


GRAD_BUCKET_ELEMS = 1 << 22


def reduce_gradients(model: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Sum every gradient over the data group, in flat buckets of at most
    GRAD_BUCKET_ELEMS elements per dtype (one all-reduce a bucket)."""
    if mesh is None or mesh.n_data == 1:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        bucket: List[torch.Tensor] = []
        size = 0
        for g in same + [None]:
            if g is not None and (size + g.numel() <= GRAD_BUCKET_ELEMS
                                  or not bucket):
                bucket.append(g)
                size += g.numel()
                continue
            flat = torch.cat([b.reshape(-1) for b in bucket])
            collectives.all_reduce_(flat, mesh.data_group)
            off = 0
            for b in bucket:
                b.copy_(flat[off:off + b.numel()].view_as(b))
                off += b.numel()
            if g is not None:
                bucket, size = [g], g.numel()


def train_step(task: Task, state: TrainState, batch: Batch,
               debug_nans: bool = False, mesh: Optional[Mesh] = None
               ) -> Dict[str, torch.Tensor]:
    """Forward, loss, backward and one Adam update; returns the step's
    metrics as device tensors, detached (no host synchronisation). With
    `debug_nans` the step reads its loss and gradients back and raises
    FloatingPointError on a NaN or an Inf, as JAX's `jax_debug_nans`
    stops a step. With `mesh`, `batch` holds this rank's rows of the
    global batch, and the loss, the metrics and the reduced gradients are
    the global batch's (the module's docstring). Under a profiler the
    step is the span `ecgmm.train_step` over the spans
    `ecgmm.step.{forward,loss,backward,optimizer}` (`train/profiler`)."""
    with profiler.span("ecgmm.train_step"):
        return _train_step(task, state, batch, debug_nans, mesh)


def _train_step(task: Task, state: TrainState, batch: Batch,
                debug_nans: bool, mesh: Optional[Mesh]
                ) -> Dict[str, torch.Tensor]:
    model = state.model
    model.train()
    shard = row_shard(mesh)
    with profiler.span("ecgmm.step.forward"), \
            collectives.data_parallel(shard), tp.gathered(model):
        outputs = gather_outputs(task.apply(model, batch), shard)
    batch = _global_batch(batch, shard)
    with profiler.span("ecgmm.step.loss"):
        loss, mets = task.loss(outputs, batch)
    if debug_nans:
        _check_finite("loss", [("loss", loss)])
    with profiler.span("ecgmm.step.backward"):
        state.optimizer.zero_grad()
        if debug_nans:
            try:
                loss.backward()
            except RuntimeError as e:
                if "nan values" not in str(e):
                    raise
                # anomaly detection met a NaN in a backward
                raise FloatingPointError(f"debug_nans: {e}") from e
        else:
            loss.backward()
        reduce_gradients(model, mesh)
    if debug_nans:
        _check_finite("gradient", [(n, p.grad) for n, p
                                   in model.named_parameters()])
    with profiler.span("ecgmm.step.optimizer"):
        state.optimizer.step(state.step)
    state.step += 1
    with torch.no_grad():
        preds = task.logits(outputs).argmax(-1)
        correct = ((preds == batch.labels).float() * batch.mask).sum()
    return {"loss": loss.detach(), "correct": correct,
            "count": batch.mask.sum(),
            **{k: v.detach() for k, v in mets.items()}}


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


def _eval_batches(task: Task, state: TrainState, batches, keep: np.ndarray,
                  mesh: Optional[Mesh] = None) -> EvalResult:
    """Eval mode, no autograd, over `batches`; `keep` marks the real rows
    of their concatenation (of the global batches, with `mesh`: each rank
    evaluates its rows and gathers the logits and labels). The host reads
    the device once."""
    model = state.model
    model.eval()
    shard = row_shard(mesh)
    losses, logits, labels = [], [], []
    extra: Dict[str, List[torch.Tensor]] = {}
    with torch.no_grad(), tp.gathered(model):
        for batch in batches:
            with collectives.data_parallel(shard):
                outputs = gather_outputs(task.apply(model, batch), shard)
            batch = _global_batch(batch, shard)
            loss, mets = task.loss(outputs, batch)
            losses.append(loss)
            logits.append(task.logits(outputs).float())
            labels.append(batch.labels)
            for k, v in mets.items():
                if v.dim() == 0:
                    extra.setdefault(k, []).append(v)
        flat_logits = torch.cat(logits).cpu().numpy()[keep]
        flat_labels = torch.cat(labels).cpu().numpy()[keep]
        return _assemble_eval(
            torch.stack(losses).cpu().numpy(), flat_logits, flat_labels,
            {k: torch.stack(v).cpu().numpy() for k, v in extra.items()},
        )


def evaluate(task: Task, state: TrainState, arrays, batch_size: int,
             stream_chunk_batches: int = 0, mesh: Optional[Mesh] = None
             ) -> EvalResult:
    """Full-split eval in eval mode without autograd: the JAX
    `evaluate_scan` semantics, read back to the host once. A HostArrays
    split streams (`evaluate_streamed`, in chunks of
    `stream_chunk_batches` batches where that is above 1). With `mesh`
    each rank evaluates its rows of every batch, and every rank returns
    the whole split's result."""
    if isinstance(arrays, HostArrays):
        return evaluate_streamed(task, state, arrays, batch_size,
                                 stream_chunk_batches, mesh=mesh)
    if arrays.n == 0:
        return _empty_eval()
    check_divides(batch_size, mesh, "eval batch size")
    idx, mask = epoch_indices(arrays.n, batch_size, shuffle=False, seed=0,
                              epoch=0)
    idx_d, mask_d = _plan_on_device(*local_plan(idx, mask, mesh),
                                    arrays.labels.device)
    return _eval_batches(
        task, state, (gather_batch(arrays, idx_d[i], mask_d[i])
                      for i in range(idx.shape[0])),
        mask.reshape(-1) > 0, mesh)


def _model_device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _chunk_batches(chunks):
    for chunk, idx_c, mask_c, _ in chunks:
        for i in range(idx_c.shape[0]):
            yield gather_batch(chunk, idx_c[i], mask_c[i])


def batch_part(batch_size: int, mesh: Optional[Mesh]):
    """This rank's (first, last + 1) columns of a batch."""
    if mesh is None or mesh.n_data == 1:
        return None
    k = batch_size // mesh.n_data
    return (mesh.data_index * k, (mesh.data_index + 1) * k)


def evaluate_streamed(task: Task, state: TrainState, arrays: HostArrays,
                      batch_size: int, stream_chunk_batches: int = 0,
                      mesh: Optional[Mesh] = None) -> EvalResult:
    """`evaluate` over a HostArrays split without a whole copy of it on the
    device: per batch (`prefetch_batches`; the last batch padded with its
    last row), or with `stream_chunk_batches` > 1 in chunks of the
    resident plan (`prefetch_chunks`); with `mesh` each rank stages its
    rows alone."""
    if arrays.n == 0:
        return _empty_eval()
    check_divides(batch_size, mesh, "eval batch size")
    device = _model_device(state)
    idx, mask = epoch_indices(arrays.n, batch_size, shuffle=False, seed=0,
                              epoch=0)
    if stream_chunk_batches > 1:
        batches = _chunk_batches(prefetch_chunks(
            arrays, *local_plan(idx, mask, mesh), stream_chunk_batches,
            device=device))
    else:
        batches = prefetch_batches(arrays, batch_size, shuffle=False,
                                   seed=0, epoch=0, device=device,
                                   part=batch_part(batch_size, mesh))
    return _eval_batches(task, state, batches, mask.reshape(-1) > 0, mesh)


class Preempted(RuntimeError):
    """Raised by multi-fit callers (the CV harnesses) when a fit reports
    `FitResult.preempted`: the process received SIGTERM, and launching
    further fits would race the SIGKILL that follows."""


def snapshot(state: TrainState) -> Dict[str, Any]:
    """`state.state_dict()` with every tensor copied: parameters,
    buffers, the optimizer's moments, the generator and the counters, none
    of them aliasing what later steps update in place. `load_state_dict`
    restores it."""
    return copy.deepcopy(state.state_dict())


@dataclasses.dataclass
class FitResult:
    state: TrainState
    history: List[Dict[str, float]]
    best_epoch: int
    stopped_early: bool
    # SIGTERM arrived mid-fit: the epoch finished, `last` was written
    preempted: bool = False
    # with fit(keep_best=True): `snapshot` of the state at the best
    # validation epoch; None when no epoch improved
    best_state: Optional[Dict[str, Any]] = None


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
    keep_best: bool = False,
    mesh: Optional[Mesh] = None,
) -> FitResult:
    """The reference's epoch loop (train.py:55-167) from `state.epoch` to
    `cfg.num_epochs`. With `keep_best`, `FitResult.best_state` is a
    `snapshot` of the state at the best validation epoch, taken after its
    counters update (None when no epoch improved). On SIGTERM (main
    thread only) the current epoch completes, `last` is saved and the loop
    stops. With `cfg.debug_nans`
    a non-finite loss or gradient raises FloatingPointError, and torch's
    anomaly detection is on for the fit (naming the backward that made a
    NaN); its previous setting is restored when fit returns or raises.
    With `mesh` every rank calls fit on the same arguments (the module's
    docstring); the state is placed on the mesh's model axis first
    (`tp.place_state`)."""
    check_divides(cfg.batch_size, mesh, "batch size")
    check_divides(cfg.eval_bs, mesh, "eval batch size")
    tp.place_state(state, mesh)
    prev_anomaly = torch.is_anomaly_enabled()
    if cfg.debug_nans:
        torch.autograd.set_detect_anomaly(True)
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
                         preempted, keep_best, mesh)
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        torch.autograd.set_detect_anomaly(prev_anomaly)


def _stop_everywhere(flag: bool, mesh: Optional[Mesh], device) -> bool:
    """True when any rank of the run saw SIGTERM (one all-reduce)."""
    if mesh is None or mesh.size == 1:
        return flag
    import torch.distributed as dist

    t = torch.tensor([1.0 if flag else 0.0], device=device)
    return bool(collectives.all_reduce_(t, dist.group.WORLD).item() > 0)


def _fit_loop(task, state, train_arrays, val_arrays, cfg, ckpt, writer,
              log_prefix, verbose, train_sample_weights,
              preempted, keep_best=False, mesh=None) -> FitResult:
    device = _model_device(state)
    verbose = verbose and (mesh is None or mesh.is_writer)
    part = batch_part(cfg.batch_size, mesh)
    streamed = isinstance(train_arrays, HostArrays)
    chunked = streamed and cfg.stream_chunk_batches > 1
    history: List[Dict[str, float]] = []
    best_epoch = -1
    best_state = None
    stopped_early = False

    for epoch in range(state.epoch, cfg.num_epochs):
        t0 = time.perf_counter()
        idx, mask = epoch_indices(
            train_arrays.n, cfg.batch_size, shuffle=True, seed=cfg.seed,
            epoch=epoch, sample_weights=train_sample_weights,
        )
        n_batches = idx.shape[0]
        idx, mask = local_plan(idx, mask, mesh)
        stream_stats: Dict[str, float] = {}
        if chunked:
            batches = _chunk_batches(prefetch_chunks(
                train_arrays, idx, mask, cfg.stream_chunk_batches,
                device=device, stats=stream_stats))
        elif streamed:
            batches = prefetch_batches(
                train_arrays, cfg.batch_size, shuffle=True, seed=cfg.seed,
                epoch=epoch, device=device,
                sample_weights=train_sample_weights, part=part)
        else:
            idx_d, mask_d = _plan_on_device(idx, mask, device)
            batches = (gather_batch(train_arrays, idx_d[i], mask_d[i])
                       for i in range(n_batches))
        step_mets = [train_step(task, state, batch, cfg.debug_nans, mesh)
                     for batch in batches]
        # one read of the device per epoch: the three sums, then the last
        # step's soft weights where the task has them
        soft_weights = None
        if step_mets:
            last_sw = step_mets[-1].get("soft_weights")
            host = torch.cat(
                [torch.stack([torch.stack([m[k] for m in step_mets]).sum()
                              for k in ("loss", "correct", "count")])]
                + ([last_sw.float()] if last_sw is not None else [])
            ).cpu().numpy()
            sums = host[:3]
            if last_sw is not None:
                soft_weights = host[3:]
        else:
            sums = np.zeros(3, np.float32)
        avg_train_loss = float(sums[0]) / max(n_batches, 1)
        train_acc = float(sums[1]) / max(float(sums[2]), 1.0)

        # one process calls them as it did before meshes
        on_mesh = {} if mesh is None else {"mesh": mesh}
        if isinstance(val_arrays, HostArrays):
            val = evaluate_streamed(task, state, val_arrays, cfg.eval_bs,
                                    cfg.stream_chunk_batches, **on_mesh)
        else:
            val = evaluate(task, state, val_arrays, cfg.eval_bs, **on_mesh)
        epoch_time = time.perf_counter() - t0

        scalars = {
            "Loss/Train": avg_train_loss,
            "Loss/Val": val.loss,
            "Accuracy/Train": train_acc,
            "Accuracy/Val": val.accuracy,
            "Time/Epoch": epoch_time,
        }
        if "var_loss" in val.metrics:
            scalars["VarLoss/Val"] = val.metrics["var_loss"]
        if chunked:
            # the producer thread's host seconds (they overlap the steps)
            scalars["Time/StreamGather"] = stream_stats.get("gather_s", 0.0)
            scalars["Time/StreamPut"] = stream_stats.get("put_s", 0.0)
        if soft_weights is not None:
            for k, branch in enumerate(("Image", "Signal", "Clinical")):
                scalars[f"AttentionWeights/{branch}_w"] = float(
                    soft_weights[k])
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
            if keep_best:
                best_state = snapshot(state)
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
        if _stop_everywhere(preempted["flag"], mesh, device):
            preempted["flag"] = True
            break

    return FitResult(state=state, history=history, best_epoch=best_epoch,
                     stopped_early=stopped_early,
                     preempted=preempted["flag"], best_state=best_state)
