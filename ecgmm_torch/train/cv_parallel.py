"""Fold-parallel cross-validation (port of `ecgmm_tpu/train/cv_parallel.py`):
every fold trains at once, each step one `torch.func.vmap` over a fold
axis.

The sequential harnesses (`train/cv.py`) fit the folds one after another:
nested 5 x 3 is 15 early-stop loops, exhaustive k = 10 is 90. Here the
folds of a wave share one Python loop over epochs and batches: each train
step gathers every fold's batch, runs the model once under `vmap` through
`torch.func.functional_call` with the folds' stacked parameters and
BatchNorm buffers (frozen parameters stay the model's own, one copy for
all folds), back-propagates the folds' summed losses, and updates every
fold with a per-fold Adam. Under `vmap` each of the three kernels takes
the fold axis (`ops/se.py`, `ops/fusion.py`, `ops/losses.py`): one launch
for all the folds of a wave, with per-fold parameters where they train.

Memory: folds are index sets over one cohort (`FoldPack`). Modalities a
fold's transform leaves as they are stay one copy, (N, ...): the raw
images and, where the transform is a scaler alone, the signals and
clinical features, with each fold's scaler as an affine applied after
the gather. Modalities whose values differ by fold stack, (F, N, ...):
filtered signals (the filter runs after the fold's scaler) and cached
embeddings (each fold's encoders are calibrated on its own train split).
`run_fold_parallel` sizes waves of folds against the device-memory budget
(`pipeline.resolve_hbm_budget`): the stacked state and data
(`fold_footprint`), and for raw modalities the concurrent sample rows a
wave puts through the encoders (`_act_rows_cap`, from the bytes a row
took on the card). Waves change no result.

Per fold, the semantics are the sequential `engine.fit(keep_best=True)`'s:
  * a pad batch (a fold with fewer batches than the widest) or a stopped
    fold changes nothing: no parameter, buffer, Adam moment or step count,
    and its dropout generator draws nothing;
  * the loss sums are guarded by selection, never multiplied by a mask;
  * a non-finite val loss neither improves nor counts as stale;
  * plateau decay and early stop are per fold, decided on the host from
    each epoch's val losses, as `engine.fit` decides them;
  * the best state is kept per fold; test logits come from it, or from
    the final state where no epoch improved;
  * dropout: every fold has its own generator, seeded as the sequential
    fit's, which draws its keep masks outside `vmap` on its active steps
    only and hands them in (`models/layers.Dropout.keep`);
  * only the constant schedule (with plateau decay) is supported.
With a mesh (`run_fold_parallel(mesh=)`) the folds spread over its data
axis: they pad to a multiple of n_data with copies of fold 0, each rank
runs its contiguous block of F / n_data folds through this program, with
no collective in a step, and the ranks gather their results at the end;
the waves and the rows cap count a rank's folds. A mesh with a model axis
is refused, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, vmap

from ecgmm_torch.config import TrainConfig
from ecgmm_torch.data import preprocess
from ecgmm_torch.data.pipeline import (Arrays, Batch, num_batches,
                                       resolve_hbm_budget)
from ecgmm_torch.models.fusion import ECGMultimodalModel
from ecgmm_torch.models.layers import Dropout
from ecgmm_torch.models.resnet18 import ResNet18
from ecgmm_torch.parallel import collectives
from ecgmm_torch.parallel.mesh import pad_to_multiple
from ecgmm_torch.train import embed, engine
from ecgmm_torch.train.engine import Task, epoch_indices
from ecgmm_torch.train.state import TrainState, create_state
from ecgmm_torch.workloads.tasks import make_fusion_head_task

# Device bytes that one concurrent sample row of a raw-modality wave takes
# beyond the wave's fixed cost: the slope of the peak memory of a fold
# program train step between waves of 2 and 6 folds of 16 rows, measured
# by chip_smoke.py phase 12 (`rows_cap`) on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md): the raw float32 `fusion` wave (224 x 224 images,
# 2476-sample signals, frozen encoders) and the `signal_only` wave (2476
# samples, the encoder back-propagated). A wave of raw modalities holds at
# most budget // these rows (`_act_rows_cap`): 4983 and 7464 rows in the
# card's default budget, 60% of its 80 GB.
IMAGE_ROW_BYTES = 10_236_768
SIGNAL_ROW_BYTES = 6_833_760


# ---------------------------------------------------------------------------
# the fold pack: cohort-wide data, per-fold transforms, row index sets


@dataclasses.dataclass
class FoldPack:
    """Cohort-wide host arrays and per-fold transforms for the fold
    program. `labels` is shared (N,); `images` (N, H, W, 3) uint8 raw, or
    cached embeddings; `signals`/`clinical` shared (N, ...) with per-fold
    affine vectors where the fold transform is a scaler, stacked
    (F, N, ...) where folds see different values (filtered signals,
    per-fold embeddings). `rows[f]` holds the fold's (train, val, test)
    cohort rows."""

    images: Optional[np.ndarray]
    signals: Optional[np.ndarray]
    clinical: Optional[np.ndarray]
    labels: np.ndarray
    rows: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    signals_stacked: bool = False
    clinical_stacked: bool = False
    images_stacked: bool = False
    # Scaler.transform affines of shared signals/clinical:
    # x -> (x - shift[f]) / scale[f] in float32
    sig_shift: Optional[np.ndarray] = None   # (F, T)
    sig_scale: Optional[np.ndarray] = None
    cli_shift: Optional[np.ndarray] = None   # (F, C)
    cli_scale: Optional[np.ndarray] = None
    # the modalities are cached encoder embeddings (head-only steps)
    cached_embeddings: bool = False

    @property
    def n_folds(self) -> int:
        return len(self.rows)

    def fold_arrays(self, f: int, device="cuda"
                    ) -> Tuple[Arrays, Arrays, Arrays]:
        """Fold f's (train, val, test) on `device`, with the values the
        program gathers: for the sequential engine (the parity tests)."""
        def build(r: np.ndarray) -> Arrays:
            def field(a, stacked, shift=None, scale=None):
                if a is None:
                    return None
                v = (a[f] if stacked else a)[r]
                if shift is not None:
                    v = (np.asarray(v, np.float32) - shift[f]) / scale[f]
                return _on(v, device)

            return Arrays(
                images=field(self.images, self.images_stacked),
                signals=field(self.signals, self.signals_stacked,
                              self.sig_shift, self.sig_scale),
                clinical=field(self.clinical, self.clinical_stacked,
                               self.cli_shift, self.cli_scale),
                labels=_on(np.asarray(self.labels[r], np.int64), device),
                indices=np.asarray(r))

        return tuple(build(r) for r in self.rows[f])


def _on(a: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`, raw images turned to (..., 3, H, W)."""
    a = np.asarray(a)
    if a.dtype == np.uint8 and a.ndim >= 4:
        a = np.moveaxis(a, -1, -3)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _trainable(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def fold_footprint(pack: FoldPack, state0: TrainState) -> Tuple[int, int]:
    """(shared_bytes, per_fold_bytes) of the program's device footprint.
    Shared: the labels, the frozen parameters and the unstacked
    modalities. Per fold: its share of the stacked modalities and affines,
    and the training state (the trainable parameters three times: live,
    best and gradient; Adam's two moments; the buffers twice: live and
    best)."""
    model = state0.model
    F = max(1, pack.n_folds)
    frozen = [p for p in model.parameters() if not p.requires_grad]
    trainable = [p for _, p in _trainable(model)]
    shared = int(pack.labels.nbytes) + _nbytes(frozen)
    per_fold = 0
    for a, stacked in ((pack.images, pack.images_stacked),
                       (pack.signals, pack.signals_stacked),
                       (pack.clinical, pack.clinical_stacked)):
        if a is None:
            continue
        if stacked:
            per_fold += int(a.nbytes) // F
        else:
            shared += int(a.nbytes)
    for aff in (pack.sig_shift, pack.sig_scale, pack.cli_shift,
                pack.cli_scale):
        if aff is not None:
            per_fold += int(aff.nbytes) // F
    per_fold += 5 * _nbytes(trainable) + 2 * _nbytes(model.buffers())
    return shared, per_fold


# ---------------------------------------------------------------------------
# epoch plans over cohort rows


def stack_fold_plans(rows_list: Sequence[np.ndarray], batch_size: int, *,
                     shuffle: bool, seed: int, epochs: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stacked epoch plans across folds, batch-padded to the widest fold:
    (F, E, B, bs) cohort rows, (F, E, B, bs) row mask, (F, B) batch
    validity. Per fold the plan is `engine.epoch_indices` over the fold's
    own order, the matrices its sequential fit builds, mapped to cohort
    rows. A pad batch gathers the fold's own first row (no other fold's
    values enter its forward) with mask 0 and validity 0: its step
    changes nothing."""
    plans = []
    for rows in rows_list:
        rows = np.asarray(rows)
        per = [epoch_indices(len(rows), batch_size, shuffle=shuffle,
                             seed=seed, epoch=e) for e in range(epochs)]
        local = np.stack([p[0] for p in per])          # (E, B, bs)
        mask = np.stack([p[1] for p in per])
        plans.append((rows[local].astype(np.int64), mask, int(rows[0])))
    b_max = max(p[0].shape[1] for p in plans)
    idxs, masks, valid = [], [], []
    for gidx, mask, row0 in plans:
        b = gidx.shape[1]
        pad = b_max - b
        if pad:
            gidx = np.concatenate(
                [gidx, np.full((epochs, pad, gidx.shape[2]), row0,
                               gidx.dtype)], 1)
            mask = np.concatenate(
                [mask, np.zeros((epochs, pad, mask.shape[2]), mask.dtype)],
                1)
        idxs.append(gidx)
        masks.append(mask)
        valid.append(np.concatenate([np.ones(b, np.float32),
                                     np.zeros(pad, np.float32)]))
    return np.stack(idxs), np.stack(masks), np.stack(valid)


def _stack_eval_plans(rows_list: Sequence[np.ndarray], bs: int):
    """(F, B, bs) unshuffled eval plans and (F, B) batch validity: the
    sequential fit's validation plan and `engine.evaluate`'s test plan."""
    idx, mask, valid = stack_fold_plans(rows_list, bs, shuffle=False,
                                        seed=0, epochs=1)
    return idx[:, 0], mask[:, 0], valid


# ---------------------------------------------------------------------------
# the fold program


def fold_adam_(flat: torch.Tensor, exp_avg: torch.Tensor,
               exp_avg_sq: torch.Tensor, steps: np.ndarray, lr: np.ndarray,
               active: np.ndarray, weight_decay: float = 0.0) -> np.ndarray:
    """One Adam update of the (F, P) parameters `flat` from `flat.grad`,
    in place, as torch's Adam makes it (betas (0.9, 0.999), eps 1e-8,
    weight decay coupled into the gradient), each fold at its own learning
    rate `lr` (F,) and step count `steps` (F,); only the `active` folds
    move: an inactive fold's parameters, moments and step count stay as
    they are. Returns the new step counts."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    steps = steps + active
    t = np.maximum(steps, 1).astype(np.float64)
    consts = torch.from_numpy(np.stack([
        lr / (1.0 - b1 ** t), np.sqrt(1.0 - b2 ** t)]).astype(np.float32))
    consts = consts.to(flat.device)
    on = torch.from_numpy(np.asarray(active, bool)).to(flat.device)[:, None]
    with torch.no_grad():
        g = flat.grad
        if weight_decay:
            g = g.add(flat, alpha=weight_decay)
        m = torch.lerp(exp_avg, g, 1.0 - b1)
        v = exp_avg_sq.mul(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (v.sqrt() / consts[1][:, None]).add_(eps)
        new_p = flat - consts[0][:, None] * (m / denom)
        exp_avg.copy_(torch.where(on, m, exp_avg))
        exp_avg_sq.copy_(torch.where(on, v, exp_avg_sq))
        flat.copy_(torch.where(on, new_p, flat))
    return steps


class _TaskApply(nn.Module):
    """`task.apply(model, batch)` as a module, so that
    `functional_call` can swap the model's parameters and buffers."""

    def __init__(self, model: nn.Module, apply: Callable):
        super().__init__()
        self.model = model
        self.apply_fn = apply

    def forward(self, batch):
        return self.apply_fn(self.model, batch)


@dataclasses.dataclass
class _Wave:
    """The stacked state of a wave of W folds. Parameters live in `flat`
    (W, P), the trainable ones in the model's order; the counters are the
    sequential `TrainState`'s, one per fold, on the host."""

    flat: torch.Tensor
    buffers: Dict[str, torch.Tensor]
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor
    steps: np.ndarray
    lr: np.ndarray
    generators: List[torch.Generator]
    best_flat: torch.Tensor
    best_buffers: Dict[str, torch.Tensor]
    best_val_loss: np.ndarray
    early_stop: np.ndarray
    lr_reduce: np.ndarray
    epochs_run: np.ndarray
    stopped: np.ndarray
    ever_improved: np.ndarray
    best_epoch: np.ndarray
    stopped_at: np.ndarray


class FoldProgram:
    """One task's train and eval steps over a wave of folds (built by
    `make_fold_program`). `run` trains a wave to the end and returns its
    best-on-test logits, best and stop epochs and val-loss history."""

    def __init__(self, task: Task, state0: TrainState, cfg: TrainConfig):
        model = state0.model
        self.task, self.cfg, self.model = task, cfg, model
        self.device = next(model.parameters()).device
        self.apply = _TaskApply(model, task.apply)
        named = _trainable(model)
        self.names = [n for n, _ in named]
        self.shapes = [tuple(p.shape) for _, p in named]
        self.sizes = [p.numel() for _, p in named]
        self.flat0 = torch.cat([p.detach().reshape(-1) for _, p in named])
        self.buffers0 = {n: b.detach().clone()
                         for n, b in model.named_buffers()}
        self.dropouts = [m for m in model.modules()
                         if isinstance(m, Dropout)]
        self.lr0 = float(state0.optimizer.get_lr())
        self.draws: Optional[List[Tuple[Dropout, tuple, torch.dtype]]] = None
        # vmapped train steps and eval batches run so far: each launches
        # every kernel of the model once for all the wave's folds
        self.train_steps = 0
        self.eval_batches = 0

    # -- parameters ---------------------------------------------------------

    def _params(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The trainable parameters as views of the (W, P) `flat`."""
        out, off = {}, 0
        for name, shape, n in zip(self.names, self.shapes, self.sizes):
            out["model." + name] = flat[:, off:off + n].view(
                flat.shape[0], *shape)
            off += n
        return out

    def _state(self, flat, buffers) -> Dict[str, torch.Tensor]:
        return {**self._params(flat),
                **{"model." + n: b for n, b in buffers.items()}}

    def _call(self, state, batch_fields, keeps):
        """The task's outputs for one fold (inside `vmap`): its parameters
        and buffers swapped in, its dropout keep masks handed in."""
        for mod, keep in zip(self._draw_modules(), keeps):
            mod.keep = keep
        try:
            batch = Batch(*batch_fields)
            outputs = functional_call(self.apply, state, (batch,))
            return outputs, batch
        finally:
            for mod in self.dropouts:
                mod.keep = None

    def _draw_modules(self):
        return [] if self.draws is None else [d[0] for d in self.draws]

    # -- dropout --------------------------------------------------------------

    def _probe_draws(self, batch_fields) -> None:
        """Record the dropout calls of one train-mode forward (module, mask
        shape, dtype, in call order) from fold 0's first batch, run alone
        on copies of the initial state with all-ones masks, so that each
        step can draw every fold's masks before it runs."""
        draws = []

        def hook(mod, args):
            x = args[0]
            if not (mod.training and mod.p > 0.0):
                return
            if any(d[0] is mod for d in draws):
                raise NotImplementedError(
                    "fold-parallel CV: a dropout module runs twice in one "
                    "forward")
            if not x.is_contiguous():
                raise NotImplementedError(
                    "fold-parallel CV: dropout of a non-contiguous input")
            shape = mod.keep_shape(x)
            draws.append((mod, shape, x.dtype))
            mod.keep = torch.ones(shape, dtype=x.dtype, device=x.device)

        handles = [m.register_forward_pre_hook(hook) for m in self.dropouts]
        try:
            self.model.train()
            state = {**{k: v[0] for k, v in self._params(
                self.flat0[None]).items()},
                **{"model." + n: b.clone()
                   for n, b in self.buffers0.items()}}
            with torch.no_grad():
                functional_call(self.apply, state,
                                (Batch(*(None if f is None else f[0]
                                         for f in batch_fields)),))
        finally:
            for h in handles:
                h.remove()
            for m in self.dropouts:
                m.keep = None
        self.draws = draws

    def _keeps(self, wave: _Wave, active: np.ndarray) -> List[torch.Tensor]:
        """Each dropout call's (W, ...) keep masks: an active fold's drawn
        from its own generator, as its sequential fit draws them; an
        inactive fold's all ones (its step is discarded, and its
        generator does not move)."""
        keeps = []
        for mod, shape, dtype in self.draws:
            keeps.append(torch.stack([
                mod.draw_keep(shape, dtype, self.device, gen) if on
                else torch.ones(shape, dtype=dtype, device=self.device)
                for gen, on in zip(wave.generators, active)]))
        return keeps

    # -- steps ----------------------------------------------------------------

    def _train_losses(self, wave, batch_fields, keeps):
        def fold_loss(state, *args):
            fields, ks = args[:5], args[5:]
            outputs, batch = self._call(state, fields, ks)
            loss, _ = self.task.loss(outputs, batch)
            return loss

        state = self._state(wave.flat, wave.buffers)
        dims = (0,) + tuple(None if f is None else 0 for f in batch_fields) \
            + (0,) * len(keeps)
        return vmap(fold_loss, in_dims=dims)(state, *batch_fields, *keeps)

    def _eval(self, flat, buffers, batch_fields):
        """(W,) losses and (W, bs, C) float32 logits of one eval batch."""
        def fold_eval(state, *fields):
            outputs, batch = self._call(state, fields, ())
            loss, _ = self.task.loss(outputs, batch)
            return loss, self.task.logits(outputs).float()

        dims = (0,) + tuple(None if f is None else 0 for f in batch_fields)
        self.eval_batches += 1
        with torch.no_grad():
            return vmap(fold_eval, in_dims=dims)(
                self._state(flat, buffers), *batch_fields)

    def _train_step(self, wave, batch_fields, active):
        keeps = self._keeps(wave, active)
        partial = not active.all()
        if partial:
            before = {n: b.clone() for n, b in wave.buffers.items()}
        self.model.train()
        self.train_steps += 1
        losses = self._train_losses(wave, batch_fields, keeps)
        # the folds are independent: the sum's gradient is each fold's
        losses.sum().backward()
        wave.steps = fold_adam_(wave.flat, wave.exp_avg, wave.exp_avg_sq,
                                wave.steps, wave.lr, active,
                                self.cfg.weight_decay)
        wave.flat.grad = None
        if partial:
            on = torch.from_numpy(active).to(self.device)
            with torch.no_grad():
                for n, b in wave.buffers.items():
                    sel = on.view(-1, *([1] * (b.dim() - 1)))
                    b.copy_(torch.where(sel, b, before[n]))

    # -- a wave ---------------------------------------------------------------

    def _new_wave(self, w: int) -> _Wave:
        flat = self.flat0.expand(w, -1).clone().requires_grad_(True)
        buffers = {n: b.expand(w, *b.shape).clone()
                   for n, b in self.buffers0.items()}
        gens = []
        for _ in range(w):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.cfg.seed)
            gens.append(gen)
        return _Wave(
            flat=flat, buffers=buffers,
            exp_avg=torch.zeros_like(flat, requires_grad=False),
            exp_avg_sq=torch.zeros_like(flat, requires_grad=False),
            steps=np.zeros(w, np.int64), lr=np.full(w, self.lr0),
            generators=gens, best_flat=flat.detach().clone(),
            best_buffers={n: b.clone() for n, b in buffers.items()},
            best_val_loss=np.full(w, math.inf),
            early_stop=np.zeros(w, np.int64),
            lr_reduce=np.zeros(w, np.int64),
            epochs_run=np.zeros(w, np.int64),
            stopped=np.zeros(w, bool), ever_improved=np.zeros(w, bool),
            best_epoch=np.full(w, -1, np.int64),
            stopped_at=np.full(w, -1, np.int64))

    def _end_of_epoch(self, wave: _Wave, epoch: int,
                      val: np.ndarray) -> None:
        """The sequential fit's epoch-end control, fold by fold: best,
        counters, plateau decay, early stop; the best state copied where a
        fold improved."""
        cfg = self.cfg
        improved = np.zeros(len(val), bool)
        for f, loss in enumerate(val):
            if wave.stopped[f]:
                continue
            wave.epochs_run[f] += 1
            informative = bool(np.isfinite(loss))
            if informative and loss < wave.best_val_loss[f]:
                improved[f] = True
                wave.best_val_loss[f] = float(np.float32(loss))
                wave.early_stop[f] = wave.lr_reduce[f] = 0
                wave.best_epoch[f] = epoch
                wave.ever_improved[f] = True
            elif informative:
                wave.early_stop[f] += 1
                wave.lr_reduce[f] += 1
                if (cfg.plateau_patience > 0
                        and wave.lr_reduce[f] >= cfg.plateau_patience):
                    wave.lr[f] = wave.lr[f] * cfg.plateau_factor
                    wave.lr_reduce[f] = 0
            if (cfg.patience > 0 and not improved[f]
                    and wave.early_stop[f] >= cfg.patience):
                wave.stopped[f] = True
                wave.stopped_at[f] = wave.epochs_run[f]
        if improved.any():
            on = torch.from_numpy(improved).to(self.device)
            with torch.no_grad():
                wave.best_flat.copy_(torch.where(on[:, None], wave.flat,
                                                 wave.best_flat))
                for n, b in wave.buffers.items():
                    sel = on.view(-1, *([1] * (b.dim() - 1)))
                    wave.best_buffers[n].copy_(
                        torch.where(sel, b, wave.best_buffers[n]))

    def run(self, data, plans):
        """Train a wave to its end: `data` the wave's (images, signals,
        clinical, labels, sig affine, cli affine, stacked flags) on the
        device, `plans` its (train, val, test) plans. Returns (test
        logits (W, SB, bs, C), best epochs, stopped-at epochs, val
        history (W, E))."""
        (tidx, tmask, tbvalid), (vidx, vmask, vbvalid), (sidx, smask) = plans
        w, n_epochs, n_train = tidx.shape[0], tidx.shape[1], tidx.shape[2]
        dev = self.device
        gather = _Gather(data, w, dev)
        t_idx = torch.from_numpy(tidx).to(dev)
        t_mask = torch.from_numpy(tmask).to(dev)
        v_idx, v_mask = (torch.from_numpy(a).to(dev) for a in (vidx, vmask))
        s_idx, s_mask = (torch.from_numpy(a).to(dev) for a in (sidx, smask))
        n_val = vbvalid.sum(axis=1).astype(np.int64)
        wave = self._new_wave(w)
        if self.draws is None:
            self._probe_draws(gather(t_idx[:, 0, 0], t_mask[:, 0, 0]))
        vhist = np.full((w, n_epochs), np.nan)
        for epoch in range(n_epochs):
            for j in range(n_train):
                active = (tbvalid[:, j] > 0) & ~wave.stopped
                if not active.any():
                    continue
                self._train_step(wave, gather(t_idx[:, epoch, j],
                                              t_mask[:, epoch, j]), active)
            self.model.eval()
            losses = torch.stack([
                self._eval(wave.flat, wave.buffers,
                           gather(v_idx[:, j], v_mask[:, j]))[0]
                for j in range(vidx.shape[1])], 1).cpu().numpy()
            # the sequential val loss: the mean of the fold's batch losses
            val = np.array([np.mean(losses[f, :n_val[f]])
                            for f in range(w)], np.float32)
            vhist[:, epoch] = val
            self._end_of_epoch(wave, epoch, val)
            if wave.stopped.all():
                # a stopped fold's state no longer moves: its later val
                # losses repeat this one
                vhist[:, epoch + 1:] = val[:, None]
                break
        # the best state, or the final one where no epoch improved
        on = torch.from_numpy(wave.ever_improved).to(dev)
        with torch.no_grad():
            flat = torch.where(on[:, None], wave.best_flat, wave.flat)
            buffers = {n: torch.where(on.view(-1, *([1] * (b.dim() - 1))),
                                      wave.best_buffers[n], b)
                       for n, b in wave.buffers.items()}
        self.model.eval()
        logits = torch.stack([
            self._eval(flat, buffers, gather(s_idx[:, j], s_mask[:, j]))[1]
            for j in range(sidx.shape[1])], 1).cpu().numpy()
        return logits, wave.best_epoch, wave.stopped_at, vhist


class _Gather:
    """Every fold's batch from the wave's device data: shared (N, ...)
    fields gathered by the folds' (W, bs) rows, stacked (W, N, ...) ones
    fold by fold, then each fold's affine where the field has one."""

    def __init__(self, data, w: int, device):
        self.data = data
        self.folds = torch.arange(w, device=device)[:, None]

    def __call__(self, idx: torch.Tensor, mask: torch.Tensor):
        d = self.data

        def take(name):
            a = d[name]
            if a is None:
                return None
            out = a[self.folds, idx] if d["stacked"][name] else a[idx]
            aff = d["affine"].get(name)
            if aff is not None:
                out = (out - aff[0][:, None]) / aff[1][:, None]
            return out

        return (take("images"), take("signals"), take("clinical"),
                d["labels"][idx], mask)


def make_fold_program(task: Task, state0: TrainState,
                      cfg: TrainConfig) -> FoldProgram:
    """The fold program of `task` over `state0`'s model: every fold of a
    wave starts from `state0` (the sequential harness builds each fold's
    model from the same seed) and trains as `engine.fit(keep_best=True)`
    would, all folds in each `vmap`-ed step."""
    return FoldProgram(task, state0, cfg)


# ---------------------------------------------------------------------------
# results and the harness entry point


@dataclasses.dataclass
class FoldResults:
    """Per-fold outcomes of a fold-parallel run, in input order."""

    aucs: List[float]
    logits: List[np.ndarray]       # per fold, (n_test, C), pad rows gone
    labels: List[np.ndarray]
    best_epochs: List[int]
    stopped_at: List[int]          # -1 = ran to num_epochs
    val_history: np.ndarray        # (F, E) per-epoch val losses
    # vmapped train steps and eval batches over all waves (the launch
    # plan: each runs every kernel of the model once for its wave)
    train_steps: int = 0
    eval_batches: int = 0


def _act_rows_cap(pack: FoldPack, budget: int) -> int:
    """The most sample rows a raw-modality wave may put through the
    encoders at once (0 = no cap): the budget over the bytes a row took on
    the card (`IMAGE_ROW_BYTES` with raw images in the pack, else
    `SIGNAL_ROW_BYTES`). A cached pack runs the head alone and is not
    capped; with no budget (the CPU) nothing is.
    `ECGMM_FOLD_PARALLEL_ROWS_CAP` overrides (0 disables)."""
    env = os.environ.get("ECGMM_FOLD_PARALLEL_ROWS_CAP")
    if env is not None:
        return max(0, int(env))
    if pack.cached_embeddings or not budget:
        return 0
    raw_images = pack.images is not None and pack.images.ndim >= 4
    return max(1, budget // (IMAGE_ROW_BYTES if raw_images
                             else SIGNAL_ROW_BYTES))


def _wave_size(pack: FoldPack, state0: TrainState, plans_nbytes: int,
               budget: int, batch_size: int,
               n_folds: Optional[int] = None) -> int:
    """Folds per wave of a rank's `n_folds` (all of the pack's by
    default): all of them where the footprint fits the budget and the
    wave's rows fit the rows cap (`_act_rows_cap`), else the most that
    do. Raises with the numbers where even one fold does not fit. budget
    0: unlimited (the rows cap still applies where it is set)."""
    F = pack.n_folds if n_folds is None else n_folds
    w = F
    cap = _act_rows_cap(pack, budget)
    if cap:
        w = min(w, max(1, cap // max(1, batch_size)))
    if not budget:
        return w
    shared, per_fold = fold_footprint(pack, state0)
    per_fold += plans_nbytes // max(1, F)
    fits = (budget - shared) // max(1, per_fold)
    if fits < 1:
        raise ValueError(
            "fold-parallel CV cannot fit even one fold: "
            f"budget {budget / 1e6:.0f} MB, shared cohort+frozen "
            f"{shared / 1e6:.0f} MB, per-fold {per_fold / 1e6:.0f} MB. "
            "Use --cache-embeddings, raise ECGMM_HBM_BUDGET_BYTES, or run "
            "the sequential harness.")
    return min(w, int(fits))


def _wave_data(pack: FoldPack, wave: List[int], device) -> dict:
    """The wave's data on the device: shared fields once, stacked fields
    and affines for the wave's folds."""
    sel = np.asarray(wave)

    def put(a, stacked):
        if a is None:
            return None
        return _on(a[sel] if stacked else a, device)

    affine = {}
    for name, shift, scale in (("signals", pack.sig_shift, pack.sig_scale),
                               ("clinical", pack.cli_shift, pack.cli_scale)):
        if shift is not None:
            affine[name] = (_on(shift[sel], device), _on(scale[sel], device))
    return {
        "images": put(pack.images, pack.images_stacked),
        "signals": put(pack.signals, pack.signals_stacked),
        "clinical": put(pack.clinical, pack.clinical_stacked),
        "labels": _on(np.asarray(pack.labels, np.int64), device),
        "stacked": {"images": pack.images_stacked,
                    "signals": pack.signals_stacked,
                    "clinical": pack.clinical_stacked},
        "affine": affine,
    }


def _fold_block(n: int, mesh) -> List[int]:
    """This rank's folds: its contiguous block of the folds padded to a
    multiple of the data axis with copies of fold 0 (a pure data mesh
    only, with JAX's message otherwise)."""
    if mesh is None:
        return list(range(n))
    extra = [a for a in mesh.axis_names
             if a != mesh.data_axis and mesh.shape[a] > 1]
    if extra:
        raise ValueError(
            "fold-parallel CV requires a pure data-parallel mesh (folds "
            f"shard over the {mesh.data_axis!r} axis); mesh has non-data "
            f"axes with size > 1: {extra}. Use a data-only mesh, or the "
            "sequential harness for tensor-parallel training.")
    ids = list(range(n)) + [0] * (pad_to_multiple(n, mesh.n_data) - n)
    k = len(ids) // mesh.n_data
    return ids[mesh.data_index * k:(mesh.data_index + 1) * k]


def run_fold_parallel(task: Task, state0: TrainState, pack: FoldPack,
                      cfg: TrainConfig, verbose: bool = True,
                      mesh=None) -> FoldResults:
    """Train and score every (train, val, test) fold of `pack`, in waves
    of folds that fit the device's budget (`_wave_size`). Every fold
    starts from `state0`. Returns per-fold best-on-test logits and AUCs in
    input order. With `mesh`, every rank calls it on the same pack, runs
    its block of the folds (`_fold_block`) and returns every fold's
    results; `train_steps` and `eval_batches` count this rank's program."""
    from ecgmm_torch.train.cv import _softmax_auc

    if cfg.schedule != "constant":
        raise ValueError(
            "fold-parallel CV supports the constant+plateau schedule (the "
            f"reference CV protocol); got schedule={cfg.schedule!r}. "
            "Schedules with per-fold step counts (onecycle) need the "
            "sequential harness.")
    n = pack.n_folds
    if n == 0:
        raise ValueError("no folds")
    for f, rset in enumerate(pack.rows):
        if any(len(r) == 0 for r in rset):
            raise ValueError("fold-parallel CV needs non-empty train/val/"
                             f"test in every fold (fold {f})")
    train = stack_fold_plans([r[0] for r in pack.rows], cfg.batch_size,
                             shuffle=True, seed=cfg.seed,
                             epochs=cfg.num_epochs)
    val = _stack_eval_plans([r[1] for r in pack.rows], cfg.eval_bs)
    test = _stack_eval_plans([r[2] for r in pack.rows], cfg.eval_bs)[:2]
    device = next(state0.model.parameters()).device
    budget = resolve_hbm_budget(device)
    mine = _fold_block(n, mesh)
    plans_nbytes = sum(a[mine].nbytes for p in (train, val, test)
                       for a in p)
    w = _wave_size(pack, state0, plans_nbytes, budget, cfg.batch_size,
                   n_folds=len(mine))
    waves = [mine[i:i + w] for i in range(0, len(mine), w)]
    if verbose and len(waves) > 1:
        print(f"[fold-parallel] {len(mine)} folds exceed one wave's budget "
              f"(device bytes / concurrent rows): running {len(waves)} "
              f"waves of up to {w}")
    program = make_fold_program(task, state0, cfg)
    logits_w, best_w, stop_w, vhist_w = [], [], [], []
    for wave in waves:
        sel = np.asarray(wave)
        out = program.run(_wave_data(pack, wave, device),
                          tuple(tuple(a[sel] for a in p)
                                for p in (train, val, test)))
        for got, acc in zip(out, (logits_w, best_w, stop_w, vhist_w)):
            acc.extend(got)
    if mesh is not None and mesh.n_data > 1:
        # every rank's folds, then the first copy of each fold in order
        blocks = collectives.all_gather_objects(
            (mine, [np.asarray(x) for x in logits_w], list(best_w),
             list(stop_w), [np.asarray(v) for v in vhist_w]),
            mesh.data_group)
        first = {}
        for ids, *fields in blocks:
            for j, f in enumerate(ids):
                first.setdefault(f, [x[j] for x in fields])
        logits_w, best_w, stop_w, vhist_w = (
            [first[f][i] for f in range(n)] for i in range(4))
    res = FoldResults([], [], [], [], [], np.stack(vhist_w),
                      program.train_steps, program.eval_batches)
    smask = test[1]
    for f in range(n):
        keep = smask[f].reshape(-1) > 0
        logits = logits_w[f].reshape(-1, logits_w[f].shape[-1])[keep]
        labels = np.asarray(pack.labels)[pack.rows[f][2]]
        res.aucs.append(_softmax_auc(logits, labels))
        res.logits.append(logits)
        res.labels.append(labels)
        res.best_epochs.append(int(best_w[f]))
        res.stopped_at.append(int(stop_w[f]))
    return res


# ---------------------------------------------------------------------------
# preparation


def _uses_images(model: nn.Module) -> bool:
    return isinstance(model, (ECGMultimodalModel, ResNet18))


def prepare_folds(make_model_task: Callable, cohort, fold_splits: Sequence,
                  cfg, apply_filter: bool = True, device="cuda"
                  ) -> Tuple[Task, TrainState, FoldPack]:
    """Host-side fold preparation: the per-fold scaler refits (reference
    train_kfold.py:26-29,159-162) as affine vectors or, where the
    transform cannot follow the gather (the filter after the scaler;
    per-fold embeddings), as stacked per-fold arrays. In the cached mode
    each fold's encoders are calibrated on its train rows (as the
    sequential `cv._fold_auc` calibrates them) and encode the cohort:
    `embed.encode_image_cohort` and `embed.encode_sigcli_rows`; without
    calibration the images are encoded once for all folds. A model that
    reads no images gets none in the pack. Returns (task, state0, pack)."""
    t = cfg.train
    model, task, freeze = make_model_task(cfg, device)
    state0 = create_state(model, t, num_batches(
        max(len(s.train) for s in fold_splits), t.batch_size), freeze=freeze)
    n_clin = min(cfg.model.clinical_in_features, cohort.clinical.shape[1])
    rows = [(np.asarray(s.train), np.asarray(s.val), np.asarray(s.test))
            for s in fold_splits]
    F, N = len(rows), len(cohort.labels)
    scalers = [(preprocess.Scaler.fit(cohort.signals[tr]),
                preprocess.Scaler.fit(cohort.clinical[tr, :n_clin]))
               for tr, _, _ in rows]
    labels = np.asarray(cohort.labels, np.int64)
    cached = embed.cache_applies(model, t, freeze is not None)

    sig_t = None
    if apply_filter or cached:
        # the per-fold transformed cohort, as cv._build_arrays transforms
        # each split (both steps are row by row)
        sig_t = np.empty((F,) + cohort.signals.shape, np.float32)
        for f, (es, _) in enumerate(scalers):
            s = es.transform(cohort.signals)
            if apply_filter:
                s = preprocess.preprocess_hospital(s)
            sig_t[f] = np.asarray(s, np.float32)

    if cached:
        cli_t = np.stack([np.asarray(cs.transform(
            cohort.clinical[:, :n_clin]), np.float32) for _, cs in scalers])
        images = _on(cohort.images, device)
        bs = t.eval_bs

        def host(x):
            return x.detach().cpu().numpy()

        if t.cache_bn_calibrate:
            snap = engine.snapshot(state0)
            imgs, sigs, clis = [], [], []
            for f, (tr, _, _) in enumerate(rows):
                state0.load_state_dict(snap)
                tr_d = torch.from_numpy(tr).to(device)
                sig_d, cli_d = _on(sig_t[f], device), _on(cli_t[f], device)
                embed.calibrate_bn_stats(state0, Arrays(
                    images=images.index_select(0, tr_d),
                    signals=sig_d.index_select(0, tr_d),
                    clinical=cli_d.index_select(0, tr_d),
                    labels=_on(labels[tr], device), indices=tr), bs)
                imgs.append(host(embed.encode_image_cohort(model, images,
                                                           bs)))
                s_e, c_e = embed.encode_sigcli_rows(model, sig_d, cli_d, bs)
                sigs.append(host(s_e))
                clis.append(host(c_e))
            state0.load_state_dict(snap)
            pack = FoldPack(
                images=np.stack(imgs), signals=np.stack(sigs),
                clinical=np.stack(clis), labels=labels, rows=rows,
                images_stacked=True, signals_stacked=True,
                clinical_stacked=True, cached_embeddings=True)
        else:
            s_e, c_e = embed.encode_sigcli_rows(
                model, _on(sig_t.reshape((F * N,) + sig_t.shape[2:]),
                           device),
                _on(cli_t.reshape(F * N, n_clin), device), bs)
            pack = FoldPack(
                images=host(embed.encode_image_cohort(model, images, bs)),
                signals=host(s_e).reshape(F, N, -1),
                clinical=host(c_e).reshape(F, N, -1), labels=labels,
                rows=rows, signals_stacked=True, clinical_stacked=True,
                cached_embeddings=True)
        return make_fusion_head_task(t), state0, pack

    f32 = np.float32
    if apply_filter:
        sig_kw = dict(signals=sig_t, signals_stacked=True)
    else:
        sig_kw = dict(
            signals=np.asarray(cohort.signals, f32),
            sig_shift=np.stack([es.mean.astype(f32) for es, _ in scalers]),
            sig_scale=np.stack([es.scale.astype(f32) for es, _ in scalers]))
    pack = FoldPack(
        images=(np.asarray(cohort.images) if _uses_images(model)
                and cohort.images is not None else None),
        clinical=np.asarray(cohort.clinical[:, :n_clin], f32),
        cli_shift=np.stack([cs.mean.astype(f32) for _, cs in scalers]),
        cli_scale=np.stack([cs.scale.astype(f32) for _, cs in scalers]),
        labels=labels, rows=rows, **sig_kw)
    return task, state0, pack
