"""Materialisation, device-memory budgets, the split cache and streaming
(port of `ecgmm_tpu/data/pipeline.py`).

Each split is preprocessed once on the host into a `HostArrays` (numpy, in
the JAX package's layout: images (N, H, W, 3) uint8, labels int32). A
split that fits the device-memory budget (`resolve_hbm_budget`) is then
promoted to an `Arrays` of device tensors (images (N, 3, H, W) uint8,
labels int64), and a training epoch gathers its batches there with
`index_select` (`train/engine.py`), so its data crosses to the device once
per run. A split over the budget stays on the host, and the engine streams
it: `prefetch_batches` copies one batch at a time, `prefetch_chunks` K
planned batches at a time, each gathered by numpy into pinned host
buffers in a ring and copied on a side CUDA stream, an event ordering each
copy before the steps that read it.

`save_materialized` writes the splits in the JAX package's on-disk form
(one `.npy` per field per split, `scalers.npz`, `meta.json`), so a cache
written by either package opens in the other; `load_materialized` reopens
it memory-mapped, and a split over the budget streams from the map.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import queue
import threading
import time
from typing import (Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Tuple)

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


class HostArrays(NamedTuple):
    """One split in host memory (numpy arrays, or maps of a split cache's
    files), in the JAX package's layout; the engine streams it to the
    device batch by batch or chunk by chunk."""

    images: Optional[np.ndarray]      # (N, H, W, 3) uint8
    signals: Optional[np.ndarray]     # (N, ...) float32
    clinical: Optional[np.ndarray]    # (N, C) float32
    labels: np.ndarray                # (N,) int32
    indices: np.ndarray               # (N,) original patient ids

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
    """Split, scale and preprocess a trimodal cohort, as the reference's
    get_dataloaders (dataset.py:118-213) does: stratified 8:1:1 on
    `cfg.train.seed`, StandardScalers fit on the train rows only (the whole
    ECG matrix; AGE/Wt, or every clinical column for the modal-balance
    variant, dataset_image.py:36), the hospital filter on the scaled
    signals; clinical columns past the scaled ones pass unscaled. The splits
    go to `device` as far as the budget allows (`fit_splits_in_budget`);
    `device=None` keeps all three on the host (the split cache's save
    path)."""
    sp = splits.stratified_811(cohort.labels, seed=cfg.train.seed)
    n_scaled = (cohort.clinical.shape[1]
                if cfg.model.variant == "modal_balance" else 2)
    ecg_scaler = preprocess.Scaler.fit(cohort.signals[sp.train])
    clin_scaler = preprocess.Scaler.fit(cohort.clinical[sp.train, :n_scaled])

    def build(idx: np.ndarray) -> HostArrays:
        sig = preprocess.preprocess_hospital(
            ecg_scaler.transform(cohort.signals[idx]))
        clin = np.concatenate(
            [clin_scaler.transform(cohort.clinical[idx, :n_scaled]),
             np.asarray(cohort.clinical[idx, n_scaled:], np.float32)],
            axis=1)
        return HostArrays(
            images=np.asarray(cohort.images[idx]),
            signals=np.ascontiguousarray(sig, np.float32),
            clinical=np.ascontiguousarray(clin, np.float32),
            labels=np.asarray(cohort.labels[idx], np.int32),
            indices=cohort.indices[idx])

    return MaterializedData(
        *_place((build(sp.train), build(sp.val), build(sp.test)), device),
        ecg_scaler=ecg_scaler, clinical_scaler=clin_scaler)


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
    log-spectrograms on the host, for the CRNN (train_physionet2.py); the
    splits then go to `device` as `materialize_trimodal` sends them."""

    def build(idx: np.ndarray) -> HostArrays:
        sig = signals[idx]
        if preprocess_fn is not None:
            sig = preprocess_fn(sig)
        sig = np.ascontiguousarray(sig, np.float32)
        if spectrogram:
            sig = log_spectrogram(torch.from_numpy(sig)).contiguous().numpy()
        return HostArrays(images=None, signals=sig, clinical=None,
                          labels=np.asarray(labels[idx], np.int32),
                          indices=np.asarray(idx))

    return MaterializedData(*_place(
        (build(split.train), build(split.val), build(split.test)), device))


def _place(host_splits, device):
    if device is None:
        return host_splits
    return fit_splits_in_budget(host_splits, resolve_hbm_budget(device),
                                device)


# ---------------------------------------------------------------------------
# Residency and device-memory budgets
# ---------------------------------------------------------------------------

def promote(host: HostArrays, device="cuda") -> Arrays:
    """A host split as device tensors: one copy a field, the images turned
    to (N, 3, H, W) on the host first, labels int64."""
    device = torch.device(device)

    def up(a, dtype=None):
        if a is None:
            return None
        a = np.ascontiguousarray(a, dtype)
        if not a.flags.writeable:  # a map of a split cache's file
            a = a.copy()
        return torch.from_numpy(a).to(device)

    images = None if host.images is None else up(
        np.asarray(host.images).transpose(0, 3, 1, 2))
    return Arrays(images=images, signals=up(host.signals, np.float32),
                  clinical=up(host.clinical, np.float32),
                  labels=up(host.labels, np.int64),
                  indices=np.asarray(host.indices))


def to_host_resident(arrays: Arrays) -> HostArrays:
    """A device split back in host memory, in the host layout."""
    def down(t):
        return None if t is None else t.detach().cpu().numpy()

    images = None if arrays.images is None else np.ascontiguousarray(
        down(arrays.images).transpose(0, 2, 3, 1))
    return HostArrays(images=images, signals=down(arrays.signals),
                      clinical=down(arrays.clinical),
                      labels=down(arrays.labels).astype(np.int32),
                      indices=np.asarray(arrays.indices))


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(a.nbytes)


def split_nbytes(arrays) -> int:
    """Bytes of a split's images, signals, clinical values and labels, the
    labels counted in their host form (int32), so that a split weighs the
    same on either side of the budget, as in the JAX package."""
    return sum(_nbytes(a) for a in (arrays.images, arrays.signals,
                                    arrays.clinical)
               if a is not None) + 4 * arrays.n


def fit_in_budget(arrays, budget: Optional[int], device="cuda"):
    """The split on `device` when it fits `budget` bytes (None or 0: no
    limit), else on the host: an Arrays that does not fit is demoted, a
    HostArrays that fits is promoted."""
    if not budget or split_nbytes(arrays) <= budget:
        return arrays if isinstance(arrays, Arrays) \
            else promote(arrays, device)
    return arrays if isinstance(arrays, HostArrays) \
        else to_host_resident(arrays)


def fit_splits_in_budget(splits_seq, budget: Optional[int], device="cuda"):
    """`fit_in_budget` over the splits in order, cumulatively: the bytes an
    earlier split put on the device count against the budget the later
    ones see, so the splits on the device together stay within it."""
    out, remaining = [], budget
    for a in splits_seq:
        if budget and remaining <= 0:
            out.append(a if isinstance(a, HostArrays)
                       else to_host_resident(a))
            continue
        fitted = fit_in_budget(a, remaining, device)
        out.append(fitted)
        if budget and isinstance(fitted, Arrays):
            remaining -= split_nbytes(fitted)
    return out


def auto_chunk_batches(budget: int, split, batch_size: int,
                       eval_batch_size: int = 0) -> int:
    """The chunk size K (in batches) for a streamed split: each chunk at
    most budget/6 bytes, so the three chunks in flight (computing, copied,
    being gathered) take at most half the budget, at the larger of the
    train and eval batch sizes. At least 1 (per-batch streaming)."""
    row_bytes = max(1, split_nbytes(split) // max(1, split.n))
    rows = max(batch_size, eval_batch_size or batch_size)
    return max(1, budget // (6 * row_bytes * rows))


def resolve_hbm_budget(device="cuda") -> int:
    """The device-memory budget, in bytes, for device-resident splits:
    `ECGMM_HBM_BUDGET_BYTES` when it is set, else 60% of the card's
    memory, and 0 (no limit) on the CPU."""
    env = os.environ.get("ECGMM_HBM_BUDGET_BYTES")
    if env:
        return int(env)
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    return int(torch.cuda.get_device_properties(device).total_memory * 0.6)


# ---------------------------------------------------------------------------
# The split cache
# ---------------------------------------------------------------------------

_SPLIT_FIELDS = ("images", "signals", "clinical", "labels", "indices")


def has_materialized(cache_dir: str) -> bool:
    return os.path.exists(os.path.join(cache_dir, "scalers.npz")) and \
        os.path.exists(os.path.join(cache_dir, "train", "labels.npy"))


def save_materialized(data: MaterializedData, cache_dir: str,
                      meta: Optional[dict] = None) -> None:
    """Write the three splits (one `.npy` a field; absent fields have no
    file), the fitted scalers (`scalers.npz`) and, given `meta`, the run's
    fingerprint (`meta.json`) that `load_materialized` checks."""
    for name in ("train", "val", "test"):
        d = os.path.join(cache_dir, name)
        os.makedirs(d, exist_ok=True)
        host = getattr(data, name)
        if isinstance(host, Arrays):
            host = to_host_resident(host)
        for f in _SPLIT_FIELDS:
            a = getattr(host, f)
            if a is not None:
                np.save(os.path.join(d, f + ".npy"), np.asarray(a))
    sc = {}
    for name, s in (("ecg", data.ecg_scaler),
                    ("clinical", data.clinical_scaler)):
        if s is not None:
            sc[name + "_mean"] = np.asarray(s.mean)
            sc[name + "_scale"] = np.asarray(s.scale)
    np.savez(os.path.join(cache_dir, "scalers.npz"), **sc)
    if meta is not None:
        with open(os.path.join(cache_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)


def _load_split(d: str) -> HostArrays:
    def rd(f):
        path = os.path.join(d, f + ".npy")
        return np.load(path, mmap_mode="r") if os.path.exists(path) \
            else None

    return HostArrays(images=rd("images"), signals=rd("signals"),
                      clinical=rd("clinical"), labels=rd("labels"),
                      indices=np.asarray(rd("indices")))


def load_materialized(cache_dir: str, device="cuda",
                      hbm_budget_bytes: Optional[int] = None,
                      expect_meta: Optional[dict] = None
                      ) -> MaterializedData:
    """Reopen a `save_materialized` cache, each split memory-mapped. A
    split within the budget (`hbm_budget_bytes`, else
    `resolve_hbm_budget(device)`) is promoted to `device`; one over it
    stays a mapped HostArrays and streams; `device=None` keeps all three
    mapped. With `expect_meta`, a cache whose `meta.json` differs from it
    in any key is refused (ValueError); a cache without `meta.json` opens
    unchecked."""
    if expect_meta is not None:
        path = os.path.join(cache_dir, "meta.json")
        if os.path.exists(path):
            with open(path) as f:
                saved = json.load(f)
            diff = {k: (saved.get(k), v) for k, v in expect_meta.items()
                    if saved.get(k) != v}
            if diff:
                raise ValueError(
                    f"split cache at {cache_dir} was built for a different "
                    "run configuration: " + "; ".join(
                        f"{k}: cached={c!r} requested={r!r}"
                        for k, (c, r) in sorted(diff.items()))
                    + " — point --split-cache at a fresh directory or "
                    "delete the stale cache")
    budget = 0
    if device is not None:
        budget = hbm_budget_bytes if hbm_budget_bytes is not None \
            else resolve_hbm_budget(device)

    def split(name):
        host = _load_split(os.path.join(cache_dir, name))
        if device is None or (budget and split_nbytes(host) > budget):
            return host
        return promote(host, device)

    z = np.load(os.path.join(cache_dir, "scalers.npz"))

    def scaler(name):
        if name + "_mean" not in z:
            return None
        return preprocess.Scaler(mean=z[name + "_mean"],
                                 scale=z[name + "_scale"])

    return MaterializedData(train=split("train"), val=split("val"),
                            test=split("test"), ecg_scaler=scaler("ecg"),
                            clinical_scaler=scaler("clinical"))


# ---------------------------------------------------------------------------
# The epoch plan
# ---------------------------------------------------------------------------

def epoch_order(
    n: int, *, shuffle: bool, seed: int, epoch: int,
    sample_weights: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The per-epoch sample order, shared by the resident and the streamed
    paths. `sample_weights` turns on weighted sampling with replacement,
    the reference's WeightedRandomSampler (train_signal_only_ptb.py:
    230-241)."""
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


def _pad_indices(idx: np.ndarray, multiple: int):
    """Pad a batch's rows to `multiple` with its last row, mask 0."""
    n = len(idx)
    padded = -(-n // multiple) * multiple
    mask = np.zeros(padded, np.float32)
    mask[:n] = 1.0
    if padded > n:
        idx = np.concatenate([idx, np.full(padded - n,
                                           idx[-1] if n else 0)])
    return idx, mask


# ---------------------------------------------------------------------------
# Streaming: pinned host buffers in a ring, copies on a side stream
# ---------------------------------------------------------------------------

# the dtype of each field as it crosses to the device
_FIELD_DTYPES = (("images", torch.uint8), ("signals", torch.float32),
                 ("clinical", torch.float32), ("labels", torch.int64))


class _Staged(NamedTuple):
    slot: int
    fields: Dict[str, torch.Tensor]   # raw copies, images (k, H, W, 3)
    copied: Optional[torch.cuda.Event]


class _Stager:
    """`depth` sets of host buffers of `rows` rows for a split's fields,
    pinned on a CUDA device, reused in turn. `stage` gathers rows into a
    set with numpy (a memory-mapped split is read-only, so torch never
    wraps it) and copies them to the device on a side stream; `consume`
    makes the current stream wait for that copy and hands the tensors
    over; `release` marks the set free once the work the current stream
    has queued (the steps that read the batch) is done. On the CPU the
    same steps run without the stream: the copy is a clone."""

    def __init__(self, arrays: HostArrays, rows: int, depth: int, device,
                 stats: Optional[dict] = None):
        self.arrays = arrays
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stats = stats
        self.side = torch.cuda.Stream(self.device) if self.cuda else None
        self.buffers: List[Dict[str, np.ndarray]] = []
        self._pinned = []  # the tensors that own the pinned buffers
        for _ in range(depth):
            bufs = {}
            for name, dtype in _FIELD_DTYPES:
                a = getattr(arrays, name)
                if a is None:
                    continue
                t = torch.empty((rows,) + tuple(a.shape[1:]), dtype=dtype,
                                pin_memory=self.cuda)
                self._pinned.append(t)
                bufs[name] = t.numpy()
            self.buffers.append(bufs)
        self.free = [threading.Event() for _ in range(depth)]
        for ev in self.free:
            ev.set()
        self.done: List[Optional[torch.cuda.Event]] = [None] * depth

    def acquire(self, slot: int, stop: Optional[threading.Event] = None
                ) -> bool:
        """Wait until set `slot` is free and the device is done with it;
        False when `stop` is set first."""
        while not self.free[slot].wait(0.1):
            if stop is not None and stop.is_set():
                return False
        self.free[slot].clear()
        if self.done[slot] is not None:
            self.done[slot].synchronize()
        return True

    def stage(self, slot: int, rows: np.ndarray) -> _Staged:
        t0 = time.perf_counter()
        k = len(rows)
        host = {}
        for name, buf in self.buffers[slot].items():
            a = getattr(self.arrays, name)
            if a.dtype == buf.dtype:
                np.take(a, rows, axis=0, out=buf[:k])
            else:
                buf[:k] = a[rows]
            host[name] = torch.from_numpy(buf[:k])
        t1 = time.perf_counter()
        copied = None
        if self.cuda:
            with torch.cuda.device(self.device), torch.cuda.stream(self.side):
                fields = {n: t.to(self.device, non_blocking=True)
                          for n, t in host.items()}
                copied = torch.cuda.Event()
                copied.record(self.side)
        else:
            fields = {n: t.clone() for n, t in host.items()}
        if self.stats is not None:
            self.stats["gather_s"] = self.stats.get("gather_s", 0.0) + t1 - t0
            self.stats["put_s"] = self.stats.get("put_s", 0.0) \
                + time.perf_counter() - t1
        return _Staged(slot, fields, copied)

    def consume(self, staged: _Staged) -> Dict[str, torch.Tensor]:
        """The staged fields, ready for the current stream; images turned
        to (k, 3, H, W)."""
        fields = dict(staged.fields)
        if self.cuda:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(staged.copied)
            for t in fields.values():
                t.record_stream(current)
        if "images" in fields:
            fields["images"] = fields["images"].permute(0, 3, 1, 2) \
                .contiguous()
        return fields

    def release(self, slot: int) -> None:
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.done[slot] = ev
        self.free[slot].set()


def _batch(fields: Dict[str, torch.Tensor], mask: torch.Tensor) -> Batch:
    return Batch(images=fields.get("images"), signals=fields.get("signals"),
                 clinical=fields.get("clinical"), labels=fields["labels"],
                 mask=mask)


def prefetch_batches(
    arrays: HostArrays,
    batch_size: int,
    *,
    shuffle: bool,
    seed: int,
    epoch: int = 0,
    device="cuda",
    sample_weights: Optional[np.ndarray] = None,
    prefetch: int = 2,
    part: Optional[Tuple[int, int]] = None,
) -> Iterator[Batch]:
    """Per-batch streaming of a host split: the batches of `epoch_order`,
    each padded to `batch_size` with its last row (mask 0, as the JAX
    package's streamed batches are; the resident plan pads with row 0, so
    the two agree exactly where the batch size divides the split), copied
    `prefetch` batches ahead of the one yielded, through a ring of
    `prefetch + 2` pinned buffers. `part` (lo, hi) stages only those rows
    of every padded batch (a data-parallel rank's block)."""
    device = torch.device(device)
    order = epoch_order(arrays.n, shuffle=shuffle, seed=seed, epoch=epoch,
                        sample_weights=sample_weights)
    starts = list(range(0, arrays.n, batch_size))
    depth = prefetch + 2
    lo, hi = part if part is not None else (0, batch_size)
    stager = _Stager(arrays, hi - lo, depth, device)
    plans = []
    for s in starts:
        idx, mask = _pad_indices(order[s:s + batch_size], batch_size)
        plans.append((idx[lo:hi], mask[lo:hi]))

    def stage(i):
        stager.acquire(i % depth)
        return stager.stage(i % depth, plans[i][0])

    staged = collections.deque(stage(i) for i in range(
        min(prefetch, len(starts))))
    for i in range(len(starts)):
        if i + prefetch < len(starts):
            staged.append(stage(i + prefetch))
        item = staged.popleft()
        fields = stager.consume(item)
        yield _batch(fields, torch.from_numpy(plans[i][1]).to(device))
        stager.release(item.slot)


def prefetch_chunks(
    arrays: HostArrays,
    idx_mat: np.ndarray,
    mask_mat: np.ndarray,
    chunk_batches: int,
    device="cuda",
    stats: Optional[dict] = None,
):
    """Chunked streaming of a host split over the epoch plan (`idx_mat`,
    `mask_mat`: (n_batches, bs), from `engine.epoch_indices`, so the chunks
    hold the resident path's batches in its order, pad rows included).
    Yields, per chunk of up to `chunk_batches` batches: the chunk's rows on
    the device as an Arrays, the (k, bs) row numbers within it and the
    (k, bs) mask on the device, and the mask on the host.

    A producer thread gathers and copies the next chunks while the caller
    runs this one; at most one staged chunk waits, so three are in flight
    (computing, staged, being gathered), in a ring of three pinned buffer
    sets. `stats` sums the producer's host seconds of gathering
    (`gather_s`) and of queueing the copies (`put_s`), and counts
    `chunks`."""
    device = torch.device(device)
    n_batches, bs = idx_mat.shape
    depth = 3
    stager = _Stager(arrays, chunk_batches * bs, depth, device, stats)
    starts = list(range(0, n_batches, chunk_batches))
    q: "queue.Queue" = queue.Queue(maxsize=1)
    stop = threading.Event()

    def send(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            with (torch.cuda.device(device) if device.type == "cuda"
                  else contextlib.nullcontext()):
                for c, c0 in enumerate(starts):
                    slot = c % depth
                    if not stager.acquire(slot, stop):
                        return
                    rows = idx_mat[c0:c0 + chunk_batches].reshape(-1)
                    if not send(("chunk", (c0, stager.stage(slot, rows)))):
                        return
                    if stats is not None:
                        stats["chunks"] = stats.get("chunks", 0) + 1
            send(("done", None))
        except BaseException as e:  # raised again on the caller's thread
            send(("error", e))

    worker = threading.Thread(target=producer, daemon=True,
                              name="ecgmm-chunk-stager")
    worker.start()
    try:
        while True:
            kind, item = q.get()
            if kind == "done":
                break
            if kind == "error":
                raise item
            c0, staged = item
            mask_host = np.asarray(mask_mat[c0:c0 + chunk_batches],
                                   np.float32)
            k = mask_host.shape[0]
            fields = stager.consume(staged)
            keep = mask_host.reshape(-1) > 0
            rows = idx_mat[c0:c0 + k].reshape(-1)
            chunk = Arrays(images=fields.get("images"),
                           signals=fields.get("signals"),
                           clinical=fields.get("clinical"),
                           labels=fields["labels"],
                           indices=np.asarray(arrays.indices)[rows[keep]])
            local = torch.arange(k * bs, device=device).reshape(k, bs)
            yield (chunk, local, torch.from_numpy(mask_host).to(device),
                   mask_host)
            stager.release(staged.slot)
    finally:
        # the caller left early (an error, a break): retire the producer
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        worker.join(timeout=5.0)

