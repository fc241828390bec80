"""Dynamic micro-batching for the serving path (port of
`ecgmm_tpu/serve/batching.py`).

`MicroBatcher` is pipeline-agnostic and numpy-only: it takes any device
function over stacked inputs and coalesces concurrent `submit()` calls
from HTTP handler threads into single calls, padding each batch up to a
fixed BUCKET size, so the device program sees a small closed set of
batch shapes (cuDNN plans and allocator blocks are reused per bucket)
instead of a fresh batch size per coalescence pattern. One worker thread
runs every dispatch, so dispatches never overlap on the device.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple

import numpy as np


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass(eq=False)  # identity semantics: fields hold numpy arrays
class _Pending:
    args: Tuple[np.ndarray, ...]
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[Tuple[np.ndarray, ...]] = None
    error: Optional[BaseException] = None


class BatcherClosed(RuntimeError):
    """submit() raced a close(): the request was never dispatched and can
    safely be retried on the unbatched path. Distinct from a dispatch
    FAILURE (wrapped as BatchDispatchError), which must surface."""


class BatchDispatchError(RuntimeError):
    """The batched device program itself failed; the underlying exception
    is ``__cause__``. Callers must NOT silently fall back on this one —
    a persistently failing batched path should be visible."""


class MicroBatcher:
    """Coalesce concurrent single-sample requests into bucketed batches.

    batch_fn: callable over stacked arrays — ``batch_fn(*args)`` where each
        arg is ``(B, ...)`` — returning a tuple of arrays each with leading
        batch dim ``B``: the request program over a bucket of rows.
    window_ms: after the first request of a batch arrives, wait at most
        this long for more before dispatching (the classic batching
        window; 0 disables coalescing without disabling bucketing).
    max_batch: hard cap; also the largest bucket.
    buckets: the closed set of batch sizes the device ever runs. Batches are
        padded up to the smallest admitting bucket by repeating the last
        sample; padded rows' outputs are discarded.
    """

    def __init__(
        self,
        batch_fn: Callable[..., Tuple],
        window_ms: float = 4.0,
        max_batch: int = 8,
        buckets: Sequence[int] = (1, 2, 4, 8),
    ):
        if max_batch != max(buckets):
            raise ValueError("max_batch must equal max(buckets)")
        self._batch_fn = batch_fn
        self._window_s = window_ms / 1000.0
        self._max_batch = max_batch
        self._buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._pending: list[_Pending] = []
        self._closed = False
        # observability: actual coalesced request counts (NOT the padded
        # bucket sizes) of the most recent dispatches, plus O(1) lifetime
        # counters — the history is bounded so a long-running server
        # never grows it
        self.dispatch_sizes: deque = deque(maxlen=1024)
        self.n_dispatches = 0
        self.n_requests = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side --------------------------------------------------

    def submit(self, *args: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Block until this sample's outputs are ready.

        Each arg is one UNBATCHED sample array; returns unbatched outputs
        (the batch dim added and removed by the batcher)."""
        item = _Pending(tuple(np.asarray(a) for a in args))
        with self._not_empty:
            if self._closed:
                raise BatcherClosed("MicroBatcher is closed")
            self._pending.append(item)
            self._not_empty.notify()
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def stats(self) -> dict:
        """Consistent snapshot of the dispatch counters."""
        with self._lock:
            return {
                "dispatches": self.n_dispatches,
                "requests": self.n_requests,
                "mean_coalescence": (
                    self.n_requests / self.n_dispatches
                    if self.n_dispatches else 0.0
                ),
                "recent_sizes": list(self.dispatch_sizes)[-16:],
            }

    def close(self) -> None:
        with self._not_empty:
            self._closed = True
            self._not_empty.notify()
        self._worker.join(timeout=5)

    # -- worker side ---------------------------------------------------

    def _take_batch(self) -> list[_Pending]:
        """Wait for the first request, then linger up to window_ms for
        companions (or until max_batch), grouping by input shape/dtype
        signature so heterogeneous requests never share a dispatch."""
        with self._not_empty:
            while not self._pending and not self._closed:
                self._not_empty.wait()
            if not self._pending:
                return []
            deadline = time.monotonic() + self._window_s
            sig = self._sig(self._pending[0])
            while True:
                same = [p for p in self._pending if self._sig(p) == sig]
                if len(same) >= self._max_batch or self._closed:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._not_empty.wait(timeout=remaining)
            batch = same[: self._max_batch]
            taken = {id(p) for p in batch}
            self._pending = [
                p for p in self._pending if id(p) not in taken
            ]
            return batch

    @staticmethod
    def _sig(p: _Pending):
        return tuple((a.shape, a.dtype.str) for a in p.args)

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                if self._closed:
                    # fail any stragglers that raced the close
                    with self._lock:
                        leftovers, self._pending = self._pending, []
                    for p in leftovers:
                        p.error = BatcherClosed("MicroBatcher closed")
                        p.event.set()
                    return
                continue
            try:
                n = len(batch)
                bucket = _bucket_for(n, self._buckets)
                stacked = tuple(
                    np.stack(
                        [p.args[i] for p in batch]
                        + [batch[-1].args[i]] * (bucket - n)
                    )
                    for i in range(len(batch[0].args))
                )
                outs = self._batch_fn(*stacked)
                outs = tuple(np.asarray(o) for o in outs)
                with self._lock:
                    self.dispatch_sizes.append(n)
                    self.n_dispatches += 1
                    self.n_requests += n
                for j, p in enumerate(batch):
                    p.result = tuple(o[j] for o in outs)
                    p.event.set()
            except BaseException as e:  # propagate to every waiter
                # One fresh exception object per waiter: re-raising a
                # single shared instance from several submitter threads
                # concurrently mutates its __traceback__ and interleaves
                # the printed tracebacks.
                for p in batch:
                    err = BatchDispatchError(
                        f"batched dispatch failed: {e!r}"
                    )
                    err.__cause__ = e
                    p.error = err
                    p.event.set()
