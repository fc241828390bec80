"""Collectives with explicit backwards, and the data-parallel context the
models read.

In the JAX package arrays are global: a mean over a batch sharded on the
`data` axis lowers to a psum, and a sharded run computes what one device
computes (`tests/test_parallel.py`). Here each rank is a process that holds
`B / n_data` rows of every global batch, so the global semantics are
written out with these wrappers:

  * `all_reduce_sum`: the sum over a group, differentiable; its backward
    sums the cotangents over the group, the adjoint of a sum that every
    rank then uses on its own rows (the BatchNorm moments,
    `models/layers.py`);
  * `gather_rows`: an all-gather along dim 0; its backward keeps this
    rank's rows of the cotangent and does not reduce: every rank computes
    the same global function of the gathered rows (the loss), so a summing
    backward would scale each gradient by n_data;
  * `all_gather_shard`: the column shards of a weight gathered over the
    model group (tensor parallelism, `parallel/tp.py`); its backward
    keeps this rank's block of the cotangent, with no collective: the
    ranks of a model group hold the same rows and compute the same
    function of them, so their cotangents agree and a reduce-scatter
    divided by the group's size would give the same block;
  * `all_reduce_` (in place, no autograd): the flat gradient buckets.

Every wrapper counts its calls and the bytes of its result under its own
name (`all_reduce_sum` forward and backward, `gather_rows`,
`all_gather_shard`, `all_reduce` for the gradient buckets and the stop flag, `all_gather_object`), as the kernels
count their launches (`counts`, `reset_counts`; `tools/tp_report.py` and
`chip_smoke.py` read them).

The collectives run on the group's backend. On gloo a CUDA tensor goes
through pinned host memory, for every op: gloo's CUDA support differs by
op and version, and gloo carries CUDA tensors only where ranks share one
card for a correctness run. NCCL never takes that route.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

_COUNTS: Dict[str, List[int]] = {}
# torch renamed the single-tensor collectives; take whichever this one has
_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_COUNT_LOCK = threading.Lock()


def _count(op: str, t: torch.Tensor) -> None:
    with _COUNT_LOCK:
        c = _COUNTS.setdefault(op, [0, 0])
        c[0] += 1
        c[1] += t.numel() * t.element_size()


def counts() -> Dict[str, Dict[str, int]]:
    """{op: {"calls": n, "bytes": result bytes}} since the last reset."""
    with _COUNT_LOCK:
        return {op: {"calls": c, "bytes": b}
                for op, (c, b) in sorted(_COUNTS.items())}


def reset_counts() -> None:
    with _COUNT_LOCK:
        _COUNTS.clear()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _via_host(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _pinned(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce_(t: torch.Tensor, group, op: str = "all_reduce"
                ) -> torch.Tensor:
    """t <- the sum of t over `group`, in place (no autograd), counted
    under `op`."""
    _count(op, t)
    if _via_host(group, t):
        h = _pinned(t)
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def _all_gather(t: torch.Tensor, group, op: str) -> torch.Tensor:
    """The group's tensors concatenated along dim 0, in rank order."""
    n = group_size(group)
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    _count(op, out)
    if _via_host(group, t):
        h = torch.empty(out.shape, dtype=t.dtype, pin_memory=True)
        _GATHER(h, _pinned(t), group=group)
        out.copy_(h)
    else:
        _GATHER(out, t, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group, "all_reduce_sum")

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group, "all_reduce_sum"), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rows = x.shape[0]
        ctx.index = dist.get_rank(group)
        return _all_gather(x, group, "gather_rows")

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.rows
        return grad[lo:lo + ctx.rows], None


class _AllGatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, group, dim):
        ctx.n, ctx.index, ctx.dim = (group_size(group),
                                     dist.get_rank(group), dim)
        full = _all_gather(shard.movedim(dim, 0), group, "all_gather_shard")
        return full.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, ctx.dim)[ctx.index].contiguous(), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group` (differentiable; see the module's
    docstring). A group of one rank returns x."""
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's rows concatenated along dim 0 in rank order
    (differentiable; the backward keeps this rank's rows). Integer tensors
    gather without autograd."""
    if group_size(group) == 1:
        return x
    if not (x.is_floating_point() and x.requires_grad):
        return _all_gather(x, group, "gather_rows")
    return _GatherRows.apply(x, group)


def all_gather_shard(shard: torch.Tensor, group, dim: int = 0
                     ) -> torch.Tensor:
    """A weight's shards over `group` joined along `dim` (differentiable:
    the backward keeps this rank's shard of the cotangent)."""
    if group_size(group) == 1:
        return shard
    return _AllGatherShard.apply(shard, group, dim)


def all_gather_objects(obj, group) -> list:
    """Every rank's picklable `obj`, in rank order (counted with bytes 0:
    objects have no tensor size)."""
    n = group_size(group)
    if n == 1:
        return [obj]
    with _COUNT_LOCK:
        _COUNTS.setdefault("all_gather_object", [0, 0])[0] += 1
    out = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


# ---------------------------------------------------------------------------
# the data-parallel context


class RowShard:
    """This rank's place in a data-parallel step: the `data` group, its
    size and this rank's index in it. Every batch a rank sees is the
    index-th of n equal blocks of the global batch."""

    def __init__(self, group, n: int, index: int):
        self.group, self.n, self.index = group, n, index

    def global_rows(self, local: int):
        """(global batch rows, this rank's first row)."""
        return local * self.n, local * self.index


# a context variable: a thread (a serving replica's) never sees the
# context of a step another thread runs
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "ecgmm_data_parallel", default=None)


def active() -> Optional[RowShard]:
    """The data-parallel context of the running step, or None (one rank,
    or outside a step)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def data_parallel(shard: Optional[RowShard]) -> Iterator[None]:
    """Run the block with `shard` as the data-parallel context (None, or a
    group of one rank, leaves the single-process code paths on)."""
    token = _ACTIVE.set(shard if shard is not None and shard.n > 1
                        else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def gather_rows_if_active(x: torch.Tensor) -> torch.Tensor:
    """`gather_rows` over the active data group; x itself outside one."""
    ctx = _ACTIVE.get()
    return x if ctx is None else gather_rows(x, ctx.group)
