"""Spawn local ranks over a `FileStore` (the tests' and `chip_smoke.py`'s
launcher; a run over cards starts under `torchrun`).

`spawn(fn, n, args)` starts n processes, each joins a gloo process group
of n ranks through a file store in a fresh temporary directory (no TCP port, so
concurrent launchers never collide), calls `fn(rank, *args)` and returns
what it returns; the parent gets the n results in rank order. A rank that
raises fails the launch: the parent raises with that rank's traceback and
the other ranks are stopped.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a collective that waits longer than this fails the launch
TIMEOUT = datetime.timedelta(minutes=10)


def _rank_main(rank: int, n: int, store_path: str, out_dir: str,
               threads: int, fn: Callable, args: Sequence[Any]) -> None:
    if threads:
        torch.set_num_threads(threads)
    store = dist.FileStore(store_path, n)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n,
                            timeout=TIMEOUT)
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, args: Sequence[Any] = (),
          threads: int = 1) -> List[Any]:
    """Run `fn(rank, *args)` on n spawned ranks joined over gloo;
    return their results (saved with torch.save) in rank order. `fn` must
    be importable by name (a module-level function). `threads` sets each
    rank's intra-op threads (0 leaves torch's default)."""
    work = tempfile.mkdtemp(prefix="ecgmm_ranks_")
    try:
        store_path = os.path.join(work, "store")
        mp.spawn(_rank_main, nprocs=n, join=True,
                 args=(n, store_path, work, threads, fn, tuple(args)))
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
