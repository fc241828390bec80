"""Checkpoints (port of `ecgmm_tpu/train/checkpoint.py`): `best`, `last`
and `epochN` (the newest `keep_epochs` of them), each the whole
TrainState for an exact resume, plus plain dictionaries such as the
fitted temperatures.

A save writes `<name>.pt` with `torch.save` to a temporary file in the
same directory and moves it into place with `os.replace`, so a reader
never sees half a file. Saves are synchronous. Loads read tensors only
(`weights_only=True`) onto the CPU; `TrainState.load_state_dict` copies
them to the state's device.

In a run over several ranks every rank calls `save` (a tensor-parallel
state gathers its shards there), the manager made with `writer=True`
(rank 0) alone writes, and every rank waits for the file before it goes
on, so a rank that restores next reads what was written.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import torch
import torch.distributed as dist

from ecgmm_torch.train.state import TrainState


class CheckpointManager:
    def __init__(self, directory: str, keep_epochs: int = 3,
                 writer: bool = True):
        self.writer = writer
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_epochs = keep_epochs
        # a resumed run keeps pruning its predecessor's epochN files
        existing = sorted(
            (f[:-3] for f in os.listdir(self.directory)
             if f.startswith("epoch") and f.endswith(".pt")
             and f[5:-3].isdigit()),
            key=lambda name: int(name[5:]),
        )
        self._epoch_names: List[str] = existing

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def save(self, name: str, state) -> None:
        """Write a TrainState, or a plain dictionary of tensors and
        numbers, under `name`."""
        payload = state.state_dict() if isinstance(state, TrainState) \
            else state
        if self.writer:
            path = self._path(name)
            tmp = f"{path}.tmp{os.getpid()}"
            torch.save(payload, tmp)
            os.replace(tmp, path)
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()

    def save_epoch(self, epoch: int, state: TrainState) -> None:
        name = f"epoch{epoch}"
        self.save(name, state)
        self._epoch_names.append(name)
        while len(self._epoch_names) > self.keep_epochs:
            old = self._path(self._epoch_names.pop(0))
            if self.writer and os.path.exists(old):
                os.remove(old)

    def load(self, name: str) -> Dict[str, Any]:
        return torch.load(self._path(name), map_location="cpu",
                          weights_only=True)

    def restore(self, name: str, state: TrainState) -> TrainState:
        """Load checkpoint `name` into `state` (in place) and return it."""
        state.load_state_dict(self.load(name))
        return state

    def exists(self, name: str) -> bool:
        return os.path.isfile(self._path(name))
