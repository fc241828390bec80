"""The (data, model) mesh over the ranks of a `torch.distributed` run
(port of `ecgmm_tpu/parallel/mesh.py`).

JAX lays its visible devices out as a `Mesh((data, model))` and GSPMD
inserts the collectives. Here a rank is one process on one device; the
mesh names this rank's coordinates and the process groups of its row and
column, and the engine, the models and the serving path call the
collectives of `parallel/collectives.py` on them. Rank r sits at
(r // n_model, r % n_model), as `np.reshape(devices, (n_data, n_model))`
places device r. Without a process group the mesh is one rank. The
groups are `new_group`s, not a `DeviceMesh`: JAX's layout may leave ranks
out (n_model not dividing them), which a mesh over the whole world cannot.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import warnings
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ecgmm_torch.config import MeshConfig
from ecgmm_torch.parallel.collectives import RowShard


def mesh_shape(cfg: MeshConfig, n_visible: int) -> Tuple[int, int]:
    """(n_data, n_model) for `cfg` over `n_visible` ranks, with the JAX
    package's checks and messages: n_data -1 takes every rank (divided by
    n_model, with a warning where n_model does not divide them)."""
    if cfg.n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {cfg.n_model}")
    n_model = cfg.n_model
    n_data = cfg.n_data if cfg.n_data > 0 else n_visible // n_model
    if cfg.n_data > 0 and n_data * n_model > n_visible:
        raise ValueError(
            f"requested mesh {n_data}x{n_model} (data x model) needs "
            f"{n_data * n_model} devices but only {n_visible} are visible")
    if n_data < 1:
        raise ValueError(
            f"n_model={n_model} exceeds the {n_visible} visible device(s) "
            "— no data-parallel replicas remain")
    if n_data * n_model < n_visible and cfg.n_data <= 0:
        warnings.warn(
            f"mesh uses {n_data * n_model} of {n_visible} devices "
            f"(n_model={n_model} does not divide the device count)",
            stacklevel=3)
    return n_data, n_model


@dataclasses.dataclass
class Mesh:
    """This rank's view of the mesh. `shape` maps the axis names to their
    sizes (as JAX's `mesh.shape`); `groups` maps them to the process group
    of the ranks that share this rank's other coordinate (None where the
    axis has one rank or there is no process group)."""

    axis_names: Tuple[str, str]
    shape: dict
    coords: Tuple[int, int]
    groups: dict
    device: torch.device

    @property
    def data_axis(self) -> str:
        return self.axis_names[0]

    @property
    def model_axis(self) -> str:
        return self.axis_names[1]

    @property
    def n_data(self) -> int:
        return self.shape[self.data_axis]

    @property
    def n_model(self) -> int:
        return self.shape[self.model_axis]

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def model_index(self) -> int:
        return self.coords[1]

    @property
    def data_group(self):
        return self.groups[self.data_axis]

    @property
    def model_group(self):
        return self.groups[self.model_axis]

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def is_writer(self) -> bool:
        """Rank (0, 0) writes the run's files."""
        return self.coords == (0, 0)

    def row_shard(self) -> RowShard:
        return RowShard(self.data_group, self.n_data, self.data_index)


def make_mesh(cfg: MeshConfig = MeshConfig(), device=None) -> Mesh:
    """The mesh of `cfg` over the ranks of the process group (one rank
    without one). Every rank of the group must call it: it creates the
    data and model groups. A rank that `mesh_shape` leaves out raises."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n_data, n_model = mesh_shape(cfg, world)
    groups = {cfg.data_axis: None, cfg.model_axis: None}
    if dist.is_initialized():
        for j in range(n_model):
            ranks = [i * n_model + j for i in range(n_data)]
            g = dist.new_group(ranks)
            if rank in ranks and n_data > 1:
                groups[cfg.data_axis] = g
        for i in range(n_data):
            ranks = [i * n_model + j for j in range(n_model)]
            g = dist.new_group(ranks)
            if rank in ranks and n_model > 1:
                groups[cfg.model_axis] = g
    if rank >= n_data * n_model:
        raise ValueError(
            f"rank {rank} lies outside the {n_data}x{n_model} mesh: start "
            f"{n_data * n_model} ranks")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    return Mesh(axis_names=(cfg.data_axis, cfg.model_axis),
                shape={cfg.data_axis: n_data, cfg.model_axis: n_model},
                coords=(rank // n_model, rank % n_model), groups=groups,
                device=torch.device(device))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def local_rows(global_batch, mesh: Optional[Mesh]):
    """This rank's contiguous block of the rows of `global_batch` (an
    array or tensor, sliced along dim 0), as `NamedSharding(P("data"))`
    places them. The data axis must divide the rows."""
    if mesh is None or mesh.n_data == 1:
        return global_batch
    b = global_batch.shape[0]
    if b % mesh.n_data:
        raise ValueError(
            f"batch of {b} rows does not divide over the data axis of "
            f"size {mesh.n_data}")
    k = b // mesh.n_data
    return global_batch[mesh.data_index * k:(mesh.data_index + 1) * k]


def visible_devices(device="cuda") -> List[torch.device]:
    """The devices of the kind of `device` this process may use: every
    CUDA device, or the one CPU. The single place that lists them (mesh
    serving takes its replicas' devices from here)."""
    kind = torch.device(device).type
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def init_distributed(backend: Optional[str] = None, device: str = "cuda"
                     ) -> Optional[torch.device]:
    """Join the process group torchrun describes (`RANK`, `WORLD_SIZE`,
    `LOCAL_RANK`, `MASTER_ADDR`/`MASTER_PORT`) and return this rank's
    device: `cuda:LOCAL_RANK` over NCCL, or with `device="cpu"` the CPU
    over gloo; `backend` overrides the choice. Without torchrun's
    environment it returns None (one process, no group). A failed init
    raises; nothing falls back to gloo or the CPU unless named."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but no CUDA device is available; "
                "pass device='cpu' (--device cpu) for gloo on the CPU")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(kind)
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method="env://",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            timeout=datetime.timedelta(minutes=30))
    return dev
