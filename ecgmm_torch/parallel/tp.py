"""Tensor parallelism over the mesh's `model` axis (port of
`ecgmm_tpu/parallel/tp.py`).

JAX column-shards every parameter leaf of rank >= 2 whose LAST axis (the
output features, flax's layout) divides by the model axis, replicates
everything else, and lets GSPMD gather. The port keeps the reference's
torch layout, so `tp_plan` maps each parameter to its flax shape through
the tables of `tools/weights.from_jax_variables`:

  * a Linear or convolution weight (out, in, ...) is flax's (..., in,
    out): shard dim 0 where `out` divides;
  * an LSTM's fused weight_ih / weight_hh (4H, ...) holds flax's per-gate
    kernels (in, H) and (H, H): shard dim 0 where H divides (the bytes of
    a rank equal those of the four sharded gate kernels);
  * the attention's packed in_proj_weight (3D, D) and in_proj_bias (3D,)
    hold flax's q, k, v DenseGeneral kernels (D, heads, head_dim) and
    biases (heads, head_dim): shard dim 0 where head_dim divides;
  * any other parameter of rank >= 2 has flax's layout (the Transformer's
    pos_embedding): shard its last dim where it divides;
  * the rest (biases, norms, the fusion logits) is replicated; TabNet's
    shared GLU Linear layers are one module in every transformer, one
    flax leaf, one shard.

`place_state` shards a TrainState in place: each sharded parameter becomes
a `torch.nn.utils.parametrize` parametrization whose original is this
rank's shard (Adam's moments follow it and stay local: the update is
elementwise) and whose value is the whole weight, gathered over the model
group (`collectives.all_gather_shard`) when a forward reads it; under
`gathered(model)` each is gathered once per forward, so the kernels
receive whole tensors as they do on one rank. `TrainState.state_dict`
gathers the full state (the checkpoint format does not change) and
`load_state_dict` shards it again.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, Iterator, Optional

import torch
from torch import nn
from torch.nn.utils import parametrize

from ecgmm_torch.models.layers import MultiHeadSelfAttention
from ecgmm_torch.parallel import collectives
from ecgmm_torch.parallel.mesh import Mesh


def _divides(size: int, n: int) -> bool:
    return size % n == 0 and size >= n


def _param_dim(module: nn.Module, pname: str, p: torch.Tensor,
               n_model: int) -> Optional[int]:
    """The dim of `module.pname` that tensor parallelism shards over
    `n_model` ranks, or None (replicated); see the module's docstring."""
    if n_model <= 1:
        return None
    if isinstance(module, MultiHeadSelfAttention) and pname.startswith(
            "in_proj_"):
        head_dim = p.shape[-1] // module.nhead if p.dim() == 2 \
            else p.shape[0] // 3 // module.nhead
        return 0 if _divides(head_dim, n_model) else None
    if p.dim() < 2:
        return None
    if isinstance(module, nn.LSTM):
        return 0 if _divides(module.hidden_size, n_model) else None
    if isinstance(module, (nn.Linear, nn.modules.conv._ConvNd)) \
            and pname == "weight":
        return 0 if _divides(p.shape[0], n_model) else None
    return p.dim() - 1 if _divides(p.shape[-1], n_model) else None


def tp_plan(model: nn.Module, n_model: int) -> Dict[str, int]:
    """{state-dict name: sharded dim} of the parameters tensor parallelism
    shards over `n_model` ranks; a parameter several modules share (TabNet's
    GLU layers) appears under each of its names."""
    plan = {}
    for mname, module in model.named_modules(remove_duplicate=False):
        for pname, p in module.named_parameters(recurse=False):
            dim = _param_dim(module, pname, p, n_model)
            if dim is not None:
                plan[f"{mname}.{pname}" if mname else pname] = dim
    return plan


def tp_bytes_per_device(model: nn.Module, n_model: int) -> int:
    """The bytes of a rank's parameters under `place_state`'s layout: each
    parameter once (shared ones too), a sharded one divided by n_model."""
    total, seen = 0, set()
    for module in model.modules():
        for pname, p in module.named_parameters(recurse=False):
            if id(p) in seen:
                continue
            seen.add(id(p))
            n = p.numel() * p.element_size()
            if _param_dim(module, pname, p, n_model) is not None:
                n //= n_model
            total += n
    return total


class _Gather(nn.Module):
    """The parametrization of a sharded parameter: the whole weight from
    this rank's shard (forward) and the shard from a whole weight
    (right_inverse)."""

    def __init__(self, mesh: Mesh, dim: int):
        super().__init__()
        self.mesh, self.dim = mesh, dim

    def forward(self, shard):
        return collectives.all_gather_shard(shard, self.mesh.model_group,
                                            self.dim)

    def right_inverse(self, full):
        return shard_of(full, self.mesh, self.dim)

    def __deepcopy__(self, memo):
        # the mesh holds process groups, which do not copy
        out = _Gather(self.mesh, self.dim)
        memo[id(self)] = out
        return out


def shard_of(full: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's block of `full` along `dim` (a copy)."""
    return full.detach().chunk(mesh.n_model, dim)[mesh.model_index].clone()


def _gather_full(shard: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    with torch.no_grad():
        return collectives.all_gather_shard(shard.detach(), mesh.model_group,
                                            dim)


class _Placement:
    """What `place_state` records on the model: the mesh, the full state
    dict's key order, and per sharded parameter its dim and the key of its
    shard in the model's own state dict."""

    def __init__(self, mesh, order, dims, shard_keys):
        self.mesh, self.order = mesh, order
        self.dims, self.shard_keys = dims, shard_keys

    def __deepcopy__(self, memo):
        return self


def placement(model: nn.Module) -> Optional[_Placement]:
    return model.__dict__.get("_tp_placement")


def place_state(state, mesh: Optional[Mesh]):
    """Shard `state` (a TrainState) in place over the mesh's model axis
    when it has more than one rank, and return it; a pure data mesh (or
    None) leaves it as it is (every rank holds the whole state, as JAX's
    `replicate`). Call it on every rank, before any step."""
    if mesh is None or mesh.n_model == 1 or placement(state.model):
        return state
    model = state.model
    order = list(model.state_dict().keys())
    plan = tp_plan(model, mesh.n_model)
    entries = [(mname, module, pname, p)
               for mname, module in model.named_modules(
                   remove_duplicate=False)
               for pname, p in module.named_parameters(recurse=False)]
    new_of: Dict[int, tuple] = {}
    shard_keys = {}
    for mname, module, pname, p in entries:
        key = f"{mname}.{pname}" if mname else pname
        if key not in plan:
            continue
        prefix = f"{mname}." if mname else ""
        shard_keys[key] = f"{prefix}parametrizations.{pname}.original"
        if id(p) in new_of:  # a shared module's alias
            continue
        parametrize.register_parametrization(
            module, pname, _Gather(mesh, plan[key]), unsafe=True)
        orig = module.parametrizations[pname].original
        orig.requires_grad_(p.requires_grad)
        new_of[id(p)] = (orig, plan[key])
    adam = state.optimizer.adam
    for group in adam.param_groups:
        group["params"] = [new_of[id(p)][0] if id(p) in new_of else p
                           for p in group["params"]]
    moved = collections.defaultdict(dict)
    for p, st in adam.state.items():
        if id(p) in new_of:
            orig, dim = new_of[id(p)]
            moved[orig] = {k: (shard_of(v, mesh, dim)
                               if torch.is_tensor(v) and v.dim() else v)
                           for k, v in st.items()}
        else:
            moved[p] = st
    adam.state = moved
    model.__dict__["_tp_placement"] = _Placement(mesh, order, plan,
                                                 shard_keys)
    return state


def sharded_params(model: nn.Module, pl: _Placement):
    """{id(shard parameter): dim} of the placed model."""
    out = {}
    sd_params = dict(model.named_parameters(remove_duplicate=False))
    for key, shard_key in pl.shard_keys.items():
        out[id(sd_params[shard_key])] = pl.dims[key]
    return out


def full_state_dict(state) -> dict:
    """`TrainState.state_dict()` of a placed state in the unsharded format:
    the model's state dict in its original key order and Adam's moments,
    with every shard gathered over the model group (a collective: every
    rank calls it)."""
    model, pl = state.model, placement(state.model)
    cur = model.state_dict()
    msd = {}
    for key in pl.order:
        if key in pl.shard_keys:
            msd[key] = _gather_full(cur[pl.shard_keys[key]], pl.mesh,
                                    pl.dims[key])
        else:
            msd[key] = cur[key]
    dims = sharded_params(model, pl)
    osd = state.optimizer.state_dict()
    params = [p for g in state.optimizer.adam.param_groups
              for p in g["params"]]
    for i, p in enumerate(params):
        if id(p) in dims and i in osd["state"]:
            osd["state"][i] = {
                k: (_gather_full(v, pl.mesh, dims[id(p)])
                    if torch.is_tensor(v) and v.dim() else v)
                for k, v in osd["state"][i].items()}
    return {"model": msd, "optimizer": osd}


def load_full_state_dict(state, sd: dict) -> None:
    """Load an unsharded `state_dict` into a placed state: each rank keeps
    its shards of the model and of Adam's moments."""
    model, pl = state.model, placement(state.model)
    mesh = pl.mesh
    msd = {}
    for key, v in sd["model"].items():
        if key in pl.shard_keys:
            msd[pl.shard_keys[key]] = shard_of(v, mesh, pl.dims[key])
        else:
            msd[key] = v
    model.load_state_dict(msd, strict=True)
    dims = sharded_params(model, pl)
    osd = dict(sd["optimizer"])
    osd["state"] = dict(osd["state"])
    params = [p for g in state.optimizer.adam.param_groups
              for p in g["params"]]
    for i, p in enumerate(params):
        if id(p) in dims and i in osd["state"]:
            osd["state"][i] = {
                k: (shard_of(v, mesh, dims[id(p)])
                    if torch.is_tensor(v) and v.dim() else v)
                for k, v in osd["state"][i].items()}
    state.optimizer.load_state_dict(osd)


@contextlib.contextmanager
def gathered(model: nn.Module) -> Iterator[None]:
    """Within the block each sharded parameter of a placed model is
    gathered once, at its first read (`parametrize.cached`); elsewhere the
    block runs as it is."""
    if placement(model) is None:
        yield
        return
    with parametrize.cached():
        yield
