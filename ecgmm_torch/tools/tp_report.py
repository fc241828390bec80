"""Collective report of a data x tensor-parallel train step (port of
`ecgmm_tpu/tools/tp_report.py`).

Runs one `fusion` train step (frozen encoders, the head trained, SGD on
the trainable surface) over n_data x n_model ranks (`parallel/launch.py`)
and prints, per collective, the calls and result bytes the wrappers of
`parallel/collectives.py` counted on rank 0, beside the bytes of a rank's
parameters (`parallel/tp.tp_bytes_per_device`) and the weight
collectives the parameter set predicts (`expected_counts`). JAX reads these
numbers from XLA's HLO; here the wrappers count them as they run.

    python -m ecgmm_torch.tools.tp_report --n-data 2 --n-model 2 \\
        --device cpu

The ranks join over gloo (`parallel/launch.py`); with `--device cuda`
they share cuda:0, a check of the counts, not of a multi-card run.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from ecgmm_torch.config import MeshConfig, ModelConfig, TrainConfig


def expected_counts(model: torch.nn.Module, n_data: int, n_model: int,
                    bucket_elems: int) -> Dict[str, Dict[str, int]]:
    """The weight collectives that the parameter set of a placed `model`
    predicts for a train step after which it holds its gradients: one
    `all_gather_shard` per sharded parameter (the whole weight's bytes)
    and over a data axis the flat buckets of every gradient
    (`engine.reduce_gradients`)."""
    from ecgmm_torch.parallel import tp

    out: Dict[str, Dict[str, int]] = {}
    pl = tp.placement(model)
    shards = tp.sharded_params(model, pl) if pl is not None else {}
    seen = set()
    for p in model.parameters():
        if id(p) not in shards or id(p) in seen:
            continue
        seen.add(id(p))
        nbytes = p.numel() * p.element_size()
        g = out.setdefault("all_gather_shard", {"calls": 0, "bytes": 0})
        g["calls"] += 1
        g["bytes"] += nbytes * n_model
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if n_data > 1 and grads:
        calls, size = 1, 0
        for g in grads:
            if size and size + g.numel() > bucket_elems:
                calls += 1
                size = 0
            size += g.numel()
        out["all_reduce"] = {"calls": calls, "bytes": sum(
            g.numel() * g.element_size() for g in grads)}
    return out


def _build(cfg: TrainConfig, mcfg: ModelConfig, device):
    from ecgmm_torch.models import ECGMultimodalModel
    from ecgmm_torch.models.layers import flax_init_
    from ecgmm_torch.train.state import (create_state,
                                         encoder_freeze_predicate)
    from ecgmm_torch.workloads.tasks import make_fusion_task

    model = ECGMultimodalModel(mcfg)
    flax_init_(model, torch.Generator().manual_seed(cfg.seed))
    state = create_state(model.to(device), cfg, 4,
                         freeze=encoder_freeze_predicate)
    return state, make_fusion_task(cfg)


def _batch(bs: int, img: int, signal_len: int, seed: int):
    from ecgmm_torch.data.pipeline import Batch

    rng = np.random.default_rng(seed)
    return Batch(
        images=torch.from_numpy(rng.integers(0, 256, (bs, 3, img, img),
                                             dtype=np.uint8)),
        signals=torch.from_numpy(rng.normal(size=(bs, signal_len))
                                 .astype(np.float32)),
        clinical=torch.from_numpy(rng.normal(size=(bs, 2))
                                  .astype(np.float32)),
        labels=torch.from_numpy(rng.integers(0, 2, bs)),
        mask=torch.ones(bs))


def rank_step(rank: int, n_data: int, n_model: int, device: str, bs: int,
              img: int, signal_len: int, dtype: str) -> dict:
    """One rank of the report: the fusion step on this rank's rows;
    returns the counters, the rank's parameter bytes and the plan."""
    from ecgmm_torch.parallel import collectives, tp
    from ecgmm_torch.parallel.mesh import local_rows, make_mesh
    from ecgmm_torch.train import engine

    dev = torch.device(device)
    cfg = TrainConfig(batch_size=bs, lr=1e-3)
    mcfg = ModelConfig(dtype=dtype)
    state, task = _build(cfg, mcfg, dev)
    mesh = make_mesh(MeshConfig(n_data=n_data, n_model=n_model), dev)
    full_bytes = tp.tp_bytes_per_device(state.model, 1)
    rank_bytes = tp.tp_bytes_per_device(state.model, n_model)
    tp.place_state(state, mesh)
    b = _batch(bs, img, signal_len, 0)
    local = type(b)(*(None if x is None else local_rows(x, mesh).to(dev)
                      for x in b))
    collectives.reset_counts()
    mets = engine.train_step(task, state, local, mesh=mesh)
    counts = collectives.counts()
    expected = expected_counts(state.model, n_data, n_model,
                               engine.GRAD_BUCKET_ELEMS)
    return {"counts": counts, "expected": expected,
            "param_bytes": full_bytes, "param_bytes_per_rank": rank_bytes,
            "loss": float(mets["loss"])}


def report(n_data: int, n_model: int, device: str = "cpu",
           bs: int = 16, img: int = 224,
           signal_len: int = 2476, dtype: str = "float32") -> dict:
    """Rank 0's counters and byte figures (every rank's losses too)."""
    from ecgmm_torch.parallel import launch

    outs = launch.spawn(rank_step, n_data * n_model,
                        args=(n_data, n_model, device, bs, img, signal_len,
                              dtype),
                        threads=0 if device != "cpu" else 1)
    return dict(outs[0], n_data=n_data, n_model=n_model,
                losses=[o["loss"] for o in outs])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n-data", type=int, default=2)
    p.add_argument("--n-model", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; every rank on cuda:0) or "
                        "'cpu'")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--img", type=int, default=224)
    p.add_argument("--signal-len", type=int, default=2476)
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass --device cpu")
    out = report(args.n_data, args.n_model, args.device, args.batch_size,
                 args.img, args.signal_len)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
