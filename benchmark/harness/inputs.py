"""What a run feeds the program and the reference, made from `--seed`:
seeds for each purpose, the weights of a model and the pools of rows.

Weights are drawn on the model's device in one call from a generator
seeded from the run's seed, then scaled by a rule on each leaf's name and
shape (the same rule on both sides):
  * a kernel of two or more dimensions: normal, std sqrt(2 / fan_in)
    (fan_in = the size of one output row), except `pos_embedding`: 0.1;
  * a norm's scale (a one-dimensional `weight`): 1 + 0.1 normal;
  * `running_var`: 1 + 0.1 normal; any other float leaf (biases, the
    attention-fusion logits, `running_mean`): 0.1 normal.
Integer buffers (BatchNorm's batch counts) start at 0."""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch


def subseed(seed: int, *purpose) -> int:
    """A 63-bit seed for one purpose of the run seeded `seed`."""
    text = ":".join([str(int(seed))] + [str(p) for p in purpose])
    return int(hashlib.sha256(text.encode()).hexdigest()[:16], 16) >> 1


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _rule(name: str, t: torch.Tensor) -> Tuple[float, float]:
    """(base, scale) of a leaf: its values are base + scale * normal."""
    if name.endswith("pos_embedding"):
        return 0.0, 0.1
    if t.dim() >= 2:
        return 0.0, math.sqrt(2.0 / (t.numel() // t.shape[0]))
    if name.endswith("running_var") or name.endswith(".weight"):
        return 1.0, 0.1
    return 0.0, 0.1


def make_weights(module: torch.nn.Module, seed: int
                 ) -> Dict[str, torch.Tensor]:
    """Fill every parameter and buffer of `module` in place from `seed`
    and return the state dict's values by name, a copy, on the module's
    device (leaves that share storage are drawn once and share values)."""
    sd = module.state_dict()
    device = next(module.parameters()).device
    unique: Dict[Tuple[int, tuple], str] = {}
    leaves = []
    for name, t in sd.items():
        key = (t.data_ptr(), tuple(t.shape))
        if t.is_floating_point() and key not in unique:
            unique[key] = name
            leaves.append((name, t))
    sizes = [t.numel() for _, t in leaves]
    rules = [_rule(name, t) for name, t in leaves]
    counts = torch.tensor(sizes, device=device)
    base = torch.tensor([r[0] for r in rules], device=device)
    scale = torch.tensor([r[1] for r in rules], device=device)
    flat = torch.randn(sum(sizes), generator=generator(device, seed),
                       device=device)
    flat = flat * scale.repeat_interleave(counts) \
        + base.repeat_interleave(counts)
    values = dict(zip((n for n, _ in leaves), flat.split(sizes)))
    out = {}
    with torch.no_grad():
        for name, t in sd.items():
            if t.is_floating_point():
                v = values[unique[(t.data_ptr(), tuple(t.shape))]].view_as(t)
                t.copy_(v)
                out[name] = v
            else:
                t.zero_()
                out[name] = torch.zeros_like(t)
    return out


def make_pool(cfg: dict, rows: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """`rows` rows of the configuration's inputs on `device`: uint8 images,
    standard-normal signals and clinical features, uniform labels."""
    inp = cfg["inputs"]
    g = generator(device, seed)
    pool = {}
    if "image" in inp:
        pool["images"] = torch.randint(0, 256, (rows, *inp["image"]),
                                       generator=g, device=device,
                                       dtype=torch.uint8)
    pool["signals"] = torch.randn(rows, inp["signal_len"], generator=g,
                                  device=device)
    if "clinical" in inp:
        pool["clinical"] = torch.randn(rows, inp["clinical"], generator=g,
                                       device=device)
    pool["labels"] = torch.randint(0, cfg["model"]["num_classes"], (rows,),
                                   generator=g, device=device)
    return pool
