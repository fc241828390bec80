"""Plain Adam (betas 0.9 / 0.999, eps 1e-8, bias-corrected, as torch's
Adam computes it) at a constant learning rate or on optax's cosine
one-cycle schedule, frozen here."""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch


def onecycle(transition_steps: int, peak: float, pct_start: float = 0.3,
             div_factor: float = 25.0, final_div_factor: float = 1e4
             ) -> Callable[[int], float]:
    """optax.cosine_onecycle_schedule: update count -> learning rate."""
    bounds = (0, int(pct_start * transition_steps), int(transition_steps))
    values = (peak / div_factor, peak, peak / (div_factor * final_div_factor))

    def lr(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct)
                                                     + 1)
        return values[-1]

    return lr


def schedule(train: dict, steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate of each update count for a configuration's
    `train` group."""
    if train["schedule"] == "onecycle":
        return onecycle(max(steps_per_epoch * train["num_epochs"], 4),
                        train["onecycle_peak_lr"])
    if train["schedule"] == "constant":
        return lambda count: train["lr"]
    raise ValueError(train["schedule"])


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor],
                 lr: Callable[[int], float], betas=(0.9, 0.999),
                 eps: float = 1e-8,
                 m: Optional[Dict[str, torch.Tensor]] = None,
                 v: Optional[Dict[str, torch.Tensor]] = None,
                 count: int = 0):
        """Fresh, or resumed from the moments `m` and `v` by name after
        `count` updates."""
        self.params, self.lr = params, lr
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = {n: t.clone() for n, t in (m or {}).items()}
        self.v = {n: t.clone() for n, t in (v or {}).items()}
        self.count = count

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        """One update; a parameter whose gradient is None is not touched."""
        lr = self.lr(self.count)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for name, p in self.params.items():
            g = grads.get(name)
            if g is None:
                continue
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            m.lerp_(g, 1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (v.sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-lr / c1)
