"""Optimizer (port of `ecgmm_tpu/train/optim.py`): Adam, betas (0.9,
0.999), eps 1e-8, at a constant learning rate or on the one-cycle
schedule.

The one-cycle schedule is optax's `cosine_onecycle_schedule` written out
(cosine warm-up from peak/25 to the peak over the first 30% of the steps,
then cosine decay to peak/25/1e4), over max(steps_per_epoch * epochs, 4)
steps, and the learning rate is set from it before every `step()`. torch's
`OneCycleLR` is not used: it places the peak one step earlier and cycles
Adam's beta1. As in the JAX package, a scheduled optimizer exposes no
learning rate to the plateau decay or the logs (`get_lr` is None: optax's
`adam(schedule)` injects no hyperparameter); the constant one does. With
`weight_decay` the gradient takes `weight_decay * p` before Adam (torch
Adam's coupled decay), as the JAX package chains
`optax.add_decayed_weights` before adam; the plateau decay reaches the
learning rate through that chain there, and through the param groups
here.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

from ecgmm_torch.config import TrainConfig


def onecycle_schedule(transition_steps: int, peak_value: float,
                      pct_start: float = 0.3, div_factor: float = 25.0,
                      final_div_factor: float = 1e4
                      ) -> Callable[[int], float]:
    """optax.cosine_onecycle_schedule: step count -> learning rate."""
    if transition_steps <= 0:
        raise ValueError("onecycle needs a positive transition_steps")
    bounds = (0, int(pct_start * transition_steps), int(transition_steps))
    values = (peak_value / div_factor, peak_value,
              peak_value / (div_factor * final_div_factor))

    def schedule(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct)
                                                     + 1)
        return values[-1]

    return schedule


class Optimizer:
    """torch Adam plus the learning-rate policy of the JAX optimizer."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: TrainConfig, steps_per_epoch: Optional[int] = None):
        self.schedule: Optional[Callable[[int], float]] = None
        if cfg.schedule == "onecycle":
            if not steps_per_epoch:
                raise ValueError("onecycle needs steps_per_epoch")
            self.schedule = onecycle_schedule(
                max(steps_per_epoch * cfg.num_epochs, 4),
                cfg.onecycle_peak_lr,
            )
            lr = self.schedule(0)
        elif cfg.schedule == "constant":
            lr = cfg.lr
        else:
            raise ValueError(f"unknown schedule {cfg.schedule!r}")
        self.adam = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8,
                                     weight_decay=cfg.weight_decay)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self, count: int) -> None:
        """One Adam update; `count` is the number of updates before it
        (the schedule's step)."""
        if self.schedule is not None:
            lr = self.schedule(count)
            for group in self.adam.param_groups:
                group["lr"] = lr
        self.adam.step()

    def get_lr(self) -> Optional[float]:
        """The constant schedule's current learning rate; None when
        scheduled."""
        if self.schedule is not None:
            return None
        return float(self.adam.param_groups[0]["lr"])

    def scale_lr(self, factor: float) -> None:
        """lr <- lr * factor (the plateau decay); only for the constant
        schedule (callers gate on `get_lr() is not None`)."""
        for group in self.adam.param_groups:
            group["lr"] = group["lr"] * factor

    def state_dict(self):
        return self.adam.state_dict()

    def load_state_dict(self, sd) -> None:
        self.adam.load_state_dict(sd)
