"""Train state (port of `ecgmm_tpu/train/state.py`): everything an exact
resume needs. The JAX state is one immutable tree; here it is the module
(parameters and BatchNorm statistics), the optimizer, the dropout
generator and the loop counters, updated in place by the engine."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from ecgmm_torch.config import TrainConfig
from ecgmm_torch.models.resnet1d_se import set_dropout_generator
from ecgmm_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    generator: torch.Generator          # dropout masks
    step: int = 0                       # optimizer updates so far
    epoch: int = 0                      # epochs completed
    best_val_loss: float = math.inf     # float32-rounded, as in JAX
    early_stop_counter: int = 0
    lr_reduce_counter: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "generator": self.generator.get_state(),
            "step": self.step,
            "epoch": self.epoch,
            "best_val_loss": self.best_val_loss,
            "early_stop_counter": self.early_stop_counter,
            "lr_reduce_counter": self.lr_reduce_counter,
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.model.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        self.generator.set_state(sd["generator"])
        for k in ("step", "epoch", "early_stop_counter",
                  "lr_reduce_counter"):
            setattr(self, k, int(sd[k]))
        self.best_val_loss = float(sd["best_val_loss"])


def create_state(model: nn.Module, cfg: TrainConfig,
                 steps_per_epoch: Optional[int] = None) -> TrainState:
    """A fresh TrainState around `model` (already on its device): Adam
    over every parameter and a dropout generator on the model's device
    seeded with `cfg.seed`."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.seed)
    set_dropout_generator(model, generator)
    return TrainState(
        model=model,
        optimizer=Optimizer(model.parameters(), cfg, steps_per_epoch),
        generator=generator,
    )
