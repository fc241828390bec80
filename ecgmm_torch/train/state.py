"""Train state (port of `ecgmm_tpu/train/state.py`): everything an exact
resume needs. The JAX state is one immutable tree; here it is the module
(parameters and BatchNorm statistics), the optimizer, the dropout
generator and the loop counters, updated in place by the engine.

The JAX state splits the parameters into a trainable and a frozen
partition by a path predicate; here the frozen parameters get
`requires_grad_(False)` and the optimizer holds the trainable ones only.
The model stays in train mode as a whole, so a frozen encoder's
BatchNorms still update their running statistics, as the JAX step's
`batch_stats` do, and the checkpoint holds the whole state dict."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ecgmm_torch.config import TrainConfig
from ecgmm_torch.models.layers import set_dropout_generator
from ecgmm_torch.parallel import tp
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
        """Everything an exact resume needs; a tensor-parallel state
        (`parallel/tp.place_state`) gathers its shards, a collective every
        rank calls, so the format is the one-rank format."""
        if tp.placement(self.model) is not None:
            weights = tp.full_state_dict(self)
        else:
            weights = {"model": self.model.state_dict(),
                       "optimizer": self.optimizer.state_dict()}
        return {
            **weights,
            "generator": self.generator.get_state(),
            "step": self.step,
            "epoch": self.epoch,
            "best_val_loss": self.best_val_loss,
            "early_stop_counter": self.early_stop_counter,
            "lr_reduce_counter": self.lr_reduce_counter,
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        if tp.placement(self.model) is not None:
            tp.load_full_state_dict(self, sd)
        else:
            self.model.load_state_dict(sd["model"], strict=True)
            self.optimizer.load_state_dict(sd["optimizer"])
        self.generator.set_state(sd["generator"])
        for k in ("step", "epoch", "early_stop_counter",
                  "lr_reduce_counter"):
            setattr(self, k, int(sd[k]))
        self.best_val_loss = float(sd["best_val_loss"])


def create_state(model: nn.Module, cfg: TrainConfig,
                 steps_per_epoch: Optional[int] = None,
                 freeze: Optional[Callable[[str], bool]] = None
                 ) -> TrainState:
    """A fresh TrainState around `model` (already on its device): the
    parameters whose names `freeze` selects stop requiring a gradient,
    Adam runs over the others, and every `Dropout` of the model draws from
    a generator on the model's device seeded with `cfg.seed`."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.seed)
    set_dropout_generator(model, generator)
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(freeze is None or not freeze(name))
        if p.requires_grad:
            trainable.append(p)
    return TrainState(
        model=model,
        optimizer=Optimizer(trainable, cfg, steps_per_epoch),
        generator=generator,
    )


ENCODER_PREFIXES = ("image_encoder.", "signal_encoder.", "clinical_encoder.")


def encoder_freeze_predicate(name: str) -> bool:
    """Freeze all three modality encoders (reference train.py:35-40)."""
    return name.startswith(ENCODER_PREFIXES)
