"""Layers with flax's training semantics, and flax's initialisation, shared
by every model of the port.

Train mode follows flax, not torch: BatchNorm normalises with the biased
batch variance and also folds the biased variance into `running_var`
(torch's BatchNorm folds the unbiased one), with eps 1e-5; the batch
statistics are taken in at least float32 whatever the activation's dtype
(flax promotes them too). Dropout draws from an explicit `torch.Generator`.
`flax_init_` initialises like flax's defaults.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated-normal initialisers divide the standard deviation by
# the std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class _FlaxBatchStats:
    """The train-mode forward of flax's BatchNorm over every dimension but
    the channels (dim 1): the batch's biased variance both normalises and
    updates `running_var`, with torch's `momentum` (flax's 1 - momentum).
    Eval mode is torch's (the running statistics)."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = (0,) + tuple(range(2, x.dim()))
        stats_dtype = torch.promote_types(x.dtype, torch.float32)
        with torch.no_grad():
            var, mean = torch.var_mean(x.to(stats_dtype), dim=dims,
                                       unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class BatchNorm1d(_FlaxBatchStats, nn.BatchNorm1d):
    """`nn.BatchNorm1d` ((B, C) or (B, C, T)) with flax's train mode."""


class BatchNorm2d(_FlaxBatchStats, nn.BatchNorm2d):
    """`nn.BatchNorm2d` ((B, C, H, W)) with flax's train mode."""


class Dropout(nn.Module):
    """Inverted dropout like flax's: keep with probability 1 - p and scale
    by 1 / (1 - p). The mask comes from `generator` (torch's default
    generator when None), which must lie on the input's device."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p,
                                              generator=self.generator)
        return x * keep / (1.0 - self.p)


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Make every `Dropout` of `model` draw from `generator`."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise `model` in place with the initialisers the JAX models
    declare (flax's defaults), drawing from `generator`: every Conv1d,
    Conv2d and Linear kernel, with or without a bias, lecun-normal
    (truncated normal, std sqrt(1 / fan_in) / 0.8796, cut at two std),
    every bias 0; BatchNorm scale 1, bias 0, running mean 0 and variance
    1; LayerNorm scale 1, bias 0. Parameters of other modules keep their
    own initialisation (the attention-fusion logits start at 1, as in
    JAX). A Linear shared by several modules is drawn once. A run from
    scratch then starts from the same distribution as the JAX run (the
    numbers differ: the generators do)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.modules.batchnorm._BatchNorm,
                                nn.LayerNorm)):
                m.reset_parameters()
    return model
