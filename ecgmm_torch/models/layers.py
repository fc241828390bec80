"""Layers with flax's training semantics, and flax's initialisation, shared
by every model of the port.

Train mode follows flax, not torch: BatchNorm normalises with the biased
batch variance and also folds the biased variance into `running_var`
(torch's BatchNorm folds the unbiased one), with eps 1e-5; the batch
statistics are taken in at least float32 whatever the activation's dtype
(flax promotes them too). Dropout draws from an explicit `torch.Generator`.
`MultiHeadSelfAttention` is flax's attention, broadcast dropout
included. `flax_init_` initialises like flax's defaults.
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


class BroadcastDropout(Dropout):
    """flax's attention dropout (`broadcast_dropout=True` in
    `MultiHeadDotProductAttention`): one keep mask over the last two
    dimensions, shared by every leading one (the batch and the heads),
    scaled by 1 / (1 - p), from `generator` like `Dropout`."""

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        shape = (1,) * (x.dim() - 2) + tuple(x.shape[-2:])
        keep = torch.empty(shape, dtype=x.dtype, device=x.device).bernoulli_(
            1.0 - self.p, generator=self.generator)
        return x * (keep / (1.0 - self.p))


class MultiHeadSelfAttention(nn.Module):
    """flax's `MultiHeadDotProductAttention` over (B, T, D) as self
    attention, with the parameters of torch's `nn.MultiheadAttention`
    (`in_proj_weight` (3D, D) holding the q, k, v projections,
    `in_proj_bias`, `out_proj`): the query is divided by sqrt(head_dim)
    before the product, and the softmax's weights take flax's broadcast
    dropout. The products are `torch.matmul`: the JAX package computes
    them outside any Pallas kernel."""

    def __init__(self, d_model: int, nhead: int, dropout: float):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.dropout = BroadcastDropout(dropout)

    def forward(self, x):  # (B, T, D)
        b, t, d = x.shape
        hd = d // self.nhead
        q, k, v = (F.linear(x, w, bias).view(b, t, self.nhead, hd)
                   .transpose(1, 2)
                   for w, bias in zip(self.in_proj_weight.chunk(3),
                                      self.in_proj_bias.chunk(3)))
        scores = torch.matmul(q / math.sqrt(hd), k.transpose(-1, -2))
        attn = self.dropout(torch.softmax(scores, dim=-1))
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, d)
        return self.out_proj(out)


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
    1; LayerNorm scale 1, bias 0; an LSTM as flax's `OptimizedLSTMCell`
    (`_flax_lstm_init_`); the attention's packed q, k, v kernels
    lecun-normal with the model width as fan-in, their biases 0; a
    `pos_embedding` 0. Parameters of other modules keep their
    own initialisation (the attention-fusion logits start at 1, as in
    JAX). A Linear shared by several modules is drawn once. A run from
    scratch then starts from the same distribution as the JAX run (the
    numbers differ: the generators do)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                _lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.modules.batchnorm._BatchNorm,
                                nn.LayerNorm)):
                m.reset_parameters()
            elif isinstance(m, nn.LSTM):
                _flax_lstm_init_(m, generator)
            elif isinstance(m, MultiHeadSelfAttention):
                _lecun_normal_(m.in_proj_weight, generator)
                m.in_proj_bias.zero_()
            pos = getattr(m, "pos_embedding", None)
            if isinstance(pos, nn.Parameter):
                pos.zero_()
    return model


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Truncated normal, std sqrt(1 / fan_in) / 0.8796, cut at two std;
    fan_in is the size of one output row (every q, k and v row of a packed
    in_proj_weight has the model width as fan-in, as flax's three kernels
    do)."""
    std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def _flax_lstm_init_(lstm: nn.LSTM, generator: torch.Generator) -> None:
    """flax's `OptimizedLSTMCell` initialisers on torch's packed (i, f, g,
    o) tensors: the input kernels lecun-normal (fan-in the input width),
    each gate's recurrent (H, H) block orthogonal on its own (flax keeps
    one `h{i,f,g,o}` kernel a gate), every bias 0 (flax has one bias a
    gate: `bias_hh_*` stays 0 and out of training, `models/crnn.py`)."""
    for name, p in lstm.named_parameters():
        if name.startswith("weight_ih"):
            _lecun_normal_(p, generator)
        elif name.startswith("weight_hh"):
            for block in p.chunk(4):
                nn.init.orthogonal_(block, generator=generator)
        else:
            p.zero_()
