"""Layers with flax's training semantics, and flax's initialisation, shared
by every model of the port.

Train mode follows flax, not torch: BatchNorm normalises with the biased
batch variance and also folds the biased variance into `running_var`
(torch's BatchNorm folds the unbiased one), with eps 1e-5; the batch
statistics are taken in at least float32 whatever the activation's dtype
(flax promotes them too). Dropout draws from an explicit `torch.Generator`,
or takes a keep mask the caller gives it. Both run under `torch.func.vmap`
with a fold axis on the buffers, as the CV fold program runs them
(`train/cv_parallel.py`).
`MultiHeadSelfAttention` is flax's attention, broadcast dropout
included. `flax_init_` initialises like flax's defaults.

Under a data-parallel step (`parallel/collectives.data_parallel`, more
than one rank on the data axis) each rank holds a block of the global
batch, and both layers keep the one-process semantics: BatchNorm takes the
global batch's moments (`global_batch_norm`), and Dropout draws the
global batch's keep mask from the shared generator and keeps its own rows,
so a data-parallel run draws the masks of the one-process run of the same
seed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ecgmm_torch.ops import _ext, attention
from ecgmm_torch.parallel import collectives
from ecgmm_torch.train import profiler

# flax's truncated-normal initialisers divide the standard deviation by
# the std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _lerp_(buf: torch.Tensor, end: torch.Tensor, weight: float) -> None:
    """buf <- lerp(buf, end, weight), in place. A buffer batched by
    `torch.func.vmap` (one per fold) takes the out-of-place lerp and a
    copy, which vmap batches, where `lerp_` has no batching rule and would
    loop over the folds; both run the same lerp kernel, so the bits are
    the same."""
    if torch._C._functorch.is_batchedtensor(buf):
        buf.copy_(torch.lerp(buf, end, weight))
    else:
        buf.lerp_(end, weight)


class _FlaxBatchStats:
    """The train-mode forward of flax's BatchNorm over every dimension but
    the channels (dim 1): the batch's biased variance both normalises and
    updates `running_var`, with torch's `momentum` (flax's 1 - momentum).
    Eval mode is torch's (the running statistics)."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        ctx = collectives.active()
        if ctx is not None:
            return global_batch_norm(self, x, ctx, [(0, x.shape[0] * ctx.n)])
        dims = (0,) + tuple(range(2, x.dim()))
        stats_dtype = torch.promote_types(x.dtype, torch.float32)
        with torch.no_grad():
            var, mean = torch.var_mean(x.to(stats_dtype), dim=dims,
                                       unbiased=False)
            _lerp_(self.running_mean, mean, self.momentum)
            _lerp_(self.running_var, var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def global_batch_norm(bn, x, ctx: collectives.RowShard, bounds):
    """The train-mode forward of `bn` over a data-parallel rank's rows x
    of a global batch cut into the chunks `bounds` ((lo, hi) global rows,
    in order; one chunk for a plain BatchNorm, the ghost chunks for
    TabNet's): each chunk is normalised with the biased moments of its
    rows on every rank, taken in float32 over two all-reduces of the
    chunks' stacked sums (the sums, then the squared deviations from the
    global means), through autograd, so the backward takes the global
    terms; the running buffers take each chunk's lerp in chunk order on
    every rank."""
    b = x.shape[0]
    _, off = ctx.global_rows(b)
    dims = (0,) + tuple(range(2, x.dim()))
    per_row = x[0].numel() // x.shape[1] if b else 1
    stats_dtype = torch.promote_types(x.dtype, torch.float32)
    xs = x.to(stats_dtype)
    segs = [(max(lo, off) - off, min(hi, off + b) - off) for lo, hi in bounds]
    zero = xs.new_zeros(x.shape[1])
    counts = torch.tensor([float((hi - lo) * per_row) for lo, hi in bounds],
                          dtype=stats_dtype, device=x.device)[:, None]
    sums = torch.stack([xs[lo:hi].sum(dim=dims) if hi > lo else zero
                        for lo, hi in segs])
    mean = collectives.all_reduce_sum(sums, ctx.group) / counts
    shape = (1, -1) + (1,) * (x.dim() - 2)
    sq = torch.stack([((xs[lo:hi] - mean[k].view(shape)) ** 2).sum(dim=dims)
                      if hi > lo else zero
                      for k, (lo, hi) in enumerate(segs)])
    var = collectives.all_reduce_sum(sq, ctx.group) / counts
    with torch.no_grad():
        for k in range(len(bounds)):
            _lerp_(bn.running_mean, mean[k].detach(), bn.momentum)
            _lerp_(bn.running_var, var[k].detach(), bn.momentum)
            bn.num_batches_tracked.add_(1)
    outs = []
    for k, (lo, hi) in enumerate(segs):
        if hi <= lo:
            continue
        y = (xs[lo:hi] - mean[k].view(shape)) * torch.rsqrt(
            var[k].view(shape) + bn.eps)
        if bn.weight is not None:
            y = y * bn.weight.view(shape) + bn.bias.view(shape)
        outs.append(y)
    y = outs[0] if len(outs) == 1 else torch.cat(outs, 0)
    return y.to(x.dtype)


class BatchNorm1d(_FlaxBatchStats, nn.BatchNorm1d):
    """`nn.BatchNorm1d` ((B, C) or (B, C, T)) with flax's train mode."""


class BatchNorm2d(_FlaxBatchStats, nn.BatchNorm2d):
    """`nn.BatchNorm2d` ((B, C, H, W)) with flax's train mode."""


class Dropout(nn.Module):
    """Inverted dropout like flax's: keep with probability 1 - p and scale
    by 1 / (1 - p). The mask comes from `generator` (torch's default
    generator when None), which must lie on the input's device, or, where
    `keep` is set, is `keep`: the CV fold program draws each fold's mask
    from that fold's generator (`draw_keep`, the draw `forward` makes) and
    hands the folds' masks in under vmap."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None
        self.keep: Optional[torch.Tensor] = None

    def keep_shape(self, x) -> tuple:
        """The shape of the keep mask for the input x."""
        return tuple(x.shape)

    def draw_keep(self, shape, dtype, device, generator):
        """A keep mask as `forward` draws it for a contiguous input of
        that shape, dtype and device."""
        return torch.empty(shape, dtype=dtype, device=device).bernoulli_(
            1.0 - self.p, generator=generator)

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = self.keep
        if keep is None:
            ctx = collectives.active()
            if ctx is None:
                keep = torch.empty_like(x).bernoulli_(
                    1.0 - self.p, generator=self.generator)
            else:
                # the global batch's mask, this rank's rows
                rows, off = ctx.global_rows(x.shape[0])
                keep = self.draw_keep((rows,) + tuple(x.shape[1:]), x.dtype,
                                      x.device, self.generator)
                keep = keep[off:off + x.shape[0]]
        return x * keep / (1.0 - self.p)


class BroadcastDropout(Dropout):
    """flax's attention dropout (`broadcast_dropout=True` in
    `MultiHeadDotProductAttention`): one keep mask over the last two
    dimensions, shared by every leading one (the batch and the heads),
    scaled by 1 / (1 - p), from `generator` like `Dropout`."""

    def keep_shape(self, x) -> tuple:
        return (1,) * (x.dim() - 2) + tuple(x.shape[-2:])

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = self.keep
        if keep is None:
            keep = self.draw_keep(self.keep_shape(x), x.dtype, x.device,
                                  self.generator)
        return x * (keep / (1.0 - self.p))


class MultiHeadSelfAttention(nn.Module):
    """flax's `MultiHeadDotProductAttention` over (B, T, D) as self
    attention, with the parameters of torch's `nn.MultiheadAttention`
    (`in_proj_weight` (3D, D) holding the q, k, v projections,
    `in_proj_bias`, `out_proj`): the query is divided by sqrt(head_dim)
    before the product, and the softmax's weights take flax's broadcast
    dropout. On a CUDA device in float32 with head size 32 and a length
    the softmax kernel takes, the attention between the projections goes
    through `ops/attention`: the same forward to the bit, its softmax,
    dropout and rows' log-sum-exp in one kernel, and a fused backward that
    writes no (B, H, T, T) tensor; elsewhere (the CPU, a functorch
    transform, a mask handed in, another dtype, head size or length, a
    traced program: `attention.unfused_reason`) the products are
    `torch.matmul`, as the JAX package computes them outside any Pallas
    kernel, and a call on a CUDA device counts in `attention.fallbacks`.
    Under a profiler the forward is the span `ecgmm.attention.forward`,
    and its backward, from the output's gradient to the input's,
    `ecgmm.attention.backward` (`train/profiler`)."""

    def __init__(self, d_model: int, nhead: int, dropout: float):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.dropout = BroadcastDropout(dropout)

    def forward(self, x):  # (B, T, D)
        with profiler.span("ecgmm.attention.forward") as traced:
            y = self._attend(x)
        if traced is not None:
            traced.backward("ecgmm.attention.backward", y, x)
        return y

    def _attend(self, x):
        if attention.unfused_reason(x, self) is None:
            return self._attend_fused(x)
        if x.is_cuda:
            _ext.count(attention.__name__, "fallbacks")
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

    def _attend_fused(self, x):
        """`_attend` through `ops/attention`: the same projections, the
        keep mask drawn as `self.dropout` draws it, the attention, the
        output projection."""
        t = x.shape[1]
        q, k, v = (F.linear(x, w, bias) for w, bias in
                   zip(self.in_proj_weight.chunk(3),
                       self.in_proj_bias.chunk(3)))
        drop, keep = self.dropout, None
        if drop.training and drop.p != 0.0:
            keep = drop.draw_keep((1, 1, t, t), x.dtype, x.device,
                                  drop.generator)
        return self.out_proj(attention.fused_self_attention(
            q, k, v, self.nhead, keep, drop.p))


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
