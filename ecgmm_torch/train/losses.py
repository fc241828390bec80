"""Loss functions (port of `ecgmm_tpu/train/losses.py`), all aware of the
mask: the last batch of an epoch is padded, and pad rows carry mask 0.

  * cross_entropy: torch's F.cross_entropy per row, masked mean
    (reference train.py:69-78);
  * focal_loss: alpha (1 - p_t)^gamma CE with p_t = exp(-CE), masked mean
    (reference signal_model.py:91-106), through the fused op
    `ecgmm_torch.ops.losses.fused_focal_loss` (the CUDA kernel for CUDA
    tensors);
  * fusion_loss: CE(fusion) + 0.1 var_loss (reference train.py:78).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ecgmm_torch.ops.losses import fused_focal_loss


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]):
    """sum(x * mask) / max(sum(mask), 1); torch.maximum's VJP splits a tie
    at sum(mask) == 1 as jnp.maximum's does."""
    if mask is None:
        return x.mean()
    s = mask.sum()
    return (x * mask).sum() / torch.maximum(s, s.new_ones(()))


def cross_entropy(logits, labels, mask=None):
    ce = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    return _masked_mean(ce, mask)


def focal_loss(logits, labels, mask=None, alpha: float = 1.0,
               gamma: float = 2.0):
    if mask is None:
        mask = torch.ones(logits.shape[0], dtype=torch.float32,
                          device=logits.device)
    return fused_focal_loss(logits.float().contiguous(), labels.contiguous(),
                            mask.float().contiguous(), alpha, gamma)


def fusion_loss(fusion_logits, labels, var_loss, mask=None,
                var_weight: float = 0.1):
    return cross_entropy(fusion_logits, labels, mask) + var_weight * var_loss


def make_loss_fn(name: str, alpha: float = 1.0, gamma: float = 2.0):
    if name == "cross_entropy":
        return cross_entropy
    if name == "focal":
        def f(logits, labels, mask=None):
            return focal_loss(logits, labels, mask, alpha=alpha, gamma=gamma)
        return f
    raise ValueError(f"unknown loss {name!r}")
