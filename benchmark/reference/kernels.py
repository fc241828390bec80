"""Plain versions of the port's three hand-written kernels, frozen here:
the squeeze-and-excitation gate, the attention fusion (softmax-weighted
concatenation and a row LayerNorm) and the masked focal loss. Each is the
unfused expression, in float32."""

from __future__ import annotations

import torch


def se_gate(x, w1, b1, w2, b2, arith):
    """x * sigmoid(relu(mean_T(x) w1^T + b1) w2^T + b2), x (B, C, T)."""
    y = x.mean(dim=-1)
    y = torch.relu(arith.linear(y, w1, b1))
    y = torch.sigmoid(arith.linear(y, w2, b2))
    return x * y[:, :, None]


def attention_fusion(img, sig, clin, weights, scale, bias, eps: float):
    """(out (B, D), softmax(weights)): the row LayerNorm (biased variance)
    of concat(sw0 img, sw1 sig, sw2 clin), times scale plus bias."""
    sw = torch.softmax(weights, dim=0)
    fused = torch.cat([sw[0] * img, sw[1] * sig, sw[2] * clin], dim=-1)
    mu = fused.mean(dim=-1, keepdim=True)
    var = fused.var(dim=-1, unbiased=False, keepdim=True)
    return (fused - mu) * torch.rsqrt(var + eps) * scale + bias, sw


def _denominator(mask):
    s = mask.sum()
    return torch.maximum(s, s.new_ones(()))


def focal_loss(logits, labels, mask, alpha: float, gamma: float):
    """sum(alpha (1 - pt)^gamma ce mask) / max(sum(mask), 1), with
    ce = logsumexp(logits) - logits[label] and pt = exp(-ce)."""
    logits = logits.float()
    ce = torch.logsumexp(logits, dim=-1) - logits.gather(
        -1, labels.long()[:, None])[:, 0]
    pt = torch.exp(-ce)
    return (alpha * (1.0 - pt) ** gamma * ce * mask).sum() / _denominator(mask)


def cross_entropy(logits, labels, mask):
    ce = torch.nn.functional.cross_entropy(logits.float(), labels.long(),
                                           reduction="none")
    return (ce * mask).sum() / _denominator(mask)
