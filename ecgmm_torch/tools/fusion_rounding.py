"""Read the fusion head's float32 gradients against float64: the kernels'
and plain autograd's, over many draws.

    python -m ecgmm_torch.tools.fusion_rounding [--seeds 12] [--out PATH]

For each seed and each row count of ROWS (D = 672 = 512 + 128 + 32, the
serving head), the inputs are drawn as chip_smoke.py phase 3 draws them
and the gradients of sum(out**2) w.r.t. the six inputs of
`fused_attention_fusion` are taken three ways: through the kernels on the
card, through plain autograd in float32 on the card, and through plain
autograd in float64 on the CPU. The `weights` gradient is
sw * (dsw - sw . dsw), where each dsw_k sums the B * D_k terms df * x of
chunk k (df the gradient w.r.t. the LayerNorm's input); those sums cancel,
so the gradient can be small while its float32 rounding is not. Its
errors are read over S = max_k sw_k * sum |df * x| (`float64_grads`),
the size of what the sums cancel; chip_smoke.py phase 3 holds the kernel
to float64 in that unit. One JSON line per draw, and a summary line: per
gradient and way, the largest max-abs error against float64 (for
`weights` also over S).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from ecgmm_torch.ops import fusion

GRADS = ("img", "sig", "clin", "weights", "scale", "bias")
DIMS = (512, 128, 32)
ROWS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
EPS = 1e-5


def float64_grads(ins, eps: float):
    """(the six gradients of sum(out**2) in float64, plain autograd on the
    CPU; S = max_k sw_k * sum over the rows and chunk k of |df * x|)."""
    leaves = [t.detach().cpu().double().requires_grad_(True) for t in ins]
    ref, _ = fusion.reference_attention_fusion(*leaves, eps=eps)
    g64 = torch.autograd.grad((ref ** 2).sum(), leaves)
    with torch.no_grad():
        x = [t.detach().cpu().double() for t in ins]
        sw = torch.softmax(x[3], 0)
        fused = torch.cat([sw[k] * x[k] for k in range(3)], -1)
    fused.requires_grad_(True)
    out = F.layer_norm(fused, fused.shape[-1:], x[4], x[5], eps)
    (df,) = torch.autograd.grad((out ** 2).sum(), fused)
    terms = (df * torch.cat(x[:3], -1)).abs()
    ends = np.cumsum([0] + [t.shape[1] for t in x[:3]])
    s = max(sw[k].item() * terms[:, ends[k]:ends[k + 1]].sum().item()
            for k in range(3))
    return g64, s


def draw(gen, b: int, dims=DIMS):
    """Phase 3's inputs: (img, sig, clin, weights, scale, bias)."""
    d = sum(dims)
    return [torch.randn(b, w, generator=gen) for w in dims] + [
        torch.randn(3, generator=gen), torch.randn(d, generator=gen) + 1,
        torch.randn(d, generator=gen)]


def read(ins, device: str):
    """One draw: per gradient, the max-abs errors against float64 of the
    kernels and of plain float32 autograd, and S."""
    on = [t.to(device) for t in ins]
    ways = {}
    for way, fn in (("kernel", fusion.fused_attention_fusion),
                    ("plain", fusion.reference_attention_fusion)):
        leaves = [t.clone().requires_grad_(True) for t in on]
        out, _ = fn(*leaves, eps=EPS)
        ways[way] = torch.autograd.grad((out ** 2).sum(), leaves)
    g64, s = float64_grads(ins, EPS)
    row = {"S": s}
    for i, name in enumerate(GRADS):
        row[name] = {way: (g[i].cpu().double() - g64[i]).abs().max().item()
                     for way, g in ways.items()}
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="also write the lines here")
    args = p.parse_args(argv)
    lines, worst = [], {}
    for seed in range(args.seeds):
        gen = torch.Generator().manual_seed(seed)
        for b in ROWS:
            row = {"seed": seed, "B": b, **read(draw(gen, b), args.device)}
            lines.append(json.dumps(row))
            print(lines[-1], flush=True)
            for name in GRADS:
                for way, err in row[name].items():
                    key = f"{name}_{way}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    if name == "weights":
                        key += "_over_S"
                        worst[key] = max(worst.get(key, 0.0), err / row["S"])
    summary = json.dumps({"draws": len(lines), "worst": worst})
    print(summary, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines + [summary]) + "\n")


if __name__ == "__main__":
    main()
