"""Device and host times of the port's focal loss and attention-fusion head
through their public entry points (`fused_focal_loss`,
`fused_attention_fusion`, autograd), at the shapes of the serving and
training paths, as one JSON object.

    python3 ecgmm_torch/tools/kernel_times.py [--root DIR] [--out FILE]

`--root` names the repository whose `ecgmm_torch` is timed (default: the
one this file lies in), so that two trees, such as a commit and its parent
unpacked with `git archive`, are timed on one card in turns by the same
code. Run it as a script, not with `-m`, so that the package comes
from `--root`. It needs a CUDA device.

Per focal shape (B, C): the forward (`fwd_us`), the backward alone
through a retained graph, logits only as in a train step (`bwd_us`), and
both (`fwd_bwd_us`). Per fusion shape: the forward without autograd
(`fwd_us`) and, for the serving request's SHAP and IG cases and for all
six inputs as a fusion head in training needs them, the backward alone
and both. `device_us` and `host_us` are chip_smoke.py's timers.

`attention` (where the tree has `ops/attention`): the self-attention
kernels at the `physionet_transformer` step's shape (B, H, T, head) =
(8, 4, 3000, 32), p = 0.1: the forward, cuBLAS's two products around
the softmax, dropout and log-sum-exp kernel (`exact_fwd_us`; that kernel
alone `softmax_drop_us`),
the backward's two kernels alone (`bwd_us`), the mask's packing (`pack_us`),
the plain version forward and forward plus autograd's backward
(`plain_fwd_us`, `plain_fwd_bwd_us`), and the FFMA bounds at 67
TFLOP/s: two (T, T) x (T, 32) products forward, four backward
(`bound_fwd_us`, `bound_bwd_us`).

`entry` (with `--entry-only`, alone): the host's µs per call of the eager
entry points as the main paths call them, `fused_se` forward at the
serving shape (1, 64, 619) and forward plus backward at the training one
(16, 64, 619), and `fused_attention_fusion` forward at B = 1 and forward
plus the IG backward at B = 8 (D = 672): the launch glue a change to the
wrappers could move.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

FOCAL_SHAPES = [(16, 2), (8, 3), (13, 4), (65536, 2)]
FUSION_DIMS = {672: (512, 128, 32), 768: (256, 256, 256)}
FUSION_FWD = [(b, d) for b in (1, 8, 16, 32, 256) for d in FUSION_DIMS]
ALL = (True,) * 6
# (B, D, case, inputs that need a gradient)
FUSION_BWD = [
    (32, 672, "shap", (True, True, True, False, False, False)),
    (8, 672, "ig", (False, False, True, False, False, False)),
    (8, 672, "all", ALL), (16, 672, "all", ALL), (32, 672, "all", ALL),
    (256, 672, "all", ALL), (16, 768, "all", ALL), (256, 768, "all", ALL),
]
EPS = 1e-5


def device_us(fn, n: int = 20, rounds: int = 3) -> float:
    """Device time of one call of fn, in µs: the least over `rounds`
    rounds of the median of n calls, each call between CUDA events. The
    launches are queued behind a sleeping kernel so that the host's launch
    overhead does not land between the timing events. The sleep lasts
    three times as long as an untimed round of the n calls took, at least
    2e7 cycles (~10 ms), and
    n is small enough that n calls of a plain version (up to ~40 launches
    each) fit in the card's launch queue; a longer queue blocks the host
    until the sleep ends, and the rest would be timed at the host's pace.
    A host stalled past the sleep (the card's machine is shared) times a
    round at its own pace too: the least of the rounds' medians drops
    it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    medians = []
    for _ in range(rounds):
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        # cycles at up to 2 GHz
        torch.cuda._sleep(int(max(2e7, 3 * round_s * 2e9)))
        for i in range(n):
            starts[i].record()
            fn()
            ends[i].record()
        torch.cuda.synchronize()
        medians.append(statistics.median(s.elapsed_time(e) * 1e3
                                         for s, e in zip(starts, ends)))
    return min(medians)


def host_us(fn, n: int = 200) -> float:
    """Host time of one call of fn, in µs: the mean wall time of n calls
    as the host enqueues them, the queue drained before and after. It
    reads the host's cost only where a call's device work takes less
    time than its launches (the small batches of the main paths); with
    more, the host waits on a full launch queue."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / n * 1e6


def focal_times(losses, gen):
    rows = []
    for b, c in FOCAL_SHAPES:
        logits = (torch.randn(b, c, generator=gen) * 2).cuda()
        labels = torch.randint(0, c, (b,), generator=gen).cuda()
        mask = (torch.rand(b, generator=gen) < 0.7).float().cuda()
        one = torch.ones((), device="cuda")
        lg = logits.clone().requires_grad_(True)
        out = losses.fused_focal_loss(lg, labels, mask)

        def fwd_bwd():
            return torch.autograd.grad(
                losses.fused_focal_loss(lg, labels, mask), lg, one)

        row = {
            "B": b, "C": c,
            "fwd_us": device_us(
                lambda: losses.fused_focal_loss(logits, labels, mask)),
            "bwd_us": device_us(lambda: torch.autograd.grad(
                out, lg, one, retain_graph=True)),
            "fwd_bwd_us": device_us(fwd_bwd),
        }
        if b <= 16:  # the training batches: the host's cost per call
            row["fwd_bwd_host_us"] = host_us(fwd_bwd)
        rows.append(row)
    return rows


def _fusion_inputs(gen, b, dims):
    d = sum(dims)
    ins = [torch.randn(b, w, generator=gen) for w in dims] + [
        torch.randn(3, generator=gen), torch.randn(d, generator=gen) + 1,
        torch.randn(d, generator=gen)]
    return [t.cuda() for t in ins]


def fusion_times(fusion, gen):
    fwd = []
    for b, d in FUSION_FWD:
        ins = _fusion_inputs(gen, b, FUSION_DIMS[d])
        fwd.append({"B": b, "D": d, "fwd_us": device_us(
            lambda: fusion.fused_attention_fusion(*ins, eps=EPS))})
    bwd = []
    for b, d, case, needs in FUSION_BWD:
        ins = _fusion_inputs(gen, b, FUSION_DIMS[d])
        go = torch.randn(b, d, generator=gen).cuda()
        gsw = torch.randn(3, generator=gen).cuda() if needs[3] else None
        leaves = [a.clone().requires_grad_(n) for a, n in zip(ins, needs)]
        wrt = [a for a in leaves if a.requires_grad]

        def grads(out, sw, retain):
            outs, cots = [out], [go]
            if gsw is not None:
                outs.append(sw)
                cots.append(gsw)
            return torch.autograd.grad(outs, wrt, cots, retain_graph=retain)

        out, sw = fusion.fused_attention_fusion(*leaves, eps=EPS)
        bwd.append({
            "B": b, "D": d, "case": case,
            "bwd_us": device_us(lambda: grads(out, sw, True)),
            "fwd_bwd_us": device_us(lambda: grads(
                *fusion.fused_attention_fusion(*leaves, eps=EPS), False)),
        })
    return fwd, bwd


ATTENTION_SHAPE = (8, 4, 3000, 32)
F32_PEAK = 67e12  # FLOP/s of an H100 SXM's CUDA cores in float32


def attention_times(attention, gen):
    b, h, t, hd = ATTENTION_SHAPE
    p = 0.1
    q, k, v = (torch.randn(b, t, h * hd, generator=gen).cuda()
               for _ in range(3))
    keep = torch.empty((1, 1, t, t)).bernoulli_(1 - p, generator=gen).cuda()
    dout = torch.randn(b, t, h * hd, generator=gen).cuda()
    bits = attention.pack_keep(keep)
    c = attention.drop_scale(p)
    out, lse = attention.exact_forward(q, k, v, h, bits, c)
    scores = torch.randn(b, h, t, t, generator=gen).cuda()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]

    def plain_fwd_bwd():
        y = attention.reference_self_attention(*leaves, h, keep, p)
        return torch.autograd.grad(y, leaves, dout)

    product = 2.0 * b * h * t * t * hd  # FLOPs of one (T, T) x (T, hd)
    return {
        "shape": ATTENTION_SHAPE, "p": p,
        "exact_fwd_us": device_us(lambda: attention.exact_forward(
            q, k, v, h, bits, c), n=5),
        "softmax_drop_us": device_us(lambda: attention._launch_softmax_drop(
            scores, bits, c), n=5),
        "bwd_us": device_us(lambda: attention._launch_backward(
            q, k, v, h, bits, c, out, lse, dout), n=5),
        "pack_us": device_us(lambda: attention.pack_keep(keep), n=5),
        "plain_fwd_us": device_us(lambda: attention.reference_self_attention(
            q, k, v, h, keep, p), n=5),
        "plain_fwd_bwd_us": device_us(plain_fwd_bwd, n=5),
        "bound_fwd_us": 2 * product / F32_PEAK * 1e6,
        "bound_bwd_us": 4 * product / F32_PEAK * 1e6,
    }


def entry_times(se, fusion, gen):
    """Host µs per call of the eager entry points (see the docstring)."""
    def se_inputs(b):
        c, t = 64, 619
        x = torch.randn(b, c, t, generator=gen).cuda()
        ws = [torch.randn(*shape, generator=gen).cuda() * 0.1
              for shape in ((4, c), (4,), (c, 4), (c,))]
        return x, ws

    x1, w1 = se_inputs(1)
    x16, w16 = se_inputs(16)
    leaf = x16.clone().requires_grad_(True)
    ws16 = [w.clone().requires_grad_(True) for w in w16]
    g16 = torch.randn_like(x16)
    f1 = _fusion_inputs(gen, 1, FUSION_DIMS[672])
    f8 = _fusion_inputs(gen, 8, FUSION_DIMS[672])
    clin = f8[2].clone().requires_grad_(True)
    go = torch.randn(8, 672, generator=gen).cuda()

    def se_train():
        out = se.fused_se(leaf, *ws16)
        return torch.autograd.grad(out, [leaf, *ws16], g16)

    def fusion_ig():
        out, _ = fusion.fused_attention_fusion(f8[0], f8[1], clin, *f8[3:],
                                               eps=EPS)
        return torch.autograd.grad(out, clin, go)

    with torch.no_grad():
        rows = {"fused_se_fwd_b1": host_us(lambda: se.fused_se(x1, *w1)),
                "fusion_fwd_b1": host_us(
                    lambda: fusion.fused_attention_fusion(*f1, eps=EPS))}
    rows["fused_se_fwd_bwd_b16"] = host_us(se_train)
    rows["fusion_fwd_ig_bwd_b8"] = host_us(fusion_ig)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--out", default=None)
    ap.add_argument("--entry-only", action="store_true",
                    help="time only the entry points' host cost per call")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from ecgmm_torch.ops import _ext, fusion, losses, se

    if not os.path.abspath(_ext.__file__).startswith(root + os.sep):
        raise RuntimeError(f"ecgmm_torch came from {_ext.__file__}, not "
                           f"{root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    _ext.library()
    gen = torch.Generator().manual_seed(0)
    result = {"root": root, "device": smi,
              "entry_host_us": entry_times(se, fusion, gen)}
    if not args.entry_only:
        result["floor_us"] = device_us(lambda: torch.cuda._sleep(1))
        result["focal"] = focal_times(losses, gen)
        result["fusion_fwd"], result["fusion_bwd"] = fusion_times(fusion,
                                                                  gen)
        if os.path.exists(os.path.join(root, "ecgmm_torch", "ops",
                                       "attention.py")):
            from ecgmm_torch.ops import attention

            result["attention"] = attention_times(attention, gen)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
