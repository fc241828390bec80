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
    overhead does not land between the timing events. The sleep lasts at
    least three times as long as an untimed round of the n calls took, and
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
        torch.cuda._sleep(int(max(1e8, 3 * round_s * 2e9)))
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from ecgmm_torch.ops import _ext, fusion, losses

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
              "floor_us": device_us(lambda: torch.cuda._sleep(1)),
              "focal": focal_times(losses, gen)}
    result["fusion_fwd"], result["fusion_bwd"] = fusion_times(fusion, gen)
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
