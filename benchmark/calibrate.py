"""The readings that a train cell's limits are set from, on the card, at
the cell's own size (the benchmark's runs do not run this):

    python3 benchmark/calibrate.py --workload fusion-train-b256 \
        --seed 100 --program 12 --control 3 --faults 3 --look 3

One JSON line per reading on standard output, each with its kind, the
cell's compared numbers of both checks (`first.*`, `warm.*`) and, under
`worst`, the three leaves with the widest first-gradient gaps of each
check:
  * `program`: the program against the reference (the lower readings),
    one seed each;
  * `control`: the reference in the configuration's control arithmetic
    (`controls` in its file: the precision below the stated one) in the
    program's place;
  * `half_batch`: the program with half of each batch left out, the mean
    taken over the rest. A state left unchanged reads 1 on `update_gap`
    by the measure's definition and needs no run;
  * `bf16` (with `--look`): the reference with its products' operands
    rounded to bfloat16 in the program's place, beside the program's
    readings of the same seed: where a bfloat16 program's gaps come from.
Training needs no measured window: set-up drives the checked steps and
the reference follows them."""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import judge, spec  # noqa: E402
from benchmark.harness.execute import Ctx  # noqa: E402


def _free(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _worst(side: dict, ref: dict, n: int = 3) -> list:
    gaps = judge.leaf_gaps(side["grad"], ref["grad"])
    top = sorted(gaps, key=lambda k: -gaps[k])[:n]
    return [[k, gaps[k], side["grad"].get(k, 0.0), ref["grad"][k]]
            for k in top]


def _compare(job, config, prog, need: dict, mode: str = "") -> tuple:
    numbers, pairs = job.compare(config, prog, need, mode)
    return numbers, {c: _worst(*pairs[c]) for c in pairs}


def train_readings(job, ctx, kinds) -> list:
    """[(kind, numbers, worst leaves)] of one seed for a train cell."""
    from ecgmm_torch.train import engine

    out = []
    config, device = ctx.config, ctx.device
    low_kinds = [k for k in ("control", "bf16") if k in kinds]
    if "program" in kinds or low_kinds:
        state, step, losses, prog, need = job.setup(ctx)
        del state, step, losses
        _free(device)
        if "program" in kinds or "bf16" in kinds:
            out.append(("program", *_compare(job, config, prog, need)))
        for kind in low_kinds:
            mode = config["controls"]["train"] if kind == "control" else kind
            out.append((kind, *_compare(job, config, None, need, mode)))
        del need
        _free(device)
    if "half_batch" in kinds:
        gather = engine.gather_batch

        def half(arrays, idx, mask):
            k = idx.shape[0] // 2
            return gather(arrays, idx[:k], mask[:k])

        engine.gather_batch = half
        try:
            state, step, losses, prog, need = job.setup(ctx)
        finally:
            engine.gather_batch = gather
        del state, step, losses
        _free(device)
        out.append(("half_batch", *_compare(job, config, prog, need)))
        del need
        _free(device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True,
                   help="the first seed; each reading takes the next")
    p.add_argument("--program", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--look", type=int, default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    config = spec.load_config(cell["config"])
    job = spec.job(cell["job"])
    device = torch.device("cuda", 0)
    counts = (("program", args.program), ("control", args.control),
              ("half_batch", args.faults), ("bf16", args.look))
    for i in range(max(m for _, m in counts)):
        seed = args.seed + i
        kinds = [k for k, m in counts if i < m]
        with tempfile.TemporaryDirectory(prefix="bench-") as workdir:
            ctx = Ctx(cell, config, seed, 0.0, False, device,
                      time.perf_counter(), workdir)
            readings = train_readings(job, ctx, kinds)
        for kind, numbers, worst in readings:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, **numbers, "worst": worst}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
