"""Train-step times of two trees on one card, in turns: a parent commit
unpacked with `git archive` and this one.

    python3 ecgmm_torch/tools/step_times.py --root build/parent \
        [--cases ptbxl_af:16,fusion:16,fusion:256] [--steps 30] \
        [--rounds 1] [--out FILE]

A round runs parent, this, this, parent; each turn is a fresh process in
that tree that times each case with that tree's
`chip_smoke.measure_train_step` (full width, the synthetic cohort, TF32
off, CUDA events; the median and the wall time a step). Host time on the
card's machine moves by a third between calls and drifts within one, so
two trees are compared only inside one call, in turns. Prints one JSON
line a turn and case; `--out` also writes them, with the card's name and
power limit. Run it as a script, not with `-m`; it needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TURN = """
import json, sys
sys.path.insert(0, {tree!r})
import chip_smoke
for name, batch in {cases!r}:
    r = chip_smoke.measure_train_step(name, batch, n={steps})
    print("STEP " + json.dumps({{k: r[k] for k in (
        "preset", "batch", "median_ms", "wall_ms_per_step")}}))
"""


def turn(tree: str, cases, steps: int):
    out = subprocess.run(
        [sys.executable, "-c", TURN.format(tree=tree, cases=cases,
                                           steps=steps)],
        cwd=tree, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: {out.stdout[-2000:]}\n"
                           f"{out.stderr[-4000:]}")
    return [json.loads(line[5:]) for line in out.stdout.splitlines()
            if line.startswith("STEP ")]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True,
                   help="the other tree (e.g. a parent unpacked with git "
                        "archive)")
    p.add_argument("--cases", default="ptbxl_af:16,fusion:16,fusion:256")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cases = [(c.split(":")[0], int(c.split(":")[1]))
             for c in args.cases.split(",")]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    trees = {"parent": os.path.abspath(args.root), "change": HERE}
    rows = []
    for _ in range(args.rounds):
        for label in ("parent", "change", "change", "parent"):
            for r in turn(trees[label], cases, args.steps):
                r.update(tree=label, card=smi)
                print(json.dumps(r), flush=True)
                rows.append(r)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)


if __name__ == "__main__":
    main()
