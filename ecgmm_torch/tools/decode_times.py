"""Host times of the upload decoder (`serve.imdecode.decode_upload`) on the
committed JPEG fixtures, for this tree and optionally another, in turns.

    python3 ecgmm_torch/tools/decode_times.py [--parent DIR] [--out FILE]

Each tree is timed in a fresh interpreter that imports `ecgmm_torch` from
that tree (and builds its host library there), on the same input files
(every `.jpg` in this tree's `ecgmm_torch/serve/fixtures/`): the median
of 40 decodes of each file, host clock, in ms; null where that tree
refuses the file (`BadRequest`). With `--parent` (a commit unpacked with
`git archive` into an ignored directory such as `build/parent/`), the
order is parent, this tree, this tree, parent, so that drift on the
machine shows as a difference between the two readings of one tree.
Each line names the machine the way chip_smoke.py does (the card's name
and power limit from `nvidia-smi`, else "cpu"). Run it as a script.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
FIXTURES = os.path.join(ROOT, "ecgmm_torch", "serve", "fixtures")
N = 40

_CHILD = r"""
import json, statistics, sys, time
root, n, paths = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
sys.path.insert(0, root)
from ecgmm_torch import native
from ecgmm_torch.serve.imdecode import decode_upload
from ecgmm_torch.serve.wire import BadRequest
native.library()
out = {}
for path in paths:
    with open(path, "rb") as f:
        data = f.read()
    name = path.rsplit("/", 1)[-1]
    try:
        decode_upload(data)
    except BadRequest:
        out[name] = None
        continue
    times = []
    for _ in range(n):
        t = time.perf_counter()
        decode_upload(data)
        times.append((time.perf_counter() - t) * 1e3)
    out[name] = statistics.median(times)
print(json.dumps(out))
"""


def machine() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else "cpu"
    except (FileNotFoundError, IndexError):
        return "cpu"


def time_tree(root: str) -> dict:
    paths = sorted(glob.glob(os.path.join(FIXTURES, "*.jpg")))
    out = subprocess.run([sys.executable, "-c", _CHILD, os.path.abspath(root),
                          str(N), *paths], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another tree, timed in turns")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    order = [ROOT] if not args.parent else \
        [args.parent, ROOT, ROOT, args.parent]
    where = machine()
    rows = []
    for root in order:
        row = {"tree": "parent" if root == args.parent else "this",
               "ms": time_tree(root), "machine": where}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
