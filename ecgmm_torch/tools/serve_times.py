"""Served-request times of this tree or another on one card: `chip_smoke.py`
phase 4 (eight full-width requests through `ServingPipeline.predict`,
each split into host time before the device, the device program and host
time after), the medians phase 5 prints, and phase 8 (the HTTP front end:
requests/s and latency at 1, 4 and 16 clients, batched and unbatched,
printed by it as a `front_end` JSON line).

    python3 ecgmm_torch/tools/serve_times.py [--root DIR] [--out FILE]

`--root` names the repository whose `chip_smoke.py` and `ecgmm_torch` run
(default: the one this file lies in), so that two trees, such as a commit
and its parent unpacked with `git archive`, are timed on one card in
turns (parent, change, change, parent) by their own code. Run it as a
script, not with `-m`, so that the package comes from `--root`. It needs
a CUDA device. The phase-5 medians go to `--out` as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    import ecgmm_torch

    for mod in (chip_smoke, ecgmm_torch):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, "
                               f"not {root}")
    smi = chip_smoke.smi_line()
    _, timings = chip_smoke.run_slice()
    request = {key: statistics.median(t[key] for t in timings)
               for key in ("total_ms", "host_before_ms", "device_ms",
                           "host_after_ms")}
    line = json.dumps({"root": root, "device": smi, "request": request})
    print(line, flush=True)
    chip_smoke.run_front_end(smi)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
