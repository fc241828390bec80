"""Seconds of one bundle program's export (`serve/export.trace_program`,
the demo pipeline at the serving width) with torch.fx's stack-trace
capture off, as the export runs it, and on, alternated in one process,
as one JSON object.

    python -m ecgmm_torch.tools.export_times [--device cuda] [--b 1]
        [--pairs 2]

Each pair traces and exports twice, the capture off and then on
(`trace_s_*`, `export_s_*`); the capture changes only the export. The
first pair carries the process's warm-up.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from unittest import mock


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--b", type=int, default=1)
    p.add_argument("--pairs", type=int, default=2)
    args = p.parse_args(argv)

    from ecgmm_torch.serve import export
    from ecgmm_torch.serve.pipeline import ServingPipeline

    pipe = ServingPipeline.demo(device=args.device)
    rows = []
    for _ in range(args.pairs):
        row = {}
        for capture in ("off", "on"):
            # "on": the export as torch makes it, without `_no_stack_traces`
            keep = (export._no_stack_traces if capture == "off"
                    else contextlib.nullcontext)
            with mock.patch.object(export, "_no_stack_traces", keep):
                _, trace_s, export_s = export.trace_program(pipe, args.b)
            row[f"trace_s_capture_{capture}"] = trace_s
            row[f"export_s_capture_{capture}"] = export_s
        rows.append(row)
    print(json.dumps({"device": args.device, "b": args.b, "pairs": rows}))


if __name__ == "__main__":
    main()
