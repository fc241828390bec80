"""Run one cell of the benchmark of `ecgmm_torch` once, on the card:

    python3 benchmark/run.py --workload fusion-train-b256 --seed 7 \
        --seconds 20 --trace 0

It makes the cell's weights and inputs from `--seed`, sets up and warms
up the cell's path (`setup_s`), measures for `--seconds`, with
`--trace 1` traces a stretch after the window, checks the outputs of the
timed path against the plain reference (`benchmark/reference/`), and
prints one JSON line last: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, with `--trace 1` `breakdown`, and last `checks` (each compared
number beside its limit, also the last lines on standard error).

It exits non-zero and prints no result where there is no CUDA card, or
fewer than the cell asks for, where the cell is unknown, where the
program is missing, and where JAX, flax, optax or the JAX package is
loaded in the process once the window has closed."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# a fixed cache directory inside the checkout for any kernel JIT cache
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, ".bench_cache", "triton"))
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ecgmm_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, flax's, optax's or
    the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness import judge, spec

    try:
        cell = spec.load_cell(args.workload)
    except spec.SpecError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    try:
        import ecgmm_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is missing: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark.harness.execute import execute

    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in the process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    judge.print_checks(result["checks"])
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
