"""Concurrent-rows cliff probe for fold-parallel CV (port of
`ecgmm_tpu/tools/rows_cap_probe.py`).

The fold-parallel harness caps raw-modality waves at `_act_rows_cap`
rows (`train/cv_parallel.py`: the device budget over the bytes a row
took on the card) because backward-pass activations scale with the
wave's effective batch. This probe measures the actual cliff for a
given model config on the card by bisection: each trial runs ONE
uncapped fold-parallel wave of `rows` concurrent sample rows in a
SUBPROCESS, with `ECGMM_FOLD_PARALLEL_ROWS_CAP=0` (a CUDA out-of-memory
error kills the trial, and the parent must survive it), and the search
brackets the largest safe row count against the first failing one.

Opt-in: the top of the range is meant to fail. Run it when nothing else
needs the card.

    # bisect the cliff for the raw-image fusion config
    python -m ecgmm_torch.tools.rows_cap_probe --lo 256 --hi 2048

    # single trial (the subprocess entry the parent spawns)
    python -m ecgmm_torch.tools.rows_cap_probe --trial-rows 512
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def run_trial(rows: int, batch_size: int, preset: str,
              epochs: int = 1, device: str = "cuda") -> None:
    """One uncapped fold-parallel wave with `rows` concurrent sample
    rows: F = rows/batch_size identical folds over a small synthetic
    cohort, every fold in ONE wave. Exits normally on success; a CUDA
    out-of-memory error propagates."""
    import dataclasses

    import numpy as np

    from ecgmm_torch.config import get_preset
    from ecgmm_torch.data import synthetic
    from ecgmm_torch.train import cv_parallel
    from ecgmm_torch.workloads.run import _device, build_model_and_task

    device = _device(device)

    n_folds = max(1, rows // batch_size)
    cfg = get_preset(preset)
    cfg = dataclasses.replace(
        cfg,
        train=dataclasses.replace(
            cfg.train, batch_size=batch_size, num_epochs=epochs,
            patience=epochs + 1, schedule="constant",
        ),
    )
    n = 64
    cohort = synthetic.make_cohort(
        n=n, signal_len=cfg.data.signal_len,
        img_hw=(cfg.data.img_height, cfg.data.img_width), seed=0,
    )

    class Split:
        def __init__(self, tr, va, te):
            self.train, self.val, self.test = tr, va, te

    rng = np.random.default_rng(0)
    perm = rng.permutation(n)
    split = Split(perm[: n - 16], perm[n - 16: n - 8], perm[n - 8:])
    folds = [split] * n_folds

    task, state0, pack = cv_parallel.prepare_folds(
        build_model_and_task, cohort, folds, cfg, device=device)
    res = cv_parallel.run_fold_parallel(task, state0, pack, cfg.train,
                                        verbose=True)
    print(f"TRIAL_OK rows={rows} folds={n_folds} "
          f"auc0={float(res.aucs[0]):.3f}")


def bisect(lo: int, hi: int, batch_size: int, preset: str,
           timeout_s: float, device: str = "cuda") -> dict:
    """Largest safe rows in [lo, hi]: lo is assumed safe (the shipped
    cap), hi is probed first — if hi survives, the cliff is beyond the
    range. Each trial is a fresh subprocess, rounded to batch
    multiples."""
    results = []

    def trial(rows: int) -> bool:
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "ecgmm_torch.tools.rows_cap_probe",
             "--trial-rows", str(rows), "--batch-size", str(batch_size),
             "--preset", preset, "--device", device],
            env={**os.environ, "ECGMM_FOLD_PARALLEL_ROWS_CAP": "0"},
            capture_output=True, text=True, timeout=timeout_s,
        )
        ok = proc.returncode == 0 and "TRIAL_OK" in proc.stdout
        results.append({
            "rows": rows, "ok": ok, "rc": proc.returncode,
            "wall_s": round(time.time() - t0, 1),
            "tail": (proc.stdout + proc.stderr)[-300:].strip()
            if not ok else "",
        })
        print(f"[probe] rows={rows}: {'OK' if ok else 'FAILED'} "
              f"({results[-1]['wall_s']}s)", flush=True)
        return ok

    out = search(lo, hi, batch_size, trial)
    out["trials"] = results
    return out


def search(lo: int, hi: int, step: int, trial) -> dict:
    """The bisection itself, over any boolean trial(rows) — separated
    from the subprocess plumbing so the logic is unit-testable."""
    lo = max(step, (lo // step) * step)
    hi = max(lo + step, (hi // step) * step)
    if trial(hi):
        return {"safe_rows": hi, "first_failing_rows": None,
                "note": f"no cliff found up to {hi} rows"}
    while hi - lo > step:
        mid = ((lo + hi) // 2 // step) * step
        if mid in (lo, hi):
            break
        if trial(mid):
            lo = mid
        else:
            hi = mid
    return {"safe_rows": lo, "first_failing_rows": hi}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trial-rows", type=int, default=None,
                   help="child mode: run one uncapped wave of this many "
                        "rows and exit")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--preset", default="fusion")
    p.add_argument("--lo", type=int, default=256,
                   help="bisect: assumed-safe lower bound (shipped cap)")
    p.add_argument("--hi", type=int, default=2048,
                   help="bisect: upper bound to probe")
    p.add_argument("--timeout", type=float, default=1800.0,
                   help="per-trial subprocess timeout, seconds")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    if args.trial_rows is not None:
        run_trial(args.trial_rows, args.batch_size, args.preset,
                  device=args.device)
        return

    out = bisect(args.lo, args.hi, args.batch_size, args.preset,
                 args.timeout, device=args.device)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
