"""The port's rows-cap probe (`ecgmm_torch/tools/rows_cap_probe.py`)
against JAX's (`tests/test_rows_cap_probe.py`), the trial stubbed as
JAX's test stubs it: the bisection brackets every cliff to one step in
the same trials as JAX's; the parent runs each trial as a child process
with the cap turned off and survives a child that dies (here a stub that
exits as a CUDA out-of-memory error would); one real child trial runs on
the CPU at a tiny size."""

import subprocess
import sys

import pytest

from ecgmm_tpu.tools import rows_cap_probe as jax_probe
from ecgmm_torch.tools import rows_cap_probe


@pytest.mark.parametrize("cliff", [300, 512, 700, 1040, 5000])
def test_search_equals_jax(cliff):
    calls, jax_calls = [], []

    def trial(rows, _c=cliff, _log=calls):
        _log.append(rows)
        return rows <= _c

    out = rows_cap_probe.search(256, 2048, 16, trial)
    want = jax_probe.search(256, 2048, 16,
                            lambda r: trial(r, _log=jax_calls))
    assert out == want and calls == jax_calls
    if cliff < 2048:
        assert out["safe_rows"] <= cliff < out["first_failing_rows"]
        assert out["first_failing_rows"] - out["safe_rows"] == 16
        assert len(calls) <= 10
    else:
        assert out["first_failing_rows"] is None


def test_bisect_spawns_children_and_survives_their_death(monkeypatch):
    """Each trial is `python -m ecgmm_torch.tools.rows_cap_probe
    --trial-rows R` with ECGMM_FOLD_PARALLEL_ROWS_CAP=0; a child that
    dies (non-zero exit, no TRIAL_OK) counts as a failed trial and the
    parent goes on."""
    seen = []

    def fake_run(cmd, env, capture_output, text, timeout):
        seen.append((cmd, env["ECGMM_FOLD_PARALLEL_ROWS_CAP"]))
        rows = int(cmd[cmd.index("--trial-rows") + 1])
        if rows <= 600:
            return subprocess.CompletedProcess(cmd, 0, f"TRIAL_OK rows="
                                               f"{rows}\n", "")
        return subprocess.CompletedProcess(
            cmd, 1, "", "torch.OutOfMemoryError: CUDA out of memory")

    monkeypatch.setattr(rows_cap_probe.subprocess, "run", fake_run)
    out = rows_cap_probe.bisect(256, 2048, 16, "fusion", 60.0,
                                device="cpu")
    assert out["safe_rows"] <= 600 < out["first_failing_rows"]
    assert all(cap == "0" for _, cap in seen)
    cmd = seen[0][0]
    assert cmd[:3] == [sys.executable, "-m",
                       "ecgmm_torch.tools.rows_cap_probe"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    failed = [t for t in out["trials"] if not t["ok"]]
    assert failed and "out of memory" in failed[0]["tail"]


def test_trial_runs_one_wave_on_the_cpu(capsys):
    """`tests/test_rows_cap_probe.py::test_probe_trial_runs_one_wave` on
    the port (signal-only config): two identical folds in one uncapped
    wave."""
    rows_cap_probe.run_trial(rows=16, batch_size=8, preset="signal_only",
                             epochs=1, device="cpu")
    assert "TRIAL_OK rows=16 folds=2" in capsys.readouterr().out
