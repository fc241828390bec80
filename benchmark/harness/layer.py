"""The readings of per-layer metrics that more than one cell reports, each
under a name of its own in each (`metrics/<name>.py` binds one of these
to its unit and to the end-to-end metric it moves). A reading that finds
nothing to read is None."""

from __future__ import annotations

from benchmark.harness import work


def idle_share(run):
    """The share of the traced stretch of train steps in which no kernel,
    copy or set ran on the device: 1 - (the union of their intervals) /
    (the stretch), in percent."""
    if run.job != "train" or run.trace is None or not run.trace.events:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu(run):
    """The train step's share of the chip's peak in the configuration's
    compute dtype: the benchmark's model FLOPs of a step
    (`harness/work.py`, from the configuration's shapes) times the steps
    of the unprofiled window over its wall time and the peak, in
    percent."""
    if run.job != "train" or run.window.units == 0:
        return None
    rate = run.flops_per_unit * run.window.units / run.window.wall_s
    return 100.0 * rate / work.PEAKS[run.peak]


def device_ops(run):
    """Device operations (kernels, copies, sets) per train step in the
    traced stretch: what the host has to launch for one step."""
    if run.job != "train" or run.trace is None or not run.trace.events:
        return None
    return len(run.trace.events) / run.trace.units
