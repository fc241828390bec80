"""The SE gate's forward kernel (`se_fwd`, the port's `fused_se`) in the
train step: the least time its three calls a step could take (x read
once, the gate's weights read once, the output written once, at the
step's batch and the configuration's compute dtype, over the HBM
bandwidth) over their traced device time, in percent."""

from benchmark.harness import work

UNIT = "%"
MOVES = "train_samples_per_s.fusion"


def read(run):
    if run.job != "train" or run.trace is None:
        return None
    traced_us = sum(e.dur for e in run.trace.events
                    if e.category == "port se_fwd")
    if not traced_us:
        return None
    m, b = run.config["model"], run.cell["batch"]
    esize = work.ESIZE[m["dtype"]]
    least = sum(work.least_seconds(work.se_forward_bytes(b, c, t, esize))
                for c, t in work.se_shapes(run.config["inputs"]["signal_len"],
                                           m["signal_base_filters"]))
    return 100.0 * least / (traced_us / 1e6 / run.trace.units)
