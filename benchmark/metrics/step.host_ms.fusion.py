"""The host's milliseconds of a train step in the fusion cell: the median
over the traced stretch's steps of the `ecgmm.train_step` span's host
interval, between the wall stamps of its enter and its exit in the span
log (`metrics/_spans.stretch`). The host's time to launch a step, the
launches of the frozen encoders' forward above all."""

from benchmark.metrics import _spans

UNIT = "ms/step"
MOVES = "train_samples_per_s.fusion"
read = _spans.step_host_ms
