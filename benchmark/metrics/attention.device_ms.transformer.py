"""Attention's milliseconds a train step in the Transformer cell: the
stream's time between the two CUDA events of every
`ecgmm.attention.forward` and `ecgmm.attention.backward` span
(`Event.elapsed_time`; the spans of `layers.MultiHeadSelfAttention`),
summed over the traced stretch, a step (`metrics/_spans.device_ms`). It
reads stream time, which is the device's time for attention's kernels
only where the stream does not wait for the host inside a span: so in
this cell, whose device is busy 98% of a step."""

from benchmark.metrics import _spans

UNIT = "ms/step"
MOVES = "train_samples_per_s.transformer"
SPANS = ("ecgmm.attention.forward", "ecgmm.attention.backward")


def read(run):
    return _spans.device_ms(run, SPANS)
