"""The Transformer cell's train step's share of the chip's peak
(`harness/layer.mfu`)."""

from benchmark.harness import layer

UNIT = "%"
MOVES = "train_samples_per_s.transformer"
read = layer.mfu
