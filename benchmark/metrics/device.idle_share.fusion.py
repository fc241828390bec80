"""The device's idle share in the fusion cell's traced train steps
(`harness/layer.idle_share`)."""

from benchmark.harness import layer

UNIT = "%"
MOVES = "train_samples_per_s.fusion"
read = layer.idle_share
