"""Device operations per train step in the Transformer cell
(`harness/layer.device_ops`)."""

from benchmark.harness import layer

UNIT = "ops/step"
MOVES = "train_samples_per_s.transformer"
read = layer.device_ops
