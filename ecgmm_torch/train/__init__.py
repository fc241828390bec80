"""Training: losses, optimizer, train state, checkpoints, the epoch engine,
metrics and the test report (port of `ecgmm_tpu/train`)."""
