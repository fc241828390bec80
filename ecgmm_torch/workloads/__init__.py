"""Workloads: task builders and the trainer CLI (port of
`ecgmm_tpu/workloads`, the signal-only ResNet1D-SE families)."""

from ecgmm_torch.workloads.tasks import make_signal_task  # noqa: F401
