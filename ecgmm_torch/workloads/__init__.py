"""Workloads: task builders, the trainer CLI and the staged pretraining
pipeline (port of `ecgmm_tpu/workloads`)."""

from ecgmm_torch.workloads.tasks import make_signal_task  # noqa: F401
