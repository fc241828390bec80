"""Task builders (port of `ecgmm_tpu/workloads/tasks.py`): bind a loss to
the engine's Task contract. The model is not bound here: it lives in the
TrainState and the engine passes it to `apply`.

Only the signal task is ported (reference train_signal_only*.py,
train_signal_only_ptb.py, train_physionet*.py). The image, clinical,
spectrogram and fusion tasks wait for their slices (ROADMAP.md).
"""

from __future__ import annotations

from ecgmm_torch.config import TrainConfig
from ecgmm_torch.data.pipeline import Batch
from ecgmm_torch.train import losses
from ecgmm_torch.train.engine import Task


def _classification_loss(cfg: TrainConfig):
    base = losses.make_loss_fn(cfg.loss, alpha=cfg.focal_alpha,
                               gamma=cfg.focal_gamma)

    def loss(outputs, batch: Batch):
        return base(outputs, batch.labels, batch.mask), {}

    return loss


def make_signal_task(cfg: TrainConfig) -> Task:
    """Signals (B, T) go in as (B, 1, T); (B, C, T) as they are."""
    def apply(model, batch: Batch):
        x = batch.signals
        if x.dim() == 2:
            x = x.unsqueeze(1)
        return model(x)

    return Task(apply=apply, loss=_classification_loss(cfg),
                logits=lambda outputs: outputs)
