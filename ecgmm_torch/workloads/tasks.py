"""Task builders (port of `ecgmm_tpu/workloads/tasks.py`): bind a loss to
the engine's Task contract. The model is not bound here: it lives in the
TrainState and the engine passes it to `apply`.

Ported: the signal task (reference train_signal_only*.py,
train_signal_only_ptb.py, train_physionet*.py) and the fusion task
(train.py / train_paper_modal_balance.py: CE(fusion) + 0.1 var_loss, the
encoders frozen by the train state). The image, clinical and spectrogram
tasks wait for their slices (ROADMAP.md).
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


def _fusion_loss(cfg: TrainConfig):
    def loss(outputs, batch: Batch):
        total = losses.fusion_loss(
            outputs.fusion_logits, batch.labels, outputs.var_loss,
            batch.mask, var_weight=cfg.var_loss_weight,
        )
        if cfg.branch_loss_weight:
            # summed per-branch CE (train_exhausted.py:67-75)
            total = total + cfg.branch_loss_weight * sum(
                losses.cross_entropy(logits, batch.labels, batch.mask)
                for logits in (outputs.image_logits, outputs.signal_logits,
                               outputs.clinical_logits))
        return total, {"var_loss": outputs.var_loss,
                       "soft_weights": outputs.soft_weights}

    return loss


def make_fusion_task(cfg: TrainConfig) -> Task:
    """Images (B, 3, H, W) uint8 go in raw (ResNet18 normalises them as
    x / 127.5 - 1); the mask keeps pad rows out of var_loss."""
    def apply(model, batch: Batch):
        return model(batch.images, batch.signals, batch.clinical,
                     mask=batch.mask)

    return Task(apply=apply, loss=_fusion_loss(cfg),
                logits=lambda outputs: outputs.fusion_logits)


def make_signal_task(cfg: TrainConfig) -> Task:
    """Signals (B, T) go in as (B, 1, T); (B, C, T) as they are."""
    def apply(model, batch: Batch):
        x = batch.signals
        if x.dim() == 2:
            x = x.unsqueeze(1)
        return model(x)

    return Task(apply=apply, loss=_classification_loss(cfg),
                logits=lambda outputs: outputs)
