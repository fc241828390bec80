"""Task builders (port of `ecgmm_tpu/workloads/tasks.py`): bind a loss to
the engine's Task contract. The model is not bound here: it lives in the
TrainState and the engine passes it to `apply`.

Ported: the signal task (reference train_signal_only*.py,
train_signal_only_ptb.py, train_physionet*.py), the image task
(train_image_only.py), the clinical-encoder pretraining task (encoder plus
a linear probe, for the clinical checkpoint multimodal.py:388 loads), the
fusion task (train.py / train_paper_modal_balance.py: CE(fusion) + 0.1
var_loss, the encoders frozen by the train state), the fusion head task
over cached embeddings and the spectrogram task (train_physionet2.py).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

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


def make_fusion_head_task(cfg: TrainConfig) -> Task:
    """Fusion training over cached embeddings (`train/embed.py`): the
    batch's image, signal and clinical slots hold the frozen encoders' raw
    outputs, and the forward is the trainable surface alone
    (`ECGMultimodalModel.from_embeddings`), with `make_fusion_task`'s loss
    and logits."""
    def apply(model, batch: Batch):
        return model.from_embeddings(batch.images, batch.signals,
                                     batch.clinical, mask=batch.mask)

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


def make_spectrogram_task(cfg: TrainConfig) -> Task:
    """The CRNN over precomputed (B, F, T) log-spectrograms held in the
    batch's signal slot (reference train_physionet2.py)."""
    return Task(apply=lambda model, batch: model(batch.signals),
                loss=_classification_loss(cfg),
                logits=lambda outputs: outputs)


def make_image_task(cfg: TrainConfig) -> Task:
    """Images (B, 3, H, W) uint8 go in raw, as in `make_fusion_task`."""
    return Task(apply=lambda model, batch: model(batch.images),
                loss=_classification_loss(cfg),
                logits=lambda outputs: outputs)


class ClinicalProbe(nn.Module):
    """A clinical encoder and a linear probe on its embedding (JAX's
    `Probe` in `make_clinical_task`): forward returns (logits, m_loss),
    m_loss 0 for an encoder without one (the MLP). State-dict keys are
    `encoder.*` and `probe.*`; the probe's width is the encoder's last
    Linear's (flax infers it from the embedding)."""

    def __init__(self, encoder: nn.Module, num_classes: int):
        super().__init__()
        self.encoder = encoder
        width = [m for m in encoder.modules()
                 if isinstance(m, nn.Linear)][-1].out_features
        self.probe = nn.Linear(width, num_classes)

    def forward(self, x):
        z = self.encoder(x)
        m_loss = x.new_zeros((), dtype=torch.float32)
        if isinstance(z, tuple):
            z, m_loss = z
        return self.probe(z), m_loss


def make_clinical_task(encoder: nn.Module, cfg: TrainConfig,
                       num_classes: int = 2) -> Tuple[Task, ClinicalProbe]:
    """Clinical-encoder pretraining: the loss is the classification loss of
    the probe's logits plus 1e-3 m_loss, and m_loss is a metric. Returns
    (task, probe): the probe is the model the caller initialises and
    trains."""
    base = losses.make_loss_fn(cfg.loss, alpha=cfg.focal_alpha,
                               gamma=cfg.focal_gamma)

    def loss(outputs, batch: Batch):
        logits, m_loss = outputs
        return (base(logits, batch.labels, batch.mask) + 1e-3 * m_loss,
                {"m_loss": m_loss})

    task = Task(apply=lambda model, batch: model(batch.clinical), loss=loss,
                logits=lambda outputs: outputs[0])
    return task, ClinicalProbe(encoder, num_classes)
