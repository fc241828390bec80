"""Trimodal attention-fusion model (port of `ecgmm_tpu/models/fusion.py`):
ResNet18 image branch, ResNet1D-SE signal branch, and a TabNet clinical
branch (the canonical 512/128/32 variant) or an MLP one (the modal-balance
256/256/256 variant), selected by `ModelConfig.clinical_encoder`.

Parameter names follow the reference torch layout that
`ecgmm_tpu.tools.export_pth.export_fusion_{canonical,modal_balance}`
emit, so `ecgmm_torch.tools.weights.from_jax_variables` loads strictly.
The AttentionFusion head goes through `ecgmm_torch.ops.fusion`.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ecgmm_torch.config import ModelConfig
from ecgmm_torch.models.clinical import ClinicalMLPEncoder, TabNetEncoder
from ecgmm_torch.models.layers import Dropout
from ecgmm_torch.models.resnet18 import ResNet18
from ecgmm_torch.models.resnet1d_se import ResNet1DSE
from ecgmm_torch.ops.fusion import fused_attention_fusion
from ecgmm_torch.parallel import collectives

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class FusionOutput(NamedTuple):
    image_logits: torch.Tensor
    signal_logits: torch.Tensor
    clinical_logits: torch.Tensor
    fusion_logits: torch.Tensor
    var_loss: torch.Tensor       # scalar variance-balance regulariser
    soft_weights: torch.Tensor   # (3,) softmax attention weights
    m_loss: torch.Tensor         # TabNet sparsity loss (0 for the MLP)


class AttentionFusion(nn.Module):
    """Three learnable scalars -> softmax -> scale each modality chunk ->
    concat -> LayerNorm (reference multimodal.py:12-27), as one fused op.
    `norm` only holds the LayerNorm's affine parameters under their
    reference names; the op applies them."""

    def __init__(self, dim: int):
        super().__init__()
        self.weights = nn.Parameter(torch.ones(3))
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, img, sig, clin):
        return fused_attention_fusion(
            img.float(), sig.float(), clin.float(), self.weights,
            self.norm.weight, self.norm.bias, 1e-5,  # torch LayerNorm eps
        )


def _chunk_variance_loss(img, sig, clin, mask=None):
    """|var_i - var_s| + |var_i - var_c| + |var_s - var_c| over per-sample
    feature variances (ddof=1, as torch.var); mask (B,) drops padded rows
    from the batch mean (`ecgmm_tpu.models.fusion._chunk_variance_loss`).
    The ties differentiate as JAX's do: the denominator max(sum(mask), 1)
    is torch.maximum against a 1.0 tensor, whose VJP splits a tie at
    sum(mask) == 1 as jnp.maximum's does, and |d| has derivative 1 at
    d == 0 as jnp.abs has (torch's abs has 0 there; all three variances
    are 0 where the mask is)."""

    def v(x):
        # under a data-parallel step, the global batch's rows
        rows = collectives.gather_rows_if_active(
            x.float().var(dim=1, unbiased=True))
        if mask is None:
            return rows.mean()
        m = collectives.gather_rows_if_active(mask.float())
        s = m.sum()
        return (rows * m).sum() / torch.maximum(s, s.new_ones(()))

    def absolute(d):
        return torch.where(d >= 0, d, -d)

    vi, vs, vc = v(img), v(sig), v(clin)
    return absolute(vi - vs) + absolute(vi - vc) + absolute(vs - vc)


class ECGMultimodalModel(nn.Module):
    """Trimodal model. Inputs: image (B, 3, H, W) uint8 raw or float
    normalised, signal (B, T) or (B, 1, T), clinical (B, F). The encoders
    run in `cfg.dtype` under autocast, and so do the head's hidden layer,
    its ReLU and its dropout (`head`); the LayerNorms, the branch
    classifiers, the attention fusion and the head's output layer run in
    float32, as in the JAX model. `.train()` puts every module in flax's
    train mode, the encoders included (batch statistics, live dropout), as
    the JAX model's `train=True` does; the fusion head's dropout draws
    from the generator `set_dropout_generator` gives it.

    `encode_raw` and `from_embeddings` split the forward at the frozen
    encoders' outputs: the cached-embedding path (`train/embed.py`)
    encodes each split once and trains the surface after them."""

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"unsupported compute dtype {cfg.dtype!r}")
        self.image_encoder = ResNet18(num_classes=cfg.image_dim)
        self.signal_encoder = ResNet1DSE(
            num_classes=cfg.signal_dim,
            input_channels=cfg.signal_input_channels,
            base_filters=cfg.signal_base_filters,
        )
        if cfg.clinical_encoder == "tabnet":
            self.clinical_encoder = TabNetEncoder(
                cfg.clinical_in_features, out_dim=cfg.clinical_dim)
        elif cfg.clinical_encoder == "mlp":
            self.clinical_encoder = ClinicalMLPEncoder(
                cfg.clinical_in_features, out_dim=cfg.clinical_dim)
        else:
            raise ValueError(
                f"unknown clinical encoder {cfg.clinical_encoder!r}")
        # torch nn.LayerNorm eps (1e-5)
        self.image_norm = nn.LayerNorm(cfg.image_dim, eps=1e-5)
        self.signal_norm = nn.LayerNorm(cfg.signal_dim, eps=1e-5)
        self.clinical_norm = nn.LayerNorm(cfg.clinical_dim, eps=1e-5)
        self.image_classifier = nn.Linear(cfg.image_dim, cfg.num_classes)
        self.signal_classifier = nn.Linear(cfg.signal_dim, cfg.num_classes)
        self.clinical_classifier = nn.Linear(cfg.clinical_dim,
                                             cfg.num_classes)
        width = cfg.image_dim + cfg.signal_dim + cfg.clinical_dim
        self.attention_fusion = AttentionFusion(width)
        self.fusion_classifier = nn.Sequential(
            nn.Linear(width, cfg.fusion_hidden), nn.ReLU(),
            Dropout(cfg.dropout), nn.Linear(cfg.fusion_hidden,
                                            cfg.num_classes),
        )

    def _autocast(self, device: torch.device):
        dt = _DTYPES[self.cfg.dtype]
        if dt == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=dt)

    def encode_image(self, image):
        """(raw fc output (B, image_dim) f32, layer-4 map (B, 512, h, w))."""
        with self._autocast(image.device):
            emb, feats = self.image_encoder(image, return_features=True)
        return emb.float(), feats.float()

    def encode_signal(self, signal):
        if signal.dim() == 2:
            signal = signal[:, None, :]  # (B, T) -> (B, 1, T)
        with self._autocast(signal.device):
            return self.signal_encoder(signal).float()

    def _encode_clinical_raw(self, clinical):
        """(raw clinical embedding f32, TabNet m_loss; 0 for the MLP)."""
        with self._autocast(clinical.device):
            clin = self.clinical_encoder(clinical)
        m_loss = clinical.new_zeros((), dtype=torch.float32)
        if isinstance(clin, tuple):
            clin, m_loss = clin
        return clin.float(), m_loss.float()

    def encode_clinical(self, clinical):
        """(LayerNorm'd clinical embedding, TabNet m_loss; 0 for the
        MLP)."""
        clin, m_loss = self._encode_clinical_raw(clinical)
        return self.clinical_norm(clin), m_loss

    def encode(self, image, signal, clinical, return_image_map=False):
        """Per-modality LayerNorm'd embeddings and m_loss (the XAI surface);
        with return_image_map also the image branch's layer-4 map, for
        Grad-CAM."""
        img_raw, img_map = self.encode_image(image)
        img_feat = self.image_norm(img_raw)
        sig_feat = self.signal_norm(self.encode_signal(signal))
        clin_feat, m_loss = self.encode_clinical(clinical)
        if return_image_map:
            return img_feat, sig_feat, clin_feat, m_loss, img_map
        return img_feat, sig_feat, clin_feat, m_loss

    def encode_raw(self, image, signal, clinical):
        """The three encoders' raw (pre-LayerNorm) float32 outputs in eval
        mode (running statistics, no dropout), as JAX's `encode_raw`
        (`train=False`): the frozen-encoder boundary of the cached path.
        The encoders' train/eval modes are restored afterwards."""
        encoders = (self.image_encoder, self.signal_encoder,
                    self.clinical_encoder)
        modes = [m.training for m in encoders]
        try:
            for m in encoders:
                m.eval()
            img_raw, _ = self.encode_image(image)
            sig_raw = self.encode_signal(signal)
            clin_raw, _ = self._encode_clinical_raw(clinical)
        finally:
            for m, mode in zip(encoders, modes):
                m.train(mode)
        return img_raw, sig_raw, clin_raw

    def head(self, fused):
        """The fusion MLP over the fused (B, D) float32 embedding, as JAX's
        `head`: the hidden layer, its ReLU and its dropout in the compute
        dtype, the output layer in float32. In a low compute dtype the
        hidden layer is flax's Dense: the product is rounded to that dtype,
        then the bias is added in it (a fused bias would round once)."""
        hidden, relu, dropout, out = self.fusion_classifier
        dt = _DTYPES[self.cfg.dtype]
        if dt == torch.float32:
            x = hidden(fused.float())
        else:
            x = (F.linear(fused.to(dt), hidden.weight.to(dt))
                 + hidden.bias.to(dt))
        return out(dropout(relu(x)).float())

    def fuse_embeddings(self, img_feat, sig_feat, clin_feat):
        """Fusion logits from per-modality embeddings (the surface SHAP and
        clinical IG differentiate through)."""
        fused, _ = self.attention_fusion(img_feat, sig_feat, clin_feat)
        return self.head(fused)

    def _surface(self, img_feat, sig_feat, clin_feat, m_loss,
                 mask) -> FusionOutput:
        """Everything after the LayerNorm'd embeddings."""
        fused, soft_weights = self.attention_fusion(
            img_feat, sig_feat, clin_feat
        )
        return FusionOutput(
            image_logits=self.image_classifier(img_feat),
            signal_logits=self.signal_classifier(sig_feat),
            clinical_logits=self.clinical_classifier(clin_feat),
            fusion_logits=self.head(fused),
            var_loss=_chunk_variance_loss(img_feat, sig_feat, clin_feat,
                                          mask=mask),
            soft_weights=soft_weights,
            m_loss=m_loss,
        )

    def from_embeddings(self, img_raw, sig_raw, clin_raw,
                        mask=None) -> FusionOutput:
        """The trainable surface over `encode_raw`'s outputs: the three
        LayerNorms, the branch classifiers, the attention fusion, `head`
        and the variance loss, with m_loss 0 (the fusion loss never reads
        it), as JAX's `from_embeddings`."""
        return self._surface(
            self.image_norm(img_raw.float()),
            self.signal_norm(sig_raw.float()),
            self.clinical_norm(clin_raw.float()),
            img_raw.new_zeros((), dtype=torch.float32), mask)

    def forward(self, image, signal, clinical, mask=None) -> FusionOutput:
        return self._surface(*self.encode(image, signal, clinical), mask)
