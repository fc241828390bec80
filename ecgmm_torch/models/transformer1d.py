"""1-D Transformer ECG classifier (port of
`ecgmm_tpu/models/transformer1d.py`; reference train_physionet.py:
211-239): a kernel-3 convolution embedding to d_model 128, a learnable
positional embedding over `seq_len`, 2 post-LN encoder layers (4 heads,
feed-forward 256, ReLU, dropout 0.1, LayerNorm eps 1e-5), the mean over
time and a 128 -> 64 -> classes head.

It attends over time, as the JAX model does (PARITY.md "Transformer1D
attention"; the reference's seq-first encoder attends over the batch).
Input is (B, C_in, T), the port's signal layout; the model transposes
after the embedding. Parameter names are the reference's (`conv`,
`pos_embedding`, `transformer_encoder.layers.{i}.{self_attn,linear1,
linear2,norm1,norm2}`, `classifier.{1,4}`), so the JAX exporter's state
dict loads strictly. The encoder layer is written out rather than taken
from `nn.TransformerEncoderLayer`: torch's attention dropout draws per
element, flax's one (T, T) mask for every sample and head
(`layers.MultiHeadSelfAttention`).
"""

from __future__ import annotations

import torch
from torch import nn

from ecgmm_torch.models.layers import Dropout, MultiHeadSelfAttention


class PostLNEncoderLayer(nn.Module):
    """torch `nn.TransformerEncoderLayer` defaults: post-norm, ReLU
    feed-forward, dropout after the attention, inside the feed-forward and
    after it; flax's attention (`MultiHeadSelfAttention`)."""

    def __init__(self, d_model: int = 128, nhead: int = 4,
                 dim_feedforward: int = 256, dropout: float = 0.1):
        super().__init__()
        self.self_attn = MultiHeadSelfAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)

    def forward(self, x):  # (B, T, D)
        x = self.norm1(x + self.dropout1(self.self_attn(x)))
        ff = self.linear2(self.dropout(torch.relu(self.linear1(x))))
        return self.norm2(x + self.dropout2(ff))


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, **layer_kw):
        super().__init__()
        self.layers = nn.ModuleList(
            PostLNEncoderLayer(**layer_kw) for _ in range(num_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class ECGTransformer1D(nn.Module):
    """`dropout` is the head's; the encoder layers keep 0.1, as the JAX
    model's `PostLNEncoderLayer` does."""

    def __init__(self, num_classes: int = 2, seq_len: int = 3000,
                 input_channels: int = 1, d_model: int = 128,
                 nhead: int = 4, num_layers: int = 2,
                 dim_feedforward: int = 256, dropout: float = 0.3):
        super().__init__()
        self.conv = nn.Conv1d(input_channels, d_model, 3, padding=1)
        self.pos_embedding = nn.Parameter(torch.zeros(1, seq_len, d_model))
        self.transformer_encoder = TransformerEncoder(
            num_layers, d_model=d_model, nhead=nhead,
            dim_feedforward=dim_feedforward)
        self.classifier = nn.Sequential(
            nn.Flatten(), nn.Linear(d_model, 64), nn.ReLU(),
            Dropout(dropout), nn.Linear(64, num_classes),
        )

    def forward(self, x):  # (B, C_in, T)
        x = self.conv(x).transpose(1, 2)
        x = x + self.pos_embedding[:, :x.shape[1]]
        x = self.transformer_encoder(x)
        return self.classifier(x.mean(dim=1)).float()
