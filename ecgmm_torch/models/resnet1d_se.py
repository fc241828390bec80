"""ResNet1D-SE signal encoder (port of `ecgmm_tpu/models/resnet1d_se.py`).

Channels-first (B, C, T), parameter names of the reference torch model
(`initial.*`, `layer{1,2,3}.*`, `classifier.{1,4}.*`), so the JAX
exporters' state dicts load strictly. Padding is symmetric and explicit.
The SE gate goes through `ecgmm_torch.ops.se`.

Train mode follows flax (`models/layers.py`): BatchNorm with the biased
variance in `running_var`, dropout from an explicit `torch.Generator`.
"""

from __future__ import annotations

import torch
from torch import nn

from ecgmm_torch.models.layers import BatchNorm1d, Dropout
from ecgmm_torch.ops.se import fused_se


class SEBlock1D(nn.Module):
    """Squeeze-and-Excitation, reduction 16 (reference
    signal_model.py:12-27). `fc` holds the two Linear layers under their
    reference names (fc.0, fc.2); the forward is the fused op, with the
    weights cast to the activation's (compute) dtype as the JAX module
    does."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        r = max(1, channels // reduction)
        self.fc = nn.Sequential(
            nn.Linear(channels, r), nn.ReLU(), nn.Linear(r, channels),
            nn.Sigmoid(),
        )

    def forward(self, x):  # (B, C, T)
        dt = x.dtype
        fc1, fc2 = self.fc[0], self.fc[2]
        return fused_se(
            x.contiguous(), fc1.weight.to(dt), fc1.bias.to(dt),
            fc2.weight.to(dt), fc2.bias.to(dt),
        )


class BasicBlock1D(nn.Module):
    """conv-bn-relu-conv-bn + SE + (1x1) downsample shortcut (reference
    signal_model.py:30-56)."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 kernel_size: int = 3):
        super().__init__()
        pad = kernel_size // 2
        self.conv1 = nn.Conv1d(c_in, c_out, kernel_size, stride=stride,
                               padding=pad)
        self.bn1 = BatchNorm1d(c_out)
        self.conv2 = nn.Conv1d(c_out, c_out, kernel_size, padding=pad)
        self.bn2 = BatchNorm1d(c_out)
        self.se = SEBlock1D(c_out)
        self.downsample = None
        if c_in != c_out or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv1d(c_in, c_out, 1, stride=stride), BatchNorm1d(c_out)
            )

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.se(self.bn2(self.conv2(out)))
        return torch.relu(out + identity)


class ResNet1DSE(nn.Module):
    """Signal encoder / classifier (reference signal_model.py:59-88).
    Input (B, C_in, T); `num_classes` is the embedding width in the fusion
    model (128)."""

    def __init__(self, num_classes: int = 2, input_channels: int = 1,
                 base_filters: int = 64, dropout: float = 0.3):
        super().__init__()
        f = base_filters
        self.initial = nn.Sequential(
            nn.Conv1d(input_channels, f, 7, stride=2, padding=3),
            BatchNorm1d(f), nn.ReLU(),
            nn.MaxPool1d(3, stride=2, padding=1),
        )
        self.layer1 = BasicBlock1D(f, f)
        self.layer2 = BasicBlock1D(f, 2 * f, stride=2)
        self.layer3 = BasicBlock1D(2 * f, 4 * f, stride=2)
        self.classifier = nn.Sequential(
            nn.Flatten(), nn.Linear(4 * f, 64), nn.ReLU(), Dropout(dropout),
            nn.Linear(64, num_classes),
        )

    def forward(self, x, return_features: bool = False):
        feats = self.layer3(self.layer2(self.layer1(self.initial(x))))
        logits = self.classifier(feats.mean(dim=-1)).float()
        if return_features:
            # pre-head temporal features (B, 4f, T'), for Grad-CAM
            return logits, feats
        return logits

