"""ResNet-18 image encoder (port of `ecgmm_tpu/models/resnet18.py`).

NCHW with torchvision's parameter names (`conv1`, `bn1`,
`layer{1..4}.{0,1}.*`, `fc`). The JAX stem evaluates the 7x7/s2 conv as
a space-to-depth 4x4 conv with the uint8 normalisation folded in (a TPU
layout trick); here the stem is the plain 7x7/s2 conv, and the input
convention is kept: a uint8 input is raw pixels, normalised as
x/127.5 - 1, and a float input is already normalised. Train mode follows
flax (`models/layers.BatchNorm2d`): the biased batch variance normalises
and is folded into `running_var`, momentum 0.1 in torch terms.
"""

from __future__ import annotations

import torch
from torch import nn

from ecgmm_torch.models.layers import BatchNorm2d


class BasicBlock2D(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = BatchNorm2d(c_out)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(c_out)
        self.downsample = None
        if c_in != c_out or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(c_in, c_out, 1, stride=stride, bias=False),
                BatchNorm2d(c_out),
            )

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + identity)


class ResNet18(nn.Module):
    """Input (B, 3, H, W), uint8 raw pixels or float normalised. `num_classes`
    is the fc width: 512 as the fusion image branch."""

    def __init__(self, num_classes: int = 2):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        c_in = 64
        for stage in range(4):
            c_out = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            setattr(self, f"layer{stage + 1}", nn.Sequential(
                BasicBlock2D(c_in, c_out, stride), BasicBlock2D(c_out, c_out)
            ))
            c_in = c_out
        self.fc = nn.Linear(512, num_classes)

    def features(self, x):
        """The layer-4 activations (B, 512, H/32, W/32)."""
        if x.dtype == torch.uint8:
            x = x.float() / 127.5 - 1.0
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))

    def forward(self, x, return_features: bool = False):
        feats = self.features(x)
        logits = self.fc(feats.mean(dim=(2, 3))).float()
        if return_features:
            return logits, feats
        return logits
