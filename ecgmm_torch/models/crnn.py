"""Spectrogram CRNN (port of `ecgmm_tpu/models/crnn.py`; reference
train_physionet2.py:55-96): three 5x5 Conv + BatchNorm + ReLU + 2x2
max-pool blocks over the log-spectrogram, a 3-layer bidirectional LSTM
(hidden 200 a direction) over time, the mean over time, and a 400 -> 64
-> classes head.

Channels-first (B, 1, F, T) inside, with the reference torch names
(`conv{1,2,3}.block.{0,1}`, `bilstm.*_l{k}[_reverse]`,
`classifier.{0,3}`), so the JAX exporter's state dict loads strictly. The
conv output is flattened as torch's reference does, channel-major (C,
F'); flax flattens (F', C), and `tools/weights.from_jax_crnn` permutes the
first LSTM layer's input columns accordingly. The convolutions are
matrix products over im2col columns (`GemmConv2d`), not cuDNN's.

flax's LSTM cell has one bias a gate where torch's has two (`bias_ih` and
`bias_hh`, summed): `bias_hh_*` stays 0 and out of training (it does not
require a gradient, and `lstm_bias_frozen` keeps it out of the train
state's optimizer), so Adam moves one bias a gate, as in JAX. `nn.LSTM`
may run on cuDNN: JAX's LSTM is an `nn.RNN` scan, not a Pallas kernel.
Train mode follows flax (`models/layers.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ecgmm_torch.models.layers import BatchNorm2d, Dropout


def lstm_bias_frozen(name: str) -> bool:
    """The parameters that stay at 0 and out of the optimizer: the LSTM's
    second bias of each gate (a `create_state` freeze predicate)."""
    return name.startswith("bilstm.bias_hh_")


class GemmConv2d(nn.Conv2d):
    """`nn.Conv2d` (stride 1, no dilation, one group) computed as im2col
    and one float32 matrix product, so that its gradients are float32
    sums as in JAX: with cuDNN's float32 convolutions the first
    `physionet_crnn` step's gradient of the second block's 5x5 kernel
    reads 6.4e-3 off float64 on the H100, with these products 2.2e-6
    (`chip_smoke.py` phase 6 prints both)."""

    def _conv_forward(self, x, weight, bias):
        b, _, h, w = x.shape
        (kh, kw), (ph, pw) = self.kernel_size, self.padding
        cols = F.unfold(x, (kh, kw), padding=(ph, pw))  # (B, C*kh*kw, L)
        out = torch.matmul(weight.flatten(1), cols)
        if bias is not None:
            out = out + bias[:, None]
        return out.view(b, -1, h + 2 * ph - kh + 1, w + 2 * pw - kw + 1)


class ConvBlock2D(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.block = nn.Sequential(
            GemmConv2d(c_in, c_out, 5, padding=2), BatchNorm2d(c_out),
            nn.ReLU(), nn.MaxPool2d(2),
        )

    def forward(self, x):
        return self.block(x)


class CRNN(nn.Module):
    """Input (B, F, T) log-spectrograms with F = `freq_bins` (33 for the
    reference's nperseg 64)."""

    def __init__(self, num_classes: int = 2, freq_bins: int = 33,
                 hidden: int = 200, lstm_layers: int = 3,
                 dropout: float = 0.3):
        super().__init__()
        self.conv1 = ConvBlock2D(1, 32)
        self.conv2 = ConvBlock2D(32, 64)
        self.conv3 = ConvBlock2D(64, 128)
        self.bilstm = nn.LSTM(128 * (freq_bins // 8), hidden,
                              num_layers=lstm_layers, batch_first=True,
                              bidirectional=True)
        for name, p in self.bilstm.named_parameters():
            if name.startswith("bias_hh_"):
                with torch.no_grad():
                    p.zero_()
                p.requires_grad_(False)
        self.classifier = nn.Sequential(
            nn.Linear(2 * hidden, 64), nn.ReLU(), Dropout(dropout),
            nn.Linear(64, num_classes),
        )

    def forward(self, spec):  # (B, F, T)
        x = self.conv3(self.conv2(self.conv1(spec.unsqueeze(1))))
        x = x.permute(0, 3, 1, 2).flatten(2)  # (B, T', C * F')
        out, _ = self.bilstm(x)
        return self.classifier(out.mean(dim=1)).float()
