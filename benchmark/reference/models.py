"""Plain PyTorch reference of the benchmark's models, frozen here: the
trimodal fusion model (ResNet-18 image encoder, ResNet1D-SE signal
encoder, TabNet clinical encoder, the attention-fusion head; reference
multimodal.py:333-469) and the 1-D Transformer (reference
train_physionet.py:211-239). The parameter and buffer names are those of
the published torch models, so one state dict loads into the program and
into the reference alike.

Every product goes through `Arith` (float32, or the lower precision of a
control). Train mode follows flax, as the configurations state:
BatchNorm normalises with the biased batch variance and folds it into
`running_var` (momentum in torch's convention), TabNet's BatchNorms are
ghost BatchNorms over torch.chunk's virtual batches, and dropout keeps
with probability 1 - p and scales by 1 / (1 - p). A keep mask is drawn
with `bernoulli_` from the run's dropout generator, in the layer order of
the forward pass and in the dtype the configuration computes that layer
in, so a generator seeded alike draws the same masks as the program's.
The attention's dropout is one (T, T) mask shared by the batch and the
heads (flax's broadcast dropout)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from benchmark.reference import kernels
from benchmark.reference.arith import Arith


@dataclasses.dataclass
class RunCtx:
    """What one forward pass needs besides its inputs: the arithmetic,
    train or eval mode, the dropout generator and the dtype its masks are
    drawn in."""

    arith: Arith
    train: bool
    generator: Optional[torch.Generator] = None
    mask_dtype: torch.dtype = torch.float32


def dropout(x, p: float, rc: RunCtx, shape=None):
    if not rc.train or p == 0.0:
        return x
    keep = torch.empty(tuple(x.shape) if shape is None else shape,
                       dtype=rc.mask_dtype, device=x.device).bernoulli_(
        1.0 - p, generator=rc.generator)
    return x * keep.float() / (1.0 - p)


class BN(nn.Module):
    """BatchNorm over every dimension but dim 1."""

    def __init__(self, c: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x, rc: RunCtx):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if rc.train:
            dims = (0,) + tuple(range(2, x.dim()))
            var, mean = torch.var_mean(x.float(), dim=dims, unbiased=False)
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        return ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
                * self.weight.view(shape) + self.bias.view(shape))


def _conv2d(m: nn.Conv2d, x, rc):
    return rc.arith.conv2d(x, m.weight, m.bias, m.stride, m.padding)


def _conv1d(m: nn.Conv1d, x, rc):
    return rc.arith.conv1d(x, m.weight, m.bias, m.stride, m.padding)


def _linear(m: nn.Linear, x, rc):
    return rc.arith.linear(x, m.weight, m.bias)


# ResNet-18 ----------------------------------------------------------------

class Block2D(nn.Module):
    def __init__(self, c_in, c_out, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, 3, stride, 1, bias=False)
        self.bn1 = BN(c_out)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, 1, 1, bias=False)
        self.bn2 = BN(c_out)
        self.downsample = None
        if c_in != c_out or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(c_in, c_out, 1, stride, bias=False), BN(c_out))

    def forward(self, x, rc):
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](
                _conv2d(self.downsample[0], x, rc), rc)
        out = torch.relu(self.bn1(_conv2d(self.conv1, x, rc), rc))
        out = self.bn2(_conv2d(self.conv2, out, rc), rc)
        return torch.relu(out + identity)


class ResNet18(nn.Module):
    """(B, 3, H, W) uint8 pixels, normalised as x / 127.5 - 1."""

    def __init__(self, out_dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BN(64)
        c_in = 64
        for stage in range(4):
            c_out = 64 * 2 ** stage
            setattr(self, f"layer{stage + 1}", nn.Sequential(
                Block2D(c_in, c_out, 1 if stage == 0 else 2),
                Block2D(c_out, c_out)))
            c_in = c_out
        self.fc = nn.Linear(512, out_dim)

    def forward(self, x, rc):
        x = x.float() / 127.5 - 1.0
        x = torch.relu(self.bn1(_conv2d(self.conv1, x, rc), rc))
        x = nn.functional.max_pool2d(x, 3, 2, 1)
        for stage in range(4):
            for block in getattr(self, f"layer{stage + 1}"):
                x = block(x, rc)
        return _linear(self.fc, x.mean(dim=(2, 3)), rc)


# ResNet1D-SE --------------------------------------------------------------

class SE(nn.Module):
    def __init__(self, c, reduction=16):
        super().__init__()
        r = max(1, c // reduction)
        self.fc = nn.Sequential(nn.Linear(c, r), nn.ReLU(), nn.Linear(r, c),
                                nn.Sigmoid())

    def forward(self, x, rc):
        return kernels.se_gate(x, self.fc[0].weight, self.fc[0].bias,
                               self.fc[2].weight, self.fc[2].bias, rc.arith)


class Block1D(nn.Module):
    def __init__(self, c_in, c_out, stride=1):
        super().__init__()
        self.conv1 = nn.Conv1d(c_in, c_out, 3, stride, 1)
        self.bn1 = BN(c_out)
        self.conv2 = nn.Conv1d(c_out, c_out, 3, 1, 1)
        self.bn2 = BN(c_out)
        self.se = SE(c_out)
        self.downsample = None
        if c_in != c_out or stride != 1:
            self.downsample = nn.Sequential(nn.Conv1d(c_in, c_out, 1, stride),
                                            BN(c_out))

    def forward(self, x, rc):
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](
                _conv1d(self.downsample[0], x, rc), rc)
        out = torch.relu(self.bn1(_conv1d(self.conv1, x, rc), rc))
        out = self.se(self.bn2(_conv1d(self.conv2, out, rc), rc), rc)
        return torch.relu(out + identity)


class ResNet1DSE(nn.Module):
    """(B, C_in, T) signals; `out_dim` is the embedding width."""

    def __init__(self, out_dim, input_channels=1, base_filters=64,
                 dropout_p=0.3):
        super().__init__()
        f = base_filters
        self.dropout_p = dropout_p
        self.initial = nn.Sequential(nn.Conv1d(input_channels, f, 7, 2, 3),
                                     BN(f))
        self.layer1 = Block1D(f, f)
        self.layer2 = Block1D(f, 2 * f, 2)
        self.layer3 = Block1D(2 * f, 4 * f, 2)
        self.classifier = nn.Sequential(
            nn.Flatten(), nn.Linear(4 * f, 64), nn.ReLU(), nn.Identity(),
            nn.Linear(64, out_dim))

    def forward(self, x, rc):
        x = torch.relu(self.initial[1](_conv1d(self.initial[0], x, rc), rc))
        x = nn.functional.max_pool1d(x, 3, 2, 1)
        x = self.layer3(self.layer2(self.layer1(x, rc), rc), rc)
        h = torch.relu(_linear(self.classifier[1], x.mean(dim=-1), rc))
        return _linear(self.classifier[4], dropout(h, self.dropout_p, rc), rc)


# TabNet -------------------------------------------------------------------

def sparsemax(z):
    """Projection of the rows of z onto the probability simplex."""
    k = z.shape[-1]
    zs = torch.sort(z, dim=-1, descending=True).values
    cs = torch.cumsum(zs, dim=-1)
    ks = torch.arange(1, k + 1, dtype=z.dtype, device=z.device)
    k_z = (1.0 + ks * zs > cs).sum(dim=-1, keepdim=True)
    tau = (torch.gather(cs, -1, k_z - 1) - 1.0) / k_z.to(z.dtype)
    return torch.maximum(z - tau, z.new_zeros(()))


class GBN(nn.Module):
    """Ghost BatchNorm: in train mode torch.chunk's virtual batches of at
    most `vbs` rows, each normalised by its own statistics through `bn`."""

    def __init__(self, c, vbs, momentum=0.02):
        super().__init__()
        self.vbs = vbs
        self.bn = BN(c, momentum)

    def forward(self, x, rc):
        if not rc.train or x.shape[0] <= self.vbs:
            return self.bn(x, rc)
        n = -(-x.shape[0] // self.vbs)
        return torch.cat([self.bn(c, rc) for c in x.chunk(n, 0)], 0)


class GLULayer(nn.Module):
    def __init__(self, fc, out_dim, vbs):
        super().__init__()
        self.out_dim = out_dim
        self.fc = fc
        self.bn = GBN(2 * out_dim, vbs)

    def forward(self, x, rc):
        x = self.bn(_linear(self.fc, x, rc), rc)
        return x[..., :self.out_dim] * torch.sigmoid(x[..., self.out_dim:])


class GLUBlock(nn.Module):
    def __init__(self, fcs, out_dim, first, vbs):
        super().__init__()
        self.first = first
        self.glu_layers = nn.ModuleList(GLULayer(fc, out_dim, vbs)
                                        for fc in fcs)

    def forward(self, x, rc):
        for i, layer in enumerate(self.glu_layers):
            h = layer(x, rc)
            x = h if (self.first and i == 0) else (x + h) * math.sqrt(0.5)
        return x


class FeatTransformer(nn.Module):
    def __init__(self, shared, w, n_independent, vbs):
        super().__init__()
        self.shared = GLUBlock(shared, w, True, vbs)
        self.specifics = GLUBlock(
            [nn.Linear(w, 2 * w, bias=False) for _ in range(n_independent)],
            w, False, vbs)

    def forward(self, x, rc):
        return self.specifics(self.shared(x, rc), rc)


class AttentiveTransformer(nn.Module):
    def __init__(self, n_a, input_dim, vbs):
        super().__init__()
        self.fc = nn.Linear(n_a, input_dim, bias=False)
        self.bn = GBN(input_dim, vbs)

    def forward(self, prior, att, rc):
        return sparsemax(self.bn(_linear(self.fc, att, rc), rc) * prior)


class TabNetCore(nn.Module):
    def __init__(self, input_dim, n_d, n_a, n_steps, n_independent, n_shared,
                 vbs):
        super().__init__()
        w = n_d + n_a
        self.initial_bn = BN(input_dim, momentum=0.01)
        shared = [nn.Linear(input_dim if i == 0 else w, 2 * w, bias=False)
                  for i in range(n_shared)]
        self.initial_splitter = FeatTransformer(shared, w, n_independent, vbs)
        self.feat_transformers = nn.ModuleList(
            FeatTransformer(shared, w, n_independent, vbs)
            for _ in range(n_steps))
        self.att_transformers = nn.ModuleList(
            AttentiveTransformer(n_a, input_dim, vbs) for _ in range(n_steps))


class TabNetNoEmbeddings(nn.Module):
    def __init__(self, input_dim, out_dim, n_d, n_a, n_steps, n_independent,
                 n_shared, vbs):
        super().__init__()
        self.encoder = TabNetCore(input_dim, n_d, n_a, n_steps,
                                  n_independent, n_shared, vbs)
        self.final_mapping = nn.Linear(n_d, out_dim, bias=False)


class TabNet(nn.Module):
    """n_d = n_a = out_dim; forward returns the (B, out_dim) latent."""

    def __init__(self, input_dim, out_dim, n_steps=3, gamma=1.5,
                 n_independent=2, n_shared=2, vbs=128, epsilon=1e-15):
        super().__init__()
        self.d, self.n_steps, self.gamma = out_dim, n_steps, gamma
        self.epsilon = epsilon
        self.tabnet = TabNetNoEmbeddings(input_dim, out_dim, out_dim,
                                         out_dim, n_steps, n_independent,
                                         n_shared, vbs)

    def forward(self, x, rc):
        enc, d = self.tabnet.encoder, self.d
        x = enc.initial_bn(x, rc)
        att = enc.initial_splitter(x, rc)[..., d:]
        prior = torch.ones_like(x)
        agg = 0.0
        for step in range(self.n_steps):
            mask = enc.att_transformers[step](prior, att, rc)
            prior = prior * (self.gamma - mask)
            out = enc.feat_transformers[step](mask * x, rc)
            agg = agg + torch.relu(out[..., :d])
            att = out[..., d:]
        return _linear(self.tabnet.final_mapping, agg, rc)


# the fusion model ---------------------------------------------------------

class AttentionFusion(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weights = nn.Parameter(torch.ones(3))
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, img, sig, clin):
        return kernels.attention_fusion(img, sig, clin, self.weights,
                                        self.norm.weight, self.norm.bias,
                                        self.norm.eps)


def variance_loss(img, sig, clin, mask):
    """|v_i - v_s| + |v_i - v_c| + |v_s - v_c|, v the masked batch mean of
    each row's feature variance (ddof 1)."""
    def v(x):
        rows = x.float().var(dim=1, unbiased=True)
        s = mask.sum()
        return (rows * mask).sum() / torch.maximum(s, s.new_ones(()))

    vi, vs, vc = v(img), v(sig), v(clin)
    return (vi - vs).abs() + (vi - vc).abs() + (vs - vc).abs()


class Fusion(nn.Module):
    """The canonical trimodal model: 512 / 128 / 32 features, TabNet
    clinical branch, the attention fusion and a hidden-layer head."""

    def __init__(self, m: dict):
        super().__init__()
        self.dropout_p = m["dropout"]
        self.image_encoder = ResNet18(m["image_dim"])
        self.signal_encoder = ResNet1DSE(m["signal_dim"],
                                         m["signal_input_channels"],
                                         m["signal_base_filters"])
        self.clinical_encoder = TabNet(m["clinical_in_features"],
                                       m["clinical_dim"])
        self.image_norm = nn.LayerNorm(m["image_dim"], eps=1e-5)
        self.signal_norm = nn.LayerNorm(m["signal_dim"], eps=1e-5)
        self.clinical_norm = nn.LayerNorm(m["clinical_dim"], eps=1e-5)
        c = m["num_classes"]
        self.image_classifier = nn.Linear(m["image_dim"], c)
        self.signal_classifier = nn.Linear(m["signal_dim"], c)
        self.clinical_classifier = nn.Linear(m["clinical_dim"], c)
        width = m["image_dim"] + m["signal_dim"] + m["clinical_dim"]
        self.attention_fusion = AttentionFusion(width)
        self.fusion_classifier = nn.Sequential(
            nn.Linear(width, m["fusion_hidden"]), nn.ReLU(), nn.Identity(),
            nn.Linear(m["fusion_hidden"], c))

    def encode(self, image, signal, clinical, rc):
        """The three LayerNorm'd embeddings."""
        ln = nn.functional.layer_norm
        img = self.image_encoder(image, rc)
        sig = self.signal_encoder(signal[:, None, :], rc)
        clin = self.clinical_encoder(clinical, rc)
        return (ln(img, img.shape[-1:], self.image_norm.weight,
                   self.image_norm.bias, 1e-5),
                ln(sig, sig.shape[-1:], self.signal_norm.weight,
                   self.signal_norm.bias, 1e-5),
                ln(clin, clin.shape[-1:], self.clinical_norm.weight,
                   self.clinical_norm.bias, 1e-5))

    def fuse(self, img, sig, clin, rc):
        """Fusion logits from the three embeddings."""
        fused, _ = self.attention_fusion(img, sig, clin)
        hidden, _, _, out = self.fusion_classifier
        h = torch.relu(_linear(hidden, fused, rc))
        return _linear(out, dropout(h, self.dropout_p, rc), rc)

    def loss(self, batch, rc, var_weight: float):
        """CE(fusion logits) + var_weight * the variance loss."""
        img, sig, clin = self.encode(batch["images"], batch["signals"],
                                     batch["clinical"], rc)
        logits = self.fuse(img, sig, clin, rc)
        mask = batch["mask"]
        return (kernels.cross_entropy(logits, batch["labels"], mask)
                + var_weight * variance_loss(img, sig, clin, mask))


# the 1-D Transformer ------------------------------------------------------

class SelfAttention(nn.Module):
    def __init__(self, d, nhead):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, x, rc, p):
        b, t, d = x.shape
        hd = d // self.nhead
        q, k, v = (rc.arith.linear(x, w, bias).view(b, t, self.nhead, hd)
                   .transpose(1, 2)
                   for w, bias in zip(self.in_proj_weight.chunk(3),
                                      self.in_proj_bias.chunk(3)))
        scores = rc.arith.matmul(q / math.sqrt(hd), k.transpose(-1, -2))
        attn = dropout(torch.softmax(scores, dim=-1), p, rc,
                       shape=(1, 1, t, t))
        out = rc.arith.matmul(attn, v).transpose(1, 2).reshape(b, t, d)
        return _linear(self.out_proj, out, rc)


class EncoderLayer(nn.Module):
    """Post-LN: attention, then a ReLU feed-forward, each with dropout and
    a residual before its LayerNorm."""

    def __init__(self, d, nhead, ff, p):
        super().__init__()
        self.p = p
        self.self_attn = SelfAttention(d, nhead)
        self.linear1 = nn.Linear(d, ff)
        self.linear2 = nn.Linear(ff, d)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x, rc):
        a = dropout(self.self_attn(x, rc, self.p), self.p, rc)
        x = self.norm1(x + a)
        h = dropout(torch.relu(_linear(self.linear1, x, rc)), self.p, rc)
        ff = dropout(_linear(self.linear2, h, rc), self.p, rc)
        return self.norm2(x + ff)


class Stack(nn.Module):
    def __init__(self, n, **kw):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(**kw) for _ in range(n))


class Transformer1D(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        d = m["d_model"]
        self.head_p = m["dropout"]
        self.conv = nn.Conv1d(m["input_channels"], d, m["conv_kernel"],
                              padding=m["conv_kernel"] // 2)
        self.pos_embedding = nn.Parameter(torch.zeros(1, m["seq_len"], d))
        self.transformer_encoder = Stack(
            m["num_layers"], d=d, nhead=m["nhead"], ff=m["dim_feedforward"],
            p=m["layer_dropout"])
        self.classifier = nn.Sequential(
            nn.Flatten(), nn.Linear(d, m["head_hidden"]), nn.ReLU(),
            nn.Identity(), nn.Linear(m["head_hidden"], m["num_classes"]))

    def forward(self, x, rc):
        x = _conv1d(self.conv, x[:, None, :], rc).transpose(1, 2)
        x = x + self.pos_embedding[:, :x.shape[1]]
        for layer in self.transformer_encoder.layers:
            x = layer(x, rc)
        h = torch.relu(_linear(self.classifier[1], x.mean(dim=1), rc))
        return _linear(self.classifier[4], dropout(h, self.head_p, rc), rc)

    def loss(self, batch, rc, alpha: float, gamma: float):
        return kernels.focal_loss(self(batch["signals"], rc), batch["labels"],
                                  batch["mask"], alpha, gamma)


def build(kind: str, model: dict, device) -> nn.Module:
    """The reference model of a configuration's `model` group, on
    `device`, with uninitialised weights (the caller loads them)."""
    with torch.device("meta"):
        net = {"fusion": Fusion, "transformer1d": Transformer1D}[kind](model)
    return net.to_empty(device=device)
