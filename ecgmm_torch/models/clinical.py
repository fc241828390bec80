"""Clinical tabular encoders (port of `ecgmm_tpu/models/clinical.py`).

  * TabNetEncoder, the canonical branch. Parameter names follow
    pytorch_tabnet's TabNetNoEmbeddings under a `tabnet.` prefix (the
    reference's ClinicalTabNetEncoder, multimodal.py:109-148):
    `tabnet.encoder.initial_bn`, `tabnet.encoder.{initial_splitter,
    feat_transformers.N}.{shared,specifics}.glu_layers.N.{fc,bn.bn}`,
    `tabnet.encoder.att_transformers.N.{fc,bn.bn}` and
    `tabnet.final_mapping`. The shared GLU Linear layers are one module
    object registered in every transformer, so their weights alias as in
    the reference state dict.
  * ClinicalMLPEncoder, the modal-balance branch (reference
    multimodal_paper_modal_balance.py:256-263): a Sequential whose state
    dict keys are `0.*` (fc1), `1.*` (BatchNorm) and `4.*` (fc2).

Train mode follows flax (`models/layers.py`). TabNet's GLU and attentive
BatchNorms are ghost BatchNorms (pytorch_tabnet's GBN): in training the
batch is cut into virtual batches of at most `virtual_batch_size` rows as
torch.chunk cuts it (greedily: every chunk ceil(B/n) rows, n =
ceil(B/virtual_batch_size), the last one shorter), each chunk normalised
with its own statistics through the one BatchNorm, which updates its
running statistics once per chunk (momentum 0.02, folding the biased
variance, flax's convention: PARITY.md's TabNet row). A batch of at most
`virtual_batch_size` rows is one chunk. The input BatchNorm `initial_bn`
is plain (momentum 0.01).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ecgmm_torch.models.layers import BatchNorm1d, Dropout


def sparsemax(z, dim: int = -1):
    """Euclidean projection of z onto the probability simplex (Martins &
    Astudillo 2016), as `ecgmm_tpu.models.clinical.sparsemax`. The last
    step is torch.maximum against a zero tensor: at z == tau its VJP gives
    each side half, as jnp.maximum's does (torch.clamp passes it all)."""
    z = z.transpose(dim, -1)
    k = z.shape[-1]
    z_sorted = torch.sort(z, dim=-1, descending=True).values
    z_cumsum = torch.cumsum(z_sorted, dim=-1)
    ks = torch.arange(1, k + 1, dtype=z.dtype, device=z.device)
    support = 1.0 + ks * z_sorted > z_cumsum
    k_z = support.sum(dim=-1, keepdim=True)
    tau_sum = torch.gather(z_cumsum, -1, k_z - 1)
    tau = (tau_sum - 1.0) / k_z.to(z.dtype)
    return torch.maximum(z - tau, z.new_zeros(())).transpose(dim, -1)


class _GBN(nn.Module):
    """Ghost BatchNorm (pytorch_tabnet GBN: the BN lives at `.bn`). In
    training, each torch.chunk virtual batch goes through `bn` in turn."""

    def __init__(self, dim: int, virtual_batch_size: int,
                 momentum: float = 0.02):
        super().__init__()
        self.virtual_batch_size = virtual_batch_size
        self.bn = BatchNorm1d(dim, momentum=momentum)

    def forward(self, x):
        b = x.shape[0]
        if not self.training or b <= self.virtual_batch_size:
            return self.bn(x)
        n_chunks = -(-b // self.virtual_batch_size)
        return torch.cat([self.bn(c) for c in x.chunk(n_chunks, 0)], 0)


class _GLULayer(nn.Module):
    def __init__(self, fc: nn.Linear, out_dim: int, vbs: int):
        super().__init__()
        self.out_dim = out_dim
        self.fc = fc
        self.bn = _GBN(2 * out_dim, vbs)

    def forward(self, x):
        x = self.bn(self.fc(x))
        return x[..., :self.out_dim] * torch.sigmoid(x[..., self.out_dim:])


class _GLUBlock(nn.Module):
    """GLU layers with sqrt(0.5)-scaled residuals; the first layer of the
    shared block takes no residual (its input width differs)."""

    def __init__(self, fcs, out_dim: int, first: bool, vbs: int):
        super().__init__()
        self.first = first
        self.glu_layers = nn.ModuleList(_GLULayer(fc, out_dim, vbs)
                                        for fc in fcs)

    def forward(self, x):
        scale = math.sqrt(0.5)
        for i, layer in enumerate(self.glu_layers):
            h = layer(x)
            x = h if (self.first and i == 0) else (x + h) * scale
        return x


class _FeatTransformer(nn.Module):
    def __init__(self, shared_fcs, out_dim: int, n_independent: int,
                 vbs: int):
        super().__init__()
        self.shared = _GLUBlock(shared_fcs, out_dim, first=True, vbs=vbs)
        self.specifics = _GLUBlock(
            [nn.Linear(out_dim, 2 * out_dim, bias=False)
             for _ in range(n_independent)],
            out_dim, first=False, vbs=vbs,
        )

    def forward(self, x):
        return self.specifics(self.shared(x))


class _AttentiveTransformer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, vbs: int):
        super().__init__()
        self.fc = nn.Linear(in_dim, out_dim, bias=False)
        self.bn = _GBN(out_dim, vbs)

    def forward(self, prior, att):
        return sparsemax(self.bn(self.fc(att)) * prior)


class _TabNetCore(nn.Module):
    def __init__(self, input_dim, n_d, n_a, n_steps, n_independent,
                 n_shared, vbs):
        super().__init__()
        w = n_d + n_a
        self.initial_bn = BatchNorm1d(input_dim, momentum=0.01)
        shared = [nn.Linear(input_dim if i == 0 else w, 2 * w, bias=False)
                  for i in range(n_shared)]
        self.initial_splitter = _FeatTransformer(shared, w, n_independent,
                                                 vbs)
        self.feat_transformers = nn.ModuleList(
            _FeatTransformer(shared, w, n_independent, vbs)
            for _ in range(n_steps)
        )
        self.att_transformers = nn.ModuleList(
            _AttentiveTransformer(n_a, input_dim, vbs)
            for _ in range(n_steps)
        )


class _TabNetNoEmbeddings(nn.Module):
    def __init__(self, input_dim, out_dim, n_d, n_a, n_steps, n_independent,
                 n_shared, vbs):
        super().__init__()
        self.encoder = _TabNetCore(input_dim, n_d, n_a, n_steps,
                                   n_independent, n_shared, vbs)
        self.final_mapping = nn.Linear(n_d, out_dim, bias=False)


class TabNetEncoder(nn.Module):
    """TabNet with attentive sparse feature selection (n_d = n_a = out_dim,
    3 steps, gamma 1.5, 2 shared + 2 independent GLU layers, ghost
    BatchNorm over virtual batches of `virtual_batch_size` rows, 128 as
    pytorch_tabnet's default). forward returns (latent (B, out_dim) f32,
    m_loss scalar)."""

    def __init__(self, input_dim: int, out_dim: int = 32, n_steps: int = 3,
                 gamma: float = 1.5, n_independent: int = 2,
                 n_shared: int = 2, epsilon: float = 1e-15,
                 virtual_batch_size: int = 128):
        super().__init__()
        self.n_d = self.n_a = out_dim
        self.n_steps = n_steps
        self.gamma = gamma
        self.epsilon = epsilon
        self.tabnet = _TabNetNoEmbeddings(input_dim, out_dim, out_dim,
                                          out_dim, n_steps, n_independent,
                                          n_shared, virtual_batch_size)

    def forward(self, x):
        enc = self.tabnet.encoder
        d = self.n_d
        x = enc.initial_bn(x)
        att = enc.initial_splitter(x)[..., d:]
        prior = torch.ones_like(x)
        m_loss = x.new_zeros(())
        agg_d = None
        for step in range(self.n_steps):
            mask = enc.att_transformers[step](prior, att)
            m_loss = m_loss + torch.mean(
                torch.sum(-mask * torch.log(mask + self.epsilon), dim=-1)
            )
            prior = prior * (self.gamma - mask)
            out = enc.feat_transformers[step](mask * x)
            step_d = torch.relu(out[..., :d])
            agg_d = step_d if agg_d is None else agg_d + step_d
            att = out[..., d:]
        latent = self.tabnet.final_mapping(agg_d).float()
        return latent, m_loss / self.n_steps


class ClinicalMLPEncoder(nn.Sequential):
    """The modal-balance clinical branch: Linear(in -> hidden), BatchNorm,
    ReLU, Dropout (0.3, the JAX module's fixed default; from the explicit
    generator), Linear(hidden -> out). forward returns (B, out_dim)."""

    def __init__(self, input_dim: int, out_dim: int = 256, hidden: int = 64,
                 dropout: float = 0.3):
        super().__init__(
            nn.Linear(input_dim, hidden), BatchNorm1d(hidden), nn.ReLU(),
            Dropout(dropout), nn.Linear(hidden, out_dim),
        )
