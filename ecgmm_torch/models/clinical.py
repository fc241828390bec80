"""TabNet clinical encoder, eval mode (port of the TabNet half of
`ecgmm_tpu/models/clinical.py`).

Parameter names follow pytorch_tabnet's TabNetNoEmbeddings under a
`tabnet.` prefix (the reference's ClinicalTabNetEncoder,
multimodal.py:109-148): `tabnet.encoder.initial_bn`,
`tabnet.encoder.{initial_splitter,feat_transformers.N}.{shared,specifics}
.glu_layers.N.{fc,bn.bn}`, `tabnet.encoder.att_transformers.N.{fc,bn.bn}`
and `tabnet.final_mapping`. The shared GLU Linear layers are one module
object registered in every transformer, so their weights alias as in the
reference state dict.

Only the eval forward is ported: ghost BatchNorm runs on its running
statistics. Training mode (ghost BN over virtual batches) belongs to the
training slice and raises until then.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_TRAIN_WAITS = (
    "TabNet training mode (ghost BatchNorm over virtual batches) is not "
    "ported yet: ROADMAP.md section 1, fusion training"
)


def sparsemax(z, dim: int = -1):
    """Euclidean projection of z onto the probability simplex (Martins &
    Astudillo 2016), as `ecgmm_tpu.models.clinical.sparsemax`."""
    z = z.transpose(dim, -1)
    k = z.shape[-1]
    z_sorted = torch.sort(z, dim=-1, descending=True).values
    z_cumsum = torch.cumsum(z_sorted, dim=-1)
    ks = torch.arange(1, k + 1, dtype=z.dtype, device=z.device)
    support = 1.0 + ks * z_sorted > z_cumsum
    k_z = support.sum(dim=-1, keepdim=True)
    tau_sum = torch.gather(z_cumsum, -1, k_z - 1)
    tau = (tau_sum - 1.0) / k_z.to(z.dtype)
    return torch.clamp(z - tau, min=0.0).transpose(dim, -1)


class _GBN(nn.Module):
    """Ghost BatchNorm holder (pytorch_tabnet GBN: the BN lives at `.bn`)."""

    def __init__(self, dim: int, momentum: float = 0.02):
        super().__init__()
        self.bn = nn.BatchNorm1d(dim, momentum=momentum)

    def forward(self, x):
        if self.training:
            raise NotImplementedError(_TRAIN_WAITS)
        return self.bn(x)


class _GLULayer(nn.Module):
    def __init__(self, fc: nn.Linear, out_dim: int):
        super().__init__()
        self.out_dim = out_dim
        self.fc = fc
        self.bn = _GBN(2 * out_dim)

    def forward(self, x):
        x = self.bn(self.fc(x))
        return x[..., :self.out_dim] * torch.sigmoid(x[..., self.out_dim:])


class _GLUBlock(nn.Module):
    """GLU layers with sqrt(0.5)-scaled residuals; the first layer of the
    shared block takes no residual (its input width differs)."""

    def __init__(self, fcs, out_dim: int, first: bool):
        super().__init__()
        self.first = first
        self.glu_layers = nn.ModuleList(_GLULayer(fc, out_dim) for fc in fcs)

    def forward(self, x):
        scale = math.sqrt(0.5)
        for i, layer in enumerate(self.glu_layers):
            h = layer(x)
            x = h if (self.first and i == 0) else (x + h) * scale
        return x


class _FeatTransformer(nn.Module):
    def __init__(self, shared_fcs, out_dim: int, n_independent: int):
        super().__init__()
        self.shared = _GLUBlock(shared_fcs, out_dim, first=True)
        self.specifics = _GLUBlock(
            [nn.Linear(out_dim, 2 * out_dim, bias=False)
             for _ in range(n_independent)],
            out_dim, first=False,
        )

    def forward(self, x):
        return self.specifics(self.shared(x))


class _AttentiveTransformer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc = nn.Linear(in_dim, out_dim, bias=False)
        self.bn = _GBN(out_dim)

    def forward(self, prior, att):
        return sparsemax(self.bn(self.fc(att)) * prior)


class _TabNetCore(nn.Module):
    def __init__(self, input_dim, n_d, n_a, n_steps, n_independent,
                 n_shared):
        super().__init__()
        w = n_d + n_a
        self.initial_bn = nn.BatchNorm1d(input_dim, momentum=0.01)
        shared = [nn.Linear(input_dim if i == 0 else w, 2 * w, bias=False)
                  for i in range(n_shared)]
        self.initial_splitter = _FeatTransformer(shared, w, n_independent)
        self.feat_transformers = nn.ModuleList(
            _FeatTransformer(shared, w, n_independent)
            for _ in range(n_steps)
        )
        self.att_transformers = nn.ModuleList(
            _AttentiveTransformer(n_a, input_dim) for _ in range(n_steps)
        )


class _TabNetNoEmbeddings(nn.Module):
    def __init__(self, input_dim, out_dim, n_d, n_a, n_steps, n_independent,
                 n_shared):
        super().__init__()
        self.encoder = _TabNetCore(input_dim, n_d, n_a, n_steps,
                                   n_independent, n_shared)
        self.final_mapping = nn.Linear(n_d, out_dim, bias=False)


class TabNetEncoder(nn.Module):
    """TabNet with attentive sparse feature selection (n_d = n_a = out_dim,
    3 steps, gamma 1.5, 2 shared + 2 independent GLU layers). forward
    returns (latent (B, out_dim) f32, m_loss scalar)."""

    def __init__(self, input_dim: int, out_dim: int = 32, n_steps: int = 3,
                 gamma: float = 1.5, n_independent: int = 2,
                 n_shared: int = 2, epsilon: float = 1e-15):
        super().__init__()
        self.n_d = self.n_a = out_dim
        self.n_steps = n_steps
        self.gamma = gamma
        self.epsilon = epsilon
        self.tabnet = _TabNetNoEmbeddings(input_dim, out_dim, out_dim,
                                          out_dim, n_steps, n_independent,
                                          n_shared)

    def forward(self, x):
        if self.training:
            raise NotImplementedError(_TRAIN_WAITS)
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
