"""Flax variables -> the port's state dict.

`from_jax_variables` takes a fusion model's variables tree (`{"params":
..., "batch_stats": ...}` with numpy leaves), canonical (TabNet) or
modal-balance (MLP clinical branch), and returns the state dict that
`ecgmm_torch.models.ECGMultimodalModel` of that variant loads strictly;
every BatchNorm's `batch_stats` become its running-statistics buffers.
The layout rules are `tools/export_pth.py`'s exporters (the port's copy
of `ecgmm_tpu/tools/export_pth.py`): the port's modules keep the
reference's state-dict layout, so the reference-format export IS the
port's state dict, and these functions only make tensors of it. The
standalone models of the pretraining stages and the other signal models
have their own entry points (`from_jax_resnet1d_se`, `from_jax_resnet18`,
`from_jax_clinical_probe`, `from_jax_crnn`, `from_jax_transformer1d`),
and `load_partial` merges one state dict into another with the
warm-start filters of `ecgmm_tpu/tools/convert_pth.load_partial`.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch

from ecgmm_torch.tools import export_pth


def _tensors(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in sd.items()}


def from_jax_resnet1d_se(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A standalone flax ResNet1DSE's variables (its paths at the root, not
    under `signal_encoder/`) as the state dict of
    `ecgmm_torch.models.ResNet1DSE`."""
    return _tensors(export_pth.export_resnet1d_se(variables))


def from_jax_resnet18(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A standalone flax ResNet18's variables (the image-only stage) as
    the state dict of `ecgmm_torch.models.ResNet18`."""
    return _tensors(export_pth.export_resnet18(variables))


def from_jax_clinical_probe(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The variables of the JAX clinical stage's `Probe` (`encoder/...`, a
    TabNet or the MLP, and the Dense `probe`) as the state dict of
    `ecgmm_torch.workloads.tasks.ClinicalProbe`."""
    encoder = export_pth.subtree(variables, "encoder")
    if "fc1" in encoder["params"]:
        sd = export_pth.prefixed(export_pth.export_clinical_mlp(encoder),
                                 "encoder")
    else:
        sd = export_pth.prefixed(export_pth.export_tabnet(encoder),
                                 "encoder.tabnet")
    probe = variables["params"]["probe"]
    sd["probe.weight"] = np.asarray(probe["kernel"], np.float32).T
    sd["probe.bias"] = np.asarray(probe["bias"], np.float32)
    return _tensors(sd)


def from_jax_crnn(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax CRNN's variables as the state dict of
    `ecgmm_torch.models.CRNN` (the fused gate bias as `bias_ih_*`, zeros
    as `bias_hh_*`)."""
    return _tensors(export_pth.export_crnn(variables))


def from_jax_transformer1d(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ECGTransformer1D's variables as the state dict of
    `ecgmm_torch.models.ECGTransformer1D`."""
    return _tensors(export_pth.export_transformer1d(variables))


def load_partial(target: Mapping[str, torch.Tensor],
                 source: Mapping[str, torch.Tensor],
                 exclude_prefixes: Iterable[str] = ()
                 ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """`target` with every entry of `source` copied in (cast to the
    target's dtype), except those whose name starts with one of
    `exclude_prefixes`, is not in `target` or has another shape: the
    reference's warm start (strict=False plus explicit filters). Returns
    (merged, the names skipped)."""
    merged = dict(target)
    skipped = []
    for k, v in source.items():
        if (k.startswith(tuple(exclude_prefixes)) or k not in merged
                or merged[k].shape != v.shape):
            skipped.append(k)
            continue
        merged[k] = v.to(merged[k].dtype)
    return merged, skipped


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A fusion model's flax variables (numpy leaves) as the port's state
    dict, for `ECGMultimodalModel.load_state_dict(..., strict=True)`: the
    layout of `export_fusion_modal_balance` where the clinical branch is
    the MLP (it has `fc1`), else of `export_fusion_canonical`."""
    if "fc1" in variables["params"]["clinical_encoder"]:
        return _tensors(export_pth.export_fusion_modal_balance(variables))
    return _tensors(export_pth.export_fusion_canonical(variables))
