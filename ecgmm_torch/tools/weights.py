"""Flax variables -> the port's state dict.

`from_jax_variables` takes the canonical fusion model's variables tree
(`{"params": ..., "batch_stats": ...}` with numpy leaves) and returns the
state dict that `ecgmm_torch.models.ECGMultimodalModel` loads strictly.
It is the port's own copy of the layout rules of the JAX exporters
(`ecgmm_tpu/tools/export_pth.py`): Conv1d (W, I, O) -> (O, I, W), Conv2d
(H, W, I, O) -> (O, I, H, W), Linear (I, O) -> (O, I), BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var plus
`num_batches_tracked`, and the TabNet shared GLU fc weights aliased into
every feature transformer.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v, dtype=np.float32)
    return out


def _conv1d(w):
    return np.transpose(w, (2, 1, 0))


def _conv2d(w):
    return np.transpose(w, (3, 2, 0, 1))


def _linear(w):
    return np.transpose(w, (1, 0))


class _Branch:
    """Collects one branch's tensors: flax paths under `src`, torch names
    under `dst`. An empty `src` or `dst` is the root (a standalone model)."""

    def __init__(self, flat, sd, src: str, dst: str):
        self.flat, self.sd, self.src, self.dst = flat, sd, src, dst

    def _key(self, collection: str, path: str) -> str:
        return "/".join(p for p in (collection, self.src, path) if p)

    def has(self, path: str) -> bool:
        return self._key("params", path) in self.flat

    def param(self, path: str) -> np.ndarray:
        return self.flat[self._key("params", path)]

    def put(self, name: str, value: np.ndarray) -> None:
        self.sd[f"{self.dst}.{name}" if self.dst else name] = value

    def bn(self, name: str, path: str) -> None:
        self.put(f"{name}.weight", self.param(f"{path}/scale"))
        self.put(f"{name}.bias", self.param(f"{path}/bias"))
        stats = self._key("batch_stats", path)
        self.put(f"{name}.running_mean", self.flat[f"{stats}/mean"])
        self.put(f"{name}.running_var", self.flat[f"{stats}/var"])
        self.put(f"{name}.num_batches_tracked", np.asarray(0, np.int64))

    def linear(self, name: str, path: str, bias: bool = True) -> None:
        self.put(f"{name}.weight", _linear(self.param(f"{path}/kernel")))
        if bias:
            self.put(f"{name}.bias", self.param(f"{path}/bias"))


def _resnet1d_se(b: _Branch) -> None:
    b.put("initial.0.weight", _conv1d(b.param("stem_conv/kernel")))
    b.put("initial.0.bias", b.param("stem_conv/bias"))
    b.bn("initial.1", "stem_bn")
    for layer in ("layer1", "layer2", "layer3"):
        for conv in ("conv1", "conv2"):
            b.put(f"{layer}.{conv}.weight",
                  _conv1d(b.param(f"{layer}/{conv}/kernel")))
            b.put(f"{layer}.{conv}.bias", b.param(f"{layer}/{conv}/bias"))
        for bn in ("bn1", "bn2"):
            b.bn(f"{layer}.{bn}", f"{layer}/{bn}")
        b.linear(f"{layer}.se.fc.0", f"{layer}/se/fc1")
        b.linear(f"{layer}.se.fc.2", f"{layer}/se/fc2")
        if b.has(f"{layer}/downsample_conv/kernel"):
            b.put(f"{layer}.downsample.0.weight",
                  _conv1d(b.param(f"{layer}/downsample_conv/kernel")))
            b.put(f"{layer}.downsample.0.bias",
                  b.param(f"{layer}/downsample_conv/bias"))
            b.bn(f"{layer}.downsample.1", f"{layer}/downsample_bn")
    b.linear("classifier.1", "head_dense")
    b.linear("classifier.4", "head_out")


def _resnet18(b: _Branch) -> None:
    b.put("conv1.weight", _conv2d(b.param("stem_conv/kernel")))
    b.bn("bn1", "stem_bn")
    for stage in range(4):
        for block in range(2):
            t, fl = f"layer{stage + 1}.{block}", f"layer{stage + 1}_{block}"
            for conv in ("conv1", "conv2"):
                b.put(f"{t}.{conv}.weight",
                      _conv2d(b.param(f"{fl}/{conv}/kernel")))
            for bn in ("bn1", "bn2"):
                b.bn(f"{t}.{bn}", f"{fl}/{bn}")
            if b.has(f"{fl}/downsample_conv/kernel"):
                b.put(f"{t}.downsample.0.weight",
                      _conv2d(b.param(f"{fl}/downsample_conv/kernel")))
                b.bn(f"{t}.downsample.1", f"{fl}/downsample_bn")
    b.linear("fc", "fc")


def _tabnet(b: _Branch) -> None:
    prefix = b._key("params", "") + "/"
    n_shared = sum(1 for k in b.flat
                   if k.startswith(prefix + "shared_fc_"))
    n_indep = sum(1 for k in b.flat
                  if k.startswith(prefix + "initial_splitter/indep_")
                  and k.endswith("/fc/kernel"))
    n_steps = sum(1 for k in b.flat if k.startswith(prefix + "att_fc_"))
    b.bn("encoder.initial_bn", "initial_bn")
    transformers = [("initial_splitter", "encoder.initial_splitter")] + [
        (f"feat_{s}", f"encoder.feat_transformers.{s}")
        for s in range(n_steps)
    ]
    for flax_name, torch_name in transformers:
        for i in range(n_shared):
            t = f"{torch_name}.shared.glu_layers.{i}"
            b.linear(f"{t}.fc", f"shared_fc_{i}", bias=False)
            b.bn(f"{t}.bn.bn", f"{flax_name}/shared_glu_{i}/bn")
        for i in range(n_indep):
            t = f"{torch_name}.specifics.glu_layers.{i}"
            b.linear(f"{t}.fc", f"{flax_name}/indep_{i}/fc", bias=False)
            b.bn(f"{t}.bn.bn", f"{flax_name}/indep_{i}/bn")
    for step in range(n_steps):
        t = f"encoder.att_transformers.{step}"
        b.linear(f"{t}.fc", f"att_fc_{step}", bias=False)
        b.bn(f"{t}.bn.bn", f"att_bn_{step}")
    b.linear("final_mapping", "final_mapping", bias=False)


def _fusion_tail(flat, sd) -> None:
    def p(path):
        return flat[f"params/{path}"]

    for branch in ("image", "signal", "clinical"):
        sd[f"{branch}_norm.weight"] = p(f"{branch}_norm/scale")
        sd[f"{branch}_norm.bias"] = p(f"{branch}_norm/bias")
        sd[f"{branch}_classifier.weight"] = _linear(
            p(f"{branch}_classifier/kernel"))
        sd[f"{branch}_classifier.bias"] = p(f"{branch}_classifier/bias")
    sd["attention_fusion.weights"] = p("attention_fusion/weights")
    sd["attention_fusion.norm.weight"] = p("attention_fusion/norm/scale")
    sd["attention_fusion.norm.bias"] = p("attention_fusion/norm/bias")
    sd["fusion_classifier.0.weight"] = _linear(p("fusion_hidden/kernel"))
    sd["fusion_classifier.0.bias"] = p("fusion_hidden/bias")
    sd["fusion_classifier.3.weight"] = _linear(p("fusion_out/kernel"))
    sd["fusion_classifier.3.bias"] = p("fusion_out/bias")


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in sd.items()}


def from_jax_resnet1d_se(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A standalone flax ResNet1DSE's variables (its paths at the root, not
    under `signal_encoder/`) as the state dict of
    `ecgmm_torch.models.ResNet1DSE` (the layout of
    `ecgmm_tpu/tools/export_pth.export_resnet1d_se`)."""
    sd: Dict[str, np.ndarray] = {}
    _resnet1d_se(_Branch(_flatten(variables), sd, "", ""))
    return _tensors(sd)


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The canonical fusion model's flax variables (numpy leaves) as the
    port's state dict, for `ECGMultimodalModel.load_state_dict(...,
    strict=True)`."""
    flat = _flatten(variables)
    sd: Dict[str, np.ndarray] = {}
    _resnet18(_Branch(flat, sd, "image_encoder", "image_encoder"))
    _resnet1d_se(_Branch(flat, sd, "signal_encoder", "signal_encoder"))
    _tabnet(_Branch(flat, sd, "clinical_encoder", "clinical_encoder.tabnet"))
    _fusion_tail(flat, sd)
    return _tensors(sd)
