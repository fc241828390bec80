"""Flax variables -> the port's state dict.

`from_jax_variables` takes a fusion model's variables tree (`{"params":
..., "batch_stats": ...}` with numpy leaves), canonical (TabNet) or
modal-balance (MLP clinical branch), and returns the state dict that
`ecgmm_torch.models.ECGMultimodalModel` of that variant loads strictly;
every BatchNorm's `batch_stats` become its running-statistics buffers.
It is the port's own copy of the layout rules of the JAX exporters
(`ecgmm_tpu/tools/export_pth.py`): Conv1d (W, I, O) -> (O, I, W), Conv2d
(H, W, I, O) -> (O, I, H, W), Linear (I, O) -> (O, I), BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var plus
`num_batches_tracked`, and the TabNet shared GLU fc weights aliased into
every feature transformer. The standalone models of the pretraining
stages and the other signal models have their own entry points
(`from_jax_resnet1d_se`, `from_jax_resnet18`, `from_jax_clinical_probe`,
`from_jax_crnn`, `from_jax_transformer1d`), and `load_partial` merges
one state dict into another with the warm-start filters of
`ecgmm_tpu/tools/convert_pth.load_partial`.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

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


def _clinical_mlp(b: _Branch) -> None:
    b.linear("0", "fc1")
    b.bn("1", "bn")
    b.linear("4", "fc2")


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


def from_jax_resnet18(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A standalone flax ResNet18's variables (the image-only stage) as
    the state dict of `ecgmm_torch.models.ResNet18`."""
    sd: Dict[str, np.ndarray] = {}
    _resnet18(_Branch(_flatten(variables), sd, "", ""))
    return _tensors(sd)


def from_jax_clinical_probe(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The variables of the JAX clinical stage's `Probe` (`encoder/...`, a
    TabNet or the MLP, and the Dense `probe`) as the state dict of
    `ecgmm_torch.workloads.tasks.ClinicalProbe`."""
    flat = _flatten(variables)
    sd: Dict[str, np.ndarray] = {}
    encoder = _Branch(flat, sd, "encoder", "encoder")
    if encoder.has("fc1/kernel"):
        _clinical_mlp(encoder)
    else:
        _tabnet(_Branch(flat, sd, "encoder", "encoder.tabnet"))
    _Branch(flat, sd, "", "").linear("probe", "probe")
    return _tensors(sd)


def from_jax_crnn(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax CRNN's variables as the state dict of
    `ecgmm_torch.models.CRNN` (the layout of
    `ecgmm_tpu/tools/export_pth.export_crnn`): the per-gate kernels
    stacked in torch's (i, f, g, o) order, the first layer's input columns
    permuted from flax's (F', C) flatten to torch's (C, F'), the one bias
    of each gate as `bias_ih_*` and zeros as `bias_hh_*`."""
    flat = _flatten(variables)
    sd: Dict[str, np.ndarray] = {}
    b = _Branch(flat, sd, "", "")
    for name in ("conv1", "conv2", "conv3"):
        b.put(f"{name}.block.0.weight",
              _conv2d(b.param(f"{name}/conv/kernel")))
        b.put(f"{name}.block.0.bias", b.param(f"{name}/conv/bias"))
        b.bn(f"{name}.block.1", f"{name}/bn")
    c_out = b.param("conv3/conv/kernel").shape[-1]
    in_dim = b.param("bilstm0/OptimizedLSTMCell_0/ii/kernel").shape[0]
    f_out = in_dim // c_out
    # torch column c * F' + f is flax row f * C + c
    torch_to_flax = (np.arange(f_out)[None, :] * c_out
                     + np.arange(c_out)[:, None]).ravel()
    n_layers = len({k.split("/")[1] for k in flat
                    if k.startswith("params/bilstm")})
    for k in range(n_layers):
        for d, cell in enumerate(("OptimizedLSTMCell_0",
                                  "OptimizedLSTMCell_1")):
            sfx = "_reverse" if d else ""
            base = f"bilstm{k}/{cell}"
            w_ih, w_hh, bias = [], [], []
            for g in "ifgo":
                w = b.param(f"{base}/i{g}/kernel")
                if k == 0:
                    w = w[torch_to_flax]
                w_ih.append(w.T)
                w_hh.append(b.param(f"{base}/h{g}/kernel").T)
                bias.append(b.param(f"{base}/h{g}/bias"))
            bias = np.concatenate(bias, 0)
            b.put(f"bilstm.weight_ih_l{k}{sfx}", np.concatenate(w_ih, 0))
            b.put(f"bilstm.weight_hh_l{k}{sfx}", np.concatenate(w_hh, 0))
            b.put(f"bilstm.bias_ih_l{k}{sfx}", bias)
            b.put(f"bilstm.bias_hh_l{k}{sfx}", np.zeros_like(bias))
    b.linear("classifier.0", "head_dense")
    b.linear("classifier.3", "head_out")
    return _tensors(sd)


def from_jax_transformer1d(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ECGTransformer1D's variables as the state dict of
    `ecgmm_torch.models.ECGTransformer1D` (the layout of
    `ecgmm_tpu/tools/export_pth.export_transformer1d`): the per-head q, k,
    v kernels (D, H, hd) packed into `in_proj_weight` (3D, D), the output
    kernel (H, hd, D) as `out_proj.weight` (D, D)."""
    flat = _flatten(variables)
    sd: Dict[str, np.ndarray] = {}
    b = _Branch(flat, sd, "", "")
    b.put("conv.weight", _conv1d(b.param("embed_conv/kernel")))
    b.put("conv.bias", b.param("embed_conv/bias"))
    b.put("pos_embedding", b.param("pos_embedding"))
    layers = sorted({int(k.split("/")[1][len("layer"):]) for k in flat
                     if k.startswith("params/layer")})
    for i in layers:
        src, dst = f"layer{i}", f"transformer_encoder.layers.{i}."
        w, bias = [], []
        for name in ("query", "key", "value"):
            kern = b.param(f"{src}/self_attn/{name}/kernel")  # (D, H, hd)
            d = kern.shape[0]
            w.append(kern.reshape(d, d).T)
            bias.append(b.param(f"{src}/self_attn/{name}/bias").reshape(d))
        b.put(dst + "self_attn.in_proj_weight", np.concatenate(w, 0))
        b.put(dst + "self_attn.in_proj_bias", np.concatenate(bias, 0))
        wo = b.param(f"{src}/self_attn/out/kernel")  # (H, hd, D)
        b.put(dst + "self_attn.out_proj.weight",
              wo.reshape(-1, wo.shape[-1]).T)
        b.put(dst + "self_attn.out_proj.bias",
              b.param(f"{src}/self_attn/out/bias"))
        b.linear(dst + "linear1", f"{src}/ff1")
        b.linear(dst + "linear2", f"{src}/ff2")
        for n in ("norm1", "norm2"):
            b.put(dst + n + ".weight", b.param(f"{src}/{n}/scale"))
            b.put(dst + n + ".bias", b.param(f"{src}/{n}/bias"))
    b.linear("classifier.1", "head_dense")
    b.linear("classifier.4", "head_out")
    return _tensors(sd)


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
    flat = _flatten(variables)
    sd: Dict[str, np.ndarray] = {}
    _resnet18(_Branch(flat, sd, "image_encoder", "image_encoder"))
    _resnet1d_se(_Branch(flat, sd, "signal_encoder", "signal_encoder"))
    clinical = _Branch(flat, sd, "clinical_encoder", "clinical_encoder")
    if clinical.has("fc1/kernel"):
        _clinical_mlp(clinical)
    else:
        _tabnet(_Branch(flat, sd, "clinical_encoder",
                        "clinical_encoder.tabnet"))
    _fusion_tail(flat, sd)
    return _tensors(sd)
