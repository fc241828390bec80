"""Reverse conversion: flax variable trees → reference-format torch
state dicts (the port's copy of `ecgmm_tpu/tools/export_pth.py`, numpy
only).

`tools/convert_pth.py` makes checkpoint interop one-way (reference
`.pth` → this framework); this module closes the loop, so a model
trained HERE can be consumed by the reference's own eval/XAI scripts —
e.g. `reference/evaluation_signal.py:176` (loads `best.pth` into
ResNet1D_SE) or `reference/shap_fusion_modal_balance.py:100-102`
(loads a fusion state dict). Every exporter is the exact inverse of the
corresponding `convert_pth` importer: same key families, inverse layout
transposes (Conv1d (W,I,O)→(O,I,W); Conv2d (H,W,I,O)→(O,I,H,W); Linear
(I,O)→(O,I)); BatchNorm scale/bias→weight/bias with batch_stats
mean/var→running_mean/running_var plus the `num_batches_tracked`
buffer torch's strict `load_state_dict` requires (emitted as 0 — torch
only consults it when momentum=None, which no reference model uses).

Two exporters are lossless-in-behavior rather than lossless-in-bytes:
  * CRNN: flax OptimizedLSTMCell keeps ONE bias per gate where torch
    LSTM keeps two (`bias_ih` + `bias_hh`, always summed in the cell
    equations — torch nn.LSTM docs). Export emits the fused bias as
    `bias_ih_*` and zeros for `bias_hh_*`: bit-different from the
    original split, bit-identical in every forward.
  * TabNet: the shared GLU Linear weights exist once here
    (`shared_fc_{i}`) but alias into EVERY transformer's
    `shared.glu_layers.{i}.fc.weight` path in the torch state dict
    (pytorch_tabnet keeps shared Linear objects); export emits the
    same tensor at each alias, exactly as `torch.Module.state_dict()`
    on the reference model does.

The port's modules keep the reference's state-dict layout, so these
exporters are also the port's only flax -> state-dict mapping:
`tools/weights.py` turns their arrays into tensors.

Round-trip gates live in tests/test_export_pth.py: torch-replica
state dict → convert → export is bit-exact on every tensor, and a
natively-initialized/trained JAX model exported and strict-loaded into
the torch replicas reproduces logits to the same tolerance the import
direction meets.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from ecgmm_torch.tools.convert_pth import flatten_path_dict


def _flat(variables: Mapping) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v, dtype=np.float32) if np.asarray(v).dtype
            != np.float32 else np.asarray(v)
            for k, v in flatten_path_dict(variables).items()}


def _inv_conv1d(w):
    return np.transpose(w, (2, 1, 0))


def _inv_conv2d(w):
    return np.transpose(w, (3, 2, 0, 1))


def _inv_linear(w):
    return np.transpose(w, (1, 0))


def _take_bn(out: Dict[str, np.ndarray], torch_prefix: str,
             f: Mapping[str, np.ndarray], flax_name: str) -> None:
    out[f"{torch_prefix}.weight"] = f[f"params/{flax_name}/scale"]
    out[f"{torch_prefix}.bias"] = f[f"params/{flax_name}/bias"]
    out[f"{torch_prefix}.running_mean"] = f[f"batch_stats/{flax_name}/mean"]
    out[f"{torch_prefix}.running_var"] = f[f"batch_stats/{flax_name}/var"]
    out[f"{torch_prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def export_resnet1d_se(variables: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of convert_pth.convert_resnet1d_se: Flax ResNet1DSE
    variables → the reference's `initial.0/layer{1..3}/classifier`
    layout (`reference/signal_model.py:59-88`)."""
    f = _flat(variables)
    sd: Dict[str, np.ndarray] = {}

    sd["initial.0.weight"] = _inv_conv1d(f["params/stem_conv/kernel"])
    sd["initial.0.bias"] = f["params/stem_conv/bias"]
    _take_bn(sd, "initial.1", f, "stem_bn")

    for layer in ("layer1", "layer2", "layer3"):
        for conv in ("conv1", "conv2"):
            sd[f"{layer}.{conv}.weight"] = _inv_conv1d(
                f[f"params/{layer}/{conv}/kernel"]
            )
            sd[f"{layer}.{conv}.bias"] = f[f"params/{layer}/{conv}/bias"]
        for bn in ("bn1", "bn2"):
            _take_bn(sd, f"{layer}.{bn}", f, f"{layer}/{bn}")
        sd[f"{layer}.se.fc.0.weight"] = _inv_linear(
            f[f"params/{layer}/se/fc1/kernel"]
        )
        sd[f"{layer}.se.fc.0.bias"] = f[f"params/{layer}/se/fc1/bias"]
        sd[f"{layer}.se.fc.2.weight"] = _inv_linear(
            f[f"params/{layer}/se/fc2/kernel"]
        )
        sd[f"{layer}.se.fc.2.bias"] = f[f"params/{layer}/se/fc2/bias"]
        if f"params/{layer}/downsample_conv/kernel" in f:
            sd[f"{layer}.downsample.0.weight"] = _inv_conv1d(
                f[f"params/{layer}/downsample_conv/kernel"]
            )
            sd[f"{layer}.downsample.0.bias"] = f[
                f"params/{layer}/downsample_conv/bias"
            ]
            _take_bn(sd, f"{layer}.downsample.1", f, f"{layer}/downsample_bn")

    if "params/head_dense/kernel" in f:
        sd["classifier.1.weight"] = _inv_linear(f["params/head_dense/kernel"])
        sd["classifier.1.bias"] = f["params/head_dense/bias"]
    if "params/head_out/kernel" in f:
        sd["classifier.4.weight"] = _inv_linear(f["params/head_out/kernel"])
        sd["classifier.4.bias"] = f["params/head_out/bias"]
    return sd


def export_resnet18(variables: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of convert_pth.convert_resnet18: Flax ResNet18 variables →
    the torchvision layout (`reference/multimodal.py:346-358`).
    The space-to-depth stem evaluation is a compute-time transform only;
    the stored `stem_conv/kernel` is the plain 7×7 kernel
    (models/resnet18.py StemConv), so the export is exact."""
    f = _flat(variables)
    sd: Dict[str, np.ndarray] = {}

    sd["conv1.weight"] = _inv_conv2d(f["params/stem_conv/kernel"])
    _take_bn(sd, "bn1", f, "stem_bn")

    for stage in range(4):
        for block in range(2):
            t = f"layer{stage + 1}.{block}"
            fl = f"layer{stage + 1}_{block}"
            for conv in ("conv1", "conv2"):
                sd[f"{t}.{conv}.weight"] = _inv_conv2d(
                    f[f"params/{fl}/{conv}/kernel"]
                )
            for bn in ("bn1", "bn2"):
                _take_bn(sd, f"{t}.{bn}", f, f"{fl}/{bn}")
            if f"params/{fl}/downsample_conv/kernel" in f:
                sd[f"{t}.downsample.0.weight"] = _inv_conv2d(
                    f[f"params/{fl}/downsample_conv/kernel"]
                )
                _take_bn(sd, f"{t}.downsample.1", f, f"{fl}/downsample_bn")

    if "params/fc/kernel" in f:
        sd["fc.weight"] = _inv_linear(f["params/fc/kernel"])
        sd["fc.bias"] = f["params/fc/bias"]
    return sd


def export_clinical_mlp(variables: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of convert_pth.convert_clinical_mlp (reference
    multimodal_paper_modal_balance.py:256-263 Sequential layout)."""
    f = _flat(variables)
    sd: Dict[str, np.ndarray] = {}
    sd["0.weight"] = _inv_linear(f["params/fc1/kernel"])
    sd["0.bias"] = f["params/fc1/bias"]
    _take_bn(sd, "1", f, "bn")
    sd["4.weight"] = _inv_linear(f["params/fc2/kernel"])
    sd["4.bias"] = f["params/fc2/bias"]
    return sd


def export_tabnet(variables: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of convert_pth.convert_tabnet: Flax TabNetEncoder →
    pytorch_tabnet TabNetNoEmbeddings layout (the reference's clinical
    branch, `reference/multimodal.py:109-148`), bare (no
    `tabnet.` wrapper prefix — the fusion exporter adds it).

    The shared GLU fc weights alias into every transformer path, as
    `Module.state_dict()` does on the reference model. pytorch_tabnet
    v4's `encoder.group_attention_matrix` identity buffer is NOT
    emitted (the importer ignores it); a strict v4 library load should
    add it or pass strict=False."""
    f = _flat(variables)
    sd: Dict[str, np.ndarray] = {}

    n_shared = len({k for k in f
                    if k.startswith("params/shared_fc_")})
    n_indep = len({k for k in f
                   if k.startswith("params/initial_splitter/indep_")
                   and k.endswith("/fc/kernel")})
    n_steps = len({k for k in f if k.startswith("params/att_fc_")})

    _take_bn(sd, "encoder.initial_bn", f, "initial_bn")

    transformers = [("initial_splitter", "encoder.initial_splitter")] + [
        (f"feat_{s}", f"encoder.feat_transformers.{s}")
        for s in range(n_steps)
    ]
    for flax_name, torch_name in transformers:
        for i in range(n_shared):
            t = f"{torch_name}.shared.glu_layers.{i}"
            sd[f"{t}.fc.weight"] = _inv_linear(
                f[f"params/shared_fc_{i}/kernel"]
            )
            _take_bn(sd, f"{t}.bn.bn", f, f"{flax_name}/shared_glu_{i}/bn")
        for i in range(n_indep):
            t = f"{torch_name}.specifics.glu_layers.{i}"
            sd[f"{t}.fc.weight"] = _inv_linear(
                f[f"params/{flax_name}/indep_{i}/fc/kernel"]
            )
            _take_bn(sd, f"{t}.bn.bn", f, f"{flax_name}/indep_{i}/bn")

    for step in range(n_steps):
        t = f"encoder.att_transformers.{step}"
        sd[f"{t}.fc.weight"] = _inv_linear(f[f"params/att_fc_{step}/kernel"])
        _take_bn(sd, f"{t}.bn.bn", f, f"att_bn_{step}")

    sd["final_mapping.weight"] = _inv_linear(f["params/final_mapping/kernel"])
    return sd


def export_crnn(variables: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of convert_pth.convert_crnn (reference
    `reference/train_physionet2.py:55-96` layout). The fused
    per-gate bias is emitted as `bias_ih_*` with zero `bias_hh_*`
    (behaviorally identical — torch always sums them); the layer-0
    input columns are permuted back from the NHWC feature-major flatten
    to torch's channel-major flatten."""
    f = _flat(variables)
    sd: Dict[str, np.ndarray] = {}

    for name in ("conv1", "conv2", "conv3"):
        sd[f"{name}.block.0.weight"] = _inv_conv2d(
            f[f"params/{name}/conv/kernel"]
        )
        sd[f"{name}.block.0.bias"] = f[f"params/{name}/conv/bias"]
        _take_bn(sd, f"{name}.block.1", f, f"{name}/bn")

    c_out = f["params/conv3/conv/kernel"].shape[-1]
    in_dim = f["params/bilstm0/OptimizedLSTMCell_0/ii/kernel"].shape[0]
    f_out = in_dim // c_out
    # convert_pth: flax row f·C+c ← torch row c·F′+f; invert it
    perm = (np.arange(f_out)[:, None] + f_out * np.arange(c_out)).ravel()
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(in_dim)

    n_layers = len({k.split("/")[1] for k in f
                    if k.startswith("params/bilstm")})
    gates = ("i", "f", "g", "o")
    for k in range(n_layers):
        for d, cell in enumerate(
            ("OptimizedLSTMCell_0", "OptimizedLSTMCell_1")
        ):
            sfx = "_reverse" if d else ""
            base = f"params/bilstm{k}/{cell}"
            wih_rows, whh_rows, bias_rows = [], [], []
            for g in gates:
                win = f[f"{base}/i{g}/kernel"]
                if k == 0:
                    win = win[inv_perm]
                wih_rows.append(win.T)
                whh_rows.append(f[f"{base}/h{g}/kernel"].T)
                bias_rows.append(f[f"{base}/h{g}/bias"])
            sd[f"bilstm.weight_ih_l{k}{sfx}"] = np.concatenate(wih_rows, 0)
            sd[f"bilstm.weight_hh_l{k}{sfx}"] = np.concatenate(whh_rows, 0)
            bias = np.concatenate(bias_rows, 0)
            sd[f"bilstm.bias_ih_l{k}{sfx}"] = bias
            sd[f"bilstm.bias_hh_l{k}{sfx}"] = np.zeros_like(bias)

    sd["classifier.0.weight"] = _inv_linear(f["params/head_dense/kernel"])
    sd["classifier.0.bias"] = f["params/head_dense/bias"]
    sd["classifier.3.weight"] = _inv_linear(f["params/head_out/kernel"])
    sd["classifier.3.bias"] = f["params/head_out/bias"]
    return sd


def export_transformer1d(variables: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of convert_pth.convert_transformer1d (reference
    `reference/train_physionet.py:211-239` layout). The per-head
    q/k/v kernels reassemble into the packed (3D, D) `in_proj_weight`;
    the head count is read from the kernel shape, so no nhead argument
    is needed in this direction."""
    f = _flat(variables)
    sd: Dict[str, np.ndarray] = {}

    sd["conv.weight"] = _inv_conv1d(f["params/embed_conv/kernel"])
    sd["conv.bias"] = f["params/embed_conv/bias"]
    sd["pos_embedding"] = f["params/pos_embedding"]

    layers = sorted({
        int(k.split("/")[1][len("layer"):]) for k in f
        if k.startswith("params/layer")
    })
    for i in layers:
        base = f"params/layer{i}"
        pre = f"transformer_encoder.layers.{i}."
        w_parts, b_parts = [], []
        for name in ("query", "key", "value"):
            w = f[f"{base}/self_attn/{name}/kernel"]  # (D, H, hd)
            d_model = w.shape[0]
            w_parts.append(w.reshape(d_model, d_model).T)
            b_parts.append(
                f[f"{base}/self_attn/{name}/bias"].reshape(d_model)
            )
        sd[pre + "self_attn.in_proj_weight"] = np.concatenate(w_parts, 0)
        sd[pre + "self_attn.in_proj_bias"] = np.concatenate(b_parts, 0)
        wo = f[f"{base}/self_attn/out/kernel"]  # (H, hd, D)
        sd[pre + "self_attn.out_proj.weight"] = wo.reshape(
            -1, wo.shape[-1]
        ).T
        sd[pre + "self_attn.out_proj.bias"] = f[f"{base}/self_attn/out/bias"]
        sd[pre + "linear1.weight"] = _inv_linear(f[f"{base}/ff1/kernel"])
        sd[pre + "linear1.bias"] = f[f"{base}/ff1/bias"]
        sd[pre + "linear2.weight"] = _inv_linear(f[f"{base}/ff2/kernel"])
        sd[pre + "linear2.bias"] = f[f"{base}/ff2/bias"]
        for n in ("norm1", "norm2"):
            sd[pre + n + ".weight"] = f[f"{base}/{n}/scale"]
            sd[pre + n + ".bias"] = f[f"{base}/{n}/bias"]

    sd["classifier.1.weight"] = _inv_linear(f["params/head_dense/kernel"])
    sd["classifier.1.bias"] = f["params/head_dense/bias"]
    sd["classifier.4.weight"] = _inv_linear(f["params/head_out/kernel"])
    sd["classifier.4.bias"] = f["params/head_out/bias"]
    return sd


def subtree(variables: Mapping, branch: str) -> Dict:
    out = {}
    if branch in variables.get("params", {}):
        out["params"] = variables["params"][branch]
    stats = variables.get("batch_stats", {})
    if branch in stats:
        out["batch_stats"] = stats[branch]
    return out


def prefixed(sd: Mapping[str, np.ndarray], prefix: str
             ) -> Dict[str, np.ndarray]:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def _export_fusion_tail(variables: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of convert_pth._convert_fusion_tail (the post-encoder
    surface shared by both fusion variants, multimodal.py:389-415)."""
    p = variables["params"]
    sd: Dict[str, np.ndarray] = {}
    for branch in ("image", "signal", "clinical"):
        sd[f"{branch}_norm.weight"] = np.asarray(
            p[f"{branch}_norm"]["scale"], np.float32
        )
        sd[f"{branch}_norm.bias"] = np.asarray(
            p[f"{branch}_norm"]["bias"], np.float32
        )
        sd[f"{branch}_classifier.weight"] = _inv_linear(np.asarray(
            p[f"{branch}_classifier"]["kernel"], np.float32
        ))
        sd[f"{branch}_classifier.bias"] = np.asarray(
            p[f"{branch}_classifier"]["bias"], np.float32
        )
    sd["attention_fusion.weights"] = np.asarray(
        p["attention_fusion"]["weights"], np.float32
    )
    sd["attention_fusion.norm.weight"] = np.asarray(
        p["attention_fusion"]["norm"]["scale"], np.float32
    )
    sd["attention_fusion.norm.bias"] = np.asarray(
        p["attention_fusion"]["norm"]["bias"], np.float32
    )
    sd["fusion_classifier.0.weight"] = _inv_linear(np.asarray(
        p["fusion_hidden"]["kernel"], np.float32
    ))
    sd["fusion_classifier.0.bias"] = np.asarray(
        p["fusion_hidden"]["bias"], np.float32
    )
    sd["fusion_classifier.3.weight"] = _inv_linear(np.asarray(
        p["fusion_out"]["kernel"], np.float32
    ))
    sd["fusion_classifier.3.bias"] = np.asarray(
        p["fusion_out"]["bias"], np.float32
    )
    return sd


def export_fusion_modal_balance(variables: Mapping
                                ) -> Dict[str, np.ndarray]:
    """Inverse of convert_pth.convert_fusion_modal_balance: the full
    modal-balance trimodal model → the reference's
    `torch.save(model.state_dict())` layout
    (multimodal_paper_modal_balance.py:197-354)."""
    sd = prefixed(
        export_resnet18(subtree(variables, "image_encoder")),
        "image_encoder",
    )
    sd.update(prefixed(
        export_resnet1d_se(subtree(variables, "signal_encoder")),
        "signal_encoder",
    ))
    sd.update(prefixed(
        export_clinical_mlp(subtree(variables, "clinical_encoder")),
        "clinical_encoder",
    ))
    sd.update(_export_fusion_tail(variables))
    return sd


def export_fusion_canonical(variables: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of convert_pth.convert_fusion_canonical: the canonical
    512/128/32 trimodal model (TabNet clinical) → the reference layout
    (multimodal.py:333-469; clinical branch under
    `clinical_encoder.tabnet.*` per multimodal.py:383-388)."""
    sd = prefixed(
        export_resnet18(subtree(variables, "image_encoder")),
        "image_encoder",
    )
    sd.update(prefixed(
        export_resnet1d_se(subtree(variables, "signal_encoder")),
        "signal_encoder",
    ))
    sd.update(prefixed(
        export_tabnet(subtree(variables, "clinical_encoder")),
        "clinical_encoder.tabnet",
    ))
    sd.update(_export_fusion_tail(variables))
    return sd


EXPORTERS = {
    "resnet1d_se": export_resnet1d_se,
    "resnet18": export_resnet18,
    "clinical_mlp": export_clinical_mlp,
    "tabnet": export_tabnet,
    "crnn": export_crnn,
    "transformer1d": export_transformer1d,
    "fusion_modal_balance": export_fusion_modal_balance,
    "fusion_canonical": export_fusion_canonical,
}


def save_torch_state_dict(sd: Mapping[str, np.ndarray], path: str) -> None:
    """torch.save the exported state dict as tensors — byte-compatible
    with the reference's `torch.load(path)` consumers."""
    import torch

    torch.save(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
        path,
    )
