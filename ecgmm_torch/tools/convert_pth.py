"""Reference checkpoints <-> flax variable trees (the port's copy of
`ecgmm_tpu/tools/convert_pth.py`, the `ecgmm-convert` CLI).

The import direction converts a reference-format torch state dict into
the flax variable tree of the JAX package's model and writes it as a
`.msgpack` file with the bytes of JAX's CLI (`tools/flax_msgpack.py`; no
flax or msgpack needed):
  * ResNet1D_SE checkpoints (key layout `initial.0.*`,
    `layer{1..3}.{conv,bn,se,downsample}*`, `classifier.{1,4}.*`);
  * torchvision-style ResNet18 state dicts (`conv1`, `bn1`,
    `layer{1..4}.{0,1}.*`, `fc`);
  * the clinical MLP, TabNet, CRNN, Transformer1D and both fusion
    variants.

Layout conversions: Conv1d (O,I,W)→(W,I,O); Conv2d (O,I,H,W)→(H,W,I,O);
Linear (O,I)→(I,O); BatchNorm weight/bias→scale/bias with
running_mean/var into batch_stats.

`--export` goes the other way (`tools/export_pth.py`): a `.msgpack` tree,
a port run directory (`--which best|last`) or a port `.pt` checkpoint
becomes a reference-format `.pth` whose tensors and key order equal
`ecgmm_tpu/tools/export_pth.py`'s for the same weights. The port's
state dicts already use the reference names; they are put through the
importer and the exporter, so the rules that `export_pth.py` documents
hold (`num_batches_tracked` 0, the LSTM's summed bias as `bias_ih` with a
zero `bias_hh`, TabNet's shared GLU weights at every alias). A JAX orbax
checkpoint directory is refused: JAX's own `--export` writes its `.pth`.
The warm-start merge of JAX's `load_partial` is
`ecgmm_torch.tools.weights.load_partial`.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from ecgmm_torch.tools import flax_msgpack


def flatten_path_dict(tree: Mapping, prefix: str = "") -> Dict:
    """A nested dict as {'a/b/c': leaf}, in the tree's order (flax's
    `traverse_util.flatten_dict`; empty dicts vanish)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_path_dict(v, path))
        else:
            out[path] = v
    return out


def unflatten_path_dict(flat: Mapping) -> Dict:
    """{'a/b/c': leaf} as a nested dict, in the order of `flat`."""
    out: Dict = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    try:
        sd = torch.load(path, map_location="cpu")
    except Exception:
        # torch>=2.6 defaults weights_only=True, which rejects
        # full-model pickles (torch.save(model)) before the
        # .state_dict() fallback below can run. Retry with the explicit
        # opt-out — this converter is a user-initiated tool operating on
        # a checkpoint the user supplied.
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: _np(v) for k, v in sd.items()}


def _conv1d(w):
    return np.transpose(w, (2, 1, 0))


def _conv2d(w):
    return np.transpose(w, (2, 3, 1, 0))


def _linear(w):
    return np.transpose(w, (1, 0))


def _put_bn(params, stats, flax_name: str, sd: Mapping[str, np.ndarray],
            torch_prefix: str):
    params[f"{flax_name}/scale"] = sd[f"{torch_prefix}.weight"]
    params[f"{flax_name}/bias"] = sd[f"{torch_prefix}.bias"]
    stats[f"{flax_name}/mean"] = sd[f"{torch_prefix}.running_mean"]
    stats[f"{flax_name}/var"] = sd[f"{torch_prefix}.running_var"]


def convert_resnet1d_se(sd: Mapping[str, np.ndarray]) -> Dict[str, dict]:
    """Reference ResNet1D_SE state dict → {'params': ..., 'batch_stats': ...}
    for models.ResNet1DSE."""
    p: Dict[str, np.ndarray] = {}
    s: Dict[str, np.ndarray] = {}

    p["stem_conv/kernel"] = _conv1d(sd["initial.0.weight"])
    p["stem_conv/bias"] = sd["initial.0.bias"]
    _put_bn(p, s, "stem_bn", sd, "initial.1")

    for layer in ("layer1", "layer2", "layer3"):
        for conv in ("conv1", "conv2"):
            p[f"{layer}/{conv}/kernel"] = _conv1d(sd[f"{layer}.{conv}.weight"])
            p[f"{layer}/{conv}/bias"] = sd[f"{layer}.{conv}.bias"]
        for bn in ("bn1", "bn2"):
            _put_bn(p, s, f"{layer}/{bn}", sd, f"{layer}.{bn}")
        p[f"{layer}/se/fc1/kernel"] = _linear(sd[f"{layer}.se.fc.0.weight"])
        p[f"{layer}/se/fc1/bias"] = sd[f"{layer}.se.fc.0.bias"]
        p[f"{layer}/se/fc2/kernel"] = _linear(sd[f"{layer}.se.fc.2.weight"])
        p[f"{layer}/se/fc2/bias"] = sd[f"{layer}.se.fc.2.bias"]
        if f"{layer}.downsample.0.weight" in sd:
            p[f"{layer}/downsample_conv/kernel"] = _conv1d(
                sd[f"{layer}.downsample.0.weight"]
            )
            p[f"{layer}/downsample_conv/bias"] = sd[
                f"{layer}.downsample.0.bias"
            ]
            _put_bn(p, s, f"{layer}/downsample_bn", sd, f"{layer}.downsample.1")

    if "classifier.1.weight" in sd:
        p["head_dense/kernel"] = _linear(sd["classifier.1.weight"])
        p["head_dense/bias"] = sd["classifier.1.bias"]
    if "classifier.4.weight" in sd:
        p["head_out/kernel"] = _linear(sd["classifier.4.weight"])
        p["head_out/bias"] = sd["classifier.4.bias"]

    return {
        "params": unflatten_path_dict(p),
        "batch_stats": unflatten_path_dict(s),
    }


def convert_resnet18(sd: Mapping[str, np.ndarray]) -> Dict[str, dict]:
    """torchvision resnet18 state dict → variables for models.ResNet18."""
    p: Dict[str, np.ndarray] = {}
    s: Dict[str, np.ndarray] = {}

    p["stem_conv/kernel"] = _conv2d(sd["conv1.weight"])
    _put_bn(p, s, "stem_bn", sd, "bn1")

    for stage in range(4):
        for block in range(2):
            t = f"layer{stage + 1}.{block}"
            f = f"layer{stage + 1}_{block}"
            for conv in ("conv1", "conv2"):
                p[f"{f}/{conv}/kernel"] = _conv2d(sd[f"{t}.{conv}.weight"])
            for bn in ("bn1", "bn2"):
                _put_bn(p, s, f"{f}/{bn}", sd, f"{t}.{bn}")
            if f"{t}.downsample.0.weight" in sd:
                p[f"{f}/downsample_conv/kernel"] = _conv2d(
                    sd[f"{t}.downsample.0.weight"]
                )
                _put_bn(p, s, f"{f}/downsample_bn", sd, f"{t}.downsample.1")

    if "fc.weight" in sd:
        p["fc/kernel"] = _linear(sd["fc.weight"])
        p["fc/bias"] = sd["fc.bias"]

    return {
        "params": unflatten_path_dict(p),
        "batch_stats": unflatten_path_dict(s),
    }


def _strip_prefix(sd: Mapping[str, np.ndarray], prefix: str
                  ) -> Dict[str, np.ndarray]:
    p = prefix + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def convert_clinical_mlp(sd: Mapping[str, np.ndarray]) -> Dict[str, dict]:
    """Sequential Linear/BN/ReLU/Dropout/Linear clinical encoder
    (reference multimodal_paper_modal_balance.py:256-263; torch keys
    0.*, 1.*, 4.*) → variables for models.ClinicalMLPEncoder."""
    p: Dict[str, np.ndarray] = {}
    s: Dict[str, np.ndarray] = {}
    p["fc1/kernel"] = _linear(sd["0.weight"])
    p["fc1/bias"] = sd["0.bias"]
    _put_bn(p, s, "bn", sd, "1")
    p["fc2/kernel"] = _linear(sd["4.weight"])
    p["fc2/bias"] = sd["4.bias"]
    return {
        "params": unflatten_path_dict(p),
        "batch_stats": unflatten_path_dict(s),
    }


def convert_tabnet(sd: Mapping[str, np.ndarray]) -> Dict[str, dict]:
    """pytorch_tabnet TabNetNoEmbeddings state dict → variables for
    models.TabNetEncoder (the reference's clinical branch wraps exactly
    this module — `reference/multimodal.py:109-148`).

    Torch key layout (pytorch_tabnet tab_network):
      encoder.initial_bn.*,
      encoder.{initial_splitter,feat_transformers.S}.shared.glu_layers.I.
        {fc.weight, bn.bn.*}   (fc weights are the SAME tensor across
        transformers — the shared Linear objects; BN is per-transformer),
      encoder.*.specifics.glu_layers.I.{fc.weight, bn.bn.*},
      encoder.att_transformers.S.{fc.weight, bn.bn.*},
      final_mapping.weight.
    Wrapper prefixes (`tabnet.` / `encoder.tabnet.` from the reference's
    ClinicalTabNetEncoder checkpoints, multimodal.py:150-168) are
    stripped automatically. `encoder.group_attention_matrix` (a v4
    identity buffer when no feature groups are defined) is ignored."""
    for pref in ("encoder.tabnet.", "tabnet."):
        if any(k.startswith(pref) for k in sd):
            sd = _strip_prefix(sd, pref[:-1])
            break
    p: Dict[str, np.ndarray] = {}
    s: Dict[str, np.ndarray] = {}

    _put_bn(p, s, "initial_bn", sd, "encoder.initial_bn")

    n_shared = len({
        k.split(".")[4] for k in sd
        if k.startswith("encoder.initial_splitter.shared.glu_layers.")
    })
    n_indep = len({
        k.split(".")[4] for k in sd
        if k.startswith("encoder.initial_splitter.specifics.glu_layers.")
    })
    n_steps = len({
        k.split(".")[2] for k in sd
        if k.startswith("encoder.feat_transformers.")
    })

    def put_feat(flax_name: str, torch_name: str):
        for i in range(n_shared):
            t = f"{torch_name}.shared.glu_layers.{i}"
            # the fc tensor is shared; take it from whichever path
            p[f"shared_fc_{i}/kernel"] = _linear(sd[f"{t}.fc.weight"])
            _put_bn(p, s, f"{flax_name}/shared_glu_{i}/bn", sd, f"{t}.bn.bn")
        for i in range(n_indep):
            t = f"{torch_name}.specifics.glu_layers.{i}"
            p[f"{flax_name}/indep_{i}/fc/kernel"] = _linear(
                sd[f"{t}.fc.weight"]
            )
            _put_bn(p, s, f"{flax_name}/indep_{i}/bn", sd, f"{t}.bn.bn")

    put_feat("initial_splitter", "encoder.initial_splitter")
    for step in range(n_steps):
        put_feat(f"feat_{step}", f"encoder.feat_transformers.{step}")
        t = f"encoder.att_transformers.{step}"
        p[f"att_fc_{step}/kernel"] = _linear(sd[f"{t}.fc.weight"])
        _put_bn(p, s, f"att_bn_{step}", sd, f"{t}.bn.bn")

    p["final_mapping/kernel"] = _linear(sd["final_mapping.weight"])
    return {
        "params": unflatten_path_dict(p),
        "batch_stats": unflatten_path_dict(s),
    }


def convert_crnn(sd: Mapping[str, np.ndarray]) -> Dict[str, dict]:
    """Reference CRNN state dict → variables for models.CRNN.

    Torch key layout (`reference/train_physionet2.py:55-96`):
    conv{1,2,3}.block.{0=Conv2d,1=BatchNorm2d}.*, bilstm.{weight,bias}_
    {ih,hh}_l{0..2}(_reverse), classifier.{0,3}.*.

    Two layout conversions beyond the usual transposes:
      * torch LSTM packs gates row-wise as (i,f,g,o) ×H and keeps two bias
        vectors; flax OptimizedLSTMCell has per-gate Dense pairs i{g}
        (no bias) / h{g} (bias) — the two torch biases are summed.
      * the LSTM layer-0 input columns: torch flattens the conv output
        channel-major (C, F′) while the NHWC flax model flattens
        feature-major (F′, C); layer-0 input weights are column-permuted.
    """
    p: Dict[str, np.ndarray] = {}
    s: Dict[str, np.ndarray] = {}

    for name in ("conv1", "conv2", "conv3"):
        p[f"{name}/conv/kernel"] = _conv2d(sd[f"{name}.block.0.weight"])
        p[f"{name}/conv/bias"] = sd[f"{name}.block.0.bias"]
        _put_bn(p, s, f"{name}/bn", sd, f"{name}.block.1")

    c_out = sd["conv3.block.0.weight"].shape[0]
    in_dim = sd["bilstm.weight_ih_l0"].shape[1]
    f_out = in_dim // c_out
    # flax column f·C+c ← torch column c·F′+f
    perm = (np.arange(f_out)[:, None] + f_out * np.arange(c_out)).ravel()

    hidden = sd["bilstm.weight_hh_l0"].shape[1]
    n_layers = len({
        k.split("_l")[1].split("_")[0] for k in sd if k.startswith("bilstm.")
    })
    gates = ("i", "f", "g", "o")  # torch chunk order == flax gate order
    for k in range(n_layers):
        for d, cell in enumerate(
            ("OptimizedLSTMCell_0", "OptimizedLSTMCell_1")
        ):
            sfx = "_reverse" if d else ""
            wih = sd[f"bilstm.weight_ih_l{k}{sfx}"]
            whh = sd[f"bilstm.weight_hh_l{k}{sfx}"]
            bias = (sd[f"bilstm.bias_ih_l{k}{sfx}"]
                    + sd[f"bilstm.bias_hh_l{k}{sfx}"])
            for gi, g in enumerate(gates):
                rows = slice(gi * hidden, (gi + 1) * hidden)
                win = wih[rows].T
                if k == 0:
                    win = win[perm]
                base = f"bilstm{k}/{cell}"
                p[f"{base}/i{g}/kernel"] = win
                p[f"{base}/h{g}/kernel"] = whh[rows].T
                p[f"{base}/h{g}/bias"] = bias[rows]

    p["head_dense/kernel"] = _linear(sd["classifier.0.weight"])
    p["head_dense/bias"] = sd["classifier.0.bias"]
    p["head_out/kernel"] = _linear(sd["classifier.3.weight"])
    p["head_out/bias"] = sd["classifier.3.bias"]
    return {
        "params": unflatten_path_dict(p),
        "batch_stats": unflatten_path_dict(s),
    }


def convert_transformer1d(sd: Mapping[str, np.ndarray],
                          nhead: int = 4) -> Dict[str, dict]:
    """Reference ECGTransformer1D state dict → variables for
    models.ECGTransformer1D.

    Torch key layout (`reference/train_physionet.py:211-239`):
    conv.*, pos_embedding, transformer_encoder.layers.{i}.{self_attn.
    {in_proj_weight,in_proj_bias,out_proj.*}, linear{1,2}.*, norm{1,2}.*},
    classifier.{1,4}.* (index 0 is a Flatten). The packed (3D, D)
    in_proj is split into per-head q/k/v kernels of shape (D, H, D/H).

    nhead: the state dict does not record the head count; the reference
    fixes 4 (train_physionet.py:233). A checkpoint trained with a
    different count MUST pass it — the per-head reshape would otherwise
    silently group the wrong rows into heads."""
    p: Dict[str, np.ndarray] = {}

    p["embed_conv/kernel"] = _conv1d(sd["conv.weight"])
    p["embed_conv/bias"] = sd["conv.bias"]
    p["pos_embedding"] = sd["pos_embedding"]

    d_model = sd["conv.weight"].shape[0]
    layers = sorted({
        int(k.split(".")[2]) for k in sd
        if k.startswith("transformer_encoder.layers.")
    })
    if nhead < 1 or d_model % nhead:
        raise ValueError(
            f"nhead={nhead} does not divide d_model={d_model}"
        )
    hd = d_model // nhead
    for i in layers:
        pre = f"transformer_encoder.layers.{i}."
        wqkv = sd[pre + "self_attn.in_proj_weight"]
        bqkv = sd[pre + "self_attn.in_proj_bias"]
        for j, name in enumerate(("query", "key", "value")):
            w = wqkv[j * d_model:(j + 1) * d_model]  # (D, D) out×in
            p[f"layer{i}/self_attn/{name}/kernel"] = w.T.reshape(
                d_model, nhead, hd
            )
            p[f"layer{i}/self_attn/{name}/bias"] = bqkv[
                j * d_model:(j + 1) * d_model
            ].reshape(nhead, hd)
        p[f"layer{i}/self_attn/out/kernel"] = sd[
            pre + "self_attn.out_proj.weight"
        ].T.reshape(nhead, hd, d_model)
        p[f"layer{i}/self_attn/out/bias"] = sd[
            pre + "self_attn.out_proj.bias"
        ]
        p[f"layer{i}/ff1/kernel"] = _linear(sd[pre + "linear1.weight"])
        p[f"layer{i}/ff1/bias"] = sd[pre + "linear1.bias"]
        p[f"layer{i}/ff2/kernel"] = _linear(sd[pre + "linear2.weight"])
        p[f"layer{i}/ff2/bias"] = sd[pre + "linear2.bias"]
        for n in ("norm1", "norm2"):
            p[f"layer{i}/{n}/scale"] = sd[pre + n + ".weight"]
            p[f"layer{i}/{n}/bias"] = sd[pre + n + ".bias"]

    p["head_dense/kernel"] = _linear(sd["classifier.1.weight"])
    p["head_dense/bias"] = sd["classifier.1.bias"]
    p["head_out/kernel"] = _linear(sd["classifier.4.weight"])
    p["head_out/bias"] = sd["classifier.4.bias"]
    return {"params": unflatten_path_dict(p)}


def _convert_fusion_tail(params: dict, sd: Mapping[str, np.ndarray]) -> None:
    """The post-encoder surface shared by both fusion variants: branch
    LayerNorms + classifiers, attention fusion, fusion MLP head
    (multimodal.py:389-415 == multimodal_paper_modal_balance.py:264-296)."""
    for branch in ("image", "signal", "clinical"):
        params[f"{branch}_norm"] = {
            "scale": sd[f"{branch}_norm.weight"],
            "bias": sd[f"{branch}_norm.bias"],
        }
        params[f"{branch}_classifier"] = {
            "kernel": _linear(sd[f"{branch}_classifier.weight"]),
            "bias": sd[f"{branch}_classifier.bias"],
        }
    params["attention_fusion"] = {
        "weights": sd["attention_fusion.weights"],
        "norm": {
            "scale": sd["attention_fusion.norm.weight"],
            "bias": sd["attention_fusion.norm.bias"],
        },
    }
    params["fusion_hidden"] = {
        "kernel": _linear(sd["fusion_classifier.0.weight"]),
        "bias": sd["fusion_classifier.0.bias"],
    }
    params["fusion_out"] = {
        "kernel": _linear(sd["fusion_classifier.3.weight"]),
        "bias": sd["fusion_classifier.3.bias"],
    }


def convert_fusion_modal_balance(sd: Mapping[str, np.ndarray]
                                 ) -> Dict[str, dict]:
    """Reference-format fusion checkpoint (torch.save of
    ECGMultimodalModel.state_dict(), the modal-balance/MLP-clinical
    variant — multimodal_paper_modal_balance.py:197-354) → variables for
    models.ECGMultimodalModel(ModelConfig.modal_balance()).

    Key families: image_encoder.* (torchvision layout), signal_encoder.*
    (initial.0/layer{1..3}/classifier layout), clinical_encoder.{0,1,4}.*,
    {image,signal,clinical}_norm.*, {image,signal,clinical}_classifier.*,
    attention_fusion.{weights,norm.*}, fusion_classifier.{0,3}.*."""
    img = convert_resnet18(_strip_prefix(sd, "image_encoder"))
    sig = convert_resnet1d_se(_strip_prefix(sd, "signal_encoder"))
    clin = convert_clinical_mlp(_strip_prefix(sd, "clinical_encoder"))

    params = {
        "image_encoder": img["params"],
        "signal_encoder": sig["params"],
        "clinical_encoder": clin["params"],
    }
    stats = {
        "image_encoder": img["batch_stats"],
        "signal_encoder": sig["batch_stats"],
        "clinical_encoder": clin["batch_stats"],
    }
    _convert_fusion_tail(params, sd)
    return {"params": params, "batch_stats": stats}


def convert_fusion_canonical(sd: Mapping[str, np.ndarray]
                             ) -> Dict[str, dict]:
    """Reference-format CANONICAL fusion checkpoint (512/128/32 dims,
    TabNet clinical branch — multimodal.py:333-469) → variables for
    models.ECGMultimodalModel(ModelConfig()).

    Same tail as the modal-balance variant; the clinical branch is the
    wrapped TabNetNoEmbeddings under `clinical_encoder.tabnet.*`
    (multimodal.py:383-388)."""
    img = convert_resnet18(_strip_prefix(sd, "image_encoder"))
    sig = convert_resnet1d_se(_strip_prefix(sd, "signal_encoder"))
    clin = convert_tabnet(_strip_prefix(sd, "clinical_encoder"))

    params = {
        "image_encoder": img["params"],
        "signal_encoder": sig["params"],
        "clinical_encoder": clin["params"],
    }
    stats = {
        "image_encoder": img["batch_stats"],
        "signal_encoder": sig["batch_stats"],
        "clinical_encoder": clin["batch_stats"],
    }
    _convert_fusion_tail(params, sd)
    return {"params": params, "batch_stats": stats}


CONVERTERS = {
    "resnet1d_se": convert_resnet1d_se,
    "resnet18": convert_resnet18,
    "clinical_mlp": convert_clinical_mlp,
    "tabnet": convert_tabnet,
    "crnn": convert_crnn,
    "transformer1d": convert_transformer1d,
    "fusion_modal_balance": convert_fusion_modal_balance,
    "fusion_canonical": convert_fusion_canonical,
}


def _to_np(tree):
    if isinstance(tree, Mapping):
        return {k: _to_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def save_converted(variables: Mapping, path: str) -> None:
    """Write a converted variable tree as flax's msgpack (the bytes of
    `flax.serialization.msgpack_serialize`)."""
    with open(path, "wb") as f:
        f.write(flax_msgpack.msgpack_serialize(_to_np(variables)))


def load_converted(path: str) -> Dict:
    with open(path, "rb") as f:
        return flax_msgpack.msgpack_restore(f.read())


def _is_orbax(path: str, which: str) -> bool:
    """Whether `path` is an orbax checkpoint or a JAX run directory: orbax
    metadata in it, or a `which` checkpoint directory."""
    return os.path.isdir(os.path.join(path, which)) or any(
        name.startswith(("_CHECKPOINT_METADATA", "_METADATA"))
        or name == "manifest.ocdbt" for name in os.listdir(path))


def load_port_state_dict(path: str, which: str = "best"
                         ) -> Dict[str, np.ndarray]:
    """The model state dict of a port checkpoint: a `.pt` file that
    `train/checkpoint.CheckpointManager` wrote, or a run directory
    holding `{which}.pt`. A JAX orbax directory is refused."""
    if os.path.isdir(path):
        pt = os.path.join(path, f"{which}.pt")
        if not os.path.isfile(pt):
            if _is_orbax(path, which):
                raise ValueError(
                    f"{path!r} looks like a JAX orbax checkpoint; write its "
                    ".pth with JAX's own export: python -m "
                    "ecgmm_tpu.tools.convert_pth SRC --arch A --export "
                    "--out F.pth")
            raise FileNotFoundError(f"no {which}.pt in {path!r}")
        path = pt
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _np(v) for k, v in payload["model"].items()}


def load_export_source(path: str, which: str, arch: str,
                       nhead: int = 4) -> Dict:
    """The variable tree an --export run writes out: a `.msgpack` tree
    (`save_converted`'s format) as it is; a port run directory or `.pt`
    checkpoint through the importer of `arch`."""
    if os.path.isfile(path) and not path.endswith(".pt"):
        return load_converted(path)
    sd = load_port_state_dict(path, which)
    if arch == "transformer1d":
        return convert_transformer1d(sd, nhead=nhead)
    return CONVERTERS[arch](sd)


def main(argv=None):
    """CLI for reference-checkpoint migration, both directions:

        # reference .pth -> flax variable tree (.msgpack)
        python -m ecgmm_torch.tools.convert_pth best.pth \
            --arch tabnet --out tabnet.msgpack

        # a .msgpack tree or a port run -> reference-format .pth
        python -m ecgmm_torch.tools.convert_pth checkpoints/<stamp> \
            --arch fusion_canonical --export --which best --out best.pth

    --export input may be a .msgpack tree (save_converted format), a port
    run directory (best/last checkpoint selected by --which) or a port
    .pt checkpoint."""
    import argparse

    from ecgmm_torch.tools import export_pth

    p = argparse.ArgumentParser(description=main.__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("src", help="import: torch state-dict .pth file; "
                               "export: .msgpack tree, port run dir or "
                               "port .pt checkpoint")
    p.add_argument("--arch", required=True, choices=sorted(CONVERTERS))
    p.add_argument("--out", required=True,
                   help="output path (.msgpack on import, .pth on export)")
    p.add_argument("--export", action="store_true",
                   help="reverse direction: variables -> "
                        "reference-format torch .pth")
    p.add_argument("--which", default="best", choices=("best", "last"),
                   help="export from a run dir: which checkpoint")
    p.add_argument("--nhead", type=int, default=4,
                   help="transformer1d only: attention head count of the "
                        "checkpoint (not stored in the state dict; the "
                        "reference uses 4)")
    args = p.parse_args(argv)

    if args.export:
        variables = load_export_source(args.src, args.which, args.arch,
                                       args.nhead)
        sd = export_pth.EXPORTERS[args.arch](variables)
        export_pth.save_torch_state_dict(sd, args.out)
        n_params = sum(int(np.prod(np.shape(v))) for v in sd.values())
        print(f"{args.arch}: {len(sd)} tensors, {n_params:,} elements "
              f"-> {args.out} (reference-format state dict)")
        return

    sd = load_torch_state_dict(args.src)
    if args.arch == "transformer1d":
        variables = convert_transformer1d(sd, nhead=args.nhead)
    else:
        variables = CONVERTERS[args.arch](sd)
    save_converted(variables, args.out)
    flat = flatten_path_dict(variables)
    n_params = sum(
        int(np.prod(np.shape(v))) for k, v in flat.items()
        if k.startswith("params/")
    )
    print(f"{args.arch}: {len(flat)} leaves, {n_params:,} params "
          f"-> {args.out}")


if __name__ == "__main__":
    main()
