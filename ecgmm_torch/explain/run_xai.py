"""XAI batch CLI (port of `ecgmm_tpu/explain/run_xai.py`): per-sample
modality-contribution CSVs over the test split, Grad-CAM overlays and
TabNet mask heatmaps.

    python -m ecgmm_torch.explain.run_xai --method shap --n-synth 64
    python -m ecgmm_torch.explain.run_xai --device cpu --method lime \
        --n-synth 48

For every test sample, the percentage contribution of each modality
(Image_%, Signal_%, Clinical_%) per class, written to
`{out_dir}/{method}/{tag}_{method}_fusion_class{c}.csv` (methods shap,
deep_shap, lime), plus the fusion attention-weight printout; `gradcam`
writes overlays under `{out_dir}/gradcam`, `tabnet_masks` heatmaps under
`{out_dir}/tabnet`. The model is the `fusion` preset's in float32 from the
port's seeded init, on the card unless `--device cpu` is given. Every
report runs the model in eval mode with TF32 off (`precision.no_tf32`).
CSVs are written by the `csv` module and PNGs by the port's native
encoder: no pandas, matplotlib or Pillow.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import time
from typing import Dict

import numpy as np
import torch

from ecgmm_torch import native
from ecgmm_torch.config import get_preset
from ecgmm_torch.explain.deep_shap import explain_fusion_deep
from ecgmm_torch.explain.gradcam import grad_cam_fusion_image, overlay_heatmap
from ecgmm_torch.explain.lime_fusion import (draw_lime_noise,
                                             lime_modality_contributions,
                                             lime_tabular)
from ecgmm_torch.explain.shap_fusion import explain_fusion, model_tensor
from ecgmm_torch.explain.tabnet_masks import save_mask_heatmaps, tabnet_masks
from ecgmm_torch.models import ECGMultimodalModel
from ecgmm_torch.models.layers import flax_init_
from ecgmm_torch.precision import no_tf32
from ecgmm_torch.workloads.run import _device, load_data

METHODS = ("shap", "deep_shap", "lime", "gradcam", "tabnet_masks")
CSV_COLUMNS = ("index", "Image_%", "Signal_%", "Clinical_%")
LIME_SAMPLES = 1000


def compute_embeddings(model, arrays, batch_size: int = 32) -> np.ndarray:
    """Concatenated LayerNorm'd per-branch features of a split (N, D), the
    explanation surface, in batches of `batch_size`; the ragged tail is
    padded by repeating its last row and the pad is cut off the output."""
    out = []
    with torch.no_grad():
        for i in range(0, arrays.n, batch_size):
            batch = [arrays.images[i:i + batch_size],
                     arrays.signals[i:i + batch_size],
                     arrays.clinical[i:i + batch_size]]
            pad = batch_size - batch[0].shape[0]
            if pad > 0:
                batch = [torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
                         for a in batch]
            emb = torch.cat(model.encode(*batch)[:3], dim=1)
            out.append(emb[:batch_size - pad])
    return torch.cat(out).cpu().numpy()


def class_balanced_background(
    embeddings: np.ndarray, labels: np.ndarray, per_class: int = 50,
    seed: int = 0,
) -> np.ndarray:
    """At most `per_class` rows of each class, shuffled by numpy's
    default_rng(seed) as in the JAX package."""
    rng = np.random.default_rng(seed)
    picks = []
    for c in np.unique(labels):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        picks.append(idx[:per_class])
    return embeddings[np.concatenate(picks)]


def _write_csv(path: str, frame: Dict[str, np.ndarray]) -> None:
    """The columns of CSV_COLUMNS as pandas' `to_csv(index=False)` writes
    numpy columns: each value's `str` (the shortest repr of its own float
    type), newline row ends."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(CSV_COLUMNS)
        for row in zip(*(np.asarray(frame[k]) for k in CSV_COLUMNS)):
            writer.writerow([str(v) for v in row])


def xai_report(
    model, train_arrays, test_arrays, dims, method: str = "shap",
    out_dir: str = "./output", tag: str = "fusion", n_samples: int = 64,
    draws=None, return_attributions: bool = False,
):
    """Modality contributions of every test sample per class by `method`
    (shap, deep_shap or lime), written as CSVs; returns {class: columns}.
    draws: for shap, {class: (bidx, alphas)} (`explain_fusion`); for lime,
    the (n_test, 1000, D) noise (`lime_tabular`); absent, they come from
    generators seeded as the JAX package keys its draws. With
    return_attributions also {class: (n_test, D)} attributions (LIME:
    coefficients)."""
    if method not in METHODS[:3]:
        raise ValueError(method)
    model.eval()
    with no_tf32():
        t0 = time.perf_counter()
        emb_train = compute_embeddings(model, train_arrays)
        emb_test = compute_embeddings(model, test_arrays)
        t_encode = time.perf_counter() - t0
        labels_train = train_arrays.labels.cpu().numpy()
        test_idx = test_arrays.indices

        t0 = time.perf_counter()
        if method == "lime":
            per_class, attrs = _lime(model, emb_train, emb_test, dims, draws)
        else:
            background = class_balanced_background(emb_train, labels_train)
            if method == "deep_shap":
                per_class, attrs = explain_fusion_deep(
                    model, emb_test, background, dims,
                    return_attributions=True)
            else:
                per_class, attrs = explain_fusion(
                    model, emb_test, background, dims, n_samples=n_samples,
                    draws=draws, return_attributions=True)
        t_attrib = time.perf_counter() - t0
    frames = {c: {"index": test_idx, **contrib}
              for c, contrib in per_class.items()}

    n_test = len(test_idx)
    print(
        f"xai[{method}]: encode {train_arrays.n + n_test} samples in "
        f"{t_encode:.2f}s, attribution over {n_test} test samples in "
        f"{t_attrib:.2f}s "
        f"({n_test / t_attrib:.1f} samples/s attrib, incl. compile)"
    )

    sub = os.path.join(out_dir, method)
    os.makedirs(sub, exist_ok=True)
    for c, frame in frames.items():
        _write_csv(os.path.join(sub, f"{tag}_{method}_fusion_class{c}.csv"),
                   frame)

    # the fusion attention-weight printout
    sw = torch.softmax(model.attention_fusion.weights.detach().float(),
                       dim=0).cpu().numpy()
    print(
        f"attention weights: image={sw[0]:.4f} signal={sw[1]:.4f} "
        f"clinical={sw[2]:.4f}"
    )
    return (frames, attrs) if return_attributions else frames


def _lime(model, emb_train, emb_test, dims, noise):
    """LIME of both classes over the test embeddings from one set of
    perturbations (the JAX package draws both classes' from one key):
    (per-class contributions, per-class coefficients)."""
    d0, d1, _ = dims
    std = model_tensor(model, emb_train.std(axis=0) + 1e-8)
    x = model_tensor(model, emb_test)
    if noise is None:
        noise = draw_lime_noise(x.shape[0], LIME_SAMPLES, x.shape[1],
                                torch.Generator().manual_seed(0))

    def predict(e):
        logits = model.fuse_embeddings(e[:, :d0], e[:, d0:d0 + d1],
                                       e[:, d0 + d1:])
        return torch.softmax(logits, dim=-1)

    with torch.no_grad():
        coefs = lime_tabular(predict, x, std, class_idx=(0, 1),
                             num_samples=LIME_SAMPLES, noise=noise)
    attrs = {c: coefs[c].cpu().numpy() for c in range(2)}
    return ({c: lime_modality_contributions(a, dims)
             for c, a in attrs.items()}, attrs)


def gradcam_report(model, arrays, out_dir: str, n_samples: int = 8) -> list:
    """Grad-CAM overlays through the fusion image branch for the first
    n_samples test strips, at input resolution, as PNGs under
    out_dir/gradcam (`sample{index}_class{pred}.png`)."""
    sub = os.path.join(out_dir, "gradcam")
    os.makedirs(sub, exist_ok=True)
    model.eval()
    images = arrays.images[:n_samples]
    with no_tf32():
        cam, logits = grad_cam_fusion_image(model, images)
    imgs_u8 = images.permute(0, 2, 3, 1).cpu().numpy()
    cam, preds = cam.cpu().numpy(), logits.argmax(dim=-1).cpu().numpy()
    paths = []
    for i in range(imgs_u8.shape[0]):
        overlay = overlay_heatmap(imgs_u8[i], cam[i])
        path = os.path.join(
            sub, f"sample{arrays.indices[i]}_class{int(preds[i])}.png")
        with open(path, "wb") as f:
            f.write(native.png_encode(overlay))
        paths.append(path)
    print(f"gradcam: wrote {len(paths)} overlays to {sub}")
    return paths


def tabnet_masks_report(model, arrays, out_dir: str) -> list:
    """Per-step and aggregate TabNet mask heatmaps over the test split
    (the TabNet-clinical fusion variant only)."""
    cfg = model.cfg
    if cfg.clinical_encoder != "tabnet":
        raise ValueError("tabnet_masks needs the TabNet clinical variant")
    model.eval()
    with no_tf32():
        m_explain, masks = tabnet_masks(model.clinical_encoder,
                                        arrays.clinical)
    # the reference's 2-feature clinical schema gets its real names;
    # wider configs fall back to save_mask_heatmaps' var_i labels
    names = ("AGE", "Wt") if cfg.clinical_in_features == 2 else None
    paths = save_mask_heatmaps(m_explain, masks, feature_names=names,
                               save_dir=os.path.join(out_dir, "tabnet"))
    print(f"tabnet_masks: wrote {len(paths)} heatmaps")
    return paths


def xai_config():
    """The `fusion` preset with its model in float32, as the JAX CLI runs
    it."""
    cfg = get_preset("fusion")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype="float32"))


def xai_model(cfg, device) -> ECGMultimodalModel:
    """The preset's fusion model from the port's seeded init (seed 0), on
    `device`, in eval mode."""
    model = ECGMultimodalModel(cfg.model)
    flax_init_(model, torch.Generator().manual_seed(0))
    return model.to(device).eval()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--method", choices=METHODS, default="shap")
    p.add_argument("--n-synth", type=int, default=64)
    p.add_argument("--out-dir", default="./output")
    p.add_argument("--repeat", type=int, default=1,
                   help="run the report N times in-process: the first "
                        "pays the kernels' build, later passes time the "
                        "warm path (the steady-state number)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    device = _device(args.device)
    cfg = xai_config()
    data = load_data(cfg, "synthetic", args.n_synth, device=device)
    model = xai_model(cfg, device)
    dims = (cfg.model.image_dim, cfg.model.signal_dim,
            cfg.model.clinical_dim)
    if args.method == "gradcam":
        gradcam_report(model, data.test, args.out_dir)
    elif args.method == "tabnet_masks":
        tabnet_masks_report(model, data.test, args.out_dir)
    else:
        for _ in range(max(1, args.repeat)):
            xai_report(model, data.train, data.test, dims,
                       method=args.method, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
