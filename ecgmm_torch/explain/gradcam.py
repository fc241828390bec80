"""Grad-CAM on autograd (port of `ecgmm_tpu/explain/gradcam.py`): the
class score's gradients w.r.t. the last conv feature map, averaged over
space or time, weight the map's channels; the ReLU of the weighted sum,
min-max normalised, is the CAM, resized to the input's resolution. For
the standalone ResNet-18 (`grad_cam_image`), the standalone ResNet1D-SE
(`grad_cam_signal`) and the fusion model's image branch
(`grad_cam_fusion_image`, `cam_from_image_map` on the serving path).

The feature map comes from a forward without autograd; only the head
after it is differentiated, so no encoder backward runs (the SE
backward kernel among them). JAX resizes with `jax.image.resize`
("linear", "bilinear"): for upsampling it gives the values of
`F.interpolate(align_corners=False)`, whose edge clamping equals JAX's
renormalised edge weights.

The jet lookup table is rebuilt in numpy from matplotlib's segment data
for jet, with matplotlib's own interpolation arithmetic, so the serving
path needs no matplotlib.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _cam_from_feats(feats, grads, spatial_dims: Tuple[int, ...]):
    """Channel weights = spatial mean of the gradients; CAM =
    relu(sum_c weight_c * feats_c), min-max normalised per sample. feats
    and grads are (B, C, *spatial)."""
    weights = grads.mean(dim=spatial_dims, keepdim=True)
    cam = torch.relu((weights * feats).sum(dim=1))
    flat = cam.flatten(1)
    shape = (-1,) + (1,) * (cam.dim() - 1)
    lo = flat.min(dim=1).values.reshape(shape)
    hi = flat.max(dim=1).values.reshape(shape)
    return (cam - lo) / torch.clamp(hi - lo, min=1e-8)


def _grad_cam(head, feats, class_idx, spatial_dims):
    """(CAM over feats' spatial dims, logits): the gradient of
    sum_b head(feats)[b, class_b] w.r.t. feats (B, C, *spatial); each row's
    class is its argmax where class_idx is None."""
    with torch.enable_grad():
        f = feats.detach().requires_grad_(True)
        logits = head(f)
        if class_idx is None:
            class_idx = logits.argmax(dim=-1)
        class_idx = torch.as_tensor(class_idx, device=logits.device)
        rows = torch.arange(logits.shape[0], device=logits.device)
        score = logits[rows, class_idx.expand(logits.shape[0])].sum()
        (grads,) = torch.autograd.grad(score, f)
    return _cam_from_feats(f.detach(), grads, spatial_dims), logits.detach()


def grad_cam_image(model, images, class_idx=None):
    """CAM over a standalone ResNet-18 classifier. images: (B, 3, H, W),
    uint8 raw or float normalised. Returns (cam (B, H, W) in [0, 1],
    logits (B, C))."""
    with torch.no_grad():
        _, feats = model(images, return_features=True)
    cam, logits = _grad_cam(
        lambda f: model.fc(f.mean(dim=(2, 3))).float(), feats, class_idx,
        (2, 3))
    cam = F.interpolate(cam[:, None], size=images.shape[2:],
                        mode="bilinear", align_corners=False)[:, 0]
    return cam, logits


def grad_cam_signal(model, signals, class_idx=None):
    """1-D CAM over a standalone ResNet1D-SE classifier. signals: (B, T) or
    (B, C, T). Returns (cam (B, T) in [0, 1], logits (B, C)). The whole
    head (GAP, Dense 64, ReLU, Dense out; dropout is off in eval) is
    differentiated w.r.t. the last feature map."""
    if signals.dim() == 2:
        signals = signals[:, None, :]
    with torch.no_grad():
        _, feats = model(signals, return_features=True)
    _, hidden, _, _, out = model.classifier

    def head(f):
        return out(torch.relu(hidden(f.mean(dim=-1)))).float()

    cam, logits = _grad_cam(head, feats, class_idx, (2,))
    cam = F.interpolate(cam[:, None], size=signals.shape[-1],
                        mode="linear", align_corners=False)[:, 0]
    return cam, logits


def image_branch_logits(model, feats):
    """image_classifier(image_norm(fc(GAP(feats)))) for a layer-4 map."""
    emb = model.image_encoder.fc(feats.mean(dim=(2, 3)))
    return model.image_classifier(model.image_norm(emb))


def cam_from_image_map(model, feats, class_idx=None):
    """Grad-CAM of the image-branch class score w.r.t. a layer-4 map
    (B, 512, h, w). Returns (cam (B, h, w) in [0, 1], logits (B, C))."""
    return _grad_cam(lambda f: image_branch_logits(model, f), feats,
                     class_idx, (2, 3))


def grad_cam_fusion_image(model, images, class_idx=None,
                          resize_to_input: bool = True):
    """CAM through the fusion model's image branch. images: (B, 3, H, W).
    Returns the CAM at the input's resolution; resize_to_input=False
    returns the feature-map-native CAM (7x7 for 224x224 inputs), which
    serving upsamples once on the host."""
    with torch.no_grad():
        _, feats = model.encode_image(images)
    cam, logits = cam_from_image_map(model, feats, class_idx)
    if resize_to_input:
        cam = F.interpolate(cam[:, None], size=images.shape[2:],
                            mode="bilinear", align_corners=False)[:, 0]
    return cam, logits


# matplotlib's segment data for jet (matplotlib/_cm.py `_jet_data`)
_JET_SEGMENTS = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
              (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.0, 0, 0)),
}


def _segment_lut(data, n: int) -> np.ndarray:
    """matplotlib.colors._create_lookup_table for (x, y0, y1) rows."""
    a = np.array(data, dtype=float)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([
        [y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]],
    ])
    return np.clip(lut, 0.0, 1.0)


_JET_LUT: Optional[np.ndarray] = None


def _jet_lut() -> np.ndarray:
    """256-entry jet RGB uint8 LUT, equal to
    `(matplotlib.colormaps["jet"](np.linspace(0, 1, 256))[:, :3] * 255)
    .astype(np.uint8)`."""
    global _JET_LUT
    if _JET_LUT is None:
        n = 256
        rgb = np.stack([_segment_lut(_JET_SEGMENTS[c], n)
                        for c in ("red", "green", "blue")], axis=1)
        # the colormap's float lookup: index = int(x * N), x == 1 -> N - 1
        xa = np.linspace(0.0, 1.0, n) * n
        xa[xa == n] = n - 1
        _JET_LUT = (rgb[xa.astype(int)] * 255).astype(np.uint8)
    return _JET_LUT


def overlay_heatmap(image_u8: np.ndarray, cam: np.ndarray,
                    alpha: float = 0.4) -> np.ndarray:
    """Blend a jet-colormapped CAM over an RGB uint8 image."""
    idx = np.clip(np.asarray(cam) * 255.0, 0, 255).astype(np.uint8)
    heat = _jet_lut()[idx]
    return (
        (1 - alpha) * image_u8.astype(np.float32)
        + alpha * heat.astype(np.float32)
    ).astype(np.uint8)
