"""TabNet attention-mask explainability (port of
`ecgmm_tpu/explain/tabnet_masks.py`): the per-step masks and the
decision-weighted aggregate of `TabNetEncoder(return_masks=True)`, and
their heatmaps.

The heatmaps carry the colours of matplotlib's `imshow(row,
cmap="viridis")` of each batch-mean mask row without matplotlib: a copy
of viridis' 256-entry table as matplotlib's colormap turns it into bytes,
each row normalised to its own min and max (`Normalize`, as `imshow`
autoscales), one block of pixels per feature, encoded by the port's
native PNG encoder. The figure around the strip (axes, tick labels,
title, colorbar) is not drawn; the title and the feature names go into
the PNG as tEXt chunks.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ecgmm_torch import native

# (matplotlib.colormaps["viridis"]._lut[:256, :3] * 255).astype(np.uint8),
# row by row, as hex
_VIRIDIS_HEX = (
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f"
    "6247116347126547146647156747166947186a48196b481a6c481c6e481d6f48"
    "1e70482071482172482273482374472575472676472777472878472a79472b7a"
    "472c7b462d7c462f7c46307d46317e45327f45347f4535804536814437814439"
    "82433a83433b83433c84423d84423e854240854141864142864043874044873f"
    "45873f47883e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a"
    "3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c365b8c355c"
    "8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d31668d30"
    "678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b"
    "8e277c8e277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24"
    "868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c"
    "20908c20918c1f928c1f938b1f948b1f958b1f968b1e978a1e988a1e998a1e99"
    "8a1e9a891e9b891e9c891e9d881e9e881e9f881ea0871fa1871fa2861fa38620"
    "a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad80"
    "28ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b7"
    "7836b87738b97639b9763bba753dbb743ebc7340bd7242be7144be7045bf6f47"
    "c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d0"
    "5477d05279d1517cd24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490"
    "d64392d74195d73f97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32"
    "addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e0"
    "1fcae01ecde01dcfe11cd2e11bd4e11ad7e219dae218dce218dfe318e1e318e4"
    "e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61ff8e621fae622fde724"
)
# pixels of one feature's block: the strip is 48 px tall and at least 600
# px wide, the width of matplotlib's 6-inch figure at 100 dpi
CELL_H = 48
STRIP_W = 600


def viridis_lut() -> np.ndarray:
    """(256, 3) uint8: matplotlib's viridis as bytes."""
    return np.frombuffer(bytes.fromhex(_VIRIDIS_HEX), np.uint8).reshape(
        256, 3)


def viridis_rgb(row: np.ndarray) -> np.ndarray:
    """(D, 3) uint8 colours of a 1-D row: matplotlib's
    `colormaps["viridis"](Normalize(row.min(), row.max())(row),
    bytes=True)`, in the row's own float type."""
    row = np.asarray(row)
    lo, hi = row.min(), row.max()
    xa = np.zeros(row.shape, row.dtype) if lo == hi else (row - lo) / (
        hi - lo)
    xa = xa * 256
    xa[xa == 256] = 255
    return viridis_lut()[np.clip(xa.astype(int), 0, 255)]


def mask_strip(row: np.ndarray) -> np.ndarray:
    """(CELL_H, D * w, 3) uint8 heatmap of a mask row, w = max(8,
    STRIP_W // D) pixels a feature."""
    rgb = viridis_rgb(row)
    w = max(8, STRIP_W // rgb.shape[0])
    return np.ascontiguousarray(np.broadcast_to(
        np.repeat(rgb, w, axis=0)[None], (CELL_H, rgb.shape[0] * w, 3)))


def tabnet_masks(model, x) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(M_explain (B, D), [per-step mask (B, D)]) of a TabNetEncoder."""
    with torch.no_grad():
        _, _, m_explain, masks = model(x, return_masks=True)
    return m_explain.cpu().numpy(), [m.cpu().numpy() for m in masks]


def save_mask_heatmaps(
    m_explain: np.ndarray,
    masks: Sequence[np.ndarray],
    feature_names: Optional[Sequence[str]] = None,
    save_dir: str = "./output/tabnet",
    base_filename: str = "mask",
) -> List[str]:
    """Heatmaps of each step mask M[i] and the aggregate M_agg (means over
    the batch): `{base}_M[i].png` (i from 1) and `{base}_M_agg.png`, the
    JAX package's file set."""
    os.makedirs(save_dir, exist_ok=True)
    d = m_explain.shape[1]
    names = ", ".join(feature_names or (f"var_{i}" for i in range(d)))
    paths = []

    def heat(row: np.ndarray, title: str, path: str):
        png = native.png_encode(mask_strip(row))
        with open(path, "wb") as f:
            f.write(native.png_with_text(png, (("Title", title),
                                         ("Features", names))))
        paths.append(path)

    for i, m in enumerate(masks):
        heat(m.mean(0), f"Step Mask M[{i + 1}] (mean over batch)",
             os.path.join(save_dir, f"{base_filename}_M[{i + 1}].png"))
    heat(np.mean([m.mean(0) for m in masks], axis=0),
         "Aggregate Mask M_agg (mean over batch)",
         os.path.join(save_dir, f"{base_filename}_M_agg.png"))
    return paths
