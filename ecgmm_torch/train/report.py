"""Test-time report (port of `ecgmm_tpu/train/report.py`): the metrics of
one checkpoint's test pass, `report_{tag}.txt` (the classification report
and the metrics as JSON), `confusion_{tag}.png` and, for two classes,
`roc_{tag}.png` (the reference's train.py:174-336 artifacts). The JAX
module draws the two PNGs with matplotlib, which the card's machine lacks;
here they are rasters written by the native PNG encoder
(`native.png_encode`): the confusion matrix as cells in matplotlib's
"Blues" with the counts in a 3x5 pixel font, and the ROC curve as a
polyline over the diagonal. Each PNG carries its numbers in tEXt chunks:
`counts` (the matrix as JSON, rows true, columns predicted) and
`class_names`; `fpr` and `tpr` (JSON lists, each float's repr).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ecgmm_torch import native
from ecgmm_torch.train import metrics as M

# matplotlib's "Blues" (ColorBrewer), its nine anchors in 0..255
_BLUES = np.array([(247, 251, 255), (222, 235, 247), (198, 219, 239),
                   (158, 202, 225), (107, 174, 214), (66, 146, 198),
                   (33, 113, 181), (8, 81, 156), (8, 48, 107)], np.float64)
# the digits 0-9, 3 columns x 5 rows, a row a 3-bit number (MSB left)
_DIGITS = ((7, 5, 5, 5, 7), (2, 6, 2, 2, 7), (7, 1, 7, 4, 7),
           (7, 1, 7, 1, 7), (5, 5, 7, 1, 1), (7, 4, 7, 1, 7),
           (7, 4, 7, 5, 7), (7, 1, 1, 1, 1), (7, 5, 7, 5, 7),
           (7, 5, 7, 1, 7))
_CELL = 64
_SIZE = 256


def _blues(v: float) -> np.ndarray:
    x = min(max(v, 0.0), 1.0) * (len(_BLUES) - 1)
    i = min(int(x), len(_BLUES) - 2)
    return np.round(_BLUES[i] + (x - i) * (_BLUES[i + 1] - _BLUES[i]))


def _draw_number(img: np.ndarray, n: int, cy: int, cx: int, color,
                 scale: int = 4) -> None:
    """`n` in the 3x5 digit font, `scale` px a dot, centred at (cy, cx)."""
    text = str(int(n))
    w = (4 * len(text) - 1) * scale
    y0, x0 = cy - 5 * scale // 2, cx - w // 2
    for k, ch in enumerate(text):
        for r, bits in enumerate(_DIGITS[int(ch)]):
            for c in range(3):
                if bits >> (2 - c) & 1:
                    y, x = y0 + r * scale, x0 + (4 * k + c) * scale
                    img[max(y, 0):y + scale, max(x, 0):x + scale] = color


def confusion_image(cm: np.ndarray) -> np.ndarray:
    """The matrix as (n*64, n*64, 3) uint8 cells, coloured as imshow's
    "Blues" between the smallest and the largest count, each count drawn
    in white on the darker half and black on the lighter."""
    n = cm.shape[0]
    lo, hi = float(cm.min()), float(cm.max())
    img = np.empty((n * _CELL, n * _CELL, 3), np.uint8)
    for i in range(n):
        for j in range(n):
            v = (cm[i, j] - lo) / (hi - lo) if hi > lo else 0.0
            cell = img[i * _CELL:(i + 1) * _CELL, j * _CELL:(j + 1) * _CELL]
            cell[:] = _blues(v)
            _draw_number(cell, cm[i, j], _CELL // 2, _CELL // 2,
                         (255, 255, 255) if v > 0.5 else (0, 0, 0))
    return img


def roc_points(labels: np.ndarray, scores: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(fpr, tpr) at each row's score in descending order, as the JAX
    report plots them: cumulative positives and negatives over their
    totals (at least 1)."""
    order = np.argsort(-scores)
    y = np.asarray(labels)[order]
    tps = np.cumsum(y)
    fps = np.cumsum(1 - y)
    return fps / max(fps[-1], 1), tps / max(tps[-1], 1)


def _draw_line(img: np.ndarray, x0, y0, x1, y1, color, every=1) -> None:
    steps = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    for k in range(0, steps, every):
        t = k / max(steps - 1, 1)
        x = int(round(x0 + t * (x1 - x0)))
        y = int(round(y0 + t * (y1 - y0)))
        img[max(y - 1, 0):y + 1, max(x - 1, 0):x + 1] = color


def roc_image(fpr: np.ndarray, tpr: np.ndarray) -> np.ndarray:
    """A (256, 256, 3) uint8 plot: the ROC polyline in matplotlib's first
    colour over a dashed grey diagonal, inside a black frame."""
    img = np.full((_SIZE, _SIZE, 3), 255, np.uint8)
    m = 16
    span = _SIZE - 2 * m - 1

    def at(f, t):
        return m + f * span, _SIZE - 1 - m - t * span

    img[m, m:_SIZE - m] = img[_SIZE - 1 - m, m:_SIZE - m] = 0
    img[m:_SIZE - m, m] = img[m:_SIZE - m, _SIZE - 1 - m] = 0
    for k in range(0, span, 8):  # dashes of 4 px
        x0, y0 = at(k / span, k / span)
        x1, y1 = at(min(k + 4, span) / span, min(k + 4, span) / span)
        _draw_line(img, x0, y0, x1, y1, (128, 128, 128))
    xs = np.concatenate([[0.0], fpr])
    ys = np.concatenate([[0.0], tpr])
    for k in range(len(xs) - 1):
        _draw_line(img, *at(xs[k], ys[k]), *at(xs[k + 1], ys[k + 1]),
                   (31, 119, 180))
    return img


def _write_png(path: str, rgb: np.ndarray,
               text: Sequence[Tuple[str, str]]) -> None:
    with open(path, "wb") as f:
        f.write(native.png_with_text(native.png_encode(rgb), text))


def test_report(
    logits: np.ndarray,
    labels: np.ndarray,
    output_dir: Optional[str] = None,
    tag: str = "best",
    class_names=("Normal", "Abnormal"),
    threshold_search: bool = False,
) -> Dict[str, float]:
    """Metrics bundle (and the report's files) for one test pass."""
    logits = np.asarray(logits, np.float32)
    num_classes = logits.shape[-1]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)

    out: Dict[str, float] = {}
    if num_classes == 2:
        scores = probs[:, 1]
        threshold = 0.5
        if threshold_search:
            threshold, _ = M.find_best_threshold(labels, scores)
            out["threshold"] = threshold
        out.update(M.summarize_binary(scores, labels, threshold))
        preds = (scores >= threshold).astype(np.int32)
    else:
        preds = probs.argmax(-1)
        out["accuracy"] = float((preds == labels).mean())
        out["f1_macro"] = M.macro_f1(preds, labels, num_classes)
        out["auroc_ovr"] = M.auroc_ovr_macro(probs, labels, num_classes)

    names = list(class_names)[:num_classes]
    names += [f"class{i}" for i in range(len(names), num_classes)]
    report_txt = M.classification_report(preds, labels, num_classes, names)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        cm = M.confusion_matrix(preds, labels, num_classes)
        _write_png(os.path.join(output_dir, f"confusion_{tag}.png"),
                   confusion_image(cm),
                   (("Title", f"Confusion matrix ({tag})"),
                    ("counts", json.dumps(np.asarray(cm).tolist())),
                    ("class_names", json.dumps(names))))
        if num_classes == 2 and len(labels):
            fpr, tpr = roc_points(labels, probs[:, 1])
            _write_png(os.path.join(output_dir, f"roc_{tag}.png"),
                       roc_image(fpr, tpr),
                       (("Title", f"ROC ({tag})"),
                        ("fpr", json.dumps(fpr.tolist())),
                        ("tpr", json.dumps(tpr.tolist()))))
        with open(os.path.join(output_dir, f"report_{tag}.txt"), "w") as f:
            f.write(report_txt + "\n\n" + json.dumps(out, indent=2))
    return out


test_report.__test__ = False  # a library function, not a pytest test
