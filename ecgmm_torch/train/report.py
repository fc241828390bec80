"""Test-time report (port of `ecgmm_tpu/train/report.py`): the metrics of
one checkpoint's test pass and `report_{tag}.txt` (the classification
report and the metrics as JSON). The JAX module also draws a confusion
matrix and a ROC curve as PNGs with matplotlib; matplotlib is not
installed on the card's machine, so the port writes no PNGs."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from ecgmm_torch.train import metrics as M


def test_report(
    logits: np.ndarray,
    labels: np.ndarray,
    output_dir: Optional[str] = None,
    tag: str = "best",
    class_names=("Normal", "Abnormal"),
    threshold_search: bool = False,
) -> Dict[str, float]:
    """Metrics bundle (and the text report) for one test pass."""
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
        with open(os.path.join(output_dir, f"report_{tag}.txt"), "w") as f:
            f.write(report_txt + "\n\n" + json.dumps(out, indent=2))
    return out


test_report.__test__ = False  # a library function, not a pytest test
