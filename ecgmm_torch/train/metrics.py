"""Evaluation metrics on the host (port of `ecgmm_tpu/train/metrics.py`):
accuracy, F1, AUROC with midranks, confusion matrix, text report and the
F1-maximising threshold search, in numpy, with the JAX module's NaN
semantics for degenerate splits (single-class AUROC is NaN,
reference train.py:225-228)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy.stats import rankdata


def accuracy(preds: np.ndarray, labels: np.ndarray) -> float:
    return float(np.mean(np.asarray(preds) == np.asarray(labels)))


def _f1(tp: float, fp: float, fn: float) -> float:
    return float(2.0 * tp / max(2.0 * tp + fp + fn, 1e-12))


def binary_f1(preds: np.ndarray, labels: np.ndarray) -> float:
    """F1 of the positive class (sklearn's f1_score default)."""
    preds, labels = np.asarray(preds), np.asarray(labels)
    tp = np.sum((preds == 1) & (labels == 1))
    fp = np.sum((preds == 1) & (labels == 0))
    fn = np.sum((preds == 0) & (labels == 1))
    return _f1(tp, fp, fn)


def macro_f1(preds: np.ndarray, labels: np.ndarray,
             num_classes: int) -> float:
    preds, labels = np.asarray(preds), np.asarray(labels)
    return float(np.mean([
        _f1(np.sum((preds == c) & (labels == c)),
            np.sum((preds == c) & (labels != c)),
            np.sum((preds != c) & (labels == c)))
        for c in range(num_classes)
    ]))


def auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Binary ROC-AUC as the Mann-Whitney statistic with midranks for
    ties (equal to sklearn's roc_auc_score); NaN when a class is absent."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    n_pos = float(np.sum(labels == 1))
    n_neg = float(len(labels)) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    r_pos = float(np.sum(rankdata(scores)[labels == 1]))
    return (r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def auroc_ovr_macro(probs: np.ndarray, labels: np.ndarray,
                    num_classes: int) -> float:
    """One-vs-rest macro AUROC; an absent class contributes NaN and the
    mean is over the classes present (PARITY.md)."""
    aucs = [auroc(probs[:, c], (np.asarray(labels) == c).astype(np.int64))
            for c in range(num_classes)]
    return float(np.nanmean(aucs)) if not np.all(np.isnan(aucs)) \
        else float("nan")


def confusion_matrix(preds: np.ndarray, labels: np.ndarray,
                     num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (np.asarray(labels).astype(int),
                   np.asarray(preds).astype(int)), 1)
    return cm


def find_best_threshold(y_true: np.ndarray,
                        y_prob: np.ndarray) -> Tuple[float, float]:
    """F1-maximising decision threshold over the reference's grid
    0.1..0.9 step 0.05 (signal_model.py:119-123). Returns (t*, f1*)."""
    thresholds = np.arange(0.1, 0.9, 0.05)
    scores = [binary_f1((y_prob >= t).astype(np.int32), y_true)
              for t in thresholds]
    i = int(np.argmax(scores))
    return float(thresholds[i]), float(scores[i])


def find_best_threshold_multiclass(
    y_true: np.ndarray, probs: np.ndarray, positive_class: int = 1
) -> Tuple[float, float]:
    """Multiclass variant: grid-search a decision threshold for one class
    against argmax of the rest, maximising that class's F1. The cited
    reference function (train_physionet_multi.py:208-218) is a
    degenerate no-op — its y_pred ignores the threshold entirely, so it
    always returns the first grid value; this implements the evident
    intent (PARITY.md row). The first threshold of the best F1 wins."""
    thresholds = np.arange(0.1, 0.9, 0.05)
    others = np.delete(np.arange(probs.shape[1]), positive_class)
    best_t, best_f1 = 0.5, -1.0
    for t in thresholds:
        preds = np.where(
            probs[:, positive_class] >= t,
            positive_class,
            others[np.argmax(probs[:, others], axis=1)],
        )
        f1 = binary_f1((preds == positive_class).astype(np.int32),
                       (np.asarray(y_true) == positive_class).astype(np.int32))
        if f1 > best_f1:
            best_t, best_f1 = float(t), f1
    return best_t, best_f1


def classification_report(
    preds: np.ndarray, labels: np.ndarray, num_classes: int,
    target_names: Optional[list] = None,
) -> str:
    """sklearn-style text report (precision/recall/F1/support per class)."""
    cm = confusion_matrix(preds, labels, num_classes)
    names = target_names or [str(c) for c in range(num_classes)]
    lines = [f"{'':>12} {'precision':>9} {'recall':>9} {'f1-score':>9} "
             f"{'support':>9}"]
    for c in range(num_classes):
        tp = cm[c, c]
        prec = tp / max(cm[:, c].sum(), 1)
        rec = tp / max(cm[c].sum(), 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        lines.append(f"{names[c]:>12} {prec:>9.4f} {rec:>9.4f} {f1:>9.4f} "
                     f"{cm[c].sum():>9d}")
    acc = np.trace(cm) / max(cm.sum(), 1)
    lines.append(f"{'accuracy':>12} {'':>9} {'':>9} {acc:>9.4f} "
                 f"{cm.sum():>9d}")
    return "\n".join(lines)


def summarize_binary(probs_pos: np.ndarray, labels: np.ndarray,
                     threshold: float = 0.5) -> Dict[str, float]:
    """The reference's per-test metric bundle: Acc / F1 / AUROC
    (train.py:218-232)."""
    preds = (probs_pos >= threshold).astype(np.int32)
    return {
        "accuracy": accuracy(preds, labels),
        "f1": binary_f1(preds, labels),
        "auroc": auroc(probs_pos, labels),
    }
