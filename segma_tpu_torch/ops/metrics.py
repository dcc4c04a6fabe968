"""Validation metrics (counterpart of ``segma_tpu/ops/metrics.py``):
per-label counts accumulated over batches on tensors, F1 from the counts;
exact AUROC and ROC curves over the host's score matrix in numpy."""

from __future__ import annotations

import numpy as np
import torch


def binary_counts(
    probs: torch.Tensor, targets: torch.Tensor, threshold: float = 0.5
) -> dict[str, torch.Tensor]:
    """Per-label TP/FP/FN/TN counts for (N, L) probabilities vs multi-hot."""
    pred = probs > threshold
    t = targets > 0.5
    return {
        "tp": (pred & t).sum(0),
        "fp": (pred & ~t).sum(0),
        "fn": (~pred & t).sum(0),
        "tn": (~pred & ~t).sum(0),
    }


def f1_from_counts(counts: dict[str, torch.Tensor], zero_division: float = 0.0) -> torch.Tensor:
    """Per-label binary F1 (f64) from accumulated counts."""
    tp, fp, fn = (torch.as_tensor(counts[k]).double() for k in ("tp", "fp", "fn"))
    denom = 2 * tp + fp + fn
    return torch.where(denom > 0, 2 * tp / denom.clamp(min=1), torch.full_like(tp, zero_division))


def multiclass_f1(preds: np.ndarray, targets: np.ndarray, n_classes: int) -> np.ndarray:
    """Per-class F1 on argmax predictions (torchmetrics
    ``multiclass_f1_score(average=None, zero_division=0)`` semantics)."""
    f1 = np.zeros(n_classes)
    for c in range(n_classes):
        tp = np.sum((preds == c) & (targets == c))
        fp = np.sum((preds == c) & (targets != c))
        fn = np.sum((preds != c) & (targets == c))
        denom = 2 * tp + fp + fn
        f1[c] = 2 * tp / denom if denom > 0 else 0.0
    return f1


def binary_auroc_np(scores: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Exact per-label AUROC (Mann-Whitney U with tie handling), numpy.

    scores: (N, L) real-valued; targets: (N, L) in {0, 1}. Labels with no
    positives or no negatives return 0.5.
    """
    n, n_labels = scores.shape
    out = np.full(n_labels, 0.5)
    for li in range(n_labels):
        s = scores[:, li].astype(np.float64)
        t = targets[:, li] > 0.5
        n_pos = int(t.sum())
        n_neg = n - n_pos
        if n_pos == 0 or n_neg == 0:
            continue
        order = np.argsort(s)
        ranks = np.empty(n, np.float64)
        # average ranks over ties
        s_sorted = s[order]
        _, inv, counts = np.unique(s_sorted, return_inverse=True, return_counts=True)
        group_sums = np.bincount(inv, weights=np.arange(1, n + 1))
        avg = (group_sums / counts)[inv]
        ranks[order] = avg
        u = ranks[t].sum() - n_pos * (n_pos + 1) / 2
        out[li] = u / (n_pos * n_neg)
    return out


def roc_curve_np(
    scores: np.ndarray, targets: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """(fpr, tpr) arrays for one label's scores (descending thresholds)."""
    order = np.argsort(-scores)
    t = (targets[order] > 0.5).astype(np.float64)
    tps = np.cumsum(t)
    fps = np.cumsum(1 - t)
    n_pos = max(t.sum(), 1e-12)
    n_neg = max((1 - t).sum(), 1e-12)
    return fps / n_neg, tps / n_pos
