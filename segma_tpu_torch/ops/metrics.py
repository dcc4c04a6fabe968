"""Validation metrics on tensors (counterpart of ``segma_tpu/ops/metrics.py``):
per-label counts accumulated over batches, F1 from the counts."""

from __future__ import annotations

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
