"""Per-label decision-threshold tuning by grid search on saved logits (a
copy of ``segma_tpu/tune.py``; numpy, yaml and the standard library, torch
only to read ``.pt`` dumps). ``python -m segma_tpu_torch.tune`` runs it.

Re-design of the reference tuner (``scripts/tune.py:15-310``): instead of
K full sklearn ``f1_score`` passes over the stacked frame tensor (one per
candidate threshold), the per-label probabilities are sorted once and every
threshold's TP/FP counts come from two ``searchsorted`` lookups —
O(T log T + K) instead of O(K*T), exact same F1 values.

Semantics parity:
- ground truth rasterized from RTTM at 20 ms resolution
  (``rttm_to_frame_tensor`` == reference ``rttm_to_tensor``,
  ``tune.py:15-56``);
- per-uri zero-padding to align pred/gt lengths (``tune.py:59-92``);
- candidate grid ``round(linspace(0, 1, n_steps), log10(n_steps))``
  (``tune.py:289-294``), F1 with ``zero_division=1.0``;
- ties resolve to the lowest threshold (reference ``max(dict, key=get)``
  returns the first maximum in insertion order);
- output YAML ``{label: {lower_bound, upper_bound: 1.0}}``.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import yaml

from segma_tpu_torch.data.utils import load_uris


def rttm_to_frame_tensor(
    rttm_path: Path, labels: list[str], frame_resolution_s: float = 0.02
) -> np.ndarray:
    """RTTM file -> (num_frames, num_labels) multi-hot at 20 ms frames."""
    label_set = set(labels)
    segments: list[tuple[float, float, str]] = []
    with Path(rttm_path).open("r") as f:
        for lineno, line in enumerate(f, 1):
            parts = line.strip().split()
            if not parts:
                continue
            try:
                start_s, duration_s, label = (
                    float(parts[3]),
                    float(parts[4]),
                    parts[7],
                )
            except (IndexError, ValueError) as e:
                raise ValueError(
                    f"{rttm_path}:{lineno}: not an RTTM line "
                    f"({line.strip()[:60]!r})"
                ) from e
            if label in label_set:
                segments.append((start_s, duration_s, label))

    label_to_idx = {label: i for i, label in enumerate(labels)}
    total = max((s + d for s, d, _ in segments), default=0.0)
    num_frames = math.ceil(total / frame_resolution_s)
    tensor = np.zeros((num_frames, len(labels)), np.float32)
    for start, dur, label in segments:
        a = int(start / frame_resolution_s)
        b = min(math.ceil((start + dur) / frame_resolution_s), num_frames)
        tensor[a:b, label_to_idx[label]] = 1.0
    return tensor


def load_pred_logits(
    logits_p: Path,
    labels: list[str],
    uris_to_load: set[str],
    str_suffix: str = "-logits_dict_t",
) -> dict[str, np.ndarray]:
    """Load per-uri logits dumps: native ``.npz`` and torch ``.pt`` compat."""
    logits_p = Path(logits_p)
    uri_to_logits: dict[str, np.ndarray] = {}
    for f in sorted(logits_p.glob(f"*{str_suffix}.npz")):
        uri = f.stem.split(str_suffix)[0]
        if uri in uris_to_load:
            data = np.load(f)
            uri_to_logits[uri] = np.stack([data[label] for label in labels], axis=1)
    for f in sorted(logits_p.glob(f"*{str_suffix}.pt")):
        uri = f.stem.split(str_suffix)[0]
        if uri in uris_to_load and uri not in uri_to_logits:
            import torch

            d = torch.load(f, map_location="cpu", weights_only=True)
            uri_to_logits[uri] = np.stack(
                [np.asarray(d[label]) for label in labels], axis=1
            )
    return uri_to_logits


def load_gt_as_frames(
    rttm_path: Path, uris_to_load: set[str], labels: list[str]
) -> dict[str, np.ndarray]:
    return {
        p.stem: rttm_to_frame_tensor(p, labels)
        for p in sorted(Path(rttm_path).glob("*.rttm"))
        if p.stem in uris_to_load
    }


def _pad_pair(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad the shorter of two (T, L) tensors on the frame axis."""
    t = max(a.shape[0], b.shape[0])
    pad = lambda x: np.pad(x, ((0, t - x.shape[0]), (0, 0)))  # noqa: E731
    return pad(a), pad(b)


def unify(
    uri_to_t0: dict[str, np.ndarray],
    uri_to_t1: dict[str, np.ndarray],
    uris: set[str],
) -> tuple[np.ndarray, np.ndarray]:
    """Per-uri length alignment, then concat over files."""
    t0s, t1s = [], []
    for uri in sorted(uris):
        a, b = _pad_pair(uri_to_t0[uri], uri_to_t1[uri])
        t0s.append(a)
        t1s.append(b)
    return np.concatenate(t0s, axis=0), np.concatenate(t1s, axis=0)


def get_set(
    true_path: str | Path,
    pred_path: str | Path,
    labels: list[str],
    uri_txt: str = "val",
) -> tuple[np.ndarray, np.ndarray]:
    """(y_true, y_pred_logits) stacked over the uri list's files."""
    true_path, pred_path = Path(true_path), Path(pred_path)
    uris = set(load_uris((true_path / uri_txt).with_suffix(".txt")))
    preds = load_pred_logits(pred_path, labels, uris)
    gts = load_gt_as_frames(true_path / "rttm", uris, labels)
    common = uris & set(preds) & set(gts)
    if not common:
        raise ValueError(
            f"no overlapping uris between predictions ({len(preds)}) and "
            f"ground truth ({len(gts)})"
        )
    gt_t, pred_t = unify(gts, preds, common)
    return gt_t, pred_t


def f1_grid(
    y_true: np.ndarray, probs: np.ndarray, thresholds: np.ndarray
) -> np.ndarray:
    """(K, L) F1 for every (threshold, label) pair in one sorted pass.

    Exact sklearn semantics with ``zero_division=1.0``: predictions are
    ``probs > thr``.
    """
    t_frames, n_labels = y_true.shape
    k = thresholds.shape[0]
    f1 = np.ones((k, n_labels))
    for li in range(n_labels):
        p = probs[:, li]
        t = y_true[:, li] > 0.5
        pos = np.sort(p[t])
        neg = np.sort(p[~t])
        n_pos = pos.shape[0]
        # counts with value > thr  (searchsorted 'right' gives <= thr count)
        tp = n_pos - np.searchsorted(pos, thresholds, side="right")
        fp = neg.shape[0] - np.searchsorted(neg, thresholds, side="right")
        fn = n_pos - tp
        denom = 2 * tp + fp + fn
        with np.errstate(invalid="ignore", divide="ignore"):
            f1[:, li] = np.where(denom > 0, 2 * tp / denom, 1.0)
    return f1


def tune_multilabel(
    y_true: np.ndarray,
    pred_logits: np.ndarray,
    thresholds: np.ndarray,
    labels: list[str],
) -> dict[str, dict[str, float]]:
    """Grid-search the onset (lower bound) per label; upper bound fixed 1.0."""
    probs = 1.0 / (1.0 + np.exp(-pred_logits.astype(np.float64)))
    f1 = f1_grid(y_true, probs, thresholds)
    n_steps = len(thresholds)
    decimals = int(math.log10(n_steps)) if n_steps > 1 else 1
    best = {}
    for li, label in enumerate(labels):
        best_i = int(np.argmax(f1[:, li]))  # ties -> lowest threshold
        best[label] = {
            "lower_bound": round(float(thresholds[best_i]), decimals),
            "upper_bound": 1.0,
        }
    return best


def threshold_grid(precision: float) -> np.ndarray:
    """Reference grid: rounded linspace(0, 1, 1/precision)."""
    if precision not in (0.1, 0.01):
        raise ValueError("precision must be 0.1 or 0.01")
    n_steps = int(1 / precision)
    return np.round(np.linspace(0, 1, n_steps), int(math.log10(n_steps)))


def run_tuning(
    val_ds: Path | str,
    val_logits: Path | str,
    labels: list[str],
    precision: float = 0.1,
    output: Path | str | None = None,
) -> dict[str, dict[str, float]]:
    thresholds = threshold_grid(precision)
    print("[log] - Loading data...", flush=True)
    y_true, y_pred = get_set(val_ds, val_logits, labels)
    print("[log] - Searching for optimal thresholds...", flush=True)
    best = tune_multilabel(y_true, y_pred, thresholds, labels)
    print(f"[log] - Best thresholds found: {best}", flush=True)
    if output is not None:
        output = Path(output)
        output.mkdir(parents=True, exist_ok=True)
        with (output / "best_thresholds.yml").open("w") as f:
            yaml.dump(best, f, sort_keys=False)
    return best


def main(argv: list[str] | None = None) -> None:
    import argparse

    from segma_tpu_torch.config import load_config

    parser = argparse.ArgumentParser(description="tune per-label thresholds")
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--precision", type=float, default=0.1)
    parser.add_argument("--val-ds", type=Path, required=True)
    parser.add_argument("--val-logits", type=Path, required=True)
    parser.add_argument("--output", type=Path, default=Path("tune_out"))
    args = parser.parse_args(argv)

    config = load_config(args.config)
    run_tuning(
        val_ds=args.val_ds,
        val_logits=args.val_logits,
        labels=config.data.classes,
        precision=args.precision,
        output=args.output,
    )


if __name__ == "__main__":
    main()
