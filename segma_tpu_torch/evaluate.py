"""Macro-average F-measure evaluation of RTTM predictions, pyannote-free (a
copy of ``segma_tpu/evaluate.py``; the standard library, and numpy for the
frame F1). ``python -m segma_tpu_torch.evaluate`` runs it.

Re-implementation of the reference evaluator (``scripts/evaluate.py:36-129``,
which wraps ``pyannote.audio...MacroAverageFMeasure``): for every class, the
reference and hypothesis annotations are restricted to that class, merged
into disjoint timelines, and scored by detection precision/recall on
durations, accumulated over all shared uris:

    P = dur(ref ∩ hyp) / dur(hyp),  R = dur(ref ∩ hyp) / dur(ref),
    F = 2PR / (P + R)

The macro average over classes is the headline number. Results are printed
per label and written to ``fscore.csv``.
"""

from __future__ import annotations

import csv
from pathlib import Path

from segma_tpu_torch.annotation import AudioAnnotation
from segma_tpu_torch.structs.interval import Intervals


def rttm_files(path: Path) -> dict[str, Path]:
    """uri -> .rttm path for a directory (nothing parsed yet — the
    evaluator streams per uri so 10k-file runs stay memory-flat)."""
    return {p.stem: p for p in sorted(Path(path).glob("*.rttm"))}


def load_rttm_file(path: Path) -> list[AudioAnnotation]:
    """Annotations of one .rttm file (empty files ok)."""
    return [
        AudioAnnotation.from_rttm(line)
        for line in Path(path).read_text().splitlines()
        if line.strip()
    ]


def load_rttm_dir(path: Path) -> dict[str, list[AudioAnnotation]]:
    """uri -> annotations for every .rttm in a directory (whole-dir
    convenience for small sets; the evaluator itself streams per uri)."""
    return {uri: load_rttm_file(p) for uri, p in rttm_files(path).items()}


def load_uem_dir(path: Path) -> dict[str, list[tuple[float, float]]]:
    """uri -> annotated (start, end) regions from .uem files.

    UEM line format: ``<uri> <channel> <start_s> <end_s>``.
    """
    out: dict[str, list[tuple[float, float]]] = {}
    for uem in sorted(Path(path).glob("*.uem")):
        regions = []
        for line in uem.read_text().splitlines():
            parts = line.split()
            if len(parts) >= 4:
                regions.append((float(parts[2]), float(parts[3])))
        # merge overlaps: _crop_segments intersects per region, so
        # overlapping UEM regions would double-count cropped durations and
        # hand _intersection_duration non-disjoint lists
        merged: list[tuple[float, float]] = []
        for s, e in sorted(regions):
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        out[uem.stem] = merged
    return out


def _crop_segments(
    segs: list[tuple[float, float]], regions: list[tuple[float, float]] | None
) -> list[tuple[float, float]]:
    """Intersect disjoint sorted segments with UEM regions (None = keep all)."""
    if regions is None:
        return segs
    out = []
    for s, e in segs:
        for rs, re_ in regions:
            lo, hi = max(s, rs), min(e, re_)
            if hi > lo:
                out.append((lo, hi))
    return sorted(out)


def _merged_segments(
    annots: list[AudioAnnotation], label: str
) -> list[tuple[float, float]]:
    """Disjoint (start, end) segments of one label, overlaps merged."""
    iv = Intervals(
        [(a.start_time_s, a.end_time_s, label) for a in annots if a.label == label]
    )
    return [(s, e) for s, e, _ in iv]


def _intersection_duration(
    a: list[tuple[float, float]], b: list[tuple[float, float]]
) -> float:
    """Total overlap duration between two disjoint sorted segment lists."""
    total = 0.0
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _duration(segs: list[tuple[float, float]]) -> float:
    return sum(e - s for s, e in segs)


class MacroAverageFMeasure:
    """Accumulating per-class detection F-measure (duration-based)."""

    def __init__(self, classes: list[str]) -> None:
        self.classes = list(classes)
        # per class: [relevant (ref dur), retrieved (hyp dur), relevant_retrieved]
        self._acc = {c: [0.0, 0.0, 0.0] for c in self.classes}
        self._rows: list[dict] = []

    def __call__(
        self,
        reference: list[AudioAnnotation],
        hypothesis: list[AudioAnnotation],
        uri: str = "?",
        uem: list[tuple[float, float]] | None = None,
    ) -> float:
        row = {"uri": uri}
        for c in self.classes:
            ref = _crop_segments(_merged_segments(reference, c), uem)
            hyp = _crop_segments(_merged_segments(hypothesis, c), uem)
            inter = _intersection_duration(ref, hyp)
            self._acc[c][0] += _duration(ref)
            self._acc[c][1] += _duration(hyp)
            self._acc[c][2] += inter
            row[c] = _f(_duration(ref), _duration(hyp), inter)
        row["macro"] = sum(row[c] for c in self.classes) / len(self.classes)
        self._rows.append(row)
        return row["macro"]

    def class_scores(self) -> dict[str, float]:
        return {
            c: _f(rel, ret, rr) for c, (rel, ret, rr) in self._acc.items()
        }

    def detection_rates(self) -> dict[str, dict[str, float]]:
        """Per-class miss rate and false-alarm rate (relative to reference
        duration, DER-style components)."""
        out = {}
        for c, (rel, ret, rr) in self._acc.items():
            miss = (rel - rr) / rel if rel > 0 else 0.0
            fa = (ret - rr) / rel if rel > 0 else (1.0 if ret > 0 else 0.0)
            out[c] = {"miss": miss, "false_alarm": fa}
        return out

    def error_rates(self) -> dict[str, float]:
        """Per-class detection error rate: (miss + false alarm) / ref
        duration — the DER analog for per-class detection (segma_tpu
        extension; the reference reports F-measure only)."""
        out = {}
        for c, (rel, ret, rr) in self._acc.items():
            if rel > 0:
                out[c] = ((rel - rr) + (ret - rr)) / rel
            else:
                out[c] = 0.0 if ret == 0 else float("inf")
        return out

    def der(self) -> float:
        """Micro-averaged detection error rate over all classes: total
        missed + falsely-alarmed duration over total reference duration
        (all classes pooled)."""
        rel = sum(v[0] for v in self._acc.values())
        ret = sum(v[1] for v in self._acc.values())
        rr = sum(v[2] for v in self._acc.values())
        if rel == 0:
            return 0.0 if ret == 0 else float("inf")
        return ((rel - rr) + (ret - rr)) / rel

    def __abs__(self) -> float:
        scores = self.class_scores()
        return sum(scores.values()) / len(scores) if scores else 0.0

    def report_csv(self, path: Path) -> None:
        path = Path(path)
        scores = self.class_scores()
        with path.open("w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["item", *self.classes, "macro"])
            for row in self._rows:
                writer.writerow(
                    [row["uri"]]
                    + [f"{row[c]:.6f}" for c in self.classes]
                    + [f"{row['macro']:.6f}"]
                )
            writer.writerow(
                ["TOTAL"]
                + [f"{scores[c]:.6f}" for c in self.classes]
                + [f"{abs(self):.6f}"]
            )


def _f(relevant: float, retrieved: float, relevant_retrieved: float) -> float:
    p = relevant_retrieved / retrieved if retrieved > 0 else 1.0
    r = relevant_retrieved / relevant if relevant > 0 else 1.0
    return 2 * p * r / (p + r) if (p + r) > 0 else 0.0


def eval_model_output(
    rttm_true_p: Path,
    rttm_pred_p: Path,
    classes: list[str],
    scores_output: Path = Path("fscore.csv"),
    uem_p: Path | None = None,
) -> dict[str, float]:
    """Score predicted RTTMs against ground truth over shared uris.

    ``uem_p``: optional directory of .uem files restricting the scoring
    regions per uri (the reference's pyannote call infers UEM instead)."""
    rttm_true_p, rttm_pred_p = Path(rttm_true_p), Path(rttm_pred_p)
    for p in (rttm_true_p, rttm_pred_p):
        if not p.is_dir():
            raise FileNotFoundError(f"Folder Path '{p}' not found.")

    metric = MacroAverageFMeasure(classes)
    truth = rttm_files(rttm_true_p)
    preds = rttm_files(rttm_pred_p)
    uems = load_uem_dir(uem_p) if uem_p else {}
    # scoring runs over the uri INTERSECTION (reference parity:
    # scripts/evaluate.py:59-75) — but a prediction run that silently
    # dropped files would then be scored only on the files it managed,
    # inflating the number. Be loud about the asymmetry.
    missing_pred = sorted(set(truth) - set(preds))
    if missing_pred:
        shown = ", ".join(missing_pred[:5])
        print(
            f"[log] - NOTE: scoring {len(set(truth) & set(preds))} shared "
            f"uri(s); {len(missing_pred)} ground-truth uri(s) have no "
            f"prediction and are excluded ({shown}"
            f"{', ...' if len(missing_pred) > 5 else ''}) — expected when "
            "predictions cover a split subset, NOT when a predict run "
            "dropped files",
            flush=True,
        )
    shared = sorted(set(truth) & set(preds))
    # per-uri streaming: parse one truth + one prediction file, score,
    # release — memory stays flat for 10k-file runs.
    # Per-file log lines would themselves dominate at that scale: chatty
    # for small sets (reference parity), a progress line per 1000 beyond.
    chatty = len(shared) <= 50
    for i, uri in enumerate(shared):
        if chatty:
            print(f"[log] - evaluating file: '{uri}'", flush=True)
        elif i % 1000 == 0:
            print(f"[log] - evaluating {i}/{len(shared)} ...", flush=True)
        metric(
            load_rttm_file(truth[uri]),
            load_rttm_file(preds[uri]),
            uri=uri,
            uem=uems.get(uri),
        )

    metric.report_csv(scores_output)

    final = {"Total": abs(metric), **metric.class_scores()}
    rates = metric.detection_rates()
    ers = metric.error_rates()
    width = max(len(k) for k in final) + 1
    print("=====================")
    print("[log] - Results\n")
    for k, fscore in final.items():
        extra = ""
        if k in rates:
            extra = (
                f"  (miss {rates[k]['miss']:.3f}, "
                f"fa {rates[k]['false_alarm']:.3f}, "
                f"der {ers[k]:.3f})"
            )
        print(f"{k:<{width}}: {round(fscore, 5)}{extra}")
    print(f"{'DER':<{width}}: {round(metric.der(), 5)}  (micro, pooled)")
    print("=====================", flush=True)
    final["DER"] = metric.der()
    return final


def frame_f1(
    rttm_true_p: Path,
    rttm_pred_p: Path,
    classes: list[str],
    frame_resolution_s: float = 0.02,
) -> dict[str, float]:
    """Per-label frame-level F1 of predicted vs true RTTMs at the model's
    20 ms grid (the "frame-F1" metric): both annotation sets are
    rasterized to multi-hot frame tensors and scored per label."""
    import numpy as np

    from segma_tpu_torch.tune import rttm_to_frame_tensor

    truth = {p.stem: p for p in sorted(Path(rttm_true_p).glob("*.rttm"))}
    preds = {p.stem: p for p in sorted(Path(rttm_pred_p).glob("*.rttm"))}
    tp = np.zeros(len(classes))
    fp = np.zeros(len(classes))
    fn = np.zeros(len(classes))
    for uri in sorted(set(truth) & set(preds)):
        t = rttm_to_frame_tensor(truth[uri], classes, frame_resolution_s)
        p = rttm_to_frame_tensor(preds[uri], classes, frame_resolution_s)
        n = max(t.shape[0], p.shape[0])
        t = np.pad(t, ((0, n - t.shape[0]), (0, 0))) > 0.5
        p = np.pad(p, ((0, n - p.shape[0]), (0, 0))) > 0.5
        tp += (t & p).sum(axis=0)
        fp += (~t & p).sum(axis=0)
        fn += (t & ~p).sum(axis=0)
    denom = 2 * tp + fp + fn
    f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 1.0)
    out = {c: float(f1[i]) for i, c in enumerate(classes)}
    out["Total"] = float(f1.mean())
    return out


def main(argv: list[str] | None = None) -> None:
    import argparse

    from segma_tpu_torch.config import load_config

    parser = argparse.ArgumentParser(description="evaluate RTTM predictions")
    parser.add_argument("--gt", required=True)
    parser.add_argument("--pred", required=True)
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument(
        "--frame-f1",
        action="store_true",
        help="also report frame-level F1 at the 20 ms grid",
    )
    parser.add_argument(
        "--uem", default=None, help="directory of .uem scoring-region files"
    )
    args, extra_args = parser.parse_known_args(argv)

    cfg = load_config(args.config, extra_args)
    eval_model_output(
        rttm_true_p=Path(args.gt),
        rttm_pred_p=Path(args.pred),
        classes=cfg.data.classes,
        scores_output=Path(args.pred).parent / "fscore.csv",
        uem_p=Path(args.uem) if args.uem else None,
    )
    if args.frame_f1:
        scores = frame_f1(Path(args.gt), Path(args.pred), cfg.data.classes)
        print("[log] - frame-level F1 (20 ms grid)")
        for k, v in scores.items():
            print(f"{k:<12}: {round(v, 5)}")


if __name__ == "__main__":
    main()
