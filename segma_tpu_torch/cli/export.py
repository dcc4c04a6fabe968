"""Export CLI: freeze a trained model into a self-contained artifact
(counterpart of ``segma_tpu/cli/export.py``).

    python -m segma_tpu_torch.cli.export --config cfg.yml --checkpoint DIR \\
        --output ARTIFACT [--platforms cuda cpu] [key.path=value ...]

The output directory holds ``torch.export`` programs (the weights inside)
and a JSON manifest, served by ``segma_tpu_torch.export.ExportedPipeline``.
A ``cuda`` export builds the kernels first, as the serving CLI's warm-up
does.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="segma_tpu_torch artifact export")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default="models/last/best.ckpt")
    parser.add_argument("--output", required=True)
    parser.add_argument("--thresholds", default=None)
    parser.add_argument("--transport", default="int16", choices=["int16", "mulaw", "adpcm", "f32"])
    parser.add_argument("--buckets", type=int, nargs="*", default=[8, 32, 128, 512])
    parser.add_argument("--batch_size", "--batch-size", default=64, type=int)
    parser.add_argument(
        "--platforms", nargs="*", default=["cuda", "cpu"], choices=["cuda", "cpu"],
        help="devices the programs are traced on, one set each (cuda needs a card)",
    )
    parser.add_argument(
        "--model-version", default=None,
        help="free-form version string stamped into the manifest (shown by bundle "
        "catalogs and GET /v1/models)",
    )
    parser.add_argument(
        "--stream-batches", type=int, nargs="*", default=[2, 4, 8],
        help="cross-session streaming batch buckets (each program holds a copy of the "
        "weights; pass nothing after the flag to ship only the single-chunk programs)",
    )
    args, extra = parser.parse_known_args(argv)

    from segma_tpu_torch.checkpoint import load_model_for_inference
    from segma_tpu_torch.config import load_config
    from segma_tpu_torch.export import export_inference
    from segma_tpu_torch.inference import load_thresholds

    platforms = tuple(args.platforms)
    if "cuda" in platforms:
        from segma_tpu_torch.ops import _build

        _build.library()
    model = load_model_for_inference(load_config(args.config, extra), args.checkpoint,
                                     device=platforms[0])
    out = export_inference(
        model,
        args.output,
        thresholds=load_thresholds(args.thresholds),
        buckets=tuple(args.buckets),
        batch_size=args.batch_size,
        transport=args.transport,
        platforms=platforms,
        model_version=args.model_version,
        stream_batches=tuple(args.stream_batches),
    )
    n_bytes = sum(p.stat().st_size for p in Path(out).rglob("*") if p.is_file())
    print(f"[log] - exported {model.name} -> {out} ({n_bytes / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
