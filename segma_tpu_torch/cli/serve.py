"""Serving CLI: expose a model over HTTP on the card (counterpart of
``segma_tpu/cli/serve.py``).

    python -m segma_tpu_torch.cli.serve --config cfg.yml [--checkpoint DIR]
    python -m segma_tpu_torch.cli.serve --artifact DIR
    python -m segma_tpu_torch.cli.serve --bundle DIR [--default-model NAME]

The JAX package's flags, plus ``--device`` (default ``cuda``; ``cpu`` runs
the plain path, and an artifact's CPU programs). Unknown arguments are
config overrides (``key.path=value``).
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="segma_tpu_torch HTTP serving")
    parser.add_argument("--config", default=None)
    parser.add_argument("--checkpoint", default="models/last/best.ckpt")
    parser.add_argument(
        "--artifact", default=None,
        help="serve an exported artifact directory (cli.export) instead of "
        "config+checkpoint: no model registry needed",
    )
    parser.add_argument(
        "--bundle", default=None,
        help="serve every artifact under a bundle directory behind one port "
        "(cli.bundle); requests select with ?model=<name>",
    )
    parser.add_argument("--default-model", default=None,
                        help="override the bundle's default model election")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--thresholds", default=None)
    parser.add_argument("--batch_size", "--batch-size", default=64, type=int)
    parser.add_argument(
        "--batch-window-ms", type=float, default=0.0,
        help="micro-batch concurrent requests arriving within this window "
        "into one packed device dispatch (0 disables)",
    )
    parser.add_argument("--max-batch", type=int, default=8,
                        help="max requests per micro-batch dispatch")
    parser.add_argument("--max-body-mb", type=float, default=512.0,
                        help="refuse request bodies above this size with 413")
    parser.add_argument("--max-sessions", type=int, default=256,
                        help="concurrent streaming-session cap per model (429 when full)")
    parser.add_argument(
        "--max-rss-gb", type=float, default=0.0,
        help="graceful self-recycle: when host RSS crosses this, drain "
        "in-flight requests and exit 75 for the orchestrator to restart "
        "(see /metrics segma_host_rss_bytes). 0 disables",
    )
    parser.add_argument(
        "--mesh", default="auto", choices=["auto", "off"],
        help="auto: with several visible cards, a live model's one-shot requests run "
        "over the config's (data, seq, model) mesh (config mesh.*); off: one card",
    )
    parser.add_argument(
        "--transport", default="int16", choices=["int16", "mulaw", "adpcm", "f32"],
        help="host->device sample encoding of WAV uploads (mulaw/adpcm: lossy, "
        "2x/3.7x fewer bytes than int16)",
    )
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (the kernels) or cpu (the plain path)")
    args, extra = parser.parse_known_args(argv)
    n_sources = sum(x is not None for x in (args.config, args.artifact, args.bundle))
    if n_sources != 1:
        parser.error("exactly one of --config, --artifact or --bundle is required")

    from segma_tpu_torch.config import load_config
    from segma_tpu_torch.inference import load_thresholds
    from segma_tpu_torch.serve import serve_forever

    serve_forever(
        config=load_config(args.config, extra) if args.config else None,
        artifact=args.artifact,
        bundle=args.bundle,
        default_model=args.default_model,
        checkpoint=args.checkpoint,
        host=args.host,
        port=args.port,
        thresholds=load_thresholds(args.thresholds),
        batch_size=args.batch_size,
        batch_window_ms=args.batch_window_ms,
        max_batch=args.max_batch,
        max_body_mb=args.max_body_mb,
        max_sessions=args.max_sessions,
        max_rss_gb=args.max_rss_gb,
        mesh=args.mesh,
        transport=args.transport,
        device=args.device,
    )


if __name__ == "__main__":
    main()
