"""Migration CLI: a reference (PyTorch Lightning) checkpoint -> a checkpoint
directory in the JAX package's format (counterpart of
``segma_tpu/cli/import_checkpoint.py``).

    python -m segma_tpu_torch.cli.import_checkpoint --ckpt best.ckpt \\
        --config config.yml --out imported/ [--device cuda|cpu] [key.path=value ...]

Any of the six reference variants. The directory holds the trainable
parameters (``params.msgpack``) and ``meta.yaml`` with ``imported_from``,
``model`` and the fingerprint of the imported frozen encoder. Both packages'
predict CLIs serve it (``python -m segma_tpu_torch.inference --checkpoint
imported/``), and they rebuild the frozen encoder from the config's
``model.config.encoder`` (or ``wav_encoder``): that snapshot must hold the
checkpoint's encoder, or the fingerprint refuses it.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv: list[str] | None = None) -> Path:
    from segma_tpu_torch.checkpoint import build_model, frozen_fingerprint, save_params
    from segma_tpu_torch.config import load_config
    from segma_tpu_torch.convert_reference import import_reference_checkpoint

    parser = argparse.ArgumentParser(description="import a reference checkpoint")
    parser.add_argument("--ckpt", required=True, help="reference .ckpt path")
    parser.add_argument("--config", required=True, help="segma config")
    parser.add_argument("--out", required=True, help="output checkpoint dir")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the model is built (the card unless cpu)")
    args, extra = parser.parse_known_args(argv)

    cfg = load_config(args.config, extra)
    # the model of train.seed, as training and inference build it
    model = build_model(cfg, device=args.device)
    params = import_reference_checkpoint(args.ckpt, model)
    # only the trainable subtree is written, as by training; the frozen
    # encoder comes back from the snapshot at use time
    trainable = {k: v for k, v in params.items() if k not in model.frozen_prefixes}
    frozen = {k: v for k, v in params.items() if k in model.frozen_prefixes}
    meta = {"imported_from": str(args.ckpt), "model": cfg.model.name}
    if frozen:
        meta["frozen_fingerprint"] = frozen_fingerprint(frozen)
    out = save_params(Path(args.out), trainable, meta=meta)
    print(f"[log] - imported {args.ckpt} -> {args.out}")
    return out


if __name__ == "__main__":
    main()
