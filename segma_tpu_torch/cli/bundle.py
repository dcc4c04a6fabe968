"""Bundle CLI: catalog a directory of exported artifacts (counterpart of
``segma_tpu/cli/bundle.py``).

    python -m segma_tpu_torch.cli.bundle <dir> [--default <name>]

scans the immediate subdirectories for artifact manifests and (re)writes
``bundle.json``, the catalog that ``cli.serve --bundle`` serves behind one
port (``segma_tpu_torch.bundle``).
"""

from __future__ import annotations

import argparse
import json


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="(re)write bundle.json over a directory of artifacts")
    parser.add_argument("bundle_dir", help="directory of artifact subdirs")
    parser.add_argument(
        "--default", default=None,
        help="model served when requests omit ?model= (required when the bundle holds "
        "several models and no prior election exists)",
    )
    args = parser.parse_args(argv)

    from segma_tpu_torch.bundle import write_bundle_manifest

    out = write_bundle_manifest(args.bundle_dir, default=args.default)
    manifest = json.loads(out.read_text())
    print(f"[log] - wrote {out} (default: {manifest['default']})")
    for name, entry in sorted(manifest["models"].items()):
        version = entry.get("model_version") or "-"
        created = entry.get("created_at") or "-"
        labels = ",".join(entry.get("labels") or [])
        print(f"[log] -   {name:<24} version={version:<12} created={created}  labels={labels}")


if __name__ == "__main__":
    main()
