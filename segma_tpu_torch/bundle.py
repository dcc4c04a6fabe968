"""Multi-model artifact bundles: one directory, several exported models
(counterpart of ``segma_tpu/bundle.py``).

A bundle is a directory whose immediate subdirectories are artifact
directories (``segma_tpu_torch.export.export_inference``'s output), with a
``bundle.json`` that names them and elects a default. One server process
(``python -m segma_tpu_torch.cli.serve --bundle``) serves every model behind
one port, chosen per request with ``?model=<name>``.

Layout::

    bundle.json            {"format_version", "default", "models": {...}}
    <name>/manifest.json   one artifact (export.py's layout)
    <name>/<platform>/*.pt2

``bundle.json`` is derived: ``write_bundle_manifest`` rebuilds it from the
subdirectories at any time, and ``load_bundle`` builds it in memory when the
file is absent (a bare directory of artifacts is a bundle already).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

BUNDLE_VERSION = 1

# the artifact manifest's fields that bundle.json and GET /v1/models show
_CATALOG_FIELDS = (
    "model_name",
    "labels",
    "sample_rate",
    "transport",
    "framework_version",
    "model_version",
    "created_at",
    "format_version",
    "streaming",
)


def _discover(bundle_dir: Path) -> dict[str, dict]:
    """Subdirectory name -> catalog entry, for every artifact inside."""
    models: dict[str, dict] = {}
    for sub in sorted(p for p in bundle_dir.iterdir() if p.is_dir()):
        mf = sub / "manifest.json"
        if not mf.is_file():
            continue
        manifest = json.loads(mf.read_text())
        entry = {k: manifest.get(k) for k in _CATALOG_FIELDS}
        entry["path"] = sub.name
        models[sub.name] = entry
    if not models:
        raise FileNotFoundError(
            f"no artifact directories (containing manifest.json) under {bundle_dir}"
        )
    return models


def _elect_default(models: dict[str, dict], default: str | None) -> str:
    if default is not None:
        if default not in models:
            raise KeyError(f"default model {default!r} not in bundle (have: {sorted(models)})")
        return default
    if len(models) == 1:
        return next(iter(models))
    raise ValueError(
        f"bundle holds {len(models)} models ({sorted(models)}); pick the "
        "default explicitly (--default / bundle.json 'default')"
    )


def write_bundle_manifest(bundle_dir: Path | str, default: str | None = None) -> Path:
    """Scan ``bundle_dir`` for artifacts and (re)write ``bundle.json``.

    Without ``default`` a re-scan keeps the existing election; a bundle of
    one model elects it."""
    bundle_dir = Path(bundle_dir)
    models = _discover(bundle_dir)
    out = bundle_dir / "bundle.json"
    if default is None and out.is_file():
        prior = json.loads(out.read_text()).get("default")
        if prior in models:
            default = prior
    manifest = {
        "format_version": BUNDLE_VERSION,
        "default": _elect_default(models, default),
        "models": models,
    }
    out.write_text(json.dumps(manifest, indent=2))
    return out


def load_bundle(
    bundle_dir: Path | str, default: str | None = None, device: str | torch.device = "cuda"
) -> tuple[dict, dict]:
    """Load every artifact of a bundle on ``device`` (the card by default).

    Returns ``(manifest, pipelines)``, ``pipelines`` mapping model name ->
    :class:`segma_tpu_torch.export.ExportedPipeline`. ``bundle.json``'s
    listing and election are used when the file exists; a bare directory of
    artifacts loads without it. ``default`` overrides the election."""
    from segma_tpu_torch.export import ExportedPipeline

    bundle_dir = Path(bundle_dir)
    bf = bundle_dir / "bundle.json"
    if bf.is_file():
        manifest = json.loads(bf.read_text())
        if manifest.get("format_version", 1) > BUNDLE_VERSION:
            raise ValueError(
                f"bundle format {manifest['format_version']} is newer than "
                f"this build ({BUNDLE_VERSION})"
            )
        models = manifest["models"]
        if default is not None:
            manifest["default"] = _elect_default(models, default)
    else:
        models = _discover(bundle_dir)
        manifest = {
            "format_version": BUNDLE_VERSION,
            "default": _elect_default(models, default),
            "models": models,
        }
    pipelines = {
        name: ExportedPipeline.load(bundle_dir / entry["path"], device=device)
        for name, entry in models.items()
    }
    if manifest["default"] not in pipelines:
        raise KeyError(
            f"bundle.json default {manifest['default']!r} has no artifact "
            f"directory (have: {sorted(pipelines)})"
        )
    return manifest, pipelines
