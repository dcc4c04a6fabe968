"""The PyTorch port imports nothing of JAX, flax, optax, the JAX package,
``safetensors``, ``transformers`` or ``lightning`` (the card's machine has
none of the last three: the port reads snapshots and reference checkpoints
itself).

``"segma_tpu_torch".startswith("segma_tpu")`` is true, so the checks match
``segma_tpu`` itself or ``segma_tpu.``-prefixed names only, and the port's
own ``segma_tpu_torch.utils.safetensors`` is not ``safetensors``.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "segma_tpu", "safetensors", "transformers", "lightning",
             "pytorch_lightning")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files() -> list[Path]:
    return sorted((REPO / "segma_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "logmel_ablations.py", REPO / "flash_f32_ablations.py",
    ]


def test_forbidden_matcher():
    assert _forbidden("segma_tpu") and _forbidden("segma_tpu.ops.melspec")
    assert _forbidden("jax.numpy") and _forbidden("flax") and _forbidden("optax")
    assert _forbidden("safetensors.numpy") and _forbidden("transformers")
    assert _forbidden("lightning.pytorch") and _forbidden("pytorch_lightning")
    assert not _forbidden("segma_tpu_torch") and not _forbidden("segma_tpu_torch.ops")
    assert not _forbidden("jaxtyping")
    assert not _forbidden("segma_tpu_torch.utils.safetensors")


def test_no_forbidden_import_statement():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad


# modules of each slice that must stay inside the boundary
REQUIRED = (
    "segma_tpu_torch.inference", "segma_tpu_torch.ops.attention",
    "segma_tpu_torch.models.hubert.encoder", "segma_tpu_torch.models.hubert.builders",
    "segma_tpu_torch.data.loaders", "segma_tpu_torch.data.file_dataset",
    "segma_tpu_torch.data.intervals", "segma_tpu_torch.data.utils", "segma_tpu_torch.train",
    "segma_tpu_torch.ops.metrics", "segma_tpu_torch.utils.logging",
    "segma_tpu_torch.checkpoint", "segma_tpu_torch.tune", "segma_tpu_torch.evaluate",
    "segma_tpu_torch.structs.interval", "segma_tpu_torch.utils.safetensors",
    "segma_tpu_torch.models.whisper.convert", "segma_tpu_torch.models.hubert.convert",
    "segma_tpu_torch.convert_reference", "segma_tpu_torch.cli.import_checkpoint",
)


def test_scan_covers_the_training_slice():
    scanned = {
        ".".join(p.relative_to(REPO).with_suffix("").parts) for p in _port_files()
    }
    assert set(REQUIRED) <= scanned, sorted(set(REQUIRED) - scanned)


def test_scan_catches_a_forbidden_import(tmp_path):
    for src in ("import jax.numpy as jnp", "from flax import linen",
                "from segma_tpu.data import loaders", "from safetensors.numpy import load_file",
                "import transformers", "import optax", "import lightning",
                "from pytorch_lightning import LightningModule"):
        tree = ast.parse(src)
        names = [
            n.name for node in ast.walk(tree) if isinstance(node, ast.Import) for n in node.names
        ] + [node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)]
        assert any(_forbidden(n) for n in names), src


def test_importing_every_module_loads_no_jax():
    code = f"""
import importlib, pkgutil, sys
import segma_tpu_torch
for m in pkgutil.walk_packages(segma_tpu_torch.__path__, "segma_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
chip_smoke.surgical_hydra_config()
chip_smoke.surgical_hubert_hydra_config("data")
forbidden = {FORBIDDEN!r}
bad = sorted(n for n in sys.modules if any(n == f or n.startswith(f + ".") for f in forbidden))
missing = sorted(set({REQUIRED!r}) - set(sys.modules))
print("LOADED", len([n for n in sys.modules if n.startswith("segma_tpu_torch")]))
assert not bad, bad
assert not missing, missing
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_loaded = int(proc.stdout.split("LOADED")[1].split()[0])
    assert n_loaded >= 25  # every module of the package was imported
