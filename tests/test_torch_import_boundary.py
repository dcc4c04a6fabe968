"""The PyTorch port imports nothing of JAX, flax or the JAX package.

``"segma_tpu_torch".startswith("segma_tpu")`` is true, so the checks match
``segma_tpu`` itself or ``segma_tpu.``-prefixed names only.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "segma_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files() -> list[Path]:
    return sorted((REPO / "segma_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_forbidden_matcher():
    assert _forbidden("segma_tpu") and _forbidden("segma_tpu.ops.melspec")
    assert _forbidden("jax.numpy") and _forbidden("flax")
    assert not _forbidden("segma_tpu_torch") and not _forbidden("segma_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


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


def test_importing_every_module_loads_no_jax():
    code = f"""
import importlib, pkgutil, sys
import segma_tpu_torch
for m in pkgutil.walk_packages(segma_tpu_torch.__path__, "segma_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
chip_smoke.surgical_hydra_config()
forbidden = {FORBIDDEN!r}
bad = sorted(n for n in sys.modules if any(n == f or n.startswith(f + ".") for f in forbidden))
print("LOADED", len([n for n in sys.modules if n.startswith("segma_tpu_torch")]))
assert not bad, bad
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_loaded = int(proc.stdout.split("LOADED")[1].split()[0])
    assert n_loaded >= 15  # every module of the package was imported
