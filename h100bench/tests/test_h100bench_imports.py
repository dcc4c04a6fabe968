"""The import boundary: nothing of the harness or the reference imports JAX
or the JAX package, and the reference imports nothing of the program.
Top-level names are compared whole: ``segma_tpu_torch`` is not
``segma_tpu``."""

import ast
import subprocess
import sys

import pytest

from h100bench.harness import manifest as mf
from h100bench.harness.core import FORBIDDEN

FILES = sorted(p for p in mf.BENCH_DIR.rglob("*.py"))
REFERENCE = [p for p in FILES if p.parent.name == "reference"]


def top_level_imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(mf.BENCH_DIR)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(FORBIDDEN), path


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    imports = top_level_imports(path)
    assert "segma_tpu_torch" not in imports and not imports & set(FORBIDDEN)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("h100bench"):
            assert node.module.startswith("h100bench.reference"), (path, node.module)


def test_loaded_modules_after_importing_the_reference_and_harness():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import h100bench.reference.whisper_hydra, h100bench.reference.hubert_hydra\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] == 'segma_tpu_torch')\n"
        "from h100bench.harness import core\n"
        "import h100bench.drivers  # noqa\n"
        "print(ref, core.forbidden_modules())\n" % str(mf.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True).stdout.strip()
    assert out == "[] []", out


def test_forbidden_names_compare_whole():
    from h100bench.harness import core

    sys.modules.setdefault("segma_tpu_torch_lookalike", sys)
    assert "segma_tpu_torch_lookalike" not in core.forbidden_modules()
    assert "segma_tpu" in FORBIDDEN and "segma_tpu_torch" not in FORBIDDEN
