"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program either.  Names are compared by
their whole top-level name: the port's ``consolver_torch`` begins with the
JAX package's name."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "consolver_tpu"}


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "consolver_torch" not in _top_level_imports(path)
    assert not _top_level_imports(path) & FORBIDDEN


def test_whole_names_are_compared():
    sys.path.insert(0, str(BENCH.parent))
    from perfbench import run

    assert "consolver_torch" not in run.FORBIDDEN and "consolver_tpu" in run.FORBIDDEN


def test_a_run_loads_no_jax():
    """A tiny run in a fresh process, then the harness's own look at
    ``sys.modules``."""
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {str(BENCH.parent)!r})\n"
        "from perfbench import run\n"
        "from perfbench.tests import tiny\n"
        "wl, cfg = tiny.cell('sd15-preview-lone')\n"
        "out = run.run_cell('sd15-preview-lone', wl, cfg, tiny.bench(), 3, 1.0, False,"
        " torch.device('cpu'))\n"
        "assert out['correct'], out\n"
        "print('FOUND', run.forbidden_modules())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FOUND []" in proc.stdout
