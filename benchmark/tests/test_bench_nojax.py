"""No module the benchmark runs imports JAX or the JAX package; the
reference imports nothing of the port either. Top-level names (before
the first dot) are compared whole: the port's name begins with the JAX
package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "pathway_tpu"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_bench_module_imports(path):
    names = _imports(path)
    assert not names & FORBIDDEN
    if "reference" in path.relative_to(BENCH).parts:
        assert "pathway_tpu_torch" not in names
        assert names <= {"__future__", "math", "re", "numpy", "torch"}


def test_bench_cells_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.tests import tiny\n"
        "from benchmark import harness\n"
        "for cell in (tiny.EMBED_CELL, tiny.ANSWER_CELL):\n"
        "    assert tiny.run(cell)['correct']\n"
        "print('loaded:' + ','.join(harness.forbidden_modules()))\n"
    ) % str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded:"
