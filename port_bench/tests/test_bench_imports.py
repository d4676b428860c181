"""(a) Nothing the benchmark runs imports JAX or the JAX package, and the
references import nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import harness

SOURCES = sorted(harness.HERE.rglob("*.py"))


def _top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_bench_source_imports_no_jax(path):
    assert not _top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(
    (harness.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_bench_reference_imports_only_torch_numpy(path):
    assert _top_level_imports(path) <= {"__future__", "dataclasses", "math",
                                        "numpy", "torch", "port_bench"}
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "port_bench"):
            assert node.module.startswith("port_bench.reference")


def test_bench_run_loads_no_jax():
    """A whole CPU run of every cell at a small size, in a fresh process:
    sys.modules then holds no module whose top-level name is jax, jaxlib,
    flax or se_tpu (compared whole: se_tpu_torch is the port)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from port_bench.tests._tiny import CELLS, run_tiny\n"
        "from port_bench import harness\n"
        "for name in CELLS:\n"
        "    res, _, _ = run_tiny(name, seconds=0.2)\n"
        "    assert res['correct'], (name, res)\n"
        "import json; print(json.dumps({'forbidden': harness.loaded_forbidden(),"
        " 'port': 'se_tpu_torch' in sys.modules}))\n" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"forbidden": [], "port": True}
