"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: ``repro_torch`` starts with ``repro``), and
the reference imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_name_no_forbidden_module():
    for path in (ROOT / "cardbench").rglob("*.py"):
        assert not _imports(path) & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "cardbench" / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path
    code = ("import sys; sys.path[:0] = [%r]; "
            "import cardbench.reference.model, cardbench.reference.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert "repro_torch" not in out and "'cardbench'" in out


def test_a_run_loads_no_forbidden_module():
    """A whole run of every kind, in a fresh process: the modules loaded
    by its end (the run itself exits non-zero where it finds one)."""
    code = f"""
import sys
sys.path[:0] = [{str(ROOT / 'cardbench' / 'tests')!r}, {str(ROOT)!r},
                {str(ROOT / 'src')!r}]
from conftest import KINDS, run_cell
for kind in sorted(KINDS):
    rc, res, _ = run_cell(kind, trace=1)
    assert rc == 0 and res["correct"], (kind, res)
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=600).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
    assert "repro_torch" in loaded
