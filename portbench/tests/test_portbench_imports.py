"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program.  Module names are compared by
their whole top-level name: the program's name begins with the JAX
package's."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness.common import BENCH, FORBIDDEN, ROOT

PORT = "equivarianttransformermpnn4quantumcomputations_tpu_torch"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imported(path: Path) -> set[str]:
    """Top-level names of every import statement and of every string that
    names a module (``import_module`` targets and the like), less the strings
    of the ``FORBIDDEN`` list that a run checks ``sys.modules`` against."""
    tree = ast.parse(path.read_text())
    guard = {id(c) for a in ast.walk(tree) if isinstance(a, ast.Assign)
             and any(isinstance(t, ast.Name) and t.id == "FORBIDDEN" for t in a.targets)
             for c in ast.walk(a.value)}   # the run's own list of forbidden modules
    out = set()
    for node in ast.walk(tree):
        if id(node) in guard:
            continue
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            head = node.value.split(".")[0]
            if head.startswith("equivarianttransformermpnn4quantumcomputations"):
                out.add(head)
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not _imported(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in SOURCES if "reference" in p.parts],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PORT not in _imported(path)
    assert PORT not in path.read_text()


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.run, portbench.harness.run, portbench.entries.train, "
            "portbench.entries.serve, portbench.calibrate\n"
            "from portbench.harness.common import load_metric, BENCH\n"
            "[load_metric(p.name[:-3]) for p in (BENCH / 'metrics').glob('*.*.py')]\n"
            "import %s.models.matpes, %s.models.oc20, %s.inference, %s.train.trainer\n"
            "from portbench.harness.common import jax_loaded; print(jax_loaded())"
            % (str(ROOT), PORT, PORT, PORT, PORT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
