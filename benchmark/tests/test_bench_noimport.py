"""Nothing the benchmark runs loads JAX, Flax or the JAX package (top-level
names compared whole: `happypose_tpu_torch` is not `happypose_tpu`), and
the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "happypose_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_nothing_forbidden():
    for path in harness.HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in {"torch", "numpy", "benchmark", "contextlib", "dataclasses",
                           "typing", "pathlib", "__future__", "math"}, (path, name)
            if top == "benchmark":
                assert name.startswith("benchmark.reference"), (path, name)


def test_a_run_loads_nothing_forbidden():
    """A cut run of every cell in one process, then its modules."""
    code = (
        "import sys\nfrom benchmark.tests import cut\n"
        "for c in cut.OVERRIDES:\n    cut.run(c, seconds=0.5)\n"
        "from benchmark import harness\nprint(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(harness.ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
