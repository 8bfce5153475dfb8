"""What the benchmark imports: by AST over every module under
portbench/, and in a fresh interpreter. No module imports jax, jaxlib or
the JAX package find_circ2_tpu; the reference imports nothing of the
program under test (find_circ2_tpu_torch) either, nor any benchmark
module outside itself. Top-level names are compared whole:
find_circ2_tpu_torch is not find_circ2_tpu."""

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench.tests.tiny import REPO

BENCH = os.path.join(REPO, "portbench")
JAX = {"jax", "jaxlib", "flax", "find_circ2_tpu"}


def modules():
    for dirpath, dirnames, files in os.walk(BENCH):
        dirnames[:] = [d for d in dirnames if not d.startswith((".", "_"))]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    """Every module name an import statement of the file names."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    seen = 0
    for path in modules():
        for name in imported(path):
            assert name.split(".")[0] not in JAX, (path, name)
            seen += 1
    assert seen > 50


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for path in modules():
        if not path.startswith(ref + os.sep):
            continue
        for name in imported(path):
            top = name.split(".")[0]
            assert top != "find_circ2_tpu_torch", (path, name)
            if top == "portbench":
                assert name.startswith("portbench.reference"), (path, name)


def _loaded(code: str) -> set:
    r = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted(sys.modules)))"],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr
    return {m.split(".")[0] for m in json.loads(r.stdout.splitlines()[-1])}


@pytest.mark.parametrize("code,forbidden", [
    ("import portbench.reference.compare", JAX | {"find_circ2_tpu_torch"}),
    ("import portbench.harness, portbench.run, portbench.control, "
     "portbench.profile, portbench.index_cache, portbench.library, "
     "portbench.yardstick.bounds\n"
     "from portbench.harness import Cell\n"
     "c = Cell('.', 'rnase_r_16mb.enriched')\n"
     "[c.reader(m['name']) for m in c.per_layer]\n"
     "import find_circ2_tpu_torch.models.stream", JAX),
])
def test_fresh_interpreter_loads_nothing_forbidden(code, forbidden):
    top = _loaded(code)
    assert not top & forbidden, top & forbidden
