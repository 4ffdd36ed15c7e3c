"""No module of the benchmark imports JAX, flax or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the plain reference imports nothing of the program."""

import ast
import json
import os
import pathlib
import subprocess
import sys

from benchmark import run

HERE = pathlib.Path(__file__).resolve().parent.parent


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not set(_imports(path)) & set(run.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "photon_ml_tpu_torch" not in set(_imports(path)), path


def test_a_run_loads_no_jax_module():
    script = ("import sys, json\n"
              "from benchmark.tests import tiny\n"
              "for w in tiny.CELLS: tiny.run_tiny(w)\n"
              "from benchmark import run\n"
              "print(json.dumps(run.forbidden_modules()))\n")
    env = dict(os.environ, PYTHONPATH=run.ROOT)
    out = subprocess.run([sys.executable, "-c", script], cwd=run.ROOT, env=env,
                         capture_output=True, text=True, timeout=600, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
