"""Import rules of the benchmark, by top-level module name compared whole: no module of
the harness or the reference imports JAX or the JAX package (whose name the port's name
begins with), and the reference imports nothing of the port either."""

import ast
import os
import subprocess
import sys

import pytest

from benchsupport import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "denseretrievaltoolkits_tpu"}
PORT = "denseretrievaltoolkits_torch"
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(BENCH) for f in fs
               if f.endswith(".py") and "__pycache__" not in d)


def _top_names(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(_top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("path", [f for f in FILES if os.sep + "reference" + os.sep in f],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_takes_nothing_of_the_port(path):
    names = set(_top_names(path))
    assert PORT not in names and "harness" not in names


def test_the_prefix_is_compared_whole():
    assert PORT.startswith("denseretrievaltoolkits") and PORT not in FORBIDDEN


def test_a_run_loads_no_jax():
    """The harness and the port's modules a run imports leave no forbidden name in
    ``sys.modules`` (the same check a run makes before it prints its result)."""
    code = ("import sys; sys.path[:0] = [%r, %r]; from harness import core, port, refs; "
            "import importlib; [core.load_module('drivers', d) for d in "
            "('encode', 'search', 'train')]; "
            "import denseretrievaltoolkits_torch.run_encode, "
            "denseretrievaltoolkits_torch.index.flat, denseretrievaltoolkits_torch.train.trainer; "
            "print(core.forbidden_loaded())") % (ROOT, BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
