"""Import rules of the torch port, checked on its source (AST, no import).

The port runs where there is no jax: it never imports ``jax``, and from the
JAX package it imports only the five jax-free modules it shares.
``chip_smoke.py`` imports nothing of the JAX package at all: it reaches the
shared names through the port."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "denseretrievaltoolkits_torch"
SHARED = {
    "denseretrievaltoolkits_tpu.config",
    "denseretrievaltoolkits_tpu.data.collators",
    "denseretrievaltoolkits_tpu.data.loaders",
    "denseretrievaltoolkits_tpu.evaluator.metrics",
    "denseretrievaltoolkits_tpu.index.modes",
}
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports(path):
    for name in _imported(path):
        assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "optax"), (path, name)
        if name.startswith("denseretrievaltoolkits_tpu"):
            assert name in SHARED and path.name != "chip_smoke.py", (path, name)


def test_shared_modules_are_jax_free():
    """The shared modules, and the package __init__ they pass through, import no jax."""
    pkg = ROOT / "denseretrievaltoolkits_tpu"
    paths = [pkg / "__init__.py", pkg / "data" / "__init__.py", pkg / "evaluator" / "__init__.py",
             pkg / "index" / "__init__.py"]
    paths += [ROOT / (m.replace(".", "/") + ".py") for m in SHARED]
    for path in paths:
        for name in _imported(path):
            assert not name.startswith("jax"), (path, name)


def test_kernel_sources_present():
    names = {p.name for p in (PORT / "csrc").glob("*.cu")}
    assert names == {"attn_ln.cu", "mlp_ln.cu", "block_topj.cu", "contrastive.cu"}
