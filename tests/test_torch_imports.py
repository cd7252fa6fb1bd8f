"""Import rules of the torch port, checked on its source (AST, no import).

The port runs where there is no jax: nothing in it, nor ``chip_smoke.py`` or
``kernel_ab.py``,
imports ``jax``, ``jaxlib``, ``flax``, ``optax`` or any module of the JAX
package, nor the ``regex`` package, which the card's machine lacks too
(``evaluator/nq_eval.py`` tokenizes with ``unicodedata`` instead). It keeps
its own copies of the modules the two packages share (``config``, ``data.collators``, ``data.loaders``, ``evaluator.metrics``,
``index.modes``, ``evaluator.nq_eval``); ``tests/test_torch_shared.py`` and
``tests/test_torch_eval.py`` hold each copy to its original."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "denseretrievaltoolkits_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "denseretrievaltoolkits_tpu", "regex")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports(path):
    for name in _imported(path):
        assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_kernel_sources_present():
    names = {p.name for p in (PORT / "csrc").glob("*.cu")}
    assert names == {"attn_ln.cu", "mlp_ln.cu", "block_topj.cu", "contrastive.cu", "quant.cu",
                     "flash_attn.cu", "pq_serve.cu", "ivf_cell.cu", "int4_certified.cu",
                     "flat_certified.cu", "flat_serve.cu"}
