"""Import rules of the torch port, checked on its source (AST, no import).

The port runs where there is no jax: nothing in it, nor ``chip_smoke.py``,
``kernel_ab.py`` or the multi-process tests' worker ``tests/torch_dist_worker.py``,
imports ``jax``, ``jaxlib``, ``flax``, ``optax`` or any module of the JAX
package, nor the ``regex`` package, which the card's machine lacks too
(``evaluator/nq_eval.py`` tokenizes with ``unicodedata`` instead). It keeps
its own copies of the modules the two packages share (``config``, ``data.collators``, ``data.loaders``, ``evaluator.metrics``,
``index.modes``, ``evaluator.nq_eval``, and ``data.datasets``, ``data.preprocess``,
``data.samplers``, ``utils``, ``evaluator.bm25``, ``mine.miner``, ``evaluator.trec``,
``evaluator.convert``, ``data.simple_preprocess``, and the recipes ``quality_trend``,
``quality_multiseed`` and ``profile_encoder``);
``tests/test_torch_shared.py``, ``tests/test_torch_eval.py``,
``tests/test_torch_data.py`` and ``tests/test_torch_mining.py`` hold each copy
to its original. ``transformers`` and ``safetensors`` never load on the HF path
(``models/hf_import.py``, ``tests/test_torch_hf.py``). ``transformers``
and ``datasets``, which the card's machine lacks too, are imported only inside
functions, never when a module is imported, and only for a T5 tokenizer or a hub
dataset: a BERT tokenizer directory and local JSON files are read by the port's own
``utils/tokenization.py`` and ``data/json_reader.py``."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "denseretrievaltoolkits_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py",
                                      ROOT / "tests" / "torch_dist_worker.py"]
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


LOADED_IN_FUNCTIONS = ("transformers", "datasets")


def _imported_at_import_time(path):
    """Absolute imports outside function bodies: what importing the module runs."""
    todo = list(ast.parse(path.read_text()).body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        todo.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_hf_packages_imported_only_in_functions(path):
    for name in _imported_at_import_time(path):
        assert name.split(".")[0] not in LOADED_IN_FUNCTIONS, (path, name)


def test_hf_rule_sees_module_level_imports(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\ntry:\n    from datasets import load_dataset\nexcept ImportError:\n"
                   "    pass\nclass A:\n    import transformers\n"
                   "def f():\n    import datasets\n")
    assert sorted(_imported_at_import_time(bad)) == ["datasets", "os", "transformers"]


def test_kernel_sources_present():
    names = {p.name for p in (PORT / "csrc").glob("*.cu")}
    assert names == {"attn_ln.cu", "mlp_ln.cu", "block_topj.cu", "contrastive.cu", "quant.cu",
                     "flash_attn.cu", "pq_serve.cu", "ivf_cell.cu", "int4_certified.cu",
                     "flat_certified.cu", "flat_serve.cu"}


def test_slice_modules_present():
    """The LoRA, HF, mining and BM25 modules of the port, each under the AST checks
    above."""
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"models/lora.py", "models/hf_import.py", "mine/miner.py", "evaluator/bm25.py",
            "evaluator/bm25_native.py", "run_BM25_negative.py"} <= names
    for path in ("models/hf_import.py",):
        assert not {n.split(".")[0] for n in _imported(PORT / path)} & {"transformers",
                                                                        "safetensors"}


def test_t5_and_reranker_modules_present():
    """The T5 and reranker slice's modules, each under the AST checks above: the T5
    towers, the reranker, the trec / convert copies and the ``run_reranker`` twin; none
    reads HF files through ``transformers`` or ``safetensors``."""
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    new = {"models/t5.py", "models/reranker.py", "evaluator/trec.py", "evaluator/convert.py",
           "run_reranker.py"}
    assert new <= names
    for path in sorted(new):
        assert not {n.split(".")[0] for n in _imported(PORT / path)} & {"transformers",
                                                                        "safetensors"}, path


def test_parallel_modules_present():
    """The data-parallel slice's modules, each under the AST checks above: the mesh, the
    three sharded indexes, the process-group start-up, and the workers the multi-process
    tests start, which import the port alone."""
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {f"denseretrievaltoolkits_torch/{m}" for m in (
        "parallel/__init__.py", "parallel/mesh.py", "parallel/sharded_index.py",
        "parallel/sharded_ivf.py", "parallel/sharded_pq.py", "utils/distributed.py")} <= names
    assert "tests/torch_dist_worker.py" in names


def test_cli_and_recipe_modules_present():
    """The CLI slice's modules, each under the AST checks above (the HF rule covers the
    recipes too): the tokenizer and its character tables, the JSON reader,
    ``simple_preprocess``, ``run_toolkits``, ``graft_entry`` and the three recipes. None
    imports ``transformers`` or ``datasets`` but the tokenizer loader and the dataset
    loader, for T5 tokenizers and hub names, inside functions."""
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    new = {"utils/tokenization.py", "utils/bert_chars.py", "data/json_reader.py",
           "data/simple_preprocess.py", "run_toolkits.py", "graft_entry.py",
           "recipes/__init__.py", "recipes/quality_trend.py", "recipes/quality_multiseed.py",
           "recipes/profile_encoder.py"}
    assert new <= names
    hf = {"transformers", "datasets"}
    for path in sorted(new - {"utils/tokenization.py"}):
        assert not {n.split(".")[0] for n in _imported(PORT / path)} & hf, path
    assert {n.split(".")[0] for n in _imported(PORT / "utils/tokenization.py")} & hf == \
        {"transformers"}
    assert {n.split(".")[0] for n in _imported(PORT / "data/datasets.py")} & hf == {"datasets"}
    for path in ("run_encode.py", "run_random_sampling.py", "run_BM25_negative.py",
                 "run_reranker.py"):
        assert not {n.split(".")[0] for n in _imported(PORT / path)} & hf, path


def test_bench_recipe_modules_present():
    """The twins of the six recipes that import ``bench.py``, and ``bench_data``, the
    port's own copies of the helpers they share, each under the AST checks above: none
    imports ``bench``, the JAX package's root ``recipes`` or an HF package."""
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    new = {f"recipes/{m}.py" for m in ("bench_data", "varlen_probe", "latency_probe",
                                       "ivfpq_sweep", "bench_pcar_sq4", "bench_pcar_38m",
                                       "pq_capacity")}
    assert new <= names
    for path in sorted(new):
        top = {n.split(".")[0] for n in _imported(PORT / path)}
        assert not top & {"bench", "recipes", "transformers", "datasets"}, path
