"""The twins of ``ivfpq_sweep.py`` and ``pq_capacity.py`` against the JAX recipes, on the CPU.

Both packages get the same numpy rows (``test_torch_bench_recipes.patch_rows``).
OPQ's training takes minutes on a host, so both sides get the same trained state,
fitted once here by the port on a 16,384-row rotated sample (a rotation from a
seeded QR, 4-bit codebooks, IVF16 centroids and residual codebooks):

- ``ivfpq_sweep`` reads it through the caches: ``bench._cache_get`` for the JAX
  recipe, the twins' cache directory (``bench_data.CACHE_DIR``, here a temporary
  one) for the twin;
- ``pq_capacity`` trains through a monkeypatched trainer: the JAX package's
  ``OPQTransform.train`` and ``ops.pq.pq_train``, and the twin's
  ``bench_data.opq_rotation`` and ``ops.pq.pq_train``, return that state.

The flat PQ arm's recall10@100 is compared within ``RECALL_TOL``; the IVF arms
(which off the TPU may take other paths) are held to bounds. A random rotation
and 4-iteration codebooks bound these codes' recall10@100 near 0.65 at 100,000
rows, so the bounds are 0.5. Each twin prints the JAX lines' keys. The twins'
timing loops make one call here (``bench_data.best_seconds``).
"""

import json
import re

import numpy as np
import pytest
import torch

import bench
from denseretrievaltoolkits_tpu.index import transforms as jtransforms
from denseretrievaltoolkits_tpu.index.ivf_pq import IVFPQIndex as JIVFPQIndex
from denseretrievaltoolkits_tpu.ops import pq as jpq
from denseretrievaltoolkits_tpu.ops import topk as jtopk
from denseretrievaltoolkits_torch.index.ivf_pq import IVFPQIndex
from denseretrievaltoolkits_torch.ops import pq as tpq
from denseretrievaltoolkits_torch.recipes import bench_data as bd
from denseretrievaltoolkits_torch.recipes import ivfpq_sweep, pq_capacity
from recipes import ivfpq_sweep as jax_sweep
from recipes import pq_capacity as jax_capacity

from test_torch_bench_recipes import RECALL_TOL, ROWS, memoized, patch_rows, spectrumed

NLIST = 16


@pytest.fixture(scope="module")
def trained():
    """(rows, rotation, 4-bit codebooks of the rotated sample, IVF16 centroids and
    residual codebooks), fitted by the port on the rotated 16,384-row sample."""
    rows = ROWS
    sample = spectrumed(rows, 2 * 10**9, 16384)
    q, r = np.linalg.qr(np.random.default_rng(3).standard_normal((bd.DIM, bd.DIM)))
    rot = np.ascontiguousarray(q * np.sign(np.diag(r)), np.float32)
    xr = torch.from_numpy(sample @ rot)
    cb = tpq.pq_train(xr, 192, iters=4, k=16)
    idx = IVFPQIndex(bd.DIM, nlist=NLIST, M=192, nbits=4, block=2048, device="cpu")
    idx.train(xr, iters=4, pq_iters=4)
    return rows, rot, cb, idx.centroids.numpy(), idx.codebooks


def _lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _same_line_keys(got, want):
    """The same keys, and the same metric names up to the corpus size (the JAX sweep
    names its 8.8M rows whatever it ran)."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        assert re.sub(r"_\d+k", "", a["metric"]) == re.sub(r"_\d+k", "", b["metric"])


def _one_call(monkeypatch):
    monkeypatch.setattr(bd, "best_seconds", lambda fn, device="cuda", repeats=3, calls=5:
                        (1.0, fn()))


def test_ivfpq_sweep_twin_against_jax(monkeypatch, capsys, tmp_path, trained):
    """Both sweeps at 100,000 rows, 16 queries, OPQ192x4,IVF16,PQ192x4 from the same
    cached state: the same lines (nprobe 8, 16, 32, 64) with the JAX keys and metric
    names, and each nprobe's recall10@100 >= 0.5 on both sides. The JAX sweep's
    timing loops (its reference's serve at J = 4, the async searches) compute once
    (``test_torch_bench_recipes.memoized``; its arrays stay alive through each loop)."""
    rows, rot, _, centroids, codebooks = trained
    patch_rows(monkeypatch, rows, n_docs=100_000, n_queries=16)
    _one_call(monkeypatch)
    monkeypatch.setattr(jtopk, "pallas_topk_serve_scaled",
                        memoized(jtopk.pallas_topk_serve_scaled))
    monkeypatch.setattr(JIVFPQIndex, "search_bulk_async", memoized(JIVFPQIndex.search_bulk_async))
    state = {"opq_192x4_v1": {"rot": rot},
             f"ivfpq_opq192x4_train_v1_nlist{NLIST}": {"centroids": centroids,
                                                        "codebooks": codebooks}}
    monkeypatch.setattr(bench, "_cache_get", lambda name: state.get(name))
    monkeypatch.setenv("BENCH_IVFPQ_NLIST", str(NLIST))
    monkeypatch.setattr(bd, "CACHE_DIR", str(tmp_path / "cache"))
    for name, arrays in state.items():
        bd.cache_put(name, **arrays)
    jax_sweep.main()
    want = _lines(capsys.readouterr().out)
    got = ivfpq_sweep.main(["--device", "cpu"])
    assert _lines(capsys.readouterr().out) == got
    _same_line_keys(got, want)
    assert [g["metric"] for g in got] == [f"ivfpq_opq192x4_nprobe{p}_100k"
                                          for p in (8, 16, 32, 64)]
    for line in got + want:
        assert line["recall10in100"] >= 0.5, line


def test_pq_capacity_twin_against_jax(monkeypatch, capsys, trained):
    """Both recipes at 100,000 rows, 16 queries, 50,000-row slabs and chunks (the
    granule cut to 50,000), IVF16 at nprobe 4, from the same trained rotation and codebooks: the same lines and
    keys; the flat OPQ192x4 serve's recall10@100 within RECALL_TOL of the JAX
    recipe's (the same codes, but at near ties) and >= 0.5, and the IVF-PQ arm's
    >= 0.5 on both sides. The JAX recipe's timing loops compute once, as in the
    sweep's test."""
    rows, rot, cb, _, _ = trained
    patch_rows(monkeypatch, rows)
    monkeypatch.setattr(bd, "GEN_GRANULE", 50_000)
    _one_call(monkeypatch)
    monkeypatch.setattr(jpq, "pallas_topk_pq", memoized(jpq.pallas_topk_pq))
    monkeypatch.setattr(JIVFPQIndex, "search_bulk_async", memoized(JIVFPQIndex.search_bulk_async))
    for name, value in (("N", 100_000), ("NQ", 16), ("SLAB", 50_000), ("CHUNK", 50_000)):
        monkeypatch.setattr(jax_capacity, name, value)
    for name, value in (("PQCAP_DOCS", 100_000), ("PQCAP_QUERIES", 16),
                        ("PQCAP_SLAB", 50_000), ("PQCAP_CHUNK", 50_000),
                        ("PQCAP_NLIST", NLIST), ("PQCAP_NPROBE", 4)):
        monkeypatch.setenv(name, str(value))
    monkeypatch.setattr(jtransforms.OPQTransform, "train",
                        lambda self, reps, block=65536: setattr(self, "matrix", rot))
    monkeypatch.setattr(bd, "opq_rotation", lambda centers, M, nbits: rot)

    def trainer(real):  # the recipes' codebook fit on the rotated sample; other fits run
        def pq_train(sample, M, iters=12, *a, k=256, **kw):
            if (M, k, sample.shape[0]) == (192, 16, 16384):
                return cb
            return real(sample, M, iters, *a, k=k, **kw)
        return pq_train

    for mod in (jpq, tpq):
        monkeypatch.setattr(mod, "pq_train", trainer(mod.pq_train))
    jax_capacity.main()
    want = _lines(capsys.readouterr().out)
    got = pq_capacity.main(["--device", "cpu"])
    assert _lines(capsys.readouterr().out) == got
    _same_line_keys(got, want)
    assert [g["metric"] for g in got] == ["opq192x4_qps_100k_docs_top100",
                                          "ivfpq_opq192x4_qps_100k_docs_top100"]
    assert abs(got[0]["recall10in100"] - want[0]["recall10in100"]) <= RECALL_TOL
    assert got[0]["recall10in100"] >= 0.5
    for line in (got[1], want[1]):
        assert line["nlist"] == NLIST and line["nprobe"] == 4
        assert line["recall10in100"] >= 0.5, line
