"""The torch port's trained IVF index vs the JAX package, on the CPU.

Inputs are made from a seed with numpy and fed to both sides; the JAX cell
kernels (K13 ``_ivf_cell_topj``, K14 ``_ivf_ragged_topj``) run in interpret
mode, the port's as their plain versions. Tolerances:

- The TPU's packed selection rounds each score to 2^id_bits ulps of fp32
  (``_quantum``: id_bits of the cell block, or of the 512-row side-scan
  block); the port keeps exact scores. Per block, selected id sets must be
  equal and scores within two quanta; whole searches must return the same
  ids except where two scores tie within that rounding.
- Probe scores and k-means sums are fp32 sums taken in another order:
  centroids within 1e-5 relative; assignments equal on well-separated data.
- Integer logic (the probe inversion, drop counts, probe counts, the tuner's
  Qcap and hot set) must be equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from denseretrievaltoolkits_tpu.index import flat as jflat
from denseretrievaltoolkits_tpu.index import ivf as jivf
from denseretrievaltoolkits_tpu.index import transforms as jtr
from denseretrievaltoolkits_tpu.index.io import load_index as jload
from denseretrievaltoolkits_tpu.ops import ivf_bulk as jb
from denseretrievaltoolkits_tpu.ops import topk as jtopk
from denseretrievaltoolkits_torch.index import flat as tflat
from denseretrievaltoolkits_torch.index import ivf as tivf
from denseretrievaltoolkits_torch.index import transforms as ttr
from denseretrievaltoolkits_torch.index.io import load_index as tload
from denseretrievaltoolkits_torch.ops import ivf_bulk as tb


def _clustered(rng, n_clusters=24, per=96, dim=32, spread=0.12):
    """The mixture of tests/test_ivf_bulk.py:15-19."""
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    return np.concatenate([c + spread * rng.normal(size=(per, dim)).astype(np.float32)
                           for c in centers])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    corpus = _clustered(rng)  # 2304 rows
    queries = corpus[rng.choice(len(corpus), 64, replace=False)] \
        + 0.05 * rng.normal(size=(64, 32)).astype(np.float32)
    return corpus, queries


def _t(a):
    """A JAX array (bf16 included) as a torch tensor of the same dtype."""
    if a is None:
        return None
    a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    return torch.from_numpy(a).to(torch.bfloat16) if str(a.dtype) == "bfloat16" else \
        torch.from_numpy(np.array(a))


def _tb(a, dtype):
    t = _t(a)
    return t.to(torch.bfloat16) if dtype == "bfloat16" and t is not None else t


def _quantum(block):
    """The JAX packed selection's rounding of a score, relative (topk.py:96-100)."""
    return 2.0 ** ((block - 1).bit_length() - 23)


def _same_up_to_ties(ts, ti, js, ji, rel):
    """Port (ts, ti) vs JAX (js, ji) [Q, k]: equal ids, except where the two
    rank scores that tie within ``rel`` (the port's id is ranked elsewhere by
    JAX at a tied score, or ties JAX's k-th); finite scores within ``rel``;
    -1 exactly where JAX has no row."""
    tol = lambda x: rel * max(1.0, abs(x)) + 1e-6  # noqa: E731
    for r in range(ts.shape[0]):
        jfin = js[r] > jb.NEG_INF / 2
        np.testing.assert_array_equal(ti[r] >= 0, jfin)
        np.testing.assert_allclose(ts[r][jfin], js[r][jfin], rtol=rel, atol=1e-6)
        last = js[r][jfin][-1] if jfin.any() else None
        for p in np.nonzero((ti[r] != ji[r]) & jfin)[0]:
            twin = np.nonzero(ji[r] == ti[r][p])[0]
            assert (twin.size and abs(js[r][twin[0]] - ts[r][p]) <= tol(ts[r][p])) or \
                abs(ts[r][p] - last) <= tol(last), (r, p, ti[r][p], ts[r][p], ji[r][p])


# -- the probe inversion ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_real,Qcap", [(40, 64), (29, 64), (40, 8), (29, 8)])
def test_invert_probe_pairs_matches_jax(n_real, Qcap):
    """Rank-major slotting, padding pairs (rows >= n_real) excluded, drops
    past a small Qcap: every output equal."""
    rng = np.random.default_rng(n_real + Qcap)
    B, nprobe, nlist = 40, 4, 16
    # skewed: cells 0-2 are everybody's favourites
    cells = np.stack([rng.choice(nlist, nprobe, replace=False, p=np.r_[[0.2] * 3,
                                                                      [0.4 / 13] * 13])
                      for _ in range(B)]).astype(np.int32)
    cells[n_real:] = np.arange(nprobe)  # an all-zero padding query probes cells 0..nprobe-1
    want = jb.invert_probe_pairs(jnp.asarray(cells), B, nprobe, nlist, Qcap, n_real)
    got = tb.invert_probe_pairs(torch.from_numpy(cells), B, nprobe, nlist, Qcap, n_real)
    for name, w, g in zip(("qtab", "dest", "sc", "slot", "in_cap", "order", "counts",
                           "n_dropped"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[-1]) > 0 or Qcap == 64
    assert int(got[6].sum()) == n_real * nprobe


# -- K13 / K14 plain versions vs the Pallas kernels ----------------------------------------------


def _cells_case(rng, body, nlist=4, C=128, Qcap=16, dim=64):
    """A slab, cells, row ids (tails of empty slots) and scales for one body."""
    x = rng.normal(size=(nlist * C, dim)).astype(np.float32)
    row_ids = np.arange(nlist * C, dtype=np.int32)
    for c, fill in enumerate((C, C - 37, C // 2, 5)):
        row_ids[c * C + fill:(c + 1) * C] = -1
    q = rng.normal(size=(nlist, Qcap, dim)).astype(np.float32)
    scales = qscales = None
    if body == "float32":
        values, slab = jnp.asarray(x), jnp.asarray(q)
    elif body == "bfloat16":
        values, slab = jnp.asarray(x, jnp.bfloat16), jnp.asarray(q, jnp.bfloat16)
    else:
        v, s = jflat.quantize_int8(x)
        values, scales = jnp.asarray(v), jnp.asarray(s)
        if body == "i8q":
            qi, qs = jtopk.quantize_queries(jnp.asarray(q.reshape(-1, dim)))
            slab, qscales = qi.reshape(nlist, Qcap, dim), qs.reshape(nlist, Qcap)
        else:
            slab = jnp.asarray(q, jnp.bfloat16)
    return slab, values, row_ids, scales, qscales


def _assert_blocks_match(tv, ti, jv, ji, block):
    """Port [nb, Qcap, J] vs JAX [nb, J, Qcap]: per (block, slot) the same
    finite ids, scores within two quanta; empty slots (-inf, -1)."""
    jv, ji = np.transpose(np.asarray(jv), (0, 2, 1)), np.transpose(np.asarray(ji), (0, 2, 1))
    tv, ti = tv.numpy(), ti.numpy()
    fin = jv > jb.NEG_INF / 2
    np.testing.assert_array_equal(ti >= 0, fin)
    flat = fin.reshape(-1, fin.shape[-1])
    assert [set(a[f]) for a, f in zip(ti.reshape(-1, ti.shape[-1]), flat)] \
        == [set(a[f]) for a, f in zip(ji.reshape(-1, ji.shape[-1]), flat)]
    np.testing.assert_allclose(np.sort(np.where(fin, tv, 0), -1), np.sort(np.where(fin, jv, 0), -1),
                               rtol=2 * _quantum(block), atol=1e-6)


@pytest.mark.parametrize("body", ["float32", "bfloat16", "int8", "i8q"])
def test_cell_topj_plain_matches_pallas(body):
    """K13's plain version vs ``_ivf_cell_topj`` (interpret) on one slab: 4
    cells of C=128 in 64-row blocks with empty tails, J=10."""
    slab, values, row_ids, scales, qscales = _cells_case(np.random.default_rng(1), body)
    nlist, Qcap, dim = slab.shape
    J, block = 10, 64
    jv, ji = jb._ivf_cell_topj(slab, values.reshape(nlist, -1, dim), jnp.asarray(
        row_ids.reshape(nlist, -1)), None if scales is None else scales.reshape(nlist, -1), J,
        block, qscales=qscales)
    before = tb.cell_topj.launches_i8q
    tv, ti = tb.cell_topj(_t(slab), _t(values).reshape(nlist, -1, dim),
                          torch.from_numpy(row_ids).reshape(nlist, -1),
                          None if scales is None else _t(scales).reshape(nlist, -1), J, block,
                          qscales=_t(qscales))
    assert tb.cell_topj.launches_i8q == before  # CPU tensors take the plain version
    _assert_blocks_match(tv, ti, jv, ji, block)


@pytest.mark.parametrize("body", ["float32", "bfloat16", "int8", "i8q"])
def test_ragged_topj_plain_matches_pallas(body):
    """K14's plain version vs ``_ivf_ragged_topj`` (interpret): 8 blocks of
    64 rows whose block -> cell map picks the slab."""
    slab, values, row_ids, scales, qscales = _cells_case(np.random.default_rng(2), body)
    block_cell = np.array([0, 0, 2, 1, 1, 3, 3, 3], np.int32)
    J, block = 10, 64
    jv, ji = jb._ivf_ragged_topj(jnp.asarray(block_cell), slab, values, jnp.asarray(row_ids),
                                 scales, J, block, qscales=qscales)
    tv, ti = tb.ragged_topj(torch.from_numpy(block_cell), _t(slab), _t(values),
                            torch.from_numpy(row_ids), _t(scales), J, block, qscales=_t(qscales))
    _assert_blocks_match(tv, ti, jv, ji, block)


def test_selection_plan_halves_within_blocks():
    """J past 32 halves the selection block; each selection block's list is
    its rows' top-J, ids flat positions, never across a storage block."""
    assert tb.selection_plan(100, 2048, 34538, tb.serve_j(100, 2048, 34538)) == (2048, 20)
    assert tb.selection_plan(100, 512, 977, tb.serve_j(100, 512, 977)) == (128, 32)
    assert tb.selection_plan(100, 2048, 2048, 100) == (256, 31)
    rng = np.random.default_rng(3)
    values = torch.from_numpy(rng.normal(size=(2 * 96, 16)).astype(np.float32))
    slab = torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
    row_ids = torch.arange(192, dtype=torch.int32)
    v, i = tb.ragged_topj(torch.tensor([1, 0], dtype=torch.int32), slab, values, row_ids, None,
                          7, 96, sel=40)  # 96-row blocks in selection blocks of 40, 40, 16
    assert v.shape == (6, 8, 7)
    for sb, (lo, hi, cell) in enumerate(((0, 40, 1), (40, 80, 1), (80, 96, 1), (96, 136, 0),
                                         (136, 176, 0), (176, 192, 0))):
        s = slab[cell] @ values[lo:hi].T
        top = torch.sort(s, dim=1, descending=True, stable=True)
        np.testing.assert_array_equal(i[sb].numpy(), (top.indices[:, :7] + lo).numpy())
        np.testing.assert_allclose(v[sb].numpy(), top.values[:, :7].numpy())


# -- the bulk searches ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built(data):
    """JAX-built fixed-capacity (fp32, bf16, int8) and ragged (int8) indexes
    with a hot cell, their side slabs and tiles."""
    corpus, _ = data
    out = {}
    for dtype in ("float32", "bfloat16", "int8"):
        idx = jivf.IVFFlatIndex(32, nlist=16, nprobe=4, dtype=dtype)
        idx.train(corpus, iters=5)
        idx.add(corpus)
        out[dtype] = idx
    r = jivf.IVFRaggedIndex(32, nlist=16, nprobe=4, dtype="int8", block=64)
    r.centroids = out["int8"].centroids
    r.add_device(jnp.asarray(corpus))
    out["ragged"] = r
    return out


def _hot(nlist, cells):
    hp = np.zeros(nlist, np.float32)
    hp[cells] = -np.inf
    return hp


@pytest.mark.parametrize("dtype,i8", [("float32", False), ("bfloat16", False), ("int8", False),
                                      ("int8", True)])
def test_ivf_bulk_search_matches_jax(data, built, dtype, i8):
    """The fixed-capacity search with a hot cell in the side slab (and the
    overflow), 37 real queries of 40, Qcap 16 (drops): ids equal up to ties,
    drops and probe counts equal."""
    _, queries = data
    idx = built[dtype]
    C = int(idx._values.shape[1])
    hot = np.array([3])
    sv, ss, si, side_valid = idx._side_slab(hot)
    block, J = idx._bulk_tiles(16, 10)
    common = dict(k=10, nprobe=4, Qcap=16, block=block, nlist=16, side_valid=side_valid,
                  side_J=jb.serve_j(10, 512, max(512, side_valid)), side_block=512,
                  i8_native=i8, n_real=37)
    q = queries[:40]
    jt = jb.ivf_bulk_search(jnp.asarray(q), idx.centroids, idx._values, idx._row_ids, idx._scales,
                            sv, ss, si, hot_penalty=jnp.asarray(_hot(16, hot)), J=J, C=C,
                            **common)
    sel, Js = tb.selection_plan(10, block, C, J)
    assert (sel, Js) == (block, J)  # J <= 32: the reference's own lists
    tt = tb.ivf_bulk_search(torch.from_numpy(q), _t(idx.centroids), _tb(idx._values, dtype),
                            _t(idx._row_ids), _t(idx._scales), _tb(sv, dtype), _t(ss), _t(si),
                            hot_penalty=torch.from_numpy(_hot(16, hot)), J=Js, sel=sel, **common)
    assert int(jt[2]) == int(tt[2]) > 0
    np.testing.assert_array_equal(tt[3].numpy(), np.asarray(jt[3]))
    _same_up_to_ties(tt[0].numpy()[:37], tt[1].numpy()[:37], np.asarray(jt[0])[:37],
                     np.asarray(jt[1])[:37], 2 * _quantum(max(block, 512)))


@pytest.mark.parametrize("k,i8", [(10, False), (10, True), (40, False)])
def test_ivf_ragged_search_matches_jax(data, built, k, i8):
    """The ragged search (block 64) with a hot cell and padding; at k=40 the
    reference's J (40) exceeds 32, so the port halves the selection block and
    only the whole search compares."""
    _, queries = data
    idx = built["ragged"]
    hot = np.array([5])
    sv, ss, si, side_valid = idx._side_slab(hot)
    mean_rows = max(64, int(idx._n / 16))
    J = jb.serve_j(k, 64, mean_rows)
    common = dict(k=k, nprobe=4, Qcap=24, block=64, nlist=16, nb_max=idx._nb_max,
                  side_valid=side_valid, side_J=jb.serve_j(k, 512, max(512, side_valid)),
                  side_block=512, i8_native=i8, n_real=37)
    q = queries[:40]
    jt = jb.ivf_ragged_search(jnp.asarray(q), idx.centroids, idx._values, idx._row_ids,
                              idx._scales, idx._block_cell, idx._block_start, sv, ss, si,
                              hot_penalty=jnp.asarray(_hot(16, hot)), J=J, **common)
    sel, Js = tb.selection_plan(k, 64, mean_rows, J)
    assert (sel < 64) == (J > 32)
    tt = tb.ivf_ragged_search(torch.from_numpy(q), _t(idx.centroids), _t(idx._values),
                              _t(idx._row_ids), _t(idx._scales), _t(idx._block_cell),
                              _t(idx._block_start), _t(sv), _t(ss), _t(si),
                              hot_penalty=torch.from_numpy(_hot(16, hot)), J=Js, sel=sel,
                              **common)
    assert int(jt[2]) == int(tt[2])
    np.testing.assert_array_equal(tt[3].numpy(), np.asarray(jt[3]))
    _same_up_to_ties(tt[0].numpy()[:37], tt[1].numpy()[:37], np.asarray(jt[0])[:37],
                     np.asarray(jt[1])[:37], 2 * _quantum(512))


# -- k-means -------------------------------------------------------------------------------------


def test_kmeans_and_assign_match_jax(data):
    """Lloyd's iterations from the same initial rows: assignments equal,
    centroids within 1e-5 relative (fp32 sums in another order)."""
    corpus, _ = data
    sel = np.sort(np.random.default_rng(0).choice(len(corpus), 24, replace=False))
    want = np.asarray(jivf._kmeans_device(jnp.asarray(corpus), jnp.asarray(corpus[sel]), 24, 4,
                                          512))
    got = tivf._kmeans_device(torch.from_numpy(corpus), torch.from_numpy(corpus[sel]), 24, 4, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tivf._assign_device(torch.from_numpy(corpus), got, 700).numpy(),
        np.asarray(jivf._assign_device(jnp.asarray(corpus), jnp.asarray(want), 700)))


def test_split_heavy_cells_matches_jax():
    """Two starving centroids move next to the two heaviest cells (the same
    numpy perturbations), then Lloyd's runs: assignments equal, centroids
    within 1e-5 relative. Each heavy cell holds two tight sub-clusters, so
    the split's first boundary (1e-3 between the copies) passes far from
    every row and no fp32 rounding can move a row across it."""
    rng = np.random.default_rng(4)
    centers = 4 * rng.normal(size=(6, 16)).astype(np.float32)
    parts = []
    for c, n in zip(centers[:2], (350, 300)):
        off = 0.5 * rng.normal(size=16).astype(np.float32) / 4
        parts += [c + off + 0.01 * rng.normal(size=(n, 16)).astype(np.float32),
                  c - off + 0.01 * rng.normal(size=(n, 16)).astype(np.float32)]
    parts += [c + 0.3 * rng.normal(size=(100, 16)).astype(np.float32) for c in centers[2:]]
    x = np.concatenate(parts)
    init = np.concatenate([centers, 50 + rng.normal(size=(2, 16)).astype(np.float32)])
    want = np.asarray(jivf._split_heavy_cells(jnp.asarray(x), jnp.asarray(init), 8, 512, seed=3))
    got = tivf._split_heavy_cells(torch.from_numpy(x), torch.from_numpy(init), 8, 512, seed=3)
    assert np.abs(want[6:] - init[6:]).max() > 10  # the starving centroids moved
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tivf._assign_device(torch.from_numpy(x), got, 512).numpy(),
        np.asarray(jivf._assign_device(jnp.asarray(x), jnp.asarray(want), 512)))


# -- the index classes -----------------------------------------------------------------------------

LAYOUT = ("_values", "_row_ids", "_scales", "_ovf_values", "_ovf_ids", "_ovf_scales")


@pytest.mark.parametrize("kind,dtype", [("fixed", "float32"), ("fixed", "bfloat16"),
                                        ("fixed", "int8"), ("ragged", "float32"),
                                        ("ragged", "int8")])
def test_index_loaded_from_jax_matches(tmp_path, data, built, kind, dtype):
    """A JAX-saved index loads bit for bit (cells, ids, scales, overflow,
    block map) and searches as JAX does in every mode."""
    corpus, queries = data
    if kind == "fixed":
        j = built[dtype]
    else:
        j = jivf.IVFRaggedIndex(32, nlist=16, nprobe=4, dtype=dtype, block=64)
        j.centroids = built["int8"].centroids
        j.add_device(jnp.asarray(corpus))
    j.docid = [f"d{i}" for i in range(len(corpus))]
    j.save(str(tmp_path / "j"))
    t = tload(str(tmp_path / "j"), device="cpu")
    assert type(t).__name__ == type(j).__name__ and t.docid == j.docid and len(t) == len(j)
    for name in LAYOUT + (("_block_cell", "_block_start") if kind == "ragged" else ()):
        a, b = getattr(j, name, None), getattr(t, name, None)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(_t(b.float() if b.dtype == torch.bfloat16 else b)
                                          .numpy(), _t(a).float().numpy() if a.dtype ==
                                          jnp.bfloat16 else np.asarray(a), err_msg=name)
    q = queries[:24]
    for mode in ("bulk", "probe", "exact", "approx") + (("i8q",) if dtype == "int8" else ()):
        js, ji = j.search(q, 10, mode=mode)
        ts, ti = t.search(q, 10, mode=mode)
        rel = 1e-5 if mode in ("probe", "exact") else 2 * _quantum(2048)
        _same_up_to_ties(ts, ti, js, ji, rel)


@pytest.mark.parametrize("kind", ["fixed", "ragged"])
def test_independent_training_and_save_interchange(tmp_path, data, kind):
    """Trained from the same seed on both sides: top-10 overlap >= 0.99
    (fp32 sums can flip a probe rank); JAX loads the port's save and ranks
    as the port."""
    corpus, queries = data
    kw = dict(block=64) if kind == "ragged" else {}
    jcls, tcls = ((jivf.IVFRaggedIndex, tivf.IVFRaggedIndex) if kind == "ragged" else
                  (jivf.IVFFlatIndex, tivf.IVFFlatIndex))
    j = jcls(32, nlist=16, nprobe=4, dtype="int8", **kw)
    t = tcls(32, nlist=16, nprobe=4, dtype="int8", device="cpu", **kw)
    for idx in (j, t):
        idx.train(corpus, iters=5, seed=1)
        idx.add(corpus)
    _, ji = j.search(queries, 10)
    ts, ti = t.search(queries, 10)
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ti, ji)]) >= 0.99
    t.docid = [f"d{i}" for i in range(len(corpus))]
    t.save(str(tmp_path / "t"))
    back = jload(str(tmp_path / "t"))
    assert type(back) is jcls and back.docid == t.docid
    np.testing.assert_array_equal(np.asarray(back._row_ids), t._row_ids.numpy())
    bs, bi = back.search(queries, 10)
    _same_up_to_ties(ts, ti, bs, bi, 2 * _quantum(2048))


@pytest.mark.parametrize("kind,dtype", [("fixed", "float32"), ("fixed", "int8"),
                                        ("ragged", "int8")])
def test_add_chunks_equals_add_device(data, kind, dtype):
    """The two-pass chunked build stores what the one-shot build stores (the
    same rows per cell), and both search alike."""
    corpus, queries = data
    cls = tivf.IVFRaggedIndex if kind == "ragged" else tivf.IVFFlatIndex
    kw = dict(block=64) if kind == "ragged" else {}
    a = cls(32, nlist=16, nprobe=8, dtype=dtype, device="cpu", **kw)
    a.train(corpus[:512], iters=4)
    a.add_device(torch.from_numpy(corpus))
    b = cls(32, nlist=16, nprobe=8, dtype=dtype, device="cpu", **kw)
    b.centroids = a.centroids
    b.add_chunks(lambda s, r: corpus[s:s + r], len(corpus), chunk_rows=500)
    assert b._values.shape == a._values.shape and len(b) == len(corpus)
    ra, rb = a._row_ids.reshape(16, -1).numpy(), b._row_ids.reshape(16, -1).numpy()
    for c in range(16):
        assert set(ra[c][ra[c] >= 0]) == set(rb[c][rb[c] >= 0]), c
    for mode in ("bulk", "exact"):
        sa, ia = a.search(queries[:16], 10, mode=mode)
        sb, ib = b.search(queries[:16], 10, mode=mode)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(sa, sb, rtol=1e-6)


def test_add_chunks_overflow_matches_jax():
    """Chunked overflow rows keep (id, row) pairs aligned, as the JAX build."""
    rng = np.random.default_rng(5)
    corpus = rng.normal(size=(512, 16)).astype(np.float32)
    corpus[:400] = corpus[:400] * 0.05 + np.ones(16, np.float32)
    j = jivf.IVFFlatIndex(16, nlist=16, nprobe=16, capacity_factor=1.0)
    j.train(corpus, iters=5)
    j.add_chunks(lambda s, r: corpus[s:s + r], 512, chunk_rows=100)
    t = tivf.IVFFlatIndex(16, nlist=16, nprobe=16, capacity_factor=1.0, device="cpu")
    t.centroids = _t(j.centroids)
    t.add_chunks(lambda s, r: corpus[s:s + r], 512, chunk_rows=100)
    # 400 near-equal rows sit between several centroids, so fp32 rounding
    # may assign a few of them elsewhere than JAX does: the overflow is the
    # same, the cells hold every other row, and the full probe ranks alike
    np.testing.assert_array_equal(t._ovf_ids.numpy(), np.asarray(j._ovf_ids))
    np.testing.assert_array_equal(t._ovf_values.numpy(), corpus[t._ovf_ids.numpy()])
    stored = t._row_ids.numpy()[t._row_ids.numpy() >= 0]
    assert sorted(stored.tolist() + t._ovf_ids.tolist()) == list(range(512))
    _, want = j.search(corpus[:8], 5, mode="probe", nprobe=16)
    np.testing.assert_array_equal(t.search(corpus[:8], 5, mode="probe", nprobe=16)[1], want)


@pytest.mark.parametrize("nlist,nprobe,qcap_factor,k", [(4, 4, 0.01, 5), (16, 8, 0.25, 10)])
def test_self_tuning_state_matches_jax(tmp_path, data, nlist, nprobe, qcap_factor, k):
    """The hot-load setups of tests/test_ivf_bulk.py:74-116 on the same
    layout: the learned Qcap, hot set and drops equal JAX's, and a second
    batch re-tunes nothing."""
    corpus, queries = data
    j = jivf.IVFFlatIndex(32, nlist=nlist, nprobe=nprobe, qcap_factor=qcap_factor)
    j.train(corpus, iters=4)
    j.add(corpus)
    j.save(str(tmp_path / "j"))
    t = tload(str(tmp_path / "j"), device="cpu")
    t.qcap_factor = qcap_factor
    js, ji = j.search(queries, k)
    ts, ti = t.search(queries, k)
    assert t._bulk_state["qcap"] == j._bulk_state["qcap"]
    np.testing.assert_array_equal(np.sort(t._bulk_state["hot"]), np.sort(j._bulk_state["hot"]))
    assert t.last_dropped == j.last_dropped
    _same_up_to_ties(ts, ti, js, ji, 2 * _quantum(2048))
    qcap = t._bulk_state["qcap"]
    # the kernel's plan: the reference's tiles, cut only where J exceeds 32
    block, J = j._bulk_tiles(qcap, k)
    assert t._cell_plan(qcap, k) == (block, *tb.selection_plan(k, block, t._values.shape[1], J))
    t.search(queries, k)
    assert t._bulk_state["qcap"] == qcap


@pytest.mark.parametrize("kind", ["fixed", "ragged"])
def test_few_candidates_yield_sentinel_ids(data, kind):
    """k past the reachable rows: the tail carries -1 ids with no finite
    score, every finite one a real row (tests/test_ivf_bulk.py:440-456)."""
    corpus, queries = data
    kw = dict(block=64) if kind == "ragged" else {}
    cls = tivf.IVFRaggedIndex if kind == "ragged" else tivf.IVFFlatIndex
    idx = cls(32, nlist=24, nprobe=1, device="cpu", **kw)
    idx.train(corpus, iters=6)
    idx.add(corpus)
    s, d = idx.search(queries[:8], k=400, mode="bulk", nprobe=1)
    junk = s < tb.NEG_INF / 2
    assert junk.any()  # one probed cell holds ~96 of 2304 rows
    assert (d[junk] == -1).all() and (d[~junk] >= 0).all()
    assert all(len(set(r[r >= 0])) == (r >= 0).sum() for r in d)


def test_search_bulk_async_matches_sync(data):
    corpus, queries = data
    idx = tivf.IVFRaggedIndex(32, nlist=16, nprobe=8, dtype="int8", block=64, device="cpu")
    idx.train(corpus, iters=5)
    idx.add_device(torch.from_numpy(corpus))
    s, i = idx.search_bulk(queries, 10)
    tv, doc = idx.search_bulk_async(queries, 10)
    np.testing.assert_array_equal(doc.numpy(), i)
    np.testing.assert_allclose(tv.numpy(), s)
    idx._bulk_state = None  # the async path tunes first when no state is kept
    np.testing.assert_array_equal(idx.search_bulk_async(queries, 10)[1].numpy(), i)


# -- transforms ----------------------------------------------------------------------------------


@pytest.mark.parametrize("rotate", [False, True])
def test_pca_transform_matches_jax(tmp_path, data, rotate):
    """PCA / PCAR trained on the same rows: the same projector W W^T within
    1e-4 (an eigenvector's sign is free), and on the same matrix (JAX's
    save) the same projection of seeded queries within 1e-5."""
    corpus, queries = data
    j = jtr.PCATransform(32, 12, rotate=rotate, seed=2)
    j.train(corpus)
    t = ttr.PCATransform(32, 12, rotate=rotate, seed=2, device="cpu")
    t.train(corpus)
    np.testing.assert_allclose(t.matrix @ t.matrix.T, j.matrix @ j.matrix.T, atol=1e-4)
    j.save(str(tmp_path / "m.npz"))
    back = ttr.PCATransform.load(str(tmp_path / "m.npz"), device="cpu")
    np.testing.assert_allclose(back.apply(queries).numpy(), np.asarray(j.apply(queries)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("spec", ["PCAR16,SQ8", "PCAR16,SQ4", "PCA16,IVF8,Flat"])
def test_transformed_index_matches_jax_and_interchanges(tmp_path, data, spec):
    """Factory chains on the same trained transform: the port ranks as JAX;
    each loads the other's save (``load_index`` dispatches on the kinds)."""
    corpus, queries = data
    j = jflat.index_factory(32, spec, nprobe=8)
    j.train(corpus)
    if hasattr(j.inner, "add_chunks"):
        j.add_chunks(lambda s, r: corpus[s:s + r], len(corpus), chunk_rows=1000)
    else:
        j.add(corpus)
    j.docid = [f"d{i}" for i in range(len(corpus))]
    j.save(str(tmp_path / "j"))
    t = tload(str(tmp_path / "j"), device="cpu")
    assert isinstance(t, ttr.TransformedIndex) and t.docid == j.docid
    js, ji = j.search(queries, 10)
    ts, ti = t.search(queries, 10)
    _same_up_to_ties(ts, ti, js, ji, 1e-5 if "IVF" not in spec else 2 * _quantum(2048))
    # the port builds its own through add_chunks, on JAX's transform
    p = tflat.index_factory(32, spec, nprobe=8, device="cpu")
    p.transform = t.transform
    p.train(corpus)
    p.add_chunks(lambda s, r: corpus[s:s + r], len(corpus), chunk_rows=1000)
    p.docid = j.docid
    ps, pi = p.search(queries, 10)
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(pi, ji)]) >= 0.99
    p.save(str(tmp_path / "p"))
    back = jload(str(tmp_path / "p"))
    assert type(back.inner).__name__ == type(p.inner).__name__ and back.docid == p.docid
    bs, bi = back.search(queries, 10)
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(pi, bi)]) >= 0.99
