"""The torch port's IVF-PQ index and the PQ strings in the trainer and the CLI, vs the JAX package.

Inputs are made from a seed with numpy (the workload of
``tests/test_ivf_pq.py`` at dim 128). The JAX cell kernel K17
(``_ivf_ragged_topj_pq``) runs in interpret mode, the port's as its plain
version. Tolerances:

- The TPU's packed selection rounds each score to 2^id_bits ulps of fp32
  (``_quantum`` of the block: the cell block, or the side scan's 512-row
  block); the port keeps exact scores. Per block the same ids and scores
  within two quanta; whole searches the same ids except where two scores tie
  within two quanta of the coarser block.
- Exact ADC: scores within 1e-5 relative (fp32 sums in another order).
- Codes equal to the reference's except at near ties (a share under 1e-3);
  integer logic (the inversion, drops, probe counts, the tuner's hot set)
  equal.
- ``Trainer.evaluate`` (the tiny BERT of ``tests/test_torch_eval.py`` at
  width 128, so the decode layout holds) into "PQ16", "IVF8,PQ16",
  "OPQ16,PQ16" and "IVF8,PQ16x4" (on the JAX-trained index): metrics within
  1e-6 and the dumps row for row, docids equal except at ties within 1e-5
  (two quanta of the 512-row block for IVF-PQ).
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseretrievaltoolkits_tpu.evaluator import retrieval as jretrieval
from denseretrievaltoolkits_tpu.index import flat as jflat
from denseretrievaltoolkits_tpu.index.io import load_index as jload
from denseretrievaltoolkits_tpu.index.ivf_pq import IVFPQIndex as JIVFPQIndex
from denseretrievaltoolkits_tpu.ops import ivf_bulk as jb
from denseretrievaltoolkits_tpu.ops import ivf_pq as jivfpq
from denseretrievaltoolkits_tpu.ops import pq as jpq
from denseretrievaltoolkits_torch.evaluator import retrieval as tretrieval
from denseretrievaltoolkits_torch.index import flat as tflat
from denseretrievaltoolkits_torch.index import transforms as ttr
from denseretrievaltoolkits_torch.index.io import load_index as tload
from denseretrievaltoolkits_torch.index.ivf_pq import IVFPQIndex
from denseretrievaltoolkits_torch.index.pq import PQIndex
from denseretrievaltoolkits_torch.ops import ivf_bulk as tb
from denseretrievaltoolkits_torch.ops import ivf_pq as tivfpq
from denseretrievaltoolkits_torch.ops import pq as tpq

from test_torch_eval import _assert_same_evaluation, _pair, data  # noqa: F401 (fixture)
from test_torch_ivf import _assert_blocks_match, _quantum, _same_up_to_ties

DIM = 128


def _workload(seed=0, n=3000, nq=48, n_centers=40, noise=0.25):
    """tests/test_ivf_pq.py:26-34 at dim 128."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, DIM)).astype(np.float32)
    corpus = (centers[rng.integers(0, n_centers, n)]
              + noise * rng.standard_normal((n, DIM))).astype(np.float32)
    q = (centers[rng.integers(0, n_centers, nq)]
         + noise * rng.standard_normal((nq, DIM))).astype(np.float32)
    return corpus, q


def _t(a):
    return torch.from_numpy(np.array(a))


# -- K17's plain version vs the Pallas kernel ------------------------------------------------------


def _k17_case(nbits, M):
    """8 blocks of 64 code columns over 4 cells (the block -> cell map picks
    the slab and the offsets), padding rows masked, J=10: the JAX kernel's
    lists in interpret mode and the port's operands."""
    rng = np.random.default_rng(nbits)
    nlist, Qcap, J, block = 4, 16, 10, 64
    block_cell = np.array([0, 0, 2, 1, 1, 3, 3, 3], np.int32)
    N = block * block_cell.size
    cb = rng.standard_normal((M, 1 << nbits, DIM // M)).astype(np.float32)
    x = rng.standard_normal((N, DIM)).astype(np.float32)
    codes = np.array(jpq.pq_encode_device(jnp.asarray(x), jnp.asarray(cb)))
    row_ids = np.arange(N, dtype=np.int32)
    for b, fill in enumerate((64, 64, 27, 64, 5, 64, 64, 40)):
        row_ids[b * block + fill:(b + 1) * block] = -1
    slab = rng.standard_normal((nlist, Qcap, DIM)).astype(np.float32)
    poff = rng.standard_normal((nlist, Qcap)).astype(np.float32) * 3
    jv, ji = jivfpq._ivf_ragged_topj_pq(
        jnp.asarray(block_cell), jnp.asarray(slab, jnp.bfloat16), jnp.asarray(codes),
        jnp.asarray(row_ids), jnp.asarray(poff.reshape(nlist, 1, Qcap)),
        jnp.asarray(jpq.build_bdcb(cb)), J, block, nbits)
    table, _ = tpq.bdcb_table(tpq.build_bdcb(cb), k=1 << nbits)
    args = (_t(block_cell), _t(slab).to(torch.bfloat16), _t(codes), _t(row_ids), _t(poff), table,
            J, block)
    return args, (jv, ji)


@pytest.mark.parametrize("nbits,M", [(8, 16), (4, 32)])
def test_ragged_topj_pq_plain_matches_pallas(nbits, M):
    """8 blocks of 64 code columns over 4 cells (the block -> cell map picks
    the slab and the offsets), padding rows masked, J=10: per block the same
    ids, scores within two quanta."""
    args, (jv, ji) = _k17_case(nbits, M)
    before = tivfpq.ragged_topj_pq.launches
    tv, ti = tivfpq.ragged_topj_pq(*args, nbits=nbits)
    assert tivfpq.ragged_topj_pq.launches == before  # CPU tensors: the plain version
    _assert_blocks_match(tv, ti, jv, ji, args[7])


@pytest.mark.parametrize("nbits,M", [(8, 16), (4, 32)])
def test_ragged_topj_pq_plain_filled_slots(nbits, M):
    """K17's plain version with ``slots`` (cell 2 empty, cell 1 full, the
    others part-filled): every filled slot's list equals the list computed
    without ``slots`` and the JAX kernel's (per block the same ids, scores
    within two quanta); every slot past its cell's count is (-inf, -1)."""
    args, (jv, ji) = _k17_case(nbits, M)
    block_cell, block = args[0], args[7]
    Qcap = args[1].shape[1]
    slots = torch.tensor([3, Qcap, 0, 9], dtype=torch.int32)
    sv, si = tivfpq.ragged_topj_pq(*args, nbits=nbits, slots=slots)
    av, ai = tivfpq.ragged_topj_pq(*args, nbits=nbits)
    filled = (torch.arange(Qcap)[None, :] < slots.long()[block_cell.long()][:, None])
    filled = filled[:, :, None].expand_as(sv)
    assert int(filled.sum()) > 0 and int((~filled).sum()) > 0
    assert torch.equal(sv[filled], av[filled]) and torch.equal(si[filled], ai[filled])
    assert bool((sv[~filled] == float("-inf")).all()) and bool((si[~filled] == -1).all())
    # the JAX lists are [nb, J, Qcap]: cleared past the counts in the port's layout
    jvc = torch.from_numpy(np.array(jv)).transpose(1, 2).contiguous()
    jic = torch.from_numpy(np.array(ji)).transpose(1, 2).contiguous()
    tb._clear_empty_slots(jvc, jic, slots, block_cell, 1, 1)
    _assert_blocks_match(sv, si, jvc.transpose(1, 2).numpy(), jic.transpose(1, 2).numpy(), block)


# -- the index -------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    """JAX IVF-PQ indexes (IVF16,PQ32 and IVF16,PQ32x4, 64-row blocks)
    trained on the workload and filled."""
    corpus, _ = _workload()
    out = {}
    for nbits in (8, 4):
        j = JIVFPQIndex(DIM, nlist=16, nprobe=4, M=32, nbits=nbits, block=64)
        j.train(corpus, iters=5, pq_iters=4)
        j.add_device(jnp.asarray(corpus))
        j.docid = [f"d{i}" for i in range(len(corpus))]
        out[nbits] = j
    return out


def _hot(nlist, cells):
    hp = np.zeros(nlist, np.float32)
    hp[cells] = -np.inf
    return hp


@pytest.mark.parametrize("nbits,k", [(8, 10), (4, 10), (8, 40)])
def test_ivf_pq_search_matches_jax(tmp_path, built, nbits, k):
    """``ivf_pq_search`` with a hot cell in the side slab, 37 real queries of
    40 and Qcap 8 (drops): drops and probe counts equal, ids up to ties. At
    k=40 the reference's J (33) exceeds 32: the port halves the selection
    block, so only the whole search compares."""
    corpus, queries = _workload()
    j = built[nbits]
    j.save(str(tmp_path / "j"))
    t = tload(str(tmp_path / "j"), device="cpu")
    hot = np.array([5])
    jsv, jss, jsi, side_valid = j._side_slab(hot)
    tsv, tss, tsi, t_valid = t._side_slab(hot)
    assert t_valid == side_valid
    np.testing.assert_array_equal(tsi.numpy()[:side_valid], np.asarray(jsi)[:side_valid])
    mean_rows = max(64, int(j._n / 16))
    J = jb.serve_j(k, 64, mean_rows)
    side_J = jb.serve_j(k, 512, max(512, side_valid))
    common = dict(k=k, nprobe=4, Qcap=8, block=64, nlist=16, nb_max=j._nb_max,
                  side_valid=side_valid, side_J=side_J, side_block=512, nbits=nbits, n_real=37)
    q = queries[:40]
    jt = jivfpq.ivf_pq_search(jnp.asarray(q), j.centroids, j._values, j._row_ids, j._block_cell,
                              j._block_start, j._bdcb, jsv, jss, jsi,
                              hot_penalty=jnp.asarray(_hot(16, hot)), J=J, **common)
    sel, Js = tb.selection_plan(k, 64, mean_rows, J)
    assert (sel < 64) == (J > 32) and t._cell_plan(8, k) == (64, sel, Js)
    tt = tivfpq.ivf_pq_search(torch.from_numpy(q), t.centroids, t._values, t._row_ids,
                              t._block_cell, t._block_start, t._table, tsv, tss, tsi,
                              hot_penalty=torch.from_numpy(_hot(16, hot)), J=Js, sel=sel, **common)
    assert int(jt[2]) == int(tt[2]) > 0
    np.testing.assert_array_equal(tt[3].numpy(), np.asarray(jt[3]))
    # the side scan's 512-row blocks round coarser than the 64-row cells
    _same_up_to_ties(tt[0].numpy()[:37], tt[1].numpy()[:37], np.asarray(jt[0])[:37],
                     np.asarray(jt[1])[:37], 2 * _quantum(512))


@pytest.mark.parametrize("nbits", [8, 4])
def test_index_loaded_from_jax_matches_in_every_mode(tmp_path, built, nbits):
    """A JAX-saved index loads bit for bit and searches as JAX does: bulk /
    serve / approx through K17 (with the tuner), exact over every
    reconstruction; probe, i8q and partial raise on both sides."""
    _, queries = _workload()
    j = built[nbits]
    j.save(str(tmp_path / "j"))
    t = tload(str(tmp_path / "j"), device="cpu")
    assert type(t) is IVFPQIndex and t.docid == j.docid and len(t) == len(j)
    assert (t.nlist, t.nprobe, t.M, t.nbits, t.block, t._nb_max) == \
        (j.nlist, j.nprobe, j.M, j.nbits, j.block, j._nb_max)
    for name in ("_values", "_row_ids", "_block_cell", "_block_start", "centroids"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    for mode in ("bulk", "serve", "approx", "exact"):
        js, ji = j.search(queries, 10, mode=mode)
        ts, ti = t.search(queries, 10, mode=mode)
        _same_up_to_ties(ts, ti, js, ji, 1e-5 if mode == "exact" else 2 * _quantum(512))
    assert t.last_dropped == j.last_dropped
    for mode in ("probe", "i8q", "partial"):
        for idx in (t, j):
            with pytest.raises(ValueError, match=mode):
                idx.search(queries, 5, mode=mode)


def test_add_paths_codes_and_save_interchange(tmp_path, built):
    """The port's add_chunks (chunks of 700) and add_device store the same
    codes and layout; against JAX's trained state its codes equal JAX's but
    at near ties; JAX loads the port's save and ranks alike."""
    corpus, queries = _workload()
    j = built[4]
    idx = []
    for how in ("add_device", "add_chunks"):
        t = IVFPQIndex(DIM, nlist=16, nprobe=4, M=32, nbits=4, block=64, device="cpu")
        t.centroids = _t(j.centroids)
        t.codebooks = np.array(j.codebooks)
        t._set_codebooks()
        if how == "add_device":
            t.add_device(torch.from_numpy(corpus))
        else:
            t.add_chunks(lambda s, r: corpus[s:s + r], len(corpus), chunk_rows=700)
        idx.append(t)
    a, b = idx
    for name in ("_values", "_row_ids", "_block_cell", "_block_start"):
        np.testing.assert_array_equal(getattr(a, name).numpy(), getattr(b, name).numpy())
    np.testing.assert_array_equal(a._row_ids.numpy(), np.asarray(j._row_ids))
    assert (a._values.numpy() != np.asarray(j._values)).mean() < 1e-3
    a.docid = [f"p{i}" for i in range(len(corpus))]
    a.save(str(tmp_path / "t"))
    back = jload(str(tmp_path / "t"))
    assert type(back) is JIVFPQIndex and back.docid == a.docid
    np.testing.assert_array_equal(np.asarray(back._values), a._values.numpy())
    bs, bi = back.search(queries, 10, mode="bulk")
    ts, ti = a.search(queries, 10, mode="bulk")
    _same_up_to_ties(ts, ti, bs, bi, 2 * _quantum(512))


def test_independent_training_matches_jax():
    """Trained from the same seed on both sides: k-means centroids within
    1e-4, top-10 overlap of the bulk search >= 0.95 (fp32 sums can move a
    row's cell, and with it the residual codebooks)."""
    corpus, queries = _workload(seed=1, n=2500)
    j = JIVFPQIndex(DIM, nlist=8, nprobe=4, M=16, block=64)
    t = IVFPQIndex(DIM, nlist=8, nprobe=4, M=16, block=64, device="cpu")
    for idx in (j, t):
        idx.train(corpus, iters=4, pq_iters=3, seed=1)
        idx.add(corpus)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), rtol=1e-4,
                               atol=1e-4)
    _, ji = j.search(queries, 10)
    _, ti = t.search(queries, 10)
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ti, ji)]) >= 0.95


def test_sentinels_when_candidates_short():
    """nprobe 1 and k=400 over 800 rows: -1 exactly where the score is not
    finite, every other id a stored row (tests/test_ivf_pq.py:144-159)."""
    corpus, q = _workload(n=800)
    t = tflat.index_factory(DIM, "IVF16,PQ32", nprobe=1, device="cpu")
    t.train(corpus)
    t.add_device(torch.from_numpy(corpus))
    s, i = t.search(q[:8], 400, mode="bulk")
    assert (i == -1).any()
    np.testing.assert_array_equal(i == -1, s <= tb.NEG_INF / 2)
    assert i[i >= 0].max() < len(corpus)


def test_hot_cell_side_slab_matches_jax(tmp_path):
    """Every query near one stored row: the tuner moves its cell to the side
    slab of decoded, K7-quantized reconstructions, on both sides alike, and
    the bulk search keeps overlap > 0.9 with the exact ADC scan
    (tests/test_ivf_pq.py:162-184)."""
    rng = np.random.default_rng(3)
    corpus, _ = _workload(seed=3)
    j = jflat.index_factory(DIM, "IVF16,PQ32", nprobe=4)
    j.qcap_factor = 1.0
    j.train(corpus[:2500])
    j.add_device(jnp.asarray(corpus))
    j.save(str(tmp_path / "j"))
    t = tload(str(tmp_path / "j"), device="cpu")
    t.qcap_factor = 1.0
    q_hot = (corpus[0][None, :] + 0.05 * rng.standard_normal((64, DIM))).astype(np.float32)
    js, ji = j.search(q_hot, 20, mode="bulk")
    ts, ti = t.search(q_hot, 20, mode="bulk")
    assert t._bulk_state["hot"].size >= 1
    np.testing.assert_array_equal(t._bulk_state["hot"], j._bulk_state["hot"])
    assert t._bulk_state["qcap"] == j._bulk_state["qcap"] and t.last_dropped == j.last_dropped
    _same_up_to_ties(ts, ti, js, ji, 2 * _quantum(512))
    _, ie = t.search(q_hot, 20, mode="exact")
    assert np.mean([len(set(a) & set(b)) / 20 for a, b in zip(ti, ie)]) > 0.9


def test_factory_strings_and_chain_loading(tmp_path):
    """IVF-PQ strings build with the reference's parameters (OPQ's code
    width from the inner index); bad geometry raises ValueError on both
    sides; a PCAR chain over IVF-PQ reloads by kind."""
    for spec in ("IVF16,PQ32", "IVFR16,PQ32x4", "IVF8,PQ64", "OPQ32x4,IVF16,PQ32x4"):
        t = tflat.index_factory(DIM, spec, nprobe=6, device="cpu")
        j = jflat.index_factory(DIM, spec, nprobe=6)
        ti, ji = (t.inner, j.inner) if spec.startswith("OPQ") else (t, j)
        assert type(ti) is IVFPQIndex and type(ji).__name__ == "IVFPQIndex"
        assert (ti.nlist, ti.nprobe, ti.M, ti.nbits, ti.block, ti.QCAP_ELEMS) == \
            (ji.nlist, ji.nprobe, ji.M, ji.nbits, ji.block, ji.QCAP_ELEMS)
        if spec.startswith("OPQ"):
            assert (t.transform.M, t.transform.nbits) == (j.transform.M, j.transform.nbits) \
                == (32, 4)
    for spec in ("IVF16,PQ24", "IVF16,PQ7"):  # d_sub does not divide 128 / dim
        with pytest.raises(ValueError):
            tflat.index_factory(DIM, spec, device="cpu")
        with pytest.raises(ValueError):
            jflat.index_factory(DIM, spec)
    corpus, q = _workload(n=2000)
    x = np.concatenate([corpus, corpus[:, ::-1]], axis=1)
    chain = tflat.index_factory(2 * DIM, "PCAR128,IVF16,PQ32x4", nprobe=6, device="cpu")
    chain.train(x)
    chain.add_device(torch.from_numpy(x))
    s1, i1 = chain.search(np.concatenate([q, q[:, ::-1]], axis=1), 10, mode="bulk")
    chain.save(str(tmp_path / "c"))
    back = tload(str(tmp_path / "c"), device="cpu")
    assert isinstance(back, ttr.TransformedIndex) and type(back.inner) is IVFPQIndex
    s2, i2 = back.search(np.concatenate([q, q[:, ::-1]], axis=1), 10, mode="bulk")
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(s1, s2)
    assert type(jload(str(tmp_path / "c")).inner).__name__ == "IVFPQIndex"


# -- the trainer's evaluation and the retrieval CLI ------------------------------------------------


@pytest.fixture(scope="module")
def data128(data):  # noqa: F811
    """The evaluation fixtures with a 128-wide tiny BERT (the decode layout
    needs 128 | dim)."""
    tmp, tokenizer, jdata, tdata, dataset, corpus, cfg = data
    return tmp, tokenizer, jdata, tdata, dataset, corpus, dict(cfg, hidden_size=128,
                                                               intermediate_size=256)


@pytest.fixture(scope="module")
def trainers(data128):
    return _pair(data128, "pq", nprobe=8)


CASES = [("PQ16", "exact", PQIndex, 31), ("PQ16", "serve", PQIndex, 31),
         ("IVF8,PQ16", "bulk", IVFPQIndex, 32), ("IVF8,PQ16", "exact", IVFPQIndex, 32),
         ("OPQ16,PQ16", "exact", ttr.TransformedIndex, 33)]
REL = {"IVF8,PQ16": 2 * _quantum(512), "IVF8,PQ16x4": 2 * _quantum(512)}


@pytest.mark.parametrize("factory,mode,cls,ep", CASES, ids=[f"{f}-{m}" for f, m, _, _ in CASES])
def test_evaluate_pq_factory_matches_jax(trainers, factory, mode, cls, ep):
    """Both Trainers spill the 48 encoded passages, train the index on them,
    build it through ``add_chunks`` in 16-row chunks and search (nprobe =
    nlist: every cell probed); serve over 48 rows is the tiny-corpus scan.
    8-bit codebooks (256 entries) fit 48 rows exactly, so the two trainings
    agree."""
    jtrainer, ttrainer = trainers
    for trainer in trainers:
        trainer.training_args.index_factory = factory
        trainer.training_args.search_mode = mode
    want = jtrainer.evaluate(jtrainer.eval_loader, ep)
    got = ttrainer.evaluate(ttrainer.eval_loader, ep)
    assert type(ttrainer.index) is cls and type(jtrainer.index).__name__ == cls.__name__
    assert ttrainer.index.is_trained and len(ttrainer.index) == 48
    assert got.keys() == want.keys()
    _assert_same_evaluation(jtrainer.training_args, ttrainer.training_args, ep,
                            rel=max(1e-5, REL.get(factory, 0)))
    assert ttrainer.idx == jtrainer.idx


def test_evaluate_4bit_ivf_pq_on_the_jax_trained_index(trainers):
    """"IVF8,PQ16x4": 16-entry residual codebooks over 48 rows are k-means
    with near ties, which the two encoders' 1e-5 differences flip, so each
    Trainer's own training is only checked to run (trained, 48 rows, K17's
    plain version searched); the evaluation itself is held to JAX's on the
    index JAX trained, which the port's ``_load_index`` reads."""
    jtrainer, ttrainer = trainers
    for trainer in trainers:
        trainer.training_args.index_factory = "IVF8,PQ16x4"
        trainer.training_args.search_mode = "bulk"
    ttrainer.evaluate(ttrainer.eval_loader, 36)
    assert type(ttrainer.index) is IVFPQIndex and ttrainer.index.nbits == 4
    assert ttrainer.index.is_trained and len(ttrainer.index) == 48
    jtrainer.evaluate(jtrainer.eval_loader, 37)
    jargs, targs = jtrainer.training_args, ttrainer.training_args
    for suffix in (".npz", ".meta.json"):
        os.replace(jargs.index_file + "37" + suffix, targs.index_file + "37" + suffix)
    with open(os.path.join(jargs.index_order_dir, "37.docid.txt")) as fh, \
            open(os.path.join(targs.index_order_dir, "37.docid.txt"), "w") as out:
        out.write(fh.read())
    ttrainer._load_index(37)
    ttrainer._indexed_ep = 37
    ttrainer.evaluate(ttrainer.eval_loader, 37)
    _assert_same_evaluation(jargs, targs, 37, rel=REL["IVF8,PQ16x4"])


@pytest.mark.parametrize("factory,mode,ep", [("PQ16", "serve", 34), ("IVF8,PQ16x4", "bulk", 35)])
def test_retrieval_cli_serves_the_saved_pq_index(trainers, tmp_path, factory, mode, ep):
    """The evaluation's saved index reloads through ``_load_index`` and
    searches alike; the retrieval CLI (``run(index_path=...)``) ranks as
    JAX's run on the same file."""
    _, ttrainer = trainers
    args = ttrainer.training_args
    args.index_factory, args.search_mode = factory, mode
    ttrainer.evaluate(ttrainer.eval_loader, ep)
    q = np.random.default_rng(5).normal(size=(6, 128)).astype(np.float32)
    s0, i0 = ttrainer.index.search(q, 10, mode=mode)
    ttrainer._load_index(ep)
    s1, i1 = ttrainer.index.search(q, 10, mode=mode)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(s1, s0)
    with open(tmp_path / "q.pkl", "wb") as fh:
        pickle.dump((q, [f"q{i}" for i in range(6)]), fh)
    got_s, got_d = tretrieval.run(str(tmp_path / "q.pkl"), save_ranking_to=str(tmp_path / "t.pkl"),
                                  depth=10, batch_size=4, search_mode=mode,
                                  index_path=args.index_file + str(ep), device="cpu")
    want_s, want_d = jretrieval.run(str(tmp_path / "q.pkl"),
                                    save_ranking_to=str(tmp_path / "j.pkl"), depth=10,
                                    batch_size=4, search_mode=mode,
                                    index_path=args.index_file + str(ep))
    rel = max(1e-5, REL.get(factory, 0))
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s), rtol=rel, atol=1e-5)
    for a, b, sa in zip(np.asarray(got_d), np.asarray(want_d), np.asarray(want_s)):
        differ = a != b
        # a swap only between two scores that tie within rel
        assert not differ.any() or np.ptp(sa[differ]) <= rel * max(1.0, np.abs(sa).max())
    assert os.path.exists(tmp_path / "t.pkl")
