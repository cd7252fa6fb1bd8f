"""The torch port's product quantization vs the JAX package, on the CPU.

Inputs are made from a seed with numpy (the clustered setups of
``tests/test_pq.py`` at H = 128) and fed to both sides. The JAX serve
kernels (K15 ``_pq_serve_kernel`` / ``_pq4_serve_kernel``, K16
``_pq_serve_kernel_i8dec``) run in interpret mode through ``pq_topj_blocks``,
the port's as their plain versions. Tolerances:

- k-means: the same initial rows (bit-equal); one Lloyd step's centroids
  within 1e-5 relative (fp32 sums in another order), counts equal.
- Encoding: codes equal except at near ties, where the two chosen entries'
  scores ``x.c - |c|^2 / 2`` are within 1e-5 relative of each other.
- Decoding is exact: reconstructions bit-equal. The exact-ADC scan: scores
  within 1e-5 relative, ids equal except where two scores tie within that.
- ``build_bdcb`` / ``build_bdcb_i8``: bit-equal.
- The serve kernels: the TPU's packed selection rounds each score to
  2^id_bits ulps (``_quantum`` of the block), the port keeps exact scores;
  per block the same ids, scores within two quanta.
- OPQ: one round's rotation within 1e-4 (an SVD of fp32 sums in another
  order); the full train by reconstruction error, within 2% of JAX's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseretrievaltoolkits_tpu.index import flat as jflat
from denseretrievaltoolkits_tpu.index import transforms as jtr
from denseretrievaltoolkits_tpu.index.io import load_index as jload
from denseretrievaltoolkits_tpu.index.pq import PQIndex as JPQIndex
from denseretrievaltoolkits_tpu.ops import pq as jpq
from denseretrievaltoolkits_torch.index import flat as tflat
from denseretrievaltoolkits_torch.index import transforms as ttr
from denseretrievaltoolkits_torch.index.io import load_index as tload
from denseretrievaltoolkits_torch.index.pq import PQIndex
from denseretrievaltoolkits_torch.ops import pq as tpq

from test_torch_ivf import _quantum, _same_up_to_ties

H = 128


def _clustered(rng, n, h=H, n_clusters=64, spread=0.25):
    """The compressible corpus of tests/test_pq.py:33-40."""
    centers = rng.standard_normal((n_clusters, h)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    return (centers[assign] + spread * rng.standard_normal((n, h))).astype(np.float32)


@pytest.fixture(scope="module")
def fitted():
    """Corpus, queries and JAX-trained codebooks of both code widths
    (8-bit M=16, d_sub 8; 4-bit M=32, d_sub 4) with their JAX codes."""
    rng = np.random.default_rng(7)
    corpus = _clustered(rng, 5000)
    queries = _clustered(rng, 40)
    out = {}
    for nbits, M in ((8, 16), (4, 32)):
        cb = np.array(jpq.pq_train(corpus[:4096], M, iters=4, block_rows=1024, k=1 << nbits))
        codes = np.asarray(jpq.pq_encode_device(jnp.asarray(corpus), jnp.asarray(cb)))
        out[nbits] = (cb, codes)
    return corpus, queries, out


def _j2t(a):
    return torch.from_numpy(np.array(a))


# -- training, encode, decode ----------------------------------------------------------------------


@pytest.mark.parametrize("k", [256, 16])
def test_pq_train_init_and_one_step_match_jax(fitted, k):
    """Zero iterations return the same sample rows; one Lloyd step from the
    same codebooks gives centroids within 1e-5 and equal counts."""
    corpus = fitted[0][:2048]
    M = 16 if k == 256 else 32
    np.testing.assert_array_equal(tpq.pq_train(corpus, M, iters=0, seed=3, block_rows=512, k=k),
                                  jpq.pq_train(corpus, M, iters=0, seed=3, block_rows=512, k=k))
    d = H // M
    x_sub = corpus.reshape(-1, M, d).transpose(1, 0, 2)
    cb0 = jpq.pq_train(corpus, M, iters=0, seed=3, block_rows=512, k=k)
    want_cb, want_n = jpq._kmeans_step(jnp.asarray(x_sub), jnp.asarray(cb0), 512)
    got_cb, got_n = tpq._kmeans_step(torch.from_numpy(np.ascontiguousarray(x_sub)),
                                     torch.from_numpy(np.array(cb0)), 512)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_allclose(got_cb.numpy(), np.asarray(want_cb), rtol=1e-5, atol=1e-6)


def test_pq_train_reseeds_like_jax():
    """Few distinct rows leave entries empty: the re-seeds draw the same rows
    from the same generator, so a short train matches within 1e-5."""
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((40, H)).astype(np.float32)
    want = jpq.pq_train(rows, 16, iters=3, seed=5, block_rows=40)
    got = tpq.pq_train(rows, 16, iters=3, seed=5, block_rows=40)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="sample rows"):
        tpq.pq_train(rows[:10], 16, block_rows=40)


@pytest.mark.parametrize("nbits", [8, 4])
def test_encode_matches_jax_up_to_near_ties(fitted, nbits):
    """Codes equal, except where the two chosen entries score within 1e-5
    relative; 4-bit codes pack subspace 2i into the low nibble."""
    corpus, _, out = fitted
    cb, want = out[nbits]
    got = tpq.pq_encode_device(torch.from_numpy(corpus), torch.from_numpy(cb)).numpy()
    assert got.shape == want.shape and got.dtype == np.int8
    gi = tpq._code_ids(torch.from_numpy(got), cb.shape[1]).numpy()
    wi = tpq._code_ids(torch.from_numpy(want), cb.shape[1]).numpy()
    M, k, d = cb.shape
    x = corpus.reshape(-1, M, d).transpose(1, 0, 2)
    for m, n in zip(*np.nonzero(gi != wi)):
        s = x[m, n] @ cb[m].T - 0.5 * (cb[m] ** 2).sum(1)
        assert abs(s[gi[m, n]] - s[wi[m, n]]) <= 1e-5 * max(1.0, abs(s[wi[m, n]])), (m, n)
    assert (gi != wi).mean() < 1e-3
    if nbits == 4:
        np.testing.assert_array_equal(tpq.pq4_unpack(torch.from_numpy(got)).numpy(),
                                      np.asarray(jpq.pq4_unpack(jnp.asarray(got))))


@pytest.mark.parametrize("nbits", [8, 4])
def test_decode_and_exact_adc_match_jax(fitted, nbits):
    """Reconstructions bit-equal; the exact-ADC scan's scores within 1e-5,
    ids equal up to ties; rows past ``valid`` masked."""
    corpus, queries, out = fitted
    cb, codes = out[nbits]
    np.testing.assert_array_equal(
        tpq.pq_decode(_j2t(codes[:, :700]), torch.from_numpy(cb)).numpy(),
        np.asarray(jpq.pq_decode(jnp.asarray(codes[:, :700]), jnp.asarray(cb))))
    for valid in (None, 4321):
        js, ji = jpq.pq_blockwise_topk(jnp.asarray(queries), jnp.asarray(codes),
                                       jnp.asarray(cb), 20, block_size=1024, valid=valid)
        ts, ti = tpq.pq_blockwise_topk(torch.from_numpy(queries), _j2t(codes),
                                       torch.from_numpy(cb), 20, block_size=1000, valid=valid)
        _same_up_to_ties(ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji), 1e-5)
        if valid:
            assert ti.numpy().max() < valid


@pytest.mark.parametrize("nbits,M", [(8, 16), (4, 32), (8, 64)])
def test_build_bdcb_bit_equal_and_table(nbits, M):
    """Both decode operands bit-equal to the reference's; the table cut out of
    them holds exactly the bf16 codebook entries and the per-dim scales."""
    rng = np.random.default_rng(M + nbits)
    cb = rng.standard_normal((M, 1 << nbits, H // M)).astype(np.float32)
    want = np.asarray(jpq.build_bdcb(cb))
    got = tpq.build_bdcb(cb)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    table, scale = tpq.bdcb_table(got, k=1 << nbits)
    np.testing.assert_array_equal(table.float().numpy(),
                                  torch.from_numpy(cb).to(torch.bfloat16).float().numpy())
    assert scale is None
    if nbits == 8:
        wq, ws = jpq.build_bdcb_i8(cb)
        gq, gs = tpq.build_bdcb_i8(cb)
        np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        t8, s8 = tpq.bdcb_table(gq, gs)
        assert t8.dtype == torch.int8 and s8.shape == (H,)
        np.testing.assert_array_equal(s8.numpy(), np.asarray(ws).reshape(-1))


# -- K15 / K16 plain versions vs the Pallas kernels -----------------------------------------------


def _serve_operands(cb, nbits, i8dec):
    """(JAX operand, JAX scale, port table, port scale) of one serve body."""
    if i8dec:
        bd, sc = jpq.build_bdcb_i8(cb)
        table, scale = tpq.bdcb_table(*tpq.build_bdcb_i8(cb))
        return jnp.asarray(bd), jnp.asarray(sc), table, scale
    table, _ = tpq.bdcb_table(tpq.build_bdcb(cb), k=1 << nbits)
    return jnp.asarray(jpq.build_bdcb(cb)), None, table, None


@pytest.mark.parametrize("nbits,i8dec", [(8, False), (8, True), (4, False)],
                         ids=["K15-8bit", "K16", "K15-4bit"])
def test_serve_kernel_plain_matches_pallas(fitted, nbits, i8dec):
    """The plain K15 / K16 vs ``pq_topj_blocks`` (interpret) on 4 blocks of
    512 rows, rows past n_valid masked, J=8: per block the same ids, scores
    within two quanta."""
    corpus, queries, out = fitted
    cb, codes = out[nbits]
    codes = codes[:, :2048]
    J, block, n_valid = 8, 512, 1900
    jop, jsc, table, scale = _serve_operands(cb, nbits, i8dec)
    jv, ji = jpq.pq_topj_blocks(jnp.asarray(queries[:32]), jnp.asarray(codes), jop, J, block,
                                n_valid, tq=32, scale=jsc, nbits=nbits)
    before = (tpq.pq_topj_blocks.launches, tpq.pq_topj_blocks.launches_4bit,
              tpq.pq_topj_blocks.launches_i8dec)
    tv, ti = tpq.pq_topj_blocks(torch.from_numpy(queries[:32]).to(torch.bfloat16), _j2t(codes),
                                table, J, block, n_valid, scale, nbits)
    assert (tpq.pq_topj_blocks.launches, tpq.pq_topj_blocks.launches_4bit,
            tpq.pq_topj_blocks.launches_i8dec) == before  # CPU: the plain version
    # port [Q, nb, J] vs JAX [nb, J, Q]: per (query, block) the same ids
    jv, ji = np.transpose(np.asarray(jv), (2, 0, 1)), np.transpose(np.asarray(ji), (2, 0, 1))
    tv, ti = tv.numpy(), ti.numpy()
    fin = jv > -1e29
    np.testing.assert_array_equal(ti >= 0, fin)
    assert (ti[fin] < n_valid).all()
    for a, b, f in zip(ti.reshape(-1, J), ji.reshape(-1, J), fin.reshape(-1, J)):
        assert set(a[f]) == set(b[f])
    np.testing.assert_allclose(np.sort(np.where(fin, tv, 0), -1), np.sort(np.where(fin, jv, 0), -1),
                               rtol=2 * _quantum(block), atol=1e-6)


def _onehot_rows(cb, codes, nbits, i8dec, row0, rows):
    """The rows [rows, H] bf16 (as uint16 bits) that the Pallas kernels' one-hot
    decode yields for code columns row0 .. row0 + rows - 1, in numpy from the
    reference's block-diagonal operand: per 128-dim group, bdcb[g] times the
    one-hot of the group's codes (fp32 sums; K16: int8 x int8 -> int32, then
    times the per-dim scale), cast to bf16 (pq.py:318-341, :375-392)."""
    M, k, d = cb.shape
    ids = tpq._code_ids(_j2t(codes[:, row0:row0 + rows]), k).numpy()  # [M, rows]
    onehot = np.zeros((M, k, rows), np.float32)
    onehot[np.arange(M)[:, None], ids, np.arange(rows)[None, :]] = 1.0
    G = 128 // d
    onehot = onehot.reshape(M // G, G * k, rows)
    if i8dec:
        bd, sc = jpq.build_bdcb_i8(cb)
        acc = np.einsum("gik,gkr->gir", np.asarray(bd, np.int32), onehot.astype(np.int32))
        out = acc.astype(np.float32) * np.asarray(sc)
    else:
        out = np.einsum("gik,gkr->gir", np.asarray(jpq.build_bdcb(cb), np.float32), onehot)
    out = out.reshape(M * d, rows).T
    return np.asarray(jnp.asarray(out).astype(jnp.bfloat16)).view(np.uint16)


@pytest.mark.parametrize("nbits,i8dec", [(8, False), (8, True), (4, False)],
                         ids=["K15-8bit", "K16", "K15-4bit"])
def test_decode_pass_plain_bit_equal_to_onehot(fitted, nbits, i8dec):
    """The plain decode pass (``_pq_decode_reference``) over a slice of code
    columns that starts mid-corpus: bit-equal to the rows the JAX kernels'
    one-hot matmul yields from ``build_bdcb`` / ``build_bdcb_i8``."""
    _, _, out = fitted
    cb, codes = out[nbits]
    _, _, table, scale = _serve_operands(cb, nbits, i8dec)
    got = tpq._pq_decode_reference(_j2t(codes), table, scale, nbits, 700, 900)
    assert got.dtype == torch.bfloat16 and got.shape == (900, H)
    want = _onehot_rows(cb, codes, nbits, i8dec, 700, 900)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)


@pytest.mark.parametrize("nbits,i8dec", [(8, False), (8, True), (4, False)],
                         ids=["K15-8bit", "K16", "K15-4bit"])
def test_chunk_plan_plain_matches_unchunked_and_pallas(fitted, monkeypatch, nbits, i8dec):
    """The plain K15 / K16 chunk by chunk under the wrapper's plan: 1900 rows,
    k=100 (serve_plan halves the 512-row block to 256, J=31), chunks of two
    blocks (four chunks, the last of 364 rows ending in a 108-row block),
    n_valid 1850 inside the last chunk. The same lists as the unchunked plain
    version, and per block the ids of ``pq_topj_blocks`` (interpret; the codes
    padded to whole blocks, the pad masked by n_valid), scores within two
    quanta."""
    from denseretrievaltoolkits_torch.ops.topk import serve_plan

    _, queries, out = fitted
    cb, codes = out[nbits]
    N, n_valid = 1900, 1850
    block, J = serve_plan(100, N, n_valid, 512)
    assert (block, J) == (256, 31)
    monkeypatch.setattr(tpq, "PQ_CHUNK_ROWS", 600)
    chunk = tpq.pq_chunk_rows(N, block)
    assert chunk == 512 and -(-N // chunk) == 4 and N % block == 108
    jop, jsc, table, scale = _serve_operands(cb, nbits, i8dec)
    q = torch.from_numpy(queries[:32]).to(torch.bfloat16)
    tv, ti = tpq.pq_topj_blocks(q, _j2t(codes[:, :N]), table, J, block, n_valid, scale, nbits)
    uv, ui = tpq._pq_topj_reference(q, _j2t(codes[:, :N]), table, J, block, n_valid, scale,
                                    nbits, chunk_rows=8 * block)
    assert torch.equal(tv, uv) and torch.equal(ti, ui)
    padded = np.concatenate([codes[:, :N], np.zeros((codes.shape[0], 8 * block - N), np.int8)], 1)
    jv, ji = jpq.pq_topj_blocks(jnp.asarray(queries[:32]), jnp.asarray(padded), jop, J, block,
                                n_valid, tq=32, scale=jsc, nbits=nbits)
    jv, ji = np.transpose(np.asarray(jv), (2, 0, 1)), np.transpose(np.asarray(ji), (2, 0, 1))
    tv, ti = tv.numpy(), ti.numpy()
    fin = jv > -1e29
    np.testing.assert_array_equal(ti >= 0, fin)
    assert (ti[fin] < n_valid).all() and (ti[:, 7][fin[:, 7]] >= 7 * block).all()
    for a, b, f in zip(ti.reshape(-1, J), ji.reshape(-1, J), fin.reshape(-1, J)):
        assert set(a[f]) == set(b[f])
    np.testing.assert_allclose(np.sort(np.where(fin, tv, 0), -1), np.sort(np.where(fin, jv, 0), -1),
                               rtol=2 * _quantum(block), atol=1e-6)


def test_chunk_plan_bounds_the_scratch(monkeypatch):
    """Chunks are whole blocks of about PQ_CHUNK_ROWS rows, at least one block,
    at most the corpus's blocks and a grid's 65535: the scratch (min(chunk, N)
    rows) does not grow with N, 48 MB at H = 768 at MS MARCO's 8.8M rows."""
    assert tpq.pq_chunk_rows(8_841_823, 1024) == 32768
    assert tpq.pq_chunk_rows(1_000_000, 2048) == 32768
    assert tpq.pq_chunk_rows(1_000_000, 3000) == 30000
    assert tpq.pq_chunk_rows(1_000_000, 65536) == 65536
    assert tpq.pq_chunk_rows(5000, 512) == 5120
    assert min(tpq.pq_chunk_rows(8_841_823, 1024), 8_841_823) * 768 * 2 == 48 * 2 ** 20
    monkeypatch.setattr(tpq, "PQ_CHUNK_ROWS", 10 ** 6)
    assert tpq.pq_chunk_rows(10 ** 9, 1) == 65535


@pytest.mark.parametrize("n,k,block", [(5000, 20, 512), (5000, 300, 512), (900, 20, 512)],
                         ids=["poisson-J", "J-over-32", "tiny-corpus"])
def test_serve_search_matches_pallas_fast(fitted, n, k, block):
    """``pq_serve_topk`` vs ``pallas_topk_pq_fast`` on 8-bit codes (K16): the
    same ranking up to ties within two quanta. At k=300 the reference's J
    (43) exceeds 32 and the port halves the block; a corpus under two blocks
    takes the exact scan on both sides, counted."""
    corpus, queries, out = fitted
    cb, codes = out[8]
    codes = codes[:, :n]
    jop, jsc, table, scale = _serve_operands(cb, 8, True)
    js, ji = jpq.pallas_topk_pq_fast(jnp.asarray(queries), jnp.asarray(codes), cb, jop, k,
                                     block_size=block, scale=jsc)
    scans = tpq.pq_serve_topk.exact_scans
    ts, ti = tpq.pq_serve_topk(torch.from_numpy(queries), _j2t(codes), torch.from_numpy(cb),
                               table, k, block_size=block, scale=scale)
    assert tpq.pq_serve_topk.exact_scans == scans + (n < 2 * block)
    rel = 1e-5 if n < 2 * block else 2 * _quantum(block)
    _same_up_to_ties(ts.numpy(), ti.numpy(), js, ji, rel)


# -- the index -----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built(fitted):
    """JAX PQ indexes (8-bit PQ16, 4-bit PQ32x4) trained and filled."""
    corpus = fitted[0]
    out = {}
    for nbits, M in ((8, 16), (4, 32)):
        j = JPQIndex(H, M=M, nbits=nbits)
        j.train(corpus[:4096], iters=4)
        j.add(corpus)
        j.docid = [f"d{i}" for i in range(len(corpus))]
        out[nbits] = j
    return out


@pytest.mark.parametrize("nbits", [8, 4])
def test_index_loaded_from_jax_matches_in_every_mode(tmp_path, fitted, built, nbits):
    """A JAX-saved PQ index loads bit for bit; ``exact`` ranks as JAX's exact
    ADC, ``serve`` / ``approx`` as JAX's serve kernel (K16 for 8-bit codes,
    K15 for 4-bit: the JAX index's own decode operand, interpret mode);
    partial and i8q raise on both sides."""
    queries = fitted[1]
    j = built[nbits]
    j.save(str(tmp_path / "j"))
    t = tload(str(tmp_path / "j"), device="cpu")
    assert type(t) is PQIndex and t.docid == j.docid and len(t) == len(j)
    np.testing.assert_array_equal(t._materialize().numpy(), np.asarray(j._codes))
    js, ji = j.search(queries, 20, mode="exact")
    ts, ti = t.search(queries, 20, mode="exact")
    _same_up_to_ties(ts, ti, js, ji, 1e-5)
    op = j._bdcb_i8 if nbits == 8 else j._bdcb
    ws, wi = jpq.pallas_topk_pq_fast(jnp.asarray(queries), j._codes, j.codebooks, op, 20,
                                     block_size=j.block_size, nbits=nbits,
                                     scale=j._bdcb_scale if nbits == 8 else None)
    for mode in ("serve", "approx"):
        ts, ti = t.search(queries, 20, mode=mode)
        _same_up_to_ties(ts, ti, ws, wi, 2 * _quantum(j.block_size))
    for mode in ("partial", "i8q"):
        for idx in (t, j):
            with pytest.raises(ValueError, match=mode):
                idx.search(queries, 5, mode=mode)


def test_port_save_loads_in_jax_and_add_paths_agree(tmp_path, fitted, built):
    """The port's add / add_device / add_chunks store the same codes (equal to
    JAX's but at near ties); JAX loads the port's save and ranks alike."""
    corpus, queries, _ = fitted
    j = built[8]
    idx = []
    for how in ("add", "add_device", "add_chunks"):
        t = PQIndex(H, M=16, device="cpu")
        t.codebooks = j.codebooks
        t._set_codebooks()
        if how == "add":
            t.add(corpus)
        elif how == "add_device":
            t.add_device(torch.from_numpy(corpus[:3000]))
            t.add_device(torch.from_numpy(corpus[3000:]))
        else:
            t.add_chunks(lambda s, r: corpus[s:s + r], len(corpus), chunk_rows=1300)
        idx.append(t)
    codes = idx[0]._materialize().numpy()
    for t in idx[1:]:
        np.testing.assert_array_equal(t._materialize().numpy(), codes)
    assert (codes != np.asarray(j._codes)).mean() < 1e-3
    t = idx[0]
    t.docid = [f"p{i}" for i in range(len(corpus))]
    t.save(str(tmp_path / "t"))
    back = jload(str(tmp_path / "t"))
    assert type(back) is JPQIndex and back.docid == t.docid and back.nbits == 8
    np.testing.assert_array_equal(np.asarray(back._code_slabs[0]), codes)
    bs, bi = back.search(queries, 10, mode="exact")
    ts, ti = t.search(queries, 10, mode="exact")
    _same_up_to_ties(ts, ti, bs, bi, 1e-5)
    np.testing.assert_array_equal(t.reconstruct([3, 1, 4]), back.reconstruct([3, 1, 4]))


@pytest.mark.parametrize("nbits", [8, 4])
def test_independent_training_matches_jax(fitted, nbits):
    """``PQIndex.train`` from the same seed on both sides (block rows
    min(2048, n)): codebooks within 1e-4, exact searches alike."""
    corpus, queries, _ = fitted
    M = 16 if nbits == 8 else 32
    j, t = JPQIndex(H, M=M, nbits=nbits), PQIndex(H, M=M, nbits=nbits, device="cpu")
    for idx in (j, t):
        idx.train(corpus[:2048], iters=3, seed=2)
        idx.add(corpus[:3000])
    np.testing.assert_allclose(t.codebooks, j.codebooks, rtol=1e-4, atol=1e-4)
    js, ji = j.search(queries, 10)
    ts, ti = t.search(queries, 10)
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ti, ji)]) >= 0.99


def test_non_kernel_geometry_serves_by_the_counted_exact_scan():
    """d_sub | 128 but 128 does not divide dim: every mode is the exact scan,
    as in the reference (index/pq.py:64-67), and serve counts it."""
    rng = np.random.default_rng(0)
    reps = rng.standard_normal((1024, 192)).astype(np.float32)
    j, t = JPQIndex(192, M=24), PQIndex(192, M=24, device="cpu")
    for idx in (j, t):
        idx.train(reps, iters=2)
        idx.add(reps)
    assert not t._pallas_geometry and t._table is None
    scans = tpq.pq_serve_topk.exact_scans
    ts, ti = t.search(reps[:8], 5, mode="serve")
    assert tpq.pq_serve_topk.exact_scans == scans + 1
    js, ji = j.search(reps[:8], 5, mode="serve")
    _same_up_to_ties(ts, ti, js, ji, 1e-5)
    for bad in (dict(M=7), dict(M=16, nbits=3), dict(M=15, nbits=4)):
        for cls in (PQIndex, JPQIndex):
            with pytest.raises(ValueError):
                cls(128 if bad["M"] != 7 else 64, **bad) if cls is JPQIndex else \
                    cls(128 if bad["M"] != 7 else 64, device="cpu", **bad)


# -- OPQ -------------------------------------------------------------------------------------------


def _correlated(rng, n):
    """Correlated data where OPQ has something to rotate (tests/test_pq.py:218-230)."""
    z = rng.standard_normal((n, H)).astype(np.float32) * np.linspace(3.0, 0.1, H, dtype=np.float32)
    mix = np.linalg.qr(rng.standard_normal((H, H)))[0].astype(np.float32)
    return (z @ mix).astype(np.float32)


def test_opq_one_round_tight_and_full_train_by_error():
    """One OPQ round: the rotation within 1e-4 of JAX's. Six rounds: the PQ
    reconstruction error of the rotated data within 2% of JAX's, and below
    plain PQ's."""
    rng = np.random.default_rng(11)
    x = _correlated(rng, 3000)
    one_j, one_t = jtr.OPQTransform(H, M=16, rounds=1), ttr.OPQTransform(H, M=16, rounds=1,
                                                                         device="cpu")
    one_j.train(x)
    one_t.train(x)
    np.testing.assert_allclose(one_t.matrix, one_j.matrix, atol=1e-4)

    def err(rot):
        xr = x @ rot
        cb = jpq.pq_train(xr, 16, iters=6, block_rows=1024)
        dec = np.asarray(jpq.pq_decode(jpq.pq_encode_device(jnp.asarray(xr), jnp.asarray(cb)),
                                       jnp.asarray(cb)))
        return float(np.mean((dec - xr) ** 2))

    full_j, full_t = jtr.OPQTransform(H, M=16), ttr.OPQTransform(H, M=16, device="cpu")
    full_j.train(x)
    full_t.train(x)
    np.testing.assert_allclose(full_t.matrix.T @ full_t.matrix, np.eye(H), atol=1e-4)
    ej, et = err(full_j.matrix), err(full_t.matrix)
    assert abs(et - ej) <= 0.02 * ej, (et, ej)
    assert et < err(np.eye(H, dtype=np.float32))


@pytest.mark.parametrize("spec", ["OPQ16,PQ16", "OPQ32x4,PQ32x4"])
def test_opq_factory_chain_and_persistence(tmp_path, fitted, spec):
    """The factory chain trains, adds and searches like JAX's; saved, it
    reloads in both packages (the rotation in PCATransform's format) and
    ranks the same."""
    corpus, queries, _ = fitted
    t = tflat.index_factory(H, spec, device="cpu")
    j = jflat.index_factory(H, spec)
    assert isinstance(t, ttr.TransformedIndex) and type(t.inner) is PQIndex
    assert (t.transform.M, t.transform.nbits, t.inner.M, t.inner.nbits) == \
        (j.transform.M, j.transform.nbits, j.inner.M, j.inner.nbits)
    t.transform.rounds = j.transform.rounds = 2
    t.train(corpus[:2048])
    t.add(corpus[:3000])
    ts, ti = t.search(queries, 10, mode="exact")
    t.save(str(tmp_path / "t"))
    back_t, back_j = tload(str(tmp_path / "t"), device="cpu"), jload(str(tmp_path / "t"))
    assert type(back_t.inner) is PQIndex and type(back_j.inner) is JPQIndex
    np.testing.assert_array_equal(back_t.transform.matrix, t.transform.matrix)
    for idx in (back_t, back_j):
        s, i = idx.search(queries, 10, mode="exact")
        _same_up_to_ties(ts, ti, np.asarray(s), np.asarray(i), 1e-5)
    assert os.path.exists(tmp_path / "t" / "transform.npz")
