"""The torch port's exact search (K5 plain version + certified search, the
blockwise scan, FlatIPIndex) vs the JAX reference on the CPU.

The JAX side runs ``pallas_topk`` with its Pallas kernel in interpret mode and
the XLA ``blockwise_topk``. Ids must be equal and scores within 1e-5
(fp32 sums in another order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from denseretrievaltoolkits_tpu.index import flat as jflat
from denseretrievaltoolkits_tpu.ops import topk as jtopk
from denseretrievaltoolkits_torch.index import flat as tflat
from denseretrievaltoolkits_torch.ops import topk as ttopk


def _corpus(case, rng):
    """2000 x 64 corpora after tests/test_ops_topk.py:48-80."""
    if case == "random":
        c = rng.normal(size=(2000, 64)).astype(np.float32)
        q = rng.normal(size=(9, 64)).astype(np.float32)
    elif case == "clustered":  # a block holds many top-k rows: escalation / fallback
        c = rng.normal(size=(2000, 64)).astype(np.float32)
        strong = rng.normal(size=(1, 64)).astype(np.float32) * 3
        c[100:130] = strong + 0.01 * rng.normal(size=(30, 64)).astype(np.float32)
        q = (strong + 0.05 * rng.normal(size=(5, 64))).astype(np.float32)
    else:  # adversarial: every top-k row in one block, scores strictly ordered
        vals = np.linspace(1, 0, 2000).astype(np.float32)
        c = vals[:, None] * np.ones((1, 64), np.float32)
        q = np.ones((8, 64), np.float32)
    return c, q


@pytest.mark.parametrize("case", ["random", "clustered", "adversarial"])
@pytest.mark.parametrize("k", [30, 64])
def test_certified_topk_matches_jax(case, k):
    c, q = _corpus(case, np.random.default_rng(7))
    js, ji = jtopk.pallas_topk(q, jnp.asarray(c), k=k, block_size=512)
    bs, bi = jflat.blockwise_topk(jnp.asarray(q), jnp.asarray(c), k, 512)
    before = ttopk.block_topj.launches
    ts, ti = ttopk.certified_topk(torch.from_numpy(q), torch.from_numpy(c), k, block_size=512)
    assert ttopk.block_topj.launches == before  # CPU tensors never launch the kernel
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(bi))
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-5)


def test_certified_topk_counts_fallback_queries():
    c, q = _corpus("adversarial", np.random.default_rng(0))
    before = ttopk.certified_topk.fallback_queries
    ttopk.certified_topk(torch.from_numpy(q), torch.from_numpy(c), 30, block_size=512)
    # all top-30 rows sit in block 0 and k < 4J: every query takes the scan
    assert ttopk.certified_topk.fallback_queries - before == q.shape[0]


def test_block_topj_plain_matches_pallas_kernel():
    """Per-block candidates, ties to the smaller id, padded rows masked."""
    rng = np.random.default_rng(1)
    c = rng.normal(size=(700, 32)).astype(np.float32)
    c[300:310] = c[300]  # exact ties inside one block
    q = rng.normal(size=(8, 32)).astype(np.float32)
    q[0] = c[300]
    n_valid = 650
    pad = np.zeros((768, 32), np.float32)
    pad[:700] = c
    jv, ji = jtopk._pallas_block_topj(jnp.asarray(q), jnp.asarray(pad), 6, 256, n_valid)
    tv, ti = ttopk.block_topj(torch.from_numpy(q), torch.from_numpy(c), 6, 256, n_valid)
    jv = np.transpose(np.asarray(jv), (2, 0, 1))  # [n_blocks, J, Q] -> [Q, n_blocks, J]
    ji = np.transpose(np.asarray(ji), (2, 0, 1))
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-5, atol=1e-5)
    assert ti.numpy().max() < n_valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockwise_topk_matches_jax(dtype):
    rng = np.random.default_rng(3)
    c = rng.normal(size=(1500, 48)).astype(np.float32)
    q = rng.normal(size=(6, 48)).astype(np.float32)
    jc = jnp.asarray(c, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    js, ji = jflat.blockwise_topk(jnp.asarray(q), jc, 20, 256, valid=1400)
    tc = torch.from_numpy(np.asarray(jc.astype(jnp.float32))).to(tflat.DTYPES[dtype])
    ts, ti = tflat.blockwise_topk(torch.from_numpy(q), tc, 20, 256, valid=1400)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["exact", "serve", "partial", "approx"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_index_cpu_modes_run_exact(mode, dtype):
    """Off the card every mode runs the exact scan, as the reference does off TPU."""
    rng = np.random.default_rng(4)
    c = rng.normal(size=(1200, 32)).astype(np.float32)
    q = rng.normal(size=(5, 32)).astype(np.float32)
    jidx = jflat.FlatIPIndex(c, dtype=dtype)
    tidx = tflat.FlatIPIndex(c, dtype=dtype, device="cpu")
    js, ji = jidx.search(q, 15, mode=mode)
    ts, ti = tidx.search(q, 15, mode=mode)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)


def test_flat_index_device_slabs_match_host_add():
    rng = np.random.default_rng(5)
    c = rng.normal(size=(900, 32)).astype(np.float32)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    host = tflat.FlatIPIndex(c, device="cpu")
    slabs = tflat.FlatIPIndex(32, device="cpu")
    slabs.add_device(torch.from_numpy(c[:500]))
    slabs.add_device(torch.from_numpy(c[500:]))
    hs, hi = host.search(q, 40)
    ss, si = slabs.search(q, 40)
    np.testing.assert_array_equal(si, hi)
    np.testing.assert_allclose(ss, hs, rtol=1e-6)


def test_unported_modes_and_dtypes_raise():
    """int4 rows are ported (K9-K11, K12's sq4 body) and build on the CPU;
    the reference's mode contract still refuses i8q on float rows and partial
    on int8 and int4 rows, and an odd dim cannot pack into int4."""
    idx = tflat.FlatIPIndex(32, dtype="int4", device="cpu")
    assert idx.dtype == "int4" and len(idx) == 0
    with pytest.raises(ValueError, match="even dim"):
        tflat.FlatIPIndex(33, dtype="int4", device="cpu")
    q = np.zeros((1, 32), np.float32)
    with pytest.raises(ValueError, match="i8q"):
        tflat.FlatIPIndex(32, device="cpu").search(q, 1, mode="i8q")
    for dtype in ("int8", "int4"):
        with pytest.raises(ValueError, match="partial"):
            tflat.FlatIPIndex(32, dtype=dtype, device="cpu").search(q, 1, mode="partial")


def _int8_corpus(seed, n=1024, h=64):
    """An int8 corpus with a negative-score region, after tests/test_ops_topk.py."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(n, h)).astype(np.float32)
    c[:n // 4] -= 2.0
    values, scales = jflat.quantize_int8(c)
    return rng, c, values, scales


# (block, J, rows, n_valid) of the K6 / K8 parity cases: the JAX kernels take whole blocks, so
# the rows are a multiple of the block, n_valid inside the last; blocks of 512 (the IVF side
# scans') and 1000 (no multiple of the CUDA bodies' 64-row tile), J of the serve searches (7
# at 1M rows, 11 on the slabs) and of the escalation (32)
PARITY_CASES = [(256, 6, 1024, 1000)] + [(b, j, 2 * b, 2 * b - 10) for b in (512, 1000)
                                         for j in (7, 11, 32)]


def _per_block(v):
    """[n_blocks, J, Q] -> [Q, n_blocks, J]."""
    return np.transpose(np.asarray(v), (2, 0, 1))


@pytest.mark.parametrize("block,J,n,n_valid", PARITY_CASES)
def test_block_topj_int8_plain_matches_pallas_kernel(block, J, n, n_valid):
    """K6: bf16 queries x int8 rows x per-row scales, as ``pallas_topk`` runs it."""
    rng, _, values, scales = _int8_corpus(12, n)
    q = rng.normal(size=(8, 64)).astype(np.float32)
    qb = jnp.asarray(q, jnp.bfloat16)
    jv, ji = jtopk._pallas_block_topj_scaled(qb, jnp.asarray(values), jnp.asarray(scales), J,
                                             block, n_valid)
    tq = torch.from_numpy(np.asarray(qb.astype(jnp.float32))).bfloat16()
    tv, ti = ttopk.block_topj(tq, torch.from_numpy(values), J, block, n_valid,
                              torch.from_numpy(scales))
    np.testing.assert_array_equal(ti.numpy(), _per_block(ji))
    np.testing.assert_allclose(tv.numpy(), _per_block(jv), rtol=1e-5, atol=1e-5)


def _packed_quantum(block_size):
    """The JAX serve kernels round a score to 2^id_bits ulps (topk.py:96-100)."""
    return 2.0 ** ((block_size - 1).bit_length() - 23)


@pytest.mark.parametrize("block,J,n,n_valid", PARITY_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_block_topj_serve_plain_matches_packed_kernels(dtype, block, J, n, n_valid):
    """K8: per-block id sets of ``_pallas_block_topj_packed`` (fp32 / bf16) and
    ``_packed_scaled`` (int8); the port's exact scores sit within the TPU's
    rounding quantum of the packed ones."""
    rng, c, values, scales = _int8_corpus(13, n)
    q = rng.normal(size=(8, 64)).astype(np.float32)
    if dtype == "int8":
        qj = jnp.asarray(q, jnp.bfloat16)
        jv, ji = jtopk._pallas_block_topj_packed_scaled(qj, jnp.asarray(values),
                                                        jnp.asarray(scales), J, block, n_valid)
        corpus, sc = torch.from_numpy(values), torch.from_numpy(scales)
    else:
        jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        qj, cj = jnp.asarray(q, jd), jnp.asarray(c, jd)
        jv, ji = jtopk._pallas_block_topj_packed(qj, cj, J, block, n_valid)
        corpus, sc = torch.from_numpy(np.asarray(cj.astype(jnp.float32))), None
        corpus = corpus.to(tflat.DTYPES[dtype])
    tq = torch.from_numpy(np.asarray(qj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype != "float32" else torch.float32)
    tv, ti = ttopk.block_topj_serve(tq, corpus, J, block, n_valid, sc)
    jv, ji = _per_block(jv), _per_block(ji)
    assert [set(r) for r in ti.numpy().reshape(-1, J)] == [set(r) for r in ji.reshape(-1, J)]
    np.testing.assert_allclose(np.sort(tv.numpy(), -1), np.sort(jv, -1),
                               rtol=2 * _packed_quantum(block), atol=1e-6)


def test_block_topj_i8q_plain_matches_packed_kernel():
    """K12 with losslessly quantizable queries, as tests/test_ops_topk.py:216-245."""
    rng, _, values, scales = _int8_corpus(15)
    q_int = rng.integers(-127, 128, size=(8, 64)).astype(np.float32)
    q_int[:, 0] = 127.0  # pin each row's absmax so the quantizer's scale is exact
    q = q_int * 0.037
    jqi, jqs = jtopk.quantize_queries(jnp.asarray(q))
    qi, qs = ttopk.quantize_queries(torch.from_numpy(q))
    np.testing.assert_array_equal(qi.numpy(), q_int.astype(np.int8))
    jv, ji = jtopk._pallas_block_topj_packed_i8q(jqi, jnp.asarray(values), jnp.asarray(scales),
                                                 jqs, 6, 256, 1000)
    tv, ti = ttopk.block_topj_i8q(qi, qs, torch.from_numpy(values), torch.from_numpy(scales),
                                  6, 256, 1000)
    jv, ji = _per_block(jv), _per_block(ji)
    assert [set(r) for r in ti.numpy().reshape(-1, 6)] == [set(r) for r in ji.reshape(-1, 6)]
    np.testing.assert_allclose(np.sort(tv.numpy(), -1), np.sort(jv, -1),
                               rtol=2 * _packed_quantum(256), atol=1e-6)


@pytest.mark.parametrize("case", ["float32", "bfloat16", "int8", "i8q"])
def test_serve_topk_matches_pallas_topk_fast(case):
    """serve_topk vs ``pallas_topk_fast`` (interpret), as
    tests/test_ops_topk.py:321-346: the same ids per query (sets, since the
    TPU's scores are rounded), scores within the rounding quantum."""
    rng = np.random.default_rng(14)
    c = rng.normal(size=(777, 48)).astype(np.float32)  # not a block multiple
    q = rng.normal(size=(5, 48)).astype(np.float32)
    if case in ("int8", "i8q"):
        values, scales = jflat.quantize_int8(c)
        js, ji = jtopk.pallas_topk_fast(q, jnp.asarray(values), 20, block_size=256,
                                        scales=jnp.asarray(scales), i8_native=case == "i8q")
        ts, ti = ttopk.serve_topk(torch.from_numpy(q), torch.from_numpy(values), 20, 256,
                                  scales=torch.from_numpy(scales), i8_native=case == "i8q")
    else:
        jd = jnp.bfloat16 if case == "bfloat16" else jnp.float32
        cj = jnp.asarray(c, jd)
        js, ji = jtopk.pallas_topk_fast(q, cj, 20, block_size=256)
        corpus = torch.from_numpy(np.asarray(cj.astype(jnp.float32))).to(tflat.DTYPES[case])
        ts, ti = ttopk.serve_topk(torch.from_numpy(q), corpus, 20, 256)
    assert ti.shape == (5, 20)
    assert [set(r) for r in ti.numpy()] == [set(r) for r in np.asarray(ji)]
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2 * _packed_quantum(256),
                               atol=1e-6)


def test_serve_j_rule():
    """The Poisson J of pallas_topk_fast (topk.py:894-900); the reference's
    tiny-corpus rule is the only one that takes the exact scan, and the port's
    block rule halves the block while J exceeds the kernels' 32."""
    for k, nb, block in ((100, 245, 4096), (100, 489, 2048), (1000, 245, 4096), (20, 4, 256),
                         (7, 3, 4)):
        lam = k / nb
        want = min(max(jtopk.SERVE_J, int(np.ceil(lam + 4 * np.sqrt(lam) + 4))), k, block)
        assert ttopk.serve_j(k, nb, block) == want
    for k, N, block_size in ((1000, 9000, 2048), (1000, 3000, 1024), (1000, 100_000, 4096),
                             (100, 1_000_000, 2048), (20, 777, 256), (1000, 1500, 512),
                             (100, 5000, 4096), (1000, 1200, 512)):
        nb = -(-N // block_size)
        J = ttopk.serve_j(k, nb, block_size)
        tiny = nb * J < min(k, N) or N < 2 * block_size  # topk.py:901
        plan = ttopk.serve_plan(k, N, N, block_size)
        assert (plan is None) == tiny, (k, N, block_size)
        if plan is not None:
            block, J = plan
            assert J <= ttopk.JMAX and block <= block_size and -(-N // block) * J >= min(k, N)
    assert ttopk.serve_plan(1000, 9000, 9000, 2048) == (64, 22)
    # k=1000 over 100k rows at 4096-row blocks: J=69 > 32, so the block shrinks
    c = torch.zeros((100_000, 8))
    launches = ttopk.block_topj_serve.launches
    ttopk.serve_topk(torch.ones(2, 8), c, 1000, 4096)
    assert ttopk.block_topj_serve.launches == launches  # CPU tensors take the plain version


@pytest.mark.parametrize("mode", ["exact", "serve", "i8q", "approx"])
def test_flat_index_int8_cpu_modes_match_jax(mode):
    """int8 FlatIPIndex on the CPU in every mode vs the JAX index (both run the
    exact scan there): ids equal, scores within 1e-5."""
    rng = np.random.default_rng(16)
    c = rng.normal(size=(1300, 32)).astype(np.float32)
    q = rng.normal(size=(6, 32)).astype(np.float32)
    js, ji = jflat.FlatIPIndex(c, dtype="int8").search(q, 25, mode=mode)
    ts, ti = tflat.FlatIPIndex(c, dtype="int8", device="cpu").search(q, 25, mode=mode)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="partial"):
        jflat.FlatIPIndex(c, dtype="int8").search(q, 25, mode="partial")


def test_flat_index_int8_device_slabs_match_host_add():
    """int8 add_device slabs (quantized per slab, padded to the block) give the
    host add's results, and the JAX index's slabs'."""
    rng = np.random.default_rng(17)
    c = rng.normal(size=(900, 32)).astype(np.float32)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    host = tflat.FlatIPIndex(c, dtype="int8", block_size=128, device="cpu")
    slabs = tflat.FlatIPIndex(32, dtype="int8", block_size=128, device="cpu")
    jslabs = jflat.FlatIPIndex(32, dtype="int8", block_size=128)
    for lo, hi in ((0, 500), (500, 900)):
        slabs.add_device(torch.from_numpy(c[lo:hi]))
        jslabs.add_device(jnp.asarray(c[lo:hi]))
    assert [v.shape[0] for v, _, _ in slabs._device_slabs] == [512, 512]
    hs, hi_ = host.search(q, 40)
    for mode in ("exact", "serve", "i8q"):
        ss, si = slabs.search(q, 40, mode=mode)
        np.testing.assert_array_equal(si, hi_)
        np.testing.assert_allclose(ss, hs, rtol=1e-6)
    js, ji = jslabs.search(q, 40)
    np.testing.assert_array_equal(si, ji)


def test_flat_index_int8_save_load_interchange(tmp_path):
    """The native int8 payload loads bit for bit in both directions."""
    rng = np.random.default_rng(18)
    c = rng.normal(size=(700, 32)).astype(np.float32)
    q = rng.normal(size=(3, 32)).astype(np.float32)
    port = tflat.FlatIPIndex(32, dtype="int8", block_size=256, device="cpu")
    port.add_device(torch.from_numpy(c[:400]))
    port.add_device(torch.from_numpy(c[400:]))
    port.docid = [f"d{i}" for i in range(700)]
    port.save(str(tmp_path / "port"))
    back = jflat.FlatIPIndex.load(str(tmp_path / "port"))
    pv, ps = port._native_int8_payload()
    bv, bs = back._native_int8_payload()
    np.testing.assert_array_equal(bv, pv)
    np.testing.assert_array_equal(bs, ps)
    assert back.docid == port.docid
    np.testing.assert_array_equal(back.search(q, 10)[1], port.search(q, 10)[1])

    jidx = jflat.FlatIPIndex(c, dtype="int8")
    jidx.save(str(tmp_path / "jax"))
    tidx = tflat.FlatIPIndex.load(str(tmp_path / "jax"), device="cpu")
    assert len(tidx._device_slabs) == 1 and len(tidx) == 700
    tv, ts = tidx._native_int8_payload()
    with np.load(str(tmp_path / "jax") + ".npz") as z:
        np.testing.assert_array_equal(tv, z["values"])
        np.testing.assert_array_equal(ts, z["scales"])
    np.testing.assert_array_equal(tidx.search(q, 10, mode="serve")[1], jidx.search(q, 10)[1])
    # a host-staged index saves the payload the plain K7 makes: numpy's
    host = tflat.FlatIPIndex(c, dtype="int8", device="cpu")
    hv, hs = host._native_int8_payload()
    nv, ns = jflat.quantize_int8(c)
    np.testing.assert_array_equal(hv, nv)
    np.testing.assert_array_equal(hs, ns)


@pytest.mark.parametrize("spec,dtype", [("Flat", "float32"), ("IP", "float32"),
                                        ("BF16", "bfloat16"), ("flat16", "bfloat16"),
                                        ("SQ8", "int8"), (" SQint8 ", "int8"),
                                        ("SQ4", "int4"), ("SQint4", "int4")])
def test_index_factory_flat_strings(spec, dtype):
    idx = tflat.index_factory(16, spec, block_size=512, device="cpu")
    assert isinstance(idx, tflat.FlatIPIndex) and idx.dtype == dtype and idx.block_size == 512
    assert jflat.index_factory(16, spec).dtype == dtype


def test_index_factory_unported_kinds_raise():
    """The IVF, IVFR, PCA/PCAR and product-quantized (PQ, OPQ, IVF-PQ)
    strings build the classes the reference's build, with its parameters;
    int4 IVF cells raise the reference's ValueError (the sq4 kernels are
    flat-corpus kernels)."""
    from denseretrievaltoolkits_torch.index import ivf, transforms

    for spec, cls, dtype, nlist in (("IVF64,Flat", ivf.IVFFlatIndex, "float32", 64),
                                    ("IVF64,BF16", ivf.IVFFlatIndex, "bfloat16", 64),
                                    ("IVF64,SQ8", ivf.IVFFlatIndex, "int8", 64),
                                    ("IVFR64,SQ8", ivf.IVFRaggedIndex, "int8", 64),
                                    ("IVFR32", ivf.IVFRaggedIndex, "int8", 32),
                                    ("IVFR64,Flat", ivf.IVFRaggedIndex, "float32", 64)):
        idx = tflat.index_factory(16, spec, nprobe=8, device="cpu")
        want = jflat.index_factory(16, spec, nprobe=8)
        assert type(idx) is cls and type(want).__name__ == cls.__name__
        assert (idx.dtype, idx.nlist, idx.nprobe) == (dtype, nlist, 8) == \
            (want.dtype, want.nlist, want.nprobe)
    for spec, inner, d_out, rotate in (("PCAR8,Flat", tflat.FlatIPIndex, 8, True),
                                       ("PCA8,SQ4", tflat.FlatIPIndex, 8, False),
                                       ("PCAR12,IVF4,SQ8", ivf.IVFFlatIndex, 12, True)):
        idx = tflat.index_factory(16, spec, device="cpu")
        assert isinstance(idx, transforms.TransformedIndex) and type(idx.inner) is inner
        assert (idx.transform.d_out, idx.transform.rotate, idx.inner.dim) == (d_out, rotate,
                                                                             d_out)
    # the product-quantized kinds build with the JAX package's parameters (dim
    # 128: IVF-PQ's decode layout needs 128 | dim)
    from denseretrievaltoolkits_torch.index import ivf_pq, pq

    for spec in ("PQ8", "PQ16x4", "OPQ8,PQ8", "OPQ16x4,PQ16x4", "IVF16,PQ8x4", "IVFR16,PQ8"):
        idx = tflat.index_factory(128, spec, nprobe=8, device="cpu")
        want = jflat.index_factory(128, spec, nprobe=8)
        if spec.startswith("OPQ"):
            assert isinstance(idx, transforms.TransformedIndex)
            assert type(idx.transform) is transforms.OPQTransform
            assert (idx.transform.M, idx.transform.nbits, idx.transform.rounds) == \
                (want.transform.M, want.transform.nbits, want.transform.rounds)
            idx, want = idx.inner, want.inner
        cls = ivf_pq.IVFPQIndex if spec.startswith("IVF") else pq.PQIndex
        assert type(idx) is cls and type(want).__name__ == cls.__name__
        assert (idx.M, idx.nbits) == (want.M, want.nbits)
        if cls is pq.PQIndex:
            assert idx.block_size == want.block_size
        else:
            assert (idx.nlist, idx.nprobe, idx.block) == (want.nlist, want.nprobe, want.block)
    for spec in ("IVF64,SQ4", "IVFR64,SQint4"):
        with pytest.raises(ValueError, match="flat SQ4"):
            tflat.index_factory(16, spec, device="cpu")
        with pytest.raises(ValueError, match="flat SQ4"):
            jflat.index_factory(16, spec)
    with pytest.raises(ValueError, match="unsupported factory"):
        tflat.index_factory(16, "HNSW32", device="cpu")


def test_entry_points_default_to_cuda(tmp_path):
    """Without a card an index built or loaded with no device raises; nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from denseretrievaltoolkits_torch.index.io import load_index

    with pytest.raises(RuntimeError, match="device='cpu'"):
        tflat.FlatIPIndex(16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tflat.index_factory(16, "SQ8")
    tflat.FlatIPIndex(np.ones((4, 16), np.float32), device="cpu").save(str(tmp_path / "i"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_index(str(tmp_path / "i"))
    assert len(load_index(str(tmp_path / "i"), device="cpu")) == 4


# --- the split products of K5's fp32 body (csrc/flat_certified.cu), emulated ----------------
# Each fp32 operand becomes hi + lo. "fp16": the kernels' split (csrc/split.cuh), a group
# scaled by 2^e (its largest magnitude into [2^13, 2^14)), hi = fp16(x 2^e), lo = fp16(x 2^e -
# hi); "tf32": the 3xTF32 split, hi = tf32_rn(x), lo = tf32_rn(x - hi), rounding by bit
# arithmetic (cvt.rna: half of 2^13 added to the magnitude, then cut). A product is hi.hi +
# hi.lo + lo.hi, summed in fp32.

def tf32_rn(x):
    """fp32 -> the nearest TF32 value (ties away from zero), as fp32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_exp(m):
    """The kernels' power of two for groups of largest magnitude m: m 2^e in [2^13, 2^14),
    0 for m = 0, clamped to +-100."""
    _, E = torch.frexp(m)  # m = f 2^E, f in [0.5, 1)
    return torch.where(m > 0, (14 - E).clamp(-100, 100), torch.zeros_like(E))


def split_pair(x, scheme, e=None):
    """(hi, lo) of x in fp32: fp16 halves of x 2^e (e broadcast against x), or TF32 halves."""
    if scheme == "tf32":
        hi = tf32_rn(x)
        return hi, tf32_rn(x - hi)
    xs = torch.ldexp(x, e)
    hi = xs.half().float()
    return hi, (xs - hi).half().float()


def split_matmul(a, b, scheme, ea=None, eb=None):
    """a [m, k] . b [n, k]^T from split operands, three products summed in fp32, scales
    (row exponents ea [m, 1] / eb [n, 1] of a and b) taken back out exactly."""
    ah, al = split_pair(a, scheme, ea)
    bh, bl = split_pair(b, scheme, eb)
    s = ah @ bh.T + ah @ bl.T + al @ bh.T
    return s if scheme == "tf32" else torch.ldexp(s, -ea - eb.T)


def emulated_flat_scores(q, c, scheme, slice_dims=64):
    """K5's fp32 scores as its split body forms them: fp16 pairs with one exponent a query
    and one a (row, 64-dim slice), each slice's three products summed in fp32, the slices'
    sums scaled back and added in fp32; or the same sums over TF32 pairs."""
    eq = split_exp(q.abs().amax(1, keepdim=True))
    total = torch.zeros(c.shape[0], q.shape[0])
    for d in range(0, q.shape[1], slice_dims):
        cs, qs = c[:, d:d + slice_dims], q[:, d:d + slice_dims]
        ec = split_exp(cs.abs().amax(1, keepdim=True))
        total = total + split_matmul(cs, qs, scheme, ec, eq)
    return total.T


@pytest.mark.parametrize("scheme", ["fp16", "tf32"])
@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e3])
def test_split_products_hold_the_k5_bound(scheme, scale):
    """The emulated split products of K5's fp32 body stay within chip_smoke.py's K5 bound
    (1e-5 of max(|score|, 1) against fp64, over each query's top 100) at 768 dims, over rows
    of several magnitudes, and their largest error over all scores, relative to the terms'
    magnitudes, is at most twice plain fp32's; each pair holds 22 bits of its value
    (|x - (hi + lo)| <= 2^-22 |x| above 2^-3 of the group's largest)."""
    rng = np.random.default_rng(11)
    c = torch.from_numpy(rng.normal(size=(2048, 768)).astype(np.float32)) * scale
    c[100:200, :384] *= 8.0  # another scale in these rows' first slices
    q = torch.from_numpy(rng.normal(size=(64, 768)).astype(np.float32))
    got = emulated_flat_scores(q, c, scheme).double()
    exact = q.double() @ c.double().T
    top = exact.topk(100, dim=1).indices
    err, want = (got - exact).abs().gather(1, top), exact.gather(1, top)
    assert bool((err <= 1e-5 * want.abs().clamp(min=1.0)).all())
    mag = q.double().abs() @ c.double().abs().T
    plain = ((q @ c.T).double() - exact).abs()
    assert float(((got - exact).abs() / mag).max()) <= 2 * float((plain / mag).max())
    e = split_exp(c.abs().amax(1, keepdim=True))
    hi, lo = split_pair(c, scheme, e)
    rebuilt = hi + lo if scheme == "tf32" else torch.ldexp(hi + lo, -e)
    big = c.abs() >= c.abs().amax(1, keepdim=True) / 8
    err = ((c.double() - rebuilt.double()).abs() / c.double().abs().clamp(min=1e-30))[big]
    assert float(err.max()) <= 2.0 ** -22


# --- the serve bodies' selection (csrc/serve_select.cuh, csrc/flat_serve.cu), emulated --------

def _score_order(v):
    """serve_select.cuh:score_order: the serve key's high word of fp32 scores (uint64 here)."""
    b = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)


def _serve_select(s, block, n_valid, J, tile=64):
    """flat_serve.cu's selection over one query's scores s [N]: per storage block, two lists
    (two threads), each of the least of 8 / 16 / 32 keys that holds J and each seeing half of
    every 64-row tile; per tile a thread's rows whose order beats the order of its list's
    J-th key (0 while it holds fewer) at the tile's start, marked first, then inserted in row
    order against the floor as it stands; at the block's end the odd list inserted into the
    even one, its first J written ((-inf, -1) empty). Returns (vals, ids) [n_blocks, J]."""
    N = s.shape[0]
    NL = 8 if J <= 8 else 16 if J <= 16 else 32
    n_blocks = -(-N // block)
    vals = np.full((n_blocks, J), -np.inf, np.float32)
    ids = np.full((n_blocks, J), -1, np.int32)
    order = _score_order(s)
    for blk in range(n_blocks):
        start = blk * block
        row_lim = min(N, start + block, n_valid)
        lists = [[], []]  # keys, sorted descending
        for base in range(start, row_lim, tile):
            for h in (0, 1):
                L = lists[h]
                floor = (L[J - 1] >> 32) if len(L) >= J else 0
                rows = [base + tile // 2 * h + b for b in range(tile // 2)
                        if base + tile // 2 * h + b < row_lim]
                cand = [r for r in rows if order[r] > floor]  # the bitmask at the tile's start
                for r in cand:
                    if order[r] > floor:
                        L.append((int(order[r]) << 32) | (~r & 0xFFFFFFFF))
                        L.sort(reverse=True)
                        del L[NL:]
                        floor = (L[J - 1] >> 32) if len(L) >= J else 0
        merged = sorted(lists[0] + lists[1], reverse=True)[:J]
        for p, key in enumerate(merged):
            o = np.uint64(key >> 32)
            bits = np.where(o & 0x80000000, o & 0x7FFFFFFF, ~o & 0xFFFFFFFF).astype(np.uint32)
            vals[blk, p] = bits.view(np.float32)
            ids[blk, p] = ~(key & 0xFFFFFFFF) & 0xFFFFFFFF
    return vals, ids


@pytest.mark.parametrize("J", [4, 7, 11, 16, 32])
def test_serve_selection_rule_matches_select_packed(J):
    """The serve bodies' selection, emulated in key order, equals ``_select_packed`` (the
    plain K8 / K11 / K12 selection) bit for bit, scores' signs included, on planted rows:
    -0 against +0 at and around the J-th place (a +0 row after a -0 J-th entry enters; a -0
    row after a +0 one does not), equal scores across the two halves of a tile and across
    tiles (the smaller id first), blocks of 1000 rows (not a multiple of the 64-row tile),
    a short last block and rows masked by n_valid inside a tile."""
    rng = np.random.default_rng(46)
    N, block, n_valid = 2900, 1000, 2871
    s = rng.normal(size=(3, N)).astype(np.float32)
    # query 0: the best rows are +0 or -0: J - 2 of +0 interleaved with -0 (both halves of
    # the first tile), a tile of -0, then one +0 in a later tile, which must displace a -0
    # J-th entry: the block's list is J - 1 rows of +0, then the first -0 row (11)
    s[0, :] = -np.abs(s[0, :]) - 1.0
    s[0, 10:10 + 2 * (J - 2):2] = 0.0
    s[0, 11:11 + 2 * (J - 2):2] = -0.0
    s[0, 100:164] = -0.0
    s[0, 170] = 0.0
    # query 1: ties across the two halves of a tile, across tiles and across blocks
    s[1, :] = rng.normal(size=N).astype(np.float32) - 3.0
    s[1, [5, 37, 70, 100, 1001, 1040, 1999]] = 2.5
    s[1, [6, 38, 71]] = -0.0
    # query 2: the top rows sit past n_valid inside the last tile, which they must not enter
    s[2, n_valid:] = 50.0
    v, i = zip(*(_serve_select(s[q], block, n_valid, J) for q in range(3)))
    want_v, want_i = ttopk._per_block(lambda a, b: torch.from_numpy(s[:, a:b]),
                                      ttopk._select_packed, 3, N, J, block, n_valid, "cpu")
    got_v, got_i = torch.from_numpy(np.stack(v)), torch.from_numpy(np.stack(i))
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))  # -0 stays -0
    assert not bool(torch.signbit(got_v[0, 0, :J - 1]).any()) and got_v[0, 0, J - 1] == 0
    assert bool(torch.signbit(got_v[0, 0, J - 1])) and got_i[0, 0, J - 1] == 11
    assert 170 in got_i[0, 0].tolist()
    assert not bool((got_i[2] >= n_valid).any())


# --- K6 / K8 int8 rows as bf16 fragments (csrc/common.cuh:i8x4_to_bf16), emulated --------------

def _i8x4_to_bf16(w):
    """common.cuh:i8x4_to_bf16 on uint32 words w: (lo, hi) bf16x2 words of bytes 0, 1 and 2, 3,
    by the kernel's bit operations: the biased byte u = x + 128 in the low byte of the float
    0x4B000000 (2^23 + u), less 2^23 + 128 (one fp32 subtraction), the result's high half."""
    w = np.atleast_1d(np.asarray(w, np.uint32))
    u = w ^ np.uint32(0x80808080)
    halves = []
    for k in range(4):
        f = (((u >> (8 * k)) & 0xFF) | 0x4B000000).astype(np.uint32).view(np.float32)
        halves.append((f - np.float32(8388736.0)).astype(np.float32).view(np.uint32) >> 16)
    return halves[0] | (halves[1] << 16), halves[2] | (halves[3] << 16)


def _bf16_bits_value(bits):
    """bf16 bit patterns (uint16 in uint32) -> their values (float64)."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32).astype(np.float64)


def _bf16_column(i):
    """int4_tiles.cuh:bf16_column: the k of dim offset i (0..15) of a 16-dim group."""
    return 2 * (i >> 2) + (i & 1) + 8 * ((i >> 1) & 1)


def test_int8_fragments_are_the_bf16_of_every_byte():
    """The kernels' int8 -> bf16 conversion (K6 and K8 int8 fragments, ivf_cell.cu's int8
    rows) is bit-equal to ``.to(torch.bfloat16)`` on all 256 byte values, in every byte of a
    word."""
    b = np.arange(256, dtype=np.uint32)
    want = torch.from_numpy(b.astype(np.uint8).view(np.int8)).to(torch.bfloat16)
    want = want.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF
    for perm in (b, b[::-1], (b * 37) % 256, (b * 101 + 7) % 256):
        words = [perm, (perm + 1) % 256, (perm + 128) % 256, 255 - perm]
        lo, hi = _i8x4_to_bf16(words[0] | (words[1] << 8) | (words[2] << 16) | (words[3] << 24))
        for got, byte in ((lo & 0xFFFF, words[0]), (lo >> 16, words[1]), (hi & 0xFFFF, words[2]),
                          (hi >> 16, words[3])):
            np.testing.assert_array_equal(got, want[byte])


def test_int8_fragment_k_order_matches_the_query_tile():
    """The k order of the int8 fragments equals the query tile's: thread t4's word (dims 4 t4
    .. 4 t4 + 3 of a 16-dim group) gives k 2 t4, 2 t4 + 1 (its bytes 0, 1) and 2 t4 + 8, 2 t4
    + 9 (bytes 2, 3), and the consumer warps' query words, pairs of 8 loaded dims at columns
    c, c + 8, c + 2, c + 10, put dim i at bf16_column(i); so a group's products summed over k
    are the dot product, exactly (fp64 here)."""
    assert sorted(_bf16_column(i) for i in range(16)) == list(range(16))
    rng = np.random.default_rng(7)
    rows = rng.integers(-128, 128, size=(4, 16)).astype(np.int8)
    qb = torch.from_numpy(rng.normal(size=16).astype(np.float32)).bfloat16()
    qbits = qb.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF
    col = np.zeros(16, np.uint32)  # the query tile's 16 columns, from the 16-byte loads
    for d in (0, 8):
        words = [qbits[d + 2 * p] | (qbits[d + 2 * p + 1] << 16) for p in range(4)]
        c = _bf16_column(d)
        for p, cc in enumerate((c, c + 8, c + 2, c + 10)):
            col[cc], col[cc + 1] = words[p] & 0xFFFF, words[p] >> 16
    qk = _bf16_bits_value(col)
    for r in rows:
        frag = np.zeros(16)
        for t4 in range(4):
            word = np.uint32(int.from_bytes(r[4 * t4:4 * t4 + 4].tobytes(), "little"))
            lo, hi = (int(x[0]) for x in _i8x4_to_bf16(word))
            frag[2 * t4], frag[2 * t4 + 1] = _bf16_bits_value([lo & 0xFFFF, lo >> 16])
            frag[2 * t4 + 8], frag[2 * t4 + 9] = _bf16_bits_value([hi & 0xFFFF, hi >> 16])
        assert float(frag @ qk) == float(r.astype(np.float64) @ qb.double().numpy())


# --- K8 fp32: the serve selection of flat_certified.cu's fp32 body, emulated -----------------

def _split_body_select(s, block, n_valid, J, zero, tile=64):
    """flat_certified.cu's fp32 body's selection over one query's scores s [N] (+ zero, -0.0:
    serve, every score kept; +0.0: certified, -0 made +0) in key order: J <= 16, two threads
    each with a list of 8 (J <= 8) or 16 over half of every 64-row tile (the even list takes
    the odd one at the block's end); J > 16, one thread with a list of 32 over every row;
    per tile a list's
    rows whose order beats its J-th key's order at the tile's start (0 while it holds fewer),
    then inserted in row order against the floor as it stands. Returns (vals, ids)
    [n_blocks, J]."""
    s = (np.asarray(s, np.float32) + np.float32(zero)).astype(np.float32)
    order = _score_order(s)
    N = s.shape[0]
    NL, parts = (8, 2) if J <= 8 else (16, 2) if J <= 16 else (32, 1)
    n_blocks = -(-N // block)
    vals = np.full((n_blocks, J), -np.inf, np.float32)
    ids = np.full((n_blocks, J), -1, np.int32)
    for blk in range(n_blocks):
        start, row_lim = blk * block, min(N, blk * block + block, n_valid)
        lists = [[] for _ in range(parts)]
        for base in range(start, row_lim, tile):
            for h, L in enumerate(lists):
                floor = (L[J - 1] >> 32) if len(L) >= J else 0
                width = tile // parts
                rows = [r for r in range(base + width * h, base + width * (h + 1)) if r < row_lim]
                for r in [r for r in rows if order[r] > floor]:
                    if order[r] > floor:
                        L.append((int(order[r]) << 32) | (~r & 0xFFFFFFFF))
                        L.sort(reverse=True)
                        del L[NL:]
                        floor = (L[J - 1] >> 32) if len(L) >= J else 0
        for p, key in enumerate(sorted(sum(lists, []), reverse=True)[:J]):
            o = np.uint64(key >> 32)
            bits = np.where(o & 0x80000000, o & 0x7FFFFFFF, ~o & 0xFFFFFFFF).astype(np.uint32)
            vals[blk, p] = bits.view(np.float32)
            ids[blk, p] = ~(key & 0xFFFFFFFF) & 0xFFFFFFFF
    return vals, ids


@pytest.mark.parametrize("J", [6, 7, 9, 11, 12, 16, 32])
def test_serve_selection_on_split_scores_matches_select_packed(J):
    """K8 over fp32 rows: the fp32 body's serve selection, emulated in key order on the
    emulated split-product scores (fp16 pairs, as ``emulated_flat_scores``), equals
    ``_select_packed`` on the same scores bit for bit, on planted rows: -0 against +0 at the
    J-th place (serve keeps the -0, a later +0 displaces it), equal scores across the two
    half-lists of a tile, across tiles and blocks (the smaller id first), 1000-row blocks, a
    short last block, rows masked by n_valid inside a tile; certified (+0 added) it equals
    ``_select_pairs`` with every -0 made +0."""
    rng = np.random.default_rng(48)
    N, block, n_valid = 2900, 1000, 2871
    c = torch.from_numpy(rng.normal(size=(N, 64)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    s = emulated_flat_scores(q, c, "fp16").numpy().astype(np.float32)
    s[0, :] = -np.abs(s[0, :]) - 1.0
    s[0, 10:10 + 2 * (J - 2):2] = 0.0
    s[0, 11:11 + 2 * (J - 2):2] = -0.0
    s[0, 100:164] = -0.0
    s[0, 170] = 0.0
    s[1, [5, 37, 70, 100, 1001, 1040, 1999]] = s[1].max() + 1.0  # ties: halves, tiles, blocks
    s[1, [6, 38, 71]] = -0.0
    s[2, n_valid:] = s[2].max() + 50.0  # the best rows, past n_valid inside the last tile
    scores = torch.from_numpy(s)
    for certified in (False, True):
        zero, select = (0.0, ttopk._select_pairs) if certified else (-0.0, ttopk._select_packed)
        v, i = zip(*(_split_body_select(s[r], block, n_valid, J, zero) for r in range(3)))
        want_v, want_i = ttopk._per_block(lambda a, b: scores[:, a:b], select, 3, N, J, block,
                                          n_valid, "cpu")
        got_v, got_i = torch.from_numpy(np.stack(v)), torch.from_numpy(np.stack(i))
        assert torch.equal(got_i, want_i)
        if certified:  # every -0 made +0, the plain version's may keep its -0
            assert torch.equal(got_v, want_v) and not bool(torch.signbit(got_v[0, 0]).any())
        else:
            assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
            assert bool(torch.signbit(got_v[0, 0, J - 1])) and got_i[0, 0, J - 1] == 11
            assert 170 in got_i[0, 0].tolist()
        assert not bool((got_i[2] >= n_valid).any())


# --- the Hopper-pair rule of ops/topk.py:_launch ----------------------------------------------

def test_hopper_pair_rule_over_every_pair(monkeypatch):
    """``hopper_pair`` is True exactly for the (query, row, selection) pairs a Hopper body
    takes: certified fp32 x fp32 / bf16 x bf16 (K5), bf16 x int8 (K6), fp32 x int4 (K10);
    serve fp32 x fp32, bf16 x bf16, bf16 x int8 (K8), int8 x int8 (K12), bf16 x int4 (K11),
    int8 x int4 (K12 sq4); and ``_launch`` counts a call that ``block_topj.cu``'s body ran
    (a C entry reporting body 0) on ``<counter>_generic`` for each pair the wrappers take."""
    f32, b16, i8 = torch.float32, torch.bfloat16, torch.int8
    taken = {(f32, f32, False, False), (b16, b16, False, False), (b16, i8, False, False),
             (f32, i8, False, True), (f32, f32, True, False), (b16, b16, True, False),
             (b16, i8, True, False), (i8, i8, True, False), (b16, i8, True, True),
             (i8, i8, True, True)}
    for qt in (f32, b16, i8):
        for ct in (f32, b16, i8):
            for serve in (False, True):
                for int4 in (False, True):
                    assert ttopk.hopper_pair(qt, ct, serve, int4) == (
                        (qt, ct, serve, int4) in taken), (qt, ct, serve, int4)

    class Lib:  # a C entry that ran block_topj.cu's body: leaves body at 0
        def drt_block_topj(self, *args):
            return 0

    monkeypatch.setattr(ttopk._native, "library", lambda: Lib())
    monkeypatch.setattr(ttopk._native, "stream_ptr", lambda t: 0)
    H, N = 64, 300
    rows = {f32: torch.zeros(N, H), b16: torch.zeros(N, H, dtype=b16),
            i8: torch.zeros(N, H, dtype=i8)}
    sc, qs = torch.ones(N), torch.ones(5)
    calls = [(ttopk.block_topj, "launches", f32, f32, {}),
             (ttopk.block_topj, "launches", b16, b16, {}),
             (ttopk.block_topj, "launches_int8", b16, i8, {"scales": sc}),
             (ttopk.block_topj, "launches_int4", f32, i8, {"scales": sc, "int4": True}),
             (ttopk.block_topj_serve, "launches", f32, f32, {"serve": True}),
             (ttopk.block_topj_serve, "launches", b16, b16, {"serve": True}),
             (ttopk.block_topj_serve, "launches", b16, i8, {"scales": sc, "serve": True}),
             (ttopk.block_topj_serve, "launches_int4", b16, i8,
              {"scales": sc, "serve": True, "int4": True}),
             (ttopk.block_topj_i8q, "launches", i8, i8, {"scales": sc, "qscales": qs,
                                                          "serve": True}),
             (ttopk.block_topj_i8q, "launches_int4", i8, i8,
              {"scales": sc, "qscales": qs, "serve": True, "int4": True})]
    for wrapper, counter, qt, ct, kw in calls:
        for name in (counter, counter + "_generic"):
            monkeypatch.setattr(wrapper, name, 0)
        corpus = rows[ct][:, :H // 2].contiguous() if kw.get("int4") else rows[ct]
        ttopk._launch(wrapper, counter, torch.zeros(5, H, dtype=qt), corpus, 7, 128, N, **kw)
        assert wrapper.last_body == "block_topj"
        assert (getattr(wrapper, counter), getattr(wrapper, counter + "_generic")) == (1, 1), (
            wrapper.__name__, counter)
