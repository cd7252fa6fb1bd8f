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


def _per_block(v):
    """[n_blocks, J, Q] -> [Q, n_blocks, J]."""
    return np.transpose(np.asarray(v), (2, 0, 1))


def test_block_topj_int8_plain_matches_pallas_kernel():
    """K6: bf16 queries x int8 rows x per-row scales, as ``pallas_topk`` runs it."""
    rng, _, values, scales = _int8_corpus(12)
    q = rng.normal(size=(8, 64)).astype(np.float32)
    qb = jnp.asarray(q, jnp.bfloat16)
    jv, ji = jtopk._pallas_block_topj_scaled(qb, jnp.asarray(values), jnp.asarray(scales), 6,
                                             256, 1000)
    tq = torch.from_numpy(np.asarray(qb.astype(jnp.float32))).bfloat16()
    tv, ti = ttopk.block_topj(tq, torch.from_numpy(values), 6, 256, 1000,
                              torch.from_numpy(scales))
    np.testing.assert_array_equal(ti.numpy(), _per_block(ji))
    np.testing.assert_allclose(tv.numpy(), _per_block(jv), rtol=1e-5, atol=1e-5)


def _packed_quantum(block_size):
    """The JAX serve kernels round a score to 2^id_bits ulps (topk.py:96-100)."""
    return 2.0 ** ((block_size - 1).bit_length() - 23)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_block_topj_serve_plain_matches_packed_kernels(dtype):
    """K8: per-block id sets of ``_pallas_block_topj_packed`` (fp32 / bf16) and
    ``_packed_scaled`` (int8); the port's exact scores sit within the TPU's
    rounding quantum of the packed ones."""
    rng, c, values, scales = _int8_corpus(13)
    q = rng.normal(size=(8, 64)).astype(np.float32)
    if dtype == "int8":
        qj = jnp.asarray(q, jnp.bfloat16)
        jv, ji = jtopk._pallas_block_topj_packed_scaled(qj, jnp.asarray(values),
                                                        jnp.asarray(scales), 6, 256, 1000)
        corpus, sc = torch.from_numpy(values), torch.from_numpy(scales)
    else:
        jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        qj, cj = jnp.asarray(q, jd), jnp.asarray(c, jd)
        jv, ji = jtopk._pallas_block_topj_packed(qj, cj, 6, 256, 1000)
        corpus, sc = torch.from_numpy(np.asarray(cj.astype(jnp.float32))), None
        corpus = corpus.to(tflat.DTYPES[dtype])
    tq = torch.from_numpy(np.asarray(qj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype != "float32" else torch.float32)
    tv, ti = ttopk.block_topj_serve(tq, corpus, 6, 256, 1000, sc)
    jv, ji = _per_block(jv), _per_block(ji)
    assert [set(r) for r in ti.numpy().reshape(-1, 6)] == [set(r) for r in ji.reshape(-1, 6)]
    np.testing.assert_allclose(np.sort(tv.numpy(), -1), np.sort(jv, -1),
                               rtol=2 * _packed_quantum(256), atol=1e-6)


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
    """The IVF, IVFR and PCA/PCAR strings build the classes the reference's
    build; the product-quantized kinds wait for their ROADMAP item; int4 IVF
    cells raise the reference's ValueError (the sq4 kernels are flat-corpus
    kernels)."""
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
    for spec in ("PQ8", "PQ16x4", "OPQ8,PQ8", "IVF16,PQ8x4", "IVFR16,PQ8"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tflat.index_factory(16, spec, device="cpu")
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
