"""The torch port's int4 (SQ4) flat index vs the JAX package, on the CPU.

K9 (``quantize_int4_device``), K10 (``block_topj(int4=True)``), K11
(``block_topj_serve(int4=True)``) and K12's sq4 body
(``block_topj_i8q(int4=True)``) run their plain versions here; the JAX side
runs its Pallas kernels in interpret mode (``_pallas_block_topj_sq4``,
``_pallas_block_topj_packed_sq4``, ``_pallas_block_topj_packed_sq4_i8q``,
``quantize_int4_device``). The searches (``certified_topk``, ``serve_topk``)
and ``FlatIPIndex(dtype="int4")`` are held to ``pallas_topk``,
``pallas_topk_fast`` and the JAX index. Inputs are numpy arrays from a seed."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from denseretrievaltoolkits_tpu.index import flat as jflat
from denseretrievaltoolkits_tpu.ops import quant as jquant
from denseretrievaltoolkits_tpu.ops import topk as jtopk
from denseretrievaltoolkits_torch.index import flat as tflat
from denseretrievaltoolkits_torch.ops import quant as tquant
from denseretrievaltoolkits_torch.ops import topk as ttopk


def _rows(n=301, h=64, seed=21):
    """An odd row count, per-row magnitudes over three decades, two zero rows
    and rows whose x / scale lands on .5 ties."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, h)) * rng.uniform(0.01, 10, size=(n, 1))).astype(np.float32)
    x[0] = 0
    x[5] = 0
    x[1] = 0
    x[1, :4] = [7.0, 2.5, -3.5, 0.5]  # scale exactly 1: ties round half to even
    x[1, h // 2:h // 2 + 2] = [-7.0, 1.5]
    return x


def _pallas_int4(x, block_rows):
    v, s = jquant.quantize_int4_device(jnp.asarray(x), block_rows=block_rows)
    return np.asarray(v), np.asarray(s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int4_matches_pallas(dtype):
    """K9's plain version divides in IEEE fp32 (absmax / 7, then x / scale)
    and rounds half to even. The JAX kernel, run by XLA on the CPU, takes
    absmax x fl(1/7) for the scale: about half of its scales sit one ulp off
    the IEEE quotient, and a code differs only where x / scale falls on a
    rounding boundary under one scale and not the other. Pinned on this
    input: the JAX scales are absmax x fl(1/7) exactly and within one ulp of
    the port's (30-70% of them differ); each side's codes are round(x / its
    own scale); and the count of codes that differ."""
    x = _rows()
    xt = torch.from_numpy(x)
    if dtype == "bfloat16":
        xt = xt.bfloat16()
        x = xt.float().numpy()
    packed, scales = tquant.quantize_int4_device(xt)
    assert packed.shape == (301, 32) and packed.dtype == torch.int8
    jv, js = _pallas_int4(x, 64)
    ts = scales.numpy()
    absmax = np.abs(x).max(axis=1)
    np.testing.assert_array_equal(js, np.where(absmax == 0, 1, absmax * np.float32(1 / 7.0)))
    np.testing.assert_array_equal(ts, np.where(absmax == 0, 1, absmax / np.float32(7.0)))
    np.testing.assert_array_max_ulp(ts, js, maxulp=1)
    ulp_share = float(np.mean(ts != js))
    assert 0.3 < ulp_share < 0.7, ulp_share
    codes = tquant.unpack_int4(packed).numpy()
    jcodes = tquant.unpack_int4(torch.from_numpy(jv)).numpy()
    np.testing.assert_array_equal(codes, np.clip(np.round(x / ts[:, None]), -7, 7))
    np.testing.assert_array_equal(jcodes, np.clip(np.round(x / js[:, None]), -7, 7))
    # bf16 inputs have 8-bit mantissas, so x / scale hits exact .5 ties often
    # and the one-ulp scale difference moves them: 41 of 19,264 codes
    assert int((codes != jcodes).sum()) == {"float32": 0, "bfloat16": 41}[dtype]
    assert codes[1, :4].tolist() == [7, 2, -4, 0] and codes[1, 32:34].tolist() == [-7, 2]
    assert (packed[0] == 0).all() and ts[0] == 1 and ts[5] == 1


def test_quantize_int4_padding_rows_and_layout():
    """Padding rows are zero bytes at scale 1, as ``jnp.pad`` then quantize;
    byte j packs dim j low and dim j + H/2 high (the column-half layout)."""
    x = _rows(n=37, h=16)
    packed, scales = tquant.quantize_int4_device(torch.from_numpy(x), rows=64)
    padded = np.zeros((64, 16), np.float32)
    padded[:37] = x
    jv, js = _pallas_int4(padded, 64)
    np.testing.assert_array_equal(packed.numpy()[37:], jv[37:])
    assert (packed.numpy()[37:] == 0).all() and (scales.numpy()[37:] == 1).all()
    b = packed.numpy().astype(np.int32) & 0xFF
    lo, hi = ((b & 0xF) ^ 8) - 8, (((b >> 4) & 0xF) ^ 8) - 8
    np.testing.assert_array_equal(np.concatenate([lo, hi], 1),
                                  tquant.unpack_int4(packed).numpy())
    with pytest.raises(ValueError, match="rows"):
        tquant.quantize_int4_device(torch.from_numpy(x), rows=10)
    with pytest.raises(ValueError, match="even feature dim"):
        tquant.quantize_int4_device(torch.zeros(3, 7))


def test_dequantize_int4_roundtrip():
    """The round trip is within absmax / 14 per element (tests/test_int4.py:32),
    and dequantizes as the JAX package's ``dequantize_int4``."""
    x = _rows(n=100, h=64, seed=3)
    packed, scales = tquant.quantize_int4_device(torch.from_numpy(x))
    d = tquant.dequantize_int4(packed, scales).numpy()
    absmax = np.abs(x).max(axis=1, keepdims=True)
    assert (np.abs(d - x) <= absmax / 14 + 1e-6).all()
    np.testing.assert_array_equal(
        d, np.asarray(jquant.dequantize_int4(jnp.asarray(packed.numpy()),
                                             jnp.asarray(scales.numpy()))))


def _int4_corpus(seed, n=1024, h=64):
    """An int4 corpus with a negative-score region (tests/test_int4.py:55),
    quantized by the port's plain K9."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(n, h)).astype(np.float32)
    c[:n // 4] -= 2.0
    packed, scales = tquant.quantize_int4_device(torch.from_numpy(c))
    return rng, c, packed.numpy(), scales.numpy()


def _per_block(v):
    """[n_blocks, J, Q] -> [Q, n_blocks, J]."""
    return np.transpose(np.asarray(v), (2, 0, 1))


def _packed_quantum(block_size):
    """The JAX serve kernels round a score to 2^id_bits ulps (topk.py:96-100)."""
    return 2.0 ** ((block_size - 1).bit_length() - 23)


def test_block_topj_sq4_plain_matches_pallas_kernel():
    """K10: fp32 queries, two half-dim fp32 products times the row scale, J
    masked maxes with ties to the smaller id; scores within 1e-5 relative
    (fp32 sums in another order), ids equal."""
    rng, _, packed, scales = _int4_corpus(31)
    packed[300:310] = packed[300]  # exact ties inside one block
    scales[300:310] = scales[300]
    q = rng.normal(size=(8, 64)).astype(np.float32)
    jv, ji = jtopk._pallas_block_topj_sq4(jnp.asarray(q), jnp.asarray(packed),
                                          jnp.asarray(scales), 6, 256, 1000)
    tv, ti = ttopk.block_topj(torch.from_numpy(q), torch.from_numpy(packed), 6, 256, 1000,
                              torch.from_numpy(scales), int4=True)
    np.testing.assert_array_equal(ti.numpy(), _per_block(ji))
    np.testing.assert_allclose(tv.numpy(), _per_block(jv), rtol=1e-5, atol=1e-5)
    assert ti.numpy().max() < 1000


def test_block_topj_serve_sq4_plain_matches_packed_kernel():
    """K11: bf16 queries over int4 rows, the packed selection. The per-block
    id sets are the Pallas kernel's; the port's exact scores sit within the
    TPU's rounding quantum of its packed ones."""
    rng, _, packed, scales = _int4_corpus(32)
    q = jnp.asarray(rng.normal(size=(8, 64)).astype(np.float32), jnp.bfloat16)
    jv, ji = jtopk._pallas_block_topj_packed_sq4(q, jnp.asarray(packed), jnp.asarray(scales), 6,
                                                 256, 1000)
    tq = torch.from_numpy(np.asarray(q.astype(jnp.float32))).bfloat16()
    tv, ti = ttopk.block_topj_serve(tq, torch.from_numpy(packed), 6, 256, 1000,
                                    torch.from_numpy(scales), int4=True)
    jv, ji = _per_block(jv), _per_block(ji)
    assert [set(r) for r in ti.numpy().reshape(-1, 6)] == [set(r) for r in ji.reshape(-1, 6)]
    np.testing.assert_allclose(np.sort(tv.numpy(), -1), np.sort(jv, -1),
                               rtol=2 * _packed_quantum(256), atol=1e-6)


def test_block_topj_i8q_sq4_plain_matches_packed_kernel():
    """K12's sq4 body: int8 queries x int4 rows in exact s32, times
    scale_row x scale_q. Queries are losslessly quantizable, so the two
    packages' query quantizers agree; scores equal within the TPU's packed
    rounding quantum, id sets equal."""
    rng, _, packed, scales = _int4_corpus(33)
    q_int = rng.integers(-127, 128, size=(8, 64)).astype(np.float32)
    q_int[:, 0] = 127.0
    q = q_int * 0.037
    jqi, jqs = jtopk.quantize_queries(jnp.asarray(q))
    qi, qs = ttopk.quantize_queries(torch.from_numpy(q))
    np.testing.assert_array_equal(qi.numpy(), np.asarray(jqi))
    jv, ji = jtopk._pallas_block_topj_packed_sq4_i8q(jqi, jnp.asarray(packed),
                                                     jnp.asarray(scales), jqs, 6, 256, 1000)
    tv, ti = ttopk.block_topj_i8q(qi, qs, torch.from_numpy(packed), torch.from_numpy(scales),
                                  6, 256, 1000, int4=True)
    jv, ji = _per_block(jv), _per_block(ji)
    assert [set(r) for r in ti.numpy().reshape(-1, 6)] == [set(r) for r in ji.reshape(-1, 6)]
    np.testing.assert_allclose(np.sort(tv.numpy(), -1), np.sort(jv, -1),
                               rtol=2 * _packed_quantum(256), atol=1e-6)


def _search_corpus(case, rng):
    """2000 x 64 corpora after tests/test_torch_topk.py, quantized to int4."""
    c = rng.normal(size=(2000, 64)).astype(np.float32)
    if case == "clustered":  # a block holds many top-k rows: escalation / fallback
        strong = rng.normal(size=(1, 64)).astype(np.float32) * 3
        c[100:130] = strong + 0.01 * rng.normal(size=(30, 64)).astype(np.float32)
        q = (strong + 0.05 * rng.normal(size=(5, 64))).astype(np.float32)
    else:
        q = rng.normal(size=(9, 64)).astype(np.float32)
    packed, scales = tquant.quantize_int4_device(torch.from_numpy(c))
    return q, packed, scales


@pytest.mark.parametrize("case", ["random", "clustered"])
@pytest.mark.parametrize("k", [30, 64])
def test_certified_topk_int4_matches_pallas_topk(case, k):
    """``certified_topk(int4=True)`` (K10 plain candidates, the certificate,
    escalation, the int4 scan) vs ``pallas_topk(int4=True)``: ids equal,
    scores within 1e-5."""
    q, packed, scales = _search_corpus(case, np.random.default_rng(41))
    js, ji = jtopk.pallas_topk(q, jnp.asarray(packed.numpy()), k=k, block_size=512,
                               scales=jnp.asarray(scales.numpy()), int4=True)
    before = ttopk.block_topj.launches_int4
    ts, ti = ttopk.certified_topk(torch.from_numpy(q), packed, k, block_size=512, scales=scales,
                                  int4=True)
    assert ttopk.block_topj.launches_int4 == before  # CPU tensors never launch the kernel
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("native", [False, True], ids=["serve", "i8q"])
def test_serve_topk_int4_matches_pallas_topk_fast(native):
    """``serve_topk(int4=True)`` vs ``pallas_topk_fast(int4=True)``: the same
    ids per query (sets: the TPU's scores are rounded), scores within the
    rounding quantum."""
    rng = np.random.default_rng(42)
    c = rng.normal(size=(777, 48)).astype(np.float32)  # not a block multiple
    q = rng.normal(size=(5, 48)).astype(np.float32)
    packed, scales = tquant.quantize_int4_device(torch.from_numpy(c))
    js, ji = jtopk.pallas_topk_fast(q, jnp.asarray(packed.numpy()), 20, block_size=256,
                                    scales=jnp.asarray(scales.numpy()), int4=True,
                                    i8_native=native)
    counter = ttopk.block_topj_i8q if native else ttopk.block_topj_serve
    before = counter.launches_int4
    ts, ti = ttopk.serve_topk(torch.from_numpy(q), packed, 20, 256, scales=scales,
                              i8_native=native, int4=True)
    assert counter.launches_int4 == before
    assert ti.shape == (5, 20)
    assert [set(r) for r in ti.numpy()] == [set(r) for r in np.asarray(ji)]
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2 * _packed_quantum(256),
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["exact", "serve", "i8q", "approx"])
def test_flat_index_int4_cpu_modes_match_jax(mode):
    """int4 FlatIPIndex on the CPU in every mode vs the JAX index (both run
    the exact int4 scan there): ids equal, scores within 1e-5."""
    rng = np.random.default_rng(43)
    c = rng.normal(size=(1300, 32)).astype(np.float32)
    q = rng.normal(size=(6, 32)).astype(np.float32)
    js, ji = jflat.FlatIPIndex(c, dtype="int4").search(q, 25, mode=mode)
    ts, ti = tflat.FlatIPIndex(c, dtype="int4", device="cpu").search(q, 25, mode=mode)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)


def test_blockwise_topk_int4_matches_jax():
    rng = np.random.default_rng(44)
    c = rng.normal(size=(1500, 48)).astype(np.float32)
    q = rng.normal(size=(6, 48)).astype(np.float32)
    packed, scales = tquant.quantize_int4_device(torch.from_numpy(c))
    js, ji = jflat.blockwise_topk(jnp.asarray(q), jnp.asarray(packed.numpy()), 20, 256,
                                  scales=jnp.asarray(scales.numpy()), valid=1400, int4=True)
    ts, ti = tflat.blockwise_topk(torch.from_numpy(q), packed, 20, 256, valid=1400,
                                  scales=scales, int4=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


def test_flat_index_int4_device_slabs():
    """Three add_device slabs (each quantized by K9 and padded to the block)
    give the host add's results in every mode, and the JAX index's slabs'."""
    rng = np.random.default_rng(45)
    c = rng.normal(size=(900, 32)).astype(np.float32)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    host = tflat.FlatIPIndex(c, dtype="int4", block_size=128, device="cpu")
    slabs = tflat.FlatIPIndex(32, dtype="int4", block_size=128, device="cpu")
    jslabs = jflat.FlatIPIndex(32, dtype="int4", block_size=128)
    for lo, hi in ((0, 300), (300, 700), (700, 900)):
        slabs.add_device(torch.from_numpy(c[lo:hi]))
        jslabs.add_device(jnp.asarray(c[lo:hi]))
    assert [v.shape for v, _, _ in slabs._device_slabs] == [(384, 16), (512, 16), (256, 16)]
    hs, hi_ = host.search(q, 40)
    for mode in ("exact", "serve", "i8q", "approx"):
        ss, si = slabs.search(q, 40, mode=mode)
        np.testing.assert_array_equal(si, hi_)
        np.testing.assert_allclose(ss, hs, rtol=1e-6)
    js, ji = jslabs.search(q, 40)
    np.testing.assert_array_equal(si, ji)
    np.testing.assert_allclose(ss, js, rtol=1e-5, atol=1e-5)


def test_flat_index_int4_save_load_interchange(tmp_path):
    """The native int4 payload (packed values [N, H/2], scales, meta dtype
    "int4") loads bit for bit in both directions, and a reload searches as
    the saved index did."""
    rng = np.random.default_rng(46)
    c = rng.normal(size=(700, 32)).astype(np.float32)
    q = rng.normal(size=(3, 32)).astype(np.float32)
    port = tflat.FlatIPIndex(32, dtype="int4", block_size=256, device="cpu")
    port.add_device(torch.from_numpy(c[:400]))
    port.add_device(torch.from_numpy(c[400:]))
    port.docid = [f"d{i}" for i in range(700)]
    port.save(str(tmp_path / "port"))
    with np.load(str(tmp_path / "port") + ".npz") as z:
        assert z["values"].shape == (700, 16) and z["values"].dtype == np.int8
    back = jflat.FlatIPIndex.load(str(tmp_path / "port"))
    assert back.dtype == "int4" and back.docid == port.docid
    pv, ps = port._native_int8_payload()
    bv, bs = back._native_int8_payload()
    np.testing.assert_array_equal(bv, pv)
    np.testing.assert_array_equal(bs, ps)
    np.testing.assert_array_equal(back.search(q, 10)[1], port.search(q, 10)[1])
    again = tflat.FlatIPIndex.load(str(tmp_path / "port"), device="cpu")
    np.testing.assert_array_equal(again.search(q, 10)[1], port.search(q, 10)[1])

    jidx = jflat.FlatIPIndex(c, dtype="int4")
    jidx.docid = port.docid
    jidx.save(str(tmp_path / "jax"))
    from denseretrievaltoolkits_torch.index.io import load_index

    tidx = load_index(str(tmp_path / "jax"), device="cpu")
    assert tidx.dtype == "int4" and len(tidx._device_slabs) == 1 and len(tidx) == 700
    tv, ts = tidx._native_int8_payload()
    with np.load(str(tmp_path / "jax") + ".npz") as z:
        np.testing.assert_array_equal(tv, z["values"])
        np.testing.assert_array_equal(ts, z["scales"])
    np.testing.assert_array_equal(tidx.search(q, 10, mode="serve")[1], jidx.search(q, 10)[1])
    assert tidx.docid == port.docid


def test_index_factory_sq4_builds_and_searches():
    """``index_factory("SQ4")`` builds an int4 index that searches as the
    reference's (tests/test_int4.py:68-80); "IVF64,SQ4" raises in both."""
    rng = np.random.default_rng(47)
    c = rng.normal(size=(600, 64)).astype(np.float32)
    q = rng.normal(size=(5, 64)).astype(np.float32)
    idx = tflat.index_factory(64, "SQ4", block_size=128, device="cpu")
    jidx = jflat.index_factory(64, "SQ4", block_size=128)
    idx.add(c)
    jidx.add(c)
    assert idx.dtype == "int4" and len(idx) == 600
    np.testing.assert_array_equal(idx.search(q, 20)[1], jidx.search(q, 20)[1])
    for spec in ("IVF64,SQ4", "IVF8,SQint4"):
        with pytest.raises(ValueError, match="flat SQ4"):
            tflat.index_factory(64, spec, device="cpu")
        with pytest.raises(ValueError, match="flat SQ4"):
            jflat.index_factory(64, spec)


def test_cpu_tensors_never_launch_int4():
    counts = (tquant.quantize_int4_device.launches, ttopk.block_topj.launches_int4,
              ttopk.block_topj_serve.launches_int4, ttopk.block_topj_i8q.launches_int4)
    rng, _, packed, scales = _int4_corpus(48, n=300)
    q = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    p, s = torch.from_numpy(packed), torch.from_numpy(scales)
    for mode in ("exact", "serve", "i8q"):
        idx = tflat.FlatIPIndex(64, dtype="int4", block_size=64, device="cpu")
        idx.add_device(torch.from_numpy(rng.normal(size=(300, 64)).astype(np.float32)))
        idx.search(q.numpy(), 10, mode=mode)
    ttopk.block_topj_serve(q.bfloat16(), p, 4, 64, 300, s, int4=True)
    assert counts == (tquant.quantize_int4_device.launches, ttopk.block_topj.launches_int4,
                      ttopk.block_topj_serve.launches_int4, ttopk.block_topj_i8q.launches_int4)


# -- K10's digit arithmetic on the card (csrc/int4_certified.cu), in plain numpy ---------------


def _k10_digits(q):
    """K10's split of fp32 queries q [Q, H]: per query the shift sh of
    ``int4_certified.cu:digit_shift`` (23 - E for max|q| = f 2^E, f in [0.5,
    1), one less where the top digit would overflow; 0 for an all-zero
    query), the fixed-point integers v = round(q 2^sh) (int64) and their
    balanced base-256 digits (d2, d1, d0), each in [-128, 127]."""
    q = np.asarray(q, np.float32)
    m = np.abs(q).max(axis=1)
    _, E = np.frexp(m)
    sh = 23 - E.astype(np.int64)
    sh = np.where(np.rint(np.ldexp(m.astype(np.float64), sh)) > 8355711, sh - 1, sh)
    sh = np.where(m > 0, sh, 0)
    v = np.rint(np.ldexp(q.astype(np.float64), sh[:, None])).astype(np.int64)
    d0 = ((v + 128) & 255) - 128
    v1 = (v - d0) >> 8
    d1 = ((v1 + 128) & 255) - 128
    d2 = (v1 - d1) >> 8
    return sh, v, (d2, d1, d0)


def _k10_scores(q, packed, scales):
    """K10's scores [Q, N]: the three digit planes' exact int64 sums against
    the codes, S = P2 2^16 + P1 2^8 + P0, fp32(S 2^-sh) rounded once, times
    the row scale in fp32, + 0. Also returns (S 2^-sh in fp64, sh, v)."""
    sh, v, digits = _k10_digits(q)
    codes = tquant.unpack_int4(torch.from_numpy(np.asarray(packed))).numpy().astype(np.int64)
    p2, p1, p0 = (d @ codes.T for d in digits)
    exact = ((p2 << 16) + (p1 << 8) + p0).astype(np.float64) * np.ldexp(1.0, -sh)[:, None]
    s = exact.astype(np.float32) * np.asarray(scales, np.float32)[None, :] + np.float32(0)
    return s, exact, sh, v


def _k10_queries(rng, n=64, h=768):
    """Seeded fp32 queries over six decades of magnitude, an all-zero query,
    one whose largest component is negative and one at the top digit's edge
    (max |q| just under a power of two)."""
    q = (rng.standard_normal((n, h)) * 10.0 ** rng.uniform(-3, 3, (n, 1))).astype(np.float32)
    q[0] = 0
    q[1, 7] = -4 * np.abs(q[1]).max()
    q[2, 3] = np.float32(np.nextafter(np.float32(8), np.float32(0))) * np.abs(q[2]).max()
    return q


def test_k10_digits_hold_the_queries():
    """Each component is off by at most e / 2, e = 2^-sh the query's step;
    the digits are balanced bytes and recombine to v exactly; v fits the
    three digits; an all-zero query has every digit 0."""
    q = _k10_queries(np.random.default_rng(40))
    sh, v, (d2, d1, d0) = _k10_digits(q)
    step = np.ldexp(1.0, -sh)[:, None]
    assert (np.abs(v * step - q.astype(np.float64)) <= step / 2).all()
    for d in (d2, d1, d0):
        assert d.min() >= -128 and d.max() <= 127
    np.testing.assert_array_equal((d2 << 16) + (d1 << 8) + d0, v)
    # the step is within a factor 2 of 2^-23 of the largest component: 22-23 bits kept
    top = np.abs(v).max(axis=1)[1:]
    assert (top >= 2 ** 21).all() and (top <= 8355711).all()
    assert sh[0] == 0 and (v[0] == 0).all()


def test_k10_digit_scores_are_exact():
    """The digit sums give the fp64 scores of the fixed-point queries
    exactly (integer sums below 2^53), and the kernel's score is that value
    rounded once to fp32, then times the scale."""
    rng = np.random.default_rng(41)
    q = _k10_queries(rng, n=32)
    _, _, packed, scales = _int4_corpus(42, n=300, h=768)
    s, exact, sh, v = _k10_scores(q, packed, scales)
    codes = tquant.unpack_int4(torch.from_numpy(packed)).numpy().astype(np.float64)
    fixed = v.astype(np.float64) * np.ldexp(1.0, -sh)[:, None]
    np.testing.assert_array_equal(exact, fixed @ codes.T)
    np.testing.assert_array_equal(s, (fixed @ codes.T).astype(np.float32) * scales[None, :])
    assert (np.signbit(s) == (s < 0)).all()  # no -0 score
    # against the fp64 score of the fp32 queries: e / 2 a component, then the two fp32
    # roundings (the sum's and the scale's)
    f64 = (q.astype(np.float64) @ codes.T) * scales[None, :]
    bound = (0.5 * np.ldexp(1.0, -sh)[:, None] * (np.abs(codes).sum(1) * scales)[None, :]
             + 2.0 ** -23 * np.abs(f64))
    assert (np.abs(s - f64) <= bound).all()


def test_k10_digit_scores_match_the_plain_version():
    """On seeded N(0, 1) queries and rows at H = 768: the digit scores lie
    within 1e-5 of the plain K10's (``_block_topj_reference(int4=True)``,
    true-fp32 products), and give the same per-block top-J ids. (Rows with a
    common offset, as ``_int4_corpus``'s, cancel to scores far below the
    terms' magnitude: there both sit about 2e-7 of the magnitude off fp64.)"""
    rng = np.random.default_rng(43)
    q = rng.standard_normal((64, 768)).astype(np.float32)
    q[0] = 0
    packed, scales = (t.numpy() for t in tquant.quantize_int4_device(
        torch.from_numpy(rng.standard_normal((2048, 768)).astype(np.float32))))
    s, _, _, _ = _k10_scores(q, packed, scales)
    J, block, n_valid = 8, 512, 2000
    tq, tc, ts = torch.from_numpy(q), torch.from_numpy(packed), torch.from_numpy(scales)
    rv, ri = ttopk._block_topj_reference(tq, tc, J, block, n_valid, ts, int4=True)
    dv, di = ttopk._per_block(lambda a, b: torch.from_numpy(s[:, a:b]), ttopk._select_pairs,
                              q.shape[0], packed.shape[0], J, block, n_valid, "cpu")
    assert torch.equal(di, ri)
    torch.testing.assert_close(dv, rv, rtol=1e-5, atol=1e-5)
    # every score, within 1e-5 of the magnitude of its terms (sum_d |q_d c_d| x scale, which
    # bounds the rounding of a sum whose terms cancel), as chip_smoke.py holds the kernels
    plain = ttopk._scores(tq, tc, ts, int4=True).numpy()
    codes = tquant.unpack_int4(tc).numpy().astype(np.float64)
    mag = (np.abs(q).astype(np.float64) @ np.abs(codes).T) * scales[None, :]
    assert (np.abs(s - plain) <= 1e-5 * np.maximum(mag, 1.0)).all()


def _certified_key(v, row):
    """``serve_select.cuh:pack_key`` of fp32 scores v (the kernel's + 0 applied)
    and int32 rows, as uint64: order-preserving score bits high, the inverted
    row low."""
    b = (np.asarray(v, np.float32) + np.float32(0)).view(np.uint32).astype(np.uint64)
    o = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    return (o << np.uint64(32)) | (~np.asarray(row, np.uint64) & np.uint64(0xFFFFFFFF))


def test_k10_packed_keys_order_as_the_certified_selection():
    """Sorting the packed keys descending orders (score, id) pairs exactly as
    ``_select_pairs`` (stable descending sort: equal scores by ascending id),
    with -0 and +0 equal, exact ties and negative scores; without the + 0 a
    -0 would sort below +0."""
    v = np.array([0.0, -0.0, 1.5, -2.0, 1.5, -0.0, 3.0, 0.0, -2.0, 1e-30, -1e-30, 1.5],
                 np.float32)
    rows = np.arange(v.size)
    keys = _certified_key(v, rows)
    order = np.array(sorted(rows, key=lambda i: keys[i], reverse=True))
    sv, pos = ttopk._select_pairs(torch.from_numpy(v)[None, :], torch.from_numpy(rows), v.size)
    np.testing.assert_array_equal(order, pos[0].numpy())
    raw = np.where(np.signbit(v) & (v == 0), np.float32(-0.0), v)  # no + 0: -0 stays
    b = raw.view(np.uint32).astype(np.uint64)
    o = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    assert o[1] < o[0]  # the packed -0 sorts below +0 without the + 0


# -- K11 / K12 sq4 on the card (csrc/flat_serve.cu, csrc/int4_tiles.cuh), in plain numpy --------
# Packed words are read as four bytes, little-endian: byte e of word m of a thread t4 is packed
# byte 16 m + 4 t4 + e of its 64-byte slice (int4_tiles.cuh:slice_words).

def _byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays: result byte i is byte (s >> 4 i) & 7 of y:x."""
    pool = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    out = np.zeros(np.shape(x), np.uint64)
    for i in range(4):
        sel = np.uint64((s >> (4 * i)) & 7)
        out |= ((pool >> (np.uint64(8) * sel)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _bf16_bits_to_f32(bits):
    return (np.asarray(bits, np.uint32) << np.uint32(16)).view(np.float32)


def _nibble_pair_bf16(x, p):
    """int4_tiles.cuh:nibble_pair_bf16: bytes 2 p, 2 p + 1 of x (low nibbles) as bf16x2, the
    bias 0x4300 | (n ^ 8) (= 136 + n) set by one byte permute and one AND-XOR, then one
    bf16x2 FMA x 1 - 136 (exact: every value is a small integer). Returns the two halves'
    bf16 bits, low first."""
    biased = (_byte_perm(x, 0, 0x4140 if p == 0 else 0x4342) & np.uint32(0x000F000F)) \
        ^ np.uint32(0x43084308)
    halves = []
    for h in (biased & np.uint32(0xFFFF), biased >> np.uint32(16)):
        v = _bf16_bits_to_f32(h).astype(np.float64) * 1.0 - 136.0
        bits = torch.from_numpy(v.astype(np.float32)).bfloat16().view(torch.int16).numpy()
        assert np.array_equal(_bf16_bits_to_f32(bits.astype(np.uint16)), v.astype(np.float32))
        halves.append(bits.astype(np.uint16))
    return halves


def test_nibble_to_bf16_conversion_is_exact():
    """The K11 fragments' conversion (int4_tiles.cuh:slice_fragments_bf16) on every byte
    value, low and high nibble, in each of a word's four byte positions: bit-equal to
    ``unpack_int4(...).to(torch.bfloat16)`` of the same packed rows."""
    packed = np.stack([np.roll(np.arange(256, dtype=np.uint8), s) for s in range(4)])  # [4, 256]
    H = 2 * packed.shape[1]
    want = tquant.unpack_int4(torch.from_numpy(packed.view(np.int8))).bfloat16()
    want = want.view(torch.int16).numpy().astype(np.uint16)
    words = packed.reshape(4, -1, 4).astype(np.uint32)
    words = words[..., 0] | words[..., 1] << 8 | words[..., 2] << 16 | words[..., 3] << 24
    got = np.zeros_like(want)
    for hi in (0, 1):
        x = words >> np.uint32(4) if hi else words
        for p in (0, 1):
            lo_bits, hi_bits = _nibble_pair_bf16(x, p)
            for e, bits in ((2 * p, lo_bits), (2 * p + 1, hi_bits)):
                got[:, hi * H // 2 + 4 * np.arange(words.shape[1]) + e] = bits
    np.testing.assert_array_equal(got, want)


def _bf16_column(i):
    """int4_tiles.cuh:bf16_column: dim offset i of a 16-dim group -> its k in a k16 step."""
    return 2 * (i >> 2) + (i & 1) + 8 * ((i >> 1) & 1)


def _fragment_k_order(H, kind):
    """The dim each k of the serve bodies' A fragments holds, from int4_tiles.cuh's word loads
    (slice_words) and fragment builds, k counted per 128-dim slice s as the wgmma steps walk
    it: SQ4 (s8, four k32 steps: a[0] / a[1] word m, a[2] / a[3] word m + 1, bytes e at k
    4 t4 + e and 16 + 4 t4 + e; steps 0-1 low nibbles, 2-3 high) and BF4 (bf16, eight k16
    steps: step 4 hi + m word m, bytes 0-1 at k 2 t4 + e, bytes 2-3 at 2 t4 + 8 + e - 2)."""
    order = np.full(H, -1)
    half = H // 2
    for s in range(H // 128):
        for t4 in range(4):
            for e in range(4):
                if kind == "sq4":
                    for kk in range(4):
                        high, m0 = kk >= 2, 2 * (kk & 1)
                        for reg, m in ((0, m0), (2, m0 + 1)):
                            k = 128 * s + 32 * kk + (16 if reg == 2 else 0) + 4 * t4 + e
                            order[k] = (half if high else 0) + 64 * s + 16 * m + 4 * t4 + e
                else:
                    for hi in (0, 1):
                        for m in range(4):
                            k = 128 * s + 16 * (4 * hi + m) + (2 * t4 + e if e < 2
                                                               else 2 * t4 + 8 + e - 2)
                            order[k] = (half if hi else 0) + 64 * s + 16 * m + 4 * t4 + e
    return order


def _query_tile_k_order(H, kind):
    """The dim each k of the query tile holds, as flat_serve.cu's consumer warps write it:
    SQ4 byte (hi ? 64 : 0) + (dd & 63) of slice dd >> 6; BF4 tile 2 s + hi, column
    16 (o >> 4) + bf16_column(o & 15) for o = dd & 63 (dd: the dim within its half)."""
    order = np.full(H, -1)
    half = H // 2
    for d in range(H):
        hi = d >= half
        dd = d - half if hi else d
        if kind == "sq4":
            k = 128 * (dd >> 6) + (64 if hi else 0) + (dd & 63)
        else:
            o = dd & 63
            k = 128 * (dd >> 6) + 64 * hi + 16 * (o >> 4) + _bf16_column(o & 15)
        order[k] = d
    return order


@pytest.mark.parametrize("kind", ["sq4", "bf4"])
@pytest.mark.parametrize("H", [768, 384, 128])
def test_serve_bodies_k_order(kind, H):
    """The k order of flat_serve.cu's int4 bodies is one permutation of the dims on both
    operands (the rows' fragments and the query tile), and scores summed in that order equal
    ``_half_products``: exactly for int8 queries (K12 sq4: exact integer sums, also from its
    biased codes less 8 x the query's sum), within fp32 rounding for bf16 ones (K11: fp32 sums
    of each k16 step's exact products, in step order, within 2^-22 of the terms' magnitudes)."""
    rows_k, query_k = _fragment_k_order(H, kind), _query_tile_k_order(H, kind)
    np.testing.assert_array_equal(np.sort(rows_k), np.arange(H))
    np.testing.assert_array_equal(rows_k, query_k)
    _, _, packed, scales = _int4_corpus(44, n=200, h=H)
    codes = tquant.unpack_int4(torch.from_numpy(packed)).numpy().astype(np.float64)
    rng = np.random.default_rng(45)
    if kind == "sq4":
        qi, _ = tquant.quantize_queries(torch.from_numpy(rng.normal(size=(16, H)).astype(
            np.float32)))
        q = qi.numpy().astype(np.int64)
        got = q[:, rows_k] @ codes[:, rows_k].astype(np.int64).T
        want = ttopk._half_products(qi.to(torch.float64), torch.from_numpy(packed)).numpy()
        np.testing.assert_array_equal(got, want)
        # the body's codes are biased (int4_tiles.cuh:biased_nibbles, n + 8 by one AND-XOR of
        # the packed byte): its s32 sums less 8 x each query's sum are the same integers, below
        # 2^22 (the epilogue's exact float conversion)
        b = packed.view(np.uint8).astype(np.int64)
        biased = np.concatenate([(b & 0xF) ^ 8, ((b >> 4) & 0xF) ^ 8], axis=1)
        np.testing.assert_array_equal(biased - 8, codes.astype(np.int64))
        sums = q[:, rows_k] @ biased[:, rows_k].T
        assert np.abs(sums).max() < 2 ** 31
        np.testing.assert_array_equal(sums - 8 * q.sum(1, keepdims=True), want)
        assert np.abs(want).max() < 2 ** 22
    else:
        qb = torch.from_numpy(rng.normal(size=(16, H)).astype(np.float32)).bfloat16()
        q = qb.double().numpy()
        acc = np.zeros((16, codes.shape[0]), np.float32)
        for k0 in range(0, H, 16):  # a k16 step: exact products, one fp32 addition a step
            idx = rows_k[k0:k0 + 16]
            acc = (acc + (q[:, idx] @ codes[:, idx].T).astype(np.float32)).astype(np.float32)
        want = ttopk._half_products(qb.float(), torch.from_numpy(packed)).numpy()
        mag = np.abs(q) @ np.abs(codes).T
        assert (np.abs(acc.astype(np.float64) - want) <= 2.0 ** -22 * np.maximum(mag, 1)).all()
