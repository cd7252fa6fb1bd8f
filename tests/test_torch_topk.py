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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tflat.FlatIPIndex(32, dtype="int8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tflat.FlatIPIndex(32, dtype="int4")
    with pytest.raises(ValueError, match="i8q"):  # the reference contract: i8q needs int rows
        tflat.FlatIPIndex(32, device="cpu").search(np.zeros((1, 32), np.float32), 1, mode="i8q")
    # on CUDA the approximate modes raise instead of silently running exact
    idx = tflat.FlatIPIndex(32, device="cuda")
    for mode in ("serve", "partial", "approx"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            idx.search(np.zeros((1, 32), np.float32), 1, mode=mode)
