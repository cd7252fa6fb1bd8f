"""The port's CUDA kernels vs their plain versions, on the card.

Marked ``cuda``: these skip where ``torch.cuda.is_available()`` is false (a
CUDA kernel has no interpret mode). On a machine with an H100 run them with
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``; ``chip_smoke.py``
makes the same comparisons at the main path's full shapes."""

import pytest
import torch

from denseretrievaltoolkits_torch.index.flat import blockwise_topk
from denseretrievaltoolkits_torch.ops import attn, topk

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled with nvcc and run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0, dtype=torch.float32):
    return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)


# bf16 post-LN outputs: 3e-2 is two bf16 ulps at |y| < 4; fp32: summation order
TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nh", [4, 3])  # H=128 takes the tensor-core projection in bf16
def test_attention_ln_kernel(gen, dtype, nh):
    B, S, hd = 3, 37, 32
    H = nh * hd
    mask = torch.ones(B, S, dtype=torch.int32, device="cuda")
    mask[1, 20:] = 0
    mask[2] = 0  # all-pad row: outputs must stay finite
    args = (_randn(gen, B, S, 3 * H, dtype=dtype), _randn(gen, B, S, H, dtype=dtype), mask,
            _randn(gen, H, H, scale=0.05, dtype=dtype), _randn(gen, H, scale=0.05, dtype=dtype),
            1 + _randn(gen, H, scale=0.1), _randn(gen, H, scale=0.1), 0.2, nh, hd, 1e-12)
    n = attn.fused_attention_ln.launches
    out = attn.fused_attention_ln(*args)
    torch.cuda.synchronize()
    assert attn.fused_attention_ln.launches == n + 1
    ref = attn._reference_attention_ln(*args)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,F", [(128, 320), (96, 600)])  # tensor-core path / CUDA-core path
def test_mlp_ln_kernel(gen, dtype, H, F):
    rows = 50
    x = _randn(gen, 2, rows // 2, H, dtype=dtype)
    args = (x, _randn(gen, H, F, scale=0.05, dtype=dtype), _randn(gen, F, scale=0.05, dtype=dtype),
            _randn(gen, F, H, scale=0.05, dtype=dtype), _randn(gen, H, scale=0.05, dtype=dtype),
            1 + _randn(gen, H, scale=0.1), _randn(gen, H, scale=0.1), 1e-12)
    out = attn.fused_mlp_ln(*args)
    torch.cuda.synchronize()
    ref = attn._reference_mlp_ln(*args)
    assert (out.float() - ref.float()).abs().max() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H", [64, 48])  # bf16 at H % 64 == 0 takes the tensor-core path
def test_block_topj_and_certified_topk(gen, dtype, H):
    c = _randn(gen, 5000, H, dtype=dtype)
    c[700:710] = c[700]  # exact ties inside one block
    q = _randn(gen, 70, H)
    q[0] = c[700].float()
    v, i = topk.block_topj(q.to(dtype), c, 8, 1024, 4990)
    torch.cuda.synchronize()
    rv, ri = topk._block_topj_reference(q.to(dtype), c, 8, 1024, 4990)
    assert torch.equal(i, ri)
    torch.testing.assert_close(v, rv, rtol=1e-5, atol=1e-5)
    s, ids = topk.certified_topk(q, c, 50, block_size=512)
    bs, bids = blockwise_topk(q, c, 50, 512)
    assert torch.equal(ids, bids)
    torch.testing.assert_close(s, bs, rtol=1e-5, atol=1e-5)


def test_unsupported_shape_raises(gen):
    """fp32 at bert-base widths takes S <= 306 (one head's K/V in the CUDA-core
    kernel's shared memory): S=306 runs, and S=307 or 512 is refused with the
    limit named, never run or silently replaced. bf16 takes S=512."""
    nh, hd = 12, 64
    H = nh * hd

    def args(S, dtype=torch.float32):
        return (_randn(gen, 1, S, 3 * H, dtype=dtype), _randn(gen, 1, S, H, dtype=dtype),
                torch.ones(1, S, dtype=torch.int32, device="cuda"),
                _randn(gen, H, H, scale=0.02, dtype=dtype), _randn(gen, H, dtype=dtype),
                _randn(gen, H), _randn(gen, H), 0.125, nh, hd, 1e-12)

    for S, dtype in ((306, torch.float32), (512, torch.bfloat16)):
        a = args(S, dtype)
        out = attn.fused_attention_ln(*a)
        torch.cuda.synchronize()
        assert (out.float() - attn._reference_attention_ln(*a).float()).abs().max() <= TOL[dtype]
    for S in (307, 512):
        with pytest.raises(ValueError, match=r"takes S <= 306 at nh=12, hd=64; got S=" + str(S)):
            attn.fused_attention_ln(*args(S))


# K3/K4: fp32 products in true fp32, so summation order only
@pytest.mark.parametrize("Q,P,H", [(64, 512, 768), (1000, 8000, 64), (37, 111, 48), (5, 10, 4)])
def test_contrastive_kernels(gen, Q, P, H):
    """K3 (lse, target) and K4 (dq, dp with an upstream scalar) vs their plain
    versions, tile-exact and ragged in Q and P (37 x 111: stride 3)."""
    from denseretrievaltoolkits_torch.ops import contrastive as con

    stride = P // Q
    q, p = _randn(gen, Q, H, scale=0.3), _randn(gen, P, H, scale=0.3)
    gout = torch.tensor(1.7, device="cuda")
    n = (con.contrastive_fwd.launches, con.contrastive_bwd_dq.launches,
         con.contrastive_bwd_dp.launches)
    lse, tgt = con.contrastive_fwd(q, p, stride)
    dq = con.contrastive_bwd_dq(q, p, lse, stride, gout)
    dp = con.contrastive_bwd_dp(q, p, lse, stride, gout)
    torch.cuda.synchronize()
    assert (con.contrastive_fwd.launches, con.contrastive_bwd_dq.launches,
            con.contrastive_bwd_dp.launches) == tuple(x + 1 for x in n)
    rlse, rtgt = con._reference_contrastive_fwd(q, p, stride)
    rdq, rdp = con._reference_contrastive_bwd(q, p, rlse, stride, gout)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tgt, rtgt, rtol=1e-5, atol=1e-5)
    for got, want in ((dq, rdq), (dp, rdp)):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_fused_loss_autograd_on_card(gen):
    from denseretrievaltoolkits_torch.ops import contrastive as con
    from denseretrievaltoolkits_torch.train.losses import contrastive_loss

    q = _randn(gen, 48, 128, scale=0.3).requires_grad_(True)
    p = _randn(gen, 384, 128, scale=0.3).requires_grad_(True)
    loss, scores = con.contrastive_loss_auto(q, p)
    assert scores is None
    gq, gp = torch.autograd.grad(loss, (q, p))
    ref, _ = contrastive_loss(q, p)
    rq, rp = torch.autograd.grad(ref, (q, p))
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=0)
    torch.testing.assert_close(gq, rq, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(gp, rp, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_kernel_gradients(gen, dtype):
    """K1/K2 under autograd: the kernel forward with the recompute backward
    gives the plain path's gradients (the backward is the plain recompute, so
    they agree up to the forward's rounding, which they do not depend on)."""
    B, S, nh, hd, F = 2, 24, 4, 32, 320
    H = nh * hd
    mask = torch.ones(B, S, dtype=torch.int32, device="cuda")
    mask[1, 15:] = 0
    k1 = [_randn(gen, B, S, 3 * H, dtype=dtype), _randn(gen, B, S, H, dtype=dtype),
          _randn(gen, H, H, scale=0.05, dtype=dtype), _randn(gen, H, scale=0.05, dtype=dtype),
          1 + _randn(gen, H, scale=0.1), _randn(gen, H, scale=0.1)]
    k2 = [_randn(gen, B, S, H, dtype=dtype), _randn(gen, H, F, scale=0.05, dtype=dtype),
          _randn(gen, F, scale=0.05, dtype=dtype), _randn(gen, F, H, scale=0.05, dtype=dtype),
          _randn(gen, H, scale=0.05, dtype=dtype), 1 + _randn(gen, H, scale=0.1),
          _randn(gen, H, scale=0.1)]
    g = _randn(gen, B, S, H, dtype=dtype)
    for fn, ref, args in (
            (lambda *a: attn.fused_attention_ln(a[0], a[1], mask, *a[2:], 0.2, nh, hd, 1e-12),
             lambda *a: attn._reference_attention_ln(a[0], a[1], mask, *a[2:], 0.2, nh, hd,
                                                     1e-12), k1),
            (lambda *a: attn.fused_mlp_ln(*a, 1e-12), lambda *a: attn._reference_mlp_ln(*a, 1e-12),
             k2)):
        leaves = [a.clone().requires_grad_(True) for a in args]
        got = torch.autograd.grad(fn(*leaves), leaves, g)
        want = torch.autograd.grad(ref(*leaves), leaves, g)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def _int8_rows(gen, N, H):
    """A seeded corpus quantized per row by the plain K7, with a zero row."""
    from denseretrievaltoolkits_torch.ops.quant import _quantize_int8_reference

    x = _randn(gen, N, H)
    x[3] = 0
    return _quantize_int8_reference(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [768, 50])  # vector loads / scalar loads
def test_quantize_int8_kernel(gen, dtype, H):
    """K7 is bit-equal to its plain version: zero rows, exact .5 ties, padding."""
    from denseretrievaltoolkits_torch.ops import quant

    x = _randn(gen, 300, H, scale=3.0)
    x[0] = 0
    x[1, :3] = torch.tensor([127.0, 2.5, -3.5])  # scale 1: 2.5 -> 2, -3.5 -> -4
    x[1, 3:] = 0
    x = x.to(dtype)
    n = quant.quantize_int8_device.launches
    v, s = quant.quantize_int8_device(x, rows=320)
    torch.cuda.synchronize()
    assert quant.quantize_int8_device.launches == n + 1
    rv, rs = quant._quantize_int8_reference(x, rows=320)
    assert torch.equal(v, rv) and torch.equal(s, rs)
    assert v[1, :3].tolist() == [127, 2, -4] and s[0] == 1 and (s[300:] == 1).all()


@pytest.mark.parametrize("H", [64, 48])  # tensor-core path / CUDA-core path
def test_block_topj_int8_kernel(gen, H):
    """K6: int8 rows x bf16 queries x per-row scales, ids equal to the plain version."""
    c, sc = _int8_rows(gen, 3000, H)
    q = _randn(gen, 70, H).to(torch.bfloat16)
    n = topk.block_topj.launches_int8
    v, i = topk.block_topj(q, c, 8, 1024, 2990, sc)
    torch.cuda.synchronize()
    assert topk.block_topj.launches_int8 == n + 1
    rv, ri = topk._block_topj_reference(q, c, 8, 1024, 2990, sc)
    assert torch.equal(i, ri)
    torch.testing.assert_close(v, rv, rtol=1e-5, atol=1e-5)
    s, ids = topk.certified_topk(q.float(), c, 50, block_size=512, scales=sc)
    cs, cids = topk.certified_topk(q.float().cpu(), c.cpu(), 50, block_size=512, scales=sc.cpu())
    assert torch.equal(ids.cpu(), cids)
    torch.testing.assert_close(s.cpu(), cs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("H", [64, 48])
def test_block_topj_serve_kernel(gen, dtype, H):
    """K8 on fp32, bf16 and int8 rows: the plain version's ids, exact scores."""
    if dtype == torch.int8:
        c, sc = _int8_rows(gen, 3000, H)
        q = _randn(gen, 70, H).to(torch.bfloat16)
    else:
        c, sc = _randn(gen, 3000, H, dtype=dtype), None
        c[700:710] = c[700]  # exact ties inside one block
        q = _randn(gen, 70, H).to(dtype)
    n = topk.block_topj_serve.launches
    v, i = topk.block_topj_serve(q, c, 7, 1024, 2990, sc)
    torch.cuda.synchronize()
    assert topk.block_topj_serve.launches == n + 1
    rv, ri = topk._block_topj_serve_reference(q, c, 7, 1024, 2990, sc)
    assert torch.equal(i, ri)
    torch.testing.assert_close(v, rv, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H", [64, 768])
def test_block_topj_i8q_kernel(gen, H):
    """K12: s32 products are exact, so scores and ids equal the plain version's."""
    from denseretrievaltoolkits_torch.ops.quant import quantize_queries

    c, sc = _int8_rows(gen, 3000, H)
    qi, qs = quantize_queries(_randn(gen, 70, H))
    n = topk.block_topj_i8q.launches
    v, i = topk.block_topj_i8q(qi, qs, c, sc, 7, 1024, 2990)
    torch.cuda.synchronize()
    assert topk.block_topj_i8q.launches == n + 1
    rv, ri = topk._block_topj_i8q_reference(qi, qs, c, sc, 7, 1024, 2990)
    assert torch.equal(i, ri) and torch.equal(v, rv)
    with pytest.raises(ValueError, match="H % 64"):
        topk.block_topj_i8q(qi[:, :48].contiguous(), qs, c[:, :48].contiguous(), sc, 7, 1024,
                            2990)


def test_serve_topk_deep_k_runs_the_kernels(gen):
    """k=1000 over 9000 int8 rows: the reference runs its kernel there with J
    up to k; the port halves the block to keep J <= 32 and still launches K8
    and K12, never the exact scan. i8q scores are exact, so its top-k equals
    the plain version's; serve sums bf16 products in another order, so its
    sets agree up to boundary ties (overlap >= 0.999)."""
    c, sc = _int8_rows(gen, 9000, 64)
    q = _randn(gen, 20, 64)
    assert topk.serve_plan(1000, 9000, 9000, 2048) == (64, 22)
    for native, fn in ((False, topk.block_topj_serve), (True, topk.block_topj_i8q)):
        n = fn.launches
        s, ids = topk.serve_topk(q, c, 1000, 2048, scales=sc, i8_native=native)
        torch.cuda.synchronize()
        assert fn.launches == n + 1 and ids.shape == (20, 1000)
        rs, rids = topk.serve_topk(q.cpu(), c.cpu(), 1000, 2048, scales=sc.cpu(),
                                   i8_native=native)
        if native:
            assert torch.equal(ids.cpu(), rids) and torch.equal(s.cpu(), rs)
        else:
            overlap = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids.cpu(), rids))
            assert overlap >= 0.999 * rids.numel()
            torch.testing.assert_close(s.cpu(), rs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_flat_index_modes_on_card(gen, dtype):
    """Every flat mode of a CUDA index against the same index on the CPU
    (the exact scan): exact ids equal; serve / partial / i8q recall."""
    from denseretrievaltoolkits_torch.index.flat import FlatIPIndex

    c = _randn(gen, 20000, 64).cpu().numpy()
    q = _randn(gen, 40, 64).cpu().numpy()
    idx = FlatIPIndex(c, dtype=dtype, block_size=1024)
    ref = FlatIPIndex(c, dtype=dtype, block_size=1024, device="cpu")
    _, want = ref.search(q, 50)
    modes = ("exact", "serve", "i8q") if dtype in ("int8", "int4") else ("exact", "serve", "partial")
    for mode in modes + ("approx",):
        _, got = idx.search(q, 50, mode=mode)
        recall = sum(len(set(a) & set(b)) for a, b in zip(got, want)) / want.size
        assert recall >= (0.99 if mode in ("exact", "serve", "partial") else 0.9), (mode, recall)


# --- int4 rows: K9, K10, K11 and K12's sq4 body ------------------------------------------------

def _int4_rows(gen, N, H):
    """A seeded corpus packed per row by the plain K9, with a zero row."""
    from denseretrievaltoolkits_torch.ops.quant import _quantize_int4_reference

    x = _randn(gen, N, H)
    x[3] = 0
    return _quantize_int4_reference(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [768, 50])  # vector loads (H % 8 == 0) / scalar loads
def test_quantize_int4_kernel(gen, dtype, H):
    """K9 is bit-equal to its plain version: zero rows, exact .5 ties, padding."""
    from denseretrievaltoolkits_torch.ops import quant

    x = _randn(gen, 300, H, scale=3.0)
    x[0] = 0
    x[1] = 0
    x[1, :3] = torch.tensor([7.0, 2.5, -3.5])  # scale 1: 2.5 -> 2, -3.5 -> -4
    x[1, H // 2] = 1.5
    x = x.to(dtype)
    n = quant.quantize_int4_device.launches
    v, s = quant.quantize_int4_device(x, rows=320)
    torch.cuda.synchronize()
    assert quant.quantize_int4_device.launches == n + 1
    rv, rs = quant._quantize_int4_reference(x, rows=320)
    assert v.shape == (320, H // 2) and torch.equal(v, rv) and torch.equal(s, rs)
    codes = quant.unpack_int4(v)
    assert codes[1, :3].tolist() == [7, 2, -4] and codes[1, H // 2] == 2
    assert s[0] == 1 and (s[300:] == 1).all() and (v[300:] == 0).all()


@pytest.mark.parametrize("H", [64, 50])  # float4 / packed-word loads, or scalar loads
def test_block_topj_int4_kernel(gen, H):
    """K10: fp32 queries x int4 rows x per-row scales, true fp32: ids equal to
    the plain version's, scores within 1e-5; the certified search on the card
    equals the one on the CPU."""
    c, sc = _int4_rows(gen, 3000, H)
    c[700:710] = c[700]  # exact ties inside one block
    sc[700:710] = sc[700]
    q = _randn(gen, 70, H)
    n = topk.block_topj.launches_int4
    v, i = topk.block_topj(q, c, 8, 1024, 2990, sc, int4=True)
    torch.cuda.synchronize()
    assert topk.block_topj.launches_int4 == n + 1
    rv, ri = topk._block_topj_reference(q, c, 8, 1024, 2990, sc, int4=True)
    assert torch.equal(i, ri)
    torch.testing.assert_close(v, rv, rtol=1e-5, atol=1e-5)
    s, ids = topk.certified_topk(q, c, 50, block_size=512, scales=sc, int4=True)
    cs, cids = topk.certified_topk(q.cpu(), c.cpu(), 50, block_size=512, scales=sc.cpu(),
                                   int4=True)
    assert torch.equal(ids.cpu(), cids)
    torch.testing.assert_close(s.cpu(), cs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H", [64, 48])  # tensor-core path / CUDA-core path
def test_block_topj_serve_int4_kernel(gen, H):
    """K11: bf16 queries x int4 rows: the plain version's ids, exact scores."""
    c, sc = _int4_rows(gen, 3000, H)
    q = _randn(gen, 70, H).to(torch.bfloat16)
    n = topk.block_topj_serve.launches_int4
    v, i = topk.block_topj_serve(q, c, 7, 1024, 2990, sc, int4=True)
    torch.cuda.synchronize()
    assert topk.block_topj_serve.launches_int4 == n + 1
    rv, ri = topk._block_topj_serve_reference(q, c, 7, 1024, 2990, sc, int4=True)
    assert torch.equal(i, ri)
    torch.testing.assert_close(v, rv, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H", [64, 768])
def test_block_topj_i8q_int4_kernel(gen, H):
    """K12's sq4 body: s32 products are exact, so scores and ids equal the
    plain version's bit for bit."""
    from denseretrievaltoolkits_torch.ops.quant import quantize_queries

    c, sc = _int4_rows(gen, 3000, H)
    qi, qs = quantize_queries(_randn(gen, 70, H))
    n = topk.block_topj_i8q.launches_int4
    v, i = topk.block_topj_i8q(qi, qs, c, sc, 7, 1024, 2990, int4=True)
    torch.cuda.synchronize()
    assert topk.block_topj_i8q.launches_int4 == n + 1
    rv, ri = topk._block_topj_i8q_reference(qi, qs, c, sc, 7, 1024, 2990, int4=True)
    assert torch.equal(i, ri) and torch.equal(v, rv)
    with pytest.raises(ValueError, match="H % 64"):
        topk.block_topj_i8q(qi[:, :48].contiguous(), qs, c[:, :24].contiguous(), sc, 7, 1024,
                            2990, int4=True)


def test_serve_topk_int4_deep_k_runs_the_kernels(gen):
    """k=1000 over 9000 int4 rows: block 64, J=22; K11 and K12's sq4 body
    launch, never the exact scan. i8q equals the plain version; serve agrees
    up to boundary ties (overlap >= 0.999)."""
    c, sc = _int4_rows(gen, 9000, 64)
    q = _randn(gen, 20, 64)
    for native, fn in ((False, topk.block_topj_serve), (True, topk.block_topj_i8q)):
        n = fn.launches_int4
        s, ids = topk.serve_topk(q, c, 1000, 2048, scales=sc, i8_native=native, int4=True)
        torch.cuda.synchronize()
        assert fn.launches_int4 == n + 1 and ids.shape == (20, 1000)
        rs, rids = topk.serve_topk(q.cpu(), c.cpu(), 1000, 2048, scales=sc.cpu(),
                                   i8_native=native, int4=True)
        if native:
            assert torch.equal(ids.cpu(), rids) and torch.equal(s.cpu(), rs)
        else:
            overlap = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids.cpu(), rids))
            assert overlap >= 0.999 * rids.numel()
            torch.testing.assert_close(s.cpu(), rs, rtol=1e-5, atol=1e-5)
