"""The port's CUDA kernels vs their plain versions, on the card.

Marked ``cuda``: these skip where ``torch.cuda.is_available()`` is false (a
CUDA kernel has no interpret mode). On a machine with an H100 run them with
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``; ``chip_smoke.py``
makes the same comparisons at the main path's full shapes."""

import numpy as np
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


def _bf16_ulp(t):
    """The spacing of bfloat16 numbers at |t|: 2^(e - 8) for |t| in [2^(e-1), 2^e)."""
    _, e = torch.frexp(t.float().abs())
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)


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


def _cuda_kernel_names(fn):
    """``fn()`` and the names of the CUDA kernels it launched (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, {e.name for e in prof.events() if str(e.device_type).endswith("CUDA")}


def _k1_bf16_args(gen, B, S, nh, hd, x_offset=0):
    """K1's bf16 arguments: lengths in [1, S] with the first sequence full and the
    last all padding; x ``x_offset`` elements past 16-byte alignment."""
    H = nh * hd
    lens = torch.randint(1, S + 1, (B,), generator=gen, device="cuda")
    lens[0] = S
    mask = (torch.arange(S, device="cuda")[None] < lens[:, None]).to(torch.int32)
    mask[-1] = 0
    x = _randn(gen, B * S * H + x_offset, dtype=torch.bfloat16)[x_offset:].view(B, S, H)
    return (_randn(gen, B, S, 3 * H, dtype=torch.bfloat16), x, mask,
            _randn(gen, H, H, scale=0.05, dtype=torch.bfloat16),
            _randn(gen, H, scale=0.05, dtype=torch.bfloat16), 1 + _randn(gen, H, scale=0.1),
            _randn(gen, H, scale=0.1), hd ** -0.5, nh, hd, 1e-12)


# K1 bf16's bounds (chip_smoke.py's phase 2): max abs TOL, mean abs 1e-4
K1_MEAN_TOL = 1e-4


@pytest.mark.parametrize("S", [1, 32, 37, 128, 156, 256, 257])
@pytest.mark.parametrize("H", [128, 768])
def test_attention_ln_wgmma_kernel(gen, H, S):
    """K1 bf16 at hd 64: the Hopper body (``attn_ln_stage_a``, then
    ``attn_ln_stage_b``) wherever ``attn_ln_plan`` gives a plan, S <= 256, and
    the mma.sync body past it (S = 257); one count a call, finite outputs, and
    the plain version's values within TOL (max) and K1_MEAN_TOL (mean), pad
    rows and the all-pad sequence included."""
    nh, hd, B = H // 64, 64, 3
    args = _k1_bf16_args(gen, B, S, nh, hd)
    hopper = attn.attn_ln_plan(B, S, H, nh, hd) is not None
    assert hopper == (S <= 256)
    n = attn.fused_attention_ln.launches
    out, names = _cuda_kernel_names(lambda: attn.fused_attention_ln(*args))
    assert attn.fused_attention_ln.launches == n + 1
    ran = {k for k in ("attn_ln_stage_a", "attn_ln_stage_b", "attn_ln_mma_kernel")
           if any(k in name for name in names)}
    assert ran == ({"attn_ln_stage_a", "attn_ln_stage_b"} if hopper else {"attn_ln_mma_kernel"})
    ref = attn._reference_attention_ln(*args)
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs()
    assert err.max() <= TOL[torch.bfloat16] and err.mean() <= K1_MEAN_TOL, (
        float(err.max()), float(err.mean()))


@pytest.mark.parametrize("S", [37, 200])
def test_attention_ln_wgmma_kernel_hd128(gen, S):
    """K1 bf16 at hd 128 (H 768, 6 heads) also takes the Hopper body, within the
    same bounds."""
    B, nh, hd = 3, 6, 128
    args = _k1_bf16_args(gen, B, S, nh, hd)
    out, names = _cuda_kernel_names(lambda: attn.fused_attention_ln(*args))
    assert any("attn_ln_stage_a" in name for name in names)
    err = (out.float() - attn._reference_attention_ln(*args).float()).abs()
    assert torch.isfinite(out).all()
    assert err.max() <= TOL[torch.bfloat16] and err.mean() <= K1_MEAN_TOL, (
        float(err.max()), float(err.mean()))


def test_attention_ln_unaligned_x_takes_the_mma_body(gen):
    """An x 2 bytes past 16-byte alignment (TMA cannot read it) sends K1 bf16 at
    the serving path's widths to the mma.sync body, which agrees all the same."""
    B, S, nh, hd = 3, 156, 12, 64
    args = _k1_bf16_args(gen, B, S, nh, hd, x_offset=1)
    assert args[1].data_ptr() % 16 != 0
    assert attn.attn_ln_plan(B, S, nh * hd, nh, hd, aligned=False) is None
    out, names = _cuda_kernel_names(lambda: attn.fused_attention_ln(*args))
    assert any("attn_ln_mma_kernel" in name for name in names)
    assert not any("attn_ln_stage" in name for name in names)
    err = (out.float() - attn._reference_attention_ln(*args).float()).abs()
    assert torch.isfinite(out).all()
    assert err.max() <= TOL[torch.bfloat16] and err.mean() <= K1_MEAN_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,F,rows,offset", [
    (128, 320, 50, 0),     # bf16: the wgmma body, one 128-column CTA in stage B, F % 256 != 0
    (96, 600, 50, 0),      # odd width: the CUDA-core body
    (768, 3072, 1, 0),     # bert-base widths: clusters of three CTAs in stage B
    (768, 3072, 50, 0),
    (768, 3072, 2048 + 17, 0),  # a ragged last row tile, 128-row tiles in stage A
    (768, 3072, 9984, 0),  # the serving path's B=64, S=156
    (128, 320, 2048 + 17, 0),
    (1024, 4096, 300, 0),  # clusters of four
    (768, 3072, 50, 1),    # x 2 bytes past 16-byte alignment: TMA cannot read it
])
def test_mlp_ln_kernel(gen, dtype, H, F, rows, offset):
    """K2 vs its plain version: the wgmma body (bf16, H in 64 * {2,4,8,12,16},
    F % 64 == 0, 16-byte aligned operands) or the CUDA-core body; one count a call.
    A bf16 output is held to TOL or to one bf16 ulp of the plain version's, the
    larger: the same bound as TOL alone below |y| = 4, where TOL is two ulps; at
    thousands of rows some outputs pass 4, where one ulp (2^-5) exceeds TOL, and
    two fp32 sums that differ in their last bits may round to neighbouring bf16
    numbers there."""
    x = _randn(gen, rows * H + offset, dtype=dtype)[offset:].view(1, rows, H)
    args = (x, _randn(gen, H, F, scale=0.05, dtype=dtype), _randn(gen, F, scale=0.05, dtype=dtype),
            _randn(gen, F, H, scale=0.05, dtype=dtype), _randn(gen, H, scale=0.05, dtype=dtype),
            1 + _randn(gen, H, scale=0.1), _randn(gen, H, scale=0.1), 1e-12)
    n = attn.fused_mlp_ln.launches
    out = attn.fused_mlp_ln(*args)
    torch.cuda.synchronize()
    assert attn.fused_mlp_ln.launches == n + 1
    ref = attn._reference_mlp_ln(*args)
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs()
    bound = _bf16_ulp(ref).clamp(min=TOL[dtype]) if dtype == torch.bfloat16 else TOL[dtype]
    assert (err <= bound).all(), err.max().item()


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("J", [1, 8, 32])
@pytest.mark.parametrize("H", [768, 128, 64])  # 12, 2 and 1 k-slices of 64 dims
def test_block_topj_flat_wgmma_kernel(gen, dtype, H, J):
    """K5's wgmma bodies (fp32: ``flat_certified.cu``, products as fp16 pairs;
    bf16: ``flat_serve.cu``, TMA + wgmma in the certified order): ids equal to
    the plain version's, scores within 1e-5,
    over 1000-row blocks (not a multiple of the 64-row tile) with n_valid inside
    the last, exact ties inside a block, a zero row, rows and queries of other
    magnitudes (each row slice and query takes its own scale), an all-zero query
    (every score +0, ids ascending) and a query tile cut short (70 queries);
    ``launches_generic`` stays; the certified search on the card equals the one
    on the CPU."""
    c = _randn(gen, 5000, H, dtype=dtype)
    c[700:710] = c[700]  # exact ties inside one block
    c[3] = 0
    c[1500:1600] *= 1e-3
    c[2500:2600] *= 1e3
    c[3500:3600, : H // 2] *= 8.0  # another scale in every row's first slices
    q = _randn(gen, 70, H, scale=3.0)
    q[5] = 0
    q[6] *= 1e-4
    qc = q.to(dtype)
    n, n_gen = topk.block_topj.launches, topk.block_topj.launches_generic
    v, i = topk.block_topj(qc, c, J, 1000, 4990)
    torch.cuda.synchronize()
    assert topk.block_topj.last_body == (
        "flat_certified" if dtype == torch.float32 else "flat_serve")
    assert (topk.block_topj.launches, topk.block_topj.launches_generic) == (n + 1, n_gen)
    rv, ri = topk._block_topj_reference(qc, c, J, 1000, 4990)
    torch.testing.assert_close(v, rv, rtol=1e-5, atol=1e-5)
    # ids equal to the plain version's but inside near ties: where they differ, both ids
    # score the same in fp64 within 1e-5 of the terms' magnitudes (cuBLAS may order the
    # exactly tied rows 700-709 by rounding)
    qi, blk, j = torch.nonzero(i != ri, as_tuple=True)
    if qi.numel():
        qd = qc.double()[qi]
        got = (qd * c.double()[i[qi, blk, j].long()]).sum(1)
        want = (qd * c.double()[ri[qi, blk, j].long()]).sum(1)
        mag = (qd.abs() * c.double()[ri[qi, blk, j].long()].abs()).sum(1)
        assert bool(((got - want).abs() <= 1e-5 * mag).all()), (qi, blk, j, got, want)
    assert bool((v[5] == 0).all()) and not bool(torch.signbit(v[5]).any())
    assert bool((i[5] == torch.arange(J, device="cuda") + 1000 * torch.arange(
        5, device="cuda")[:, None]).all())
    s, ids = topk.certified_topk(q, c, 50, block_size=512)
    cs, cids = topk.certified_topk(q.cpu(), c.cpu(), 50, block_size=512)
    assert torch.equal(ids.cpu(), cids)
    # scores within 1e-5 of their terms' magnitudes: the rows scaled by 1e3 score in the
    # 1e5s, where the two fp32 searches' sums part by more than 1e-5 of a cancelled score
    mag = torch.einsum("qd,qkd->qk", q.to(dtype).double().abs(), c[ids.long()].double().abs())
    assert bool(((s.double() - cs.to(s.device).double()).abs()
                 <= 1e-5 * mag.clamp(min=1.0)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,offset", [(48, 0), (768, 2)])  # 2 elements: off 16-byte alignment
def test_block_topj_flat_generic_body(gen, dtype, H, offset):
    """K5 at the shapes its Hopper bodies do not take (H % 64 != 0, or rows
    off 16-byte alignment) runs ``block_topj.cu``'s bodies, counted on
    ``launches_generic`` too: the plain version's ids, scores within 1e-5."""
    c = _randn(gen, 3000, H, dtype=dtype)
    if offset:
        buf = torch.empty(c.numel() + offset, dtype=dtype, device="cuda")
        moved = buf[offset:].view(c.shape)
        moved.copy_(c)
        c = moved
    q = _randn(gen, 70, H).to(dtype)
    n, n_gen = topk.block_topj.launches, topk.block_topj.launches_generic
    v, i = topk.block_topj(q, c, 8, 1024, 2990)
    torch.cuda.synchronize()
    assert topk.block_topj.last_body == "block_topj"
    assert (topk.block_topj.launches, topk.block_topj.launches_generic) == (n + 1, n_gen + 1)
    rv, ri = topk._block_topj_reference(q, c, 8, 1024, 2990)
    assert torch.equal(i, ri)
    torch.testing.assert_close(v, rv, rtol=1e-5, atol=1e-5)


def test_unsupported_shape_raises(gen):
    """K1's CUDA-core path keeps one head's K/V in shared memory where it fits
    and streams it over S above that, so fp32 at bert-base widths takes S=306
    (resident), 307 and 512 (streamed; it took S <= 306 before); bf16 takes
    S=512 on the tensor-core path, S=512 at the odd width H=384 on the resident
    CUDA-core body, and S=600 on the streamed one. A width the kernel does not
    take is refused, never run or silently replaced."""
    def args(S, dtype=torch.float32, nh=12, hd=64):
        H = nh * hd
        return (_randn(gen, 1, S, 3 * H, dtype=dtype), _randn(gen, 1, S, H, dtype=dtype),
                torch.ones(1, S, dtype=torch.int32, device="cuda"),
                _randn(gen, H, H, scale=0.02, dtype=dtype), _randn(gen, H, dtype=dtype),
                _randn(gen, H), _randn(gen, H), 0.125, nh, hd, 1e-12)

    errors = {}
    for S, dtype, nh in ((306, torch.float32, 12), (307, torch.float32, 12),
                         (512, torch.float32, 12), (512, torch.bfloat16, 12),
                         (512, torch.bfloat16, 6)):
        a = args(S, dtype, nh=nh)
        out = attn.fused_attention_ln(*a)
        torch.cuda.synchronize()
        errors[S, dtype, nh] = (out.float() - attn._reference_attention_ln(*a).float()).abs().max()
    assert all(err <= TOL[dtype] for (_, dtype, _), err in errors.items()), errors
    # bf16 past the tensor-core path's shared memory: the streamed body rounds
    # exp(s - m) where the plain version rounds the normalized probabilities, so
    # outputs agree within two bf16 ulps of each value (of 1 below 1)
    a = args(600, torch.bfloat16)
    out = attn.fused_attention_ln(*a).float()
    ref = attn._reference_attention_ln(*a).float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1.0))) - 7)
    assert bool(((out - ref).abs() <= 2 * ulp).all()), float(((out - ref).abs() / ulp).max())
    with pytest.raises(ValueError, match="H <= 1024"):
        attn.fused_attention_ln(*args(8, nh=17))


def _flash_case(gen, B, S, nh, hd, dtype, kind="ragged"):
    """q, k, v as views of one [B,S,3H] tensor and a mask: "ragged" (pad rows, the
    last sequence all padding), "runs40" (segments alternating in runs of 40 rows,
    0 first in the first sequence and 1 first in the others: no prefix) or "all_pad"."""
    from denseretrievaltoolkits_torch.ops.flash import split_qkv

    qkv = _randn(gen, B, S, 3 * nh * hd, dtype=dtype)
    views = split_qkv(qkv, nh, hd)
    rows = torch.arange(S, device="cuda")
    if kind == "runs40":
        mask = ((rows // 40) % 2).to(torch.int32)[None].repeat(B, 1)
        mask[1:] = 1 - mask[1:]
    elif kind == "all_pad":
        mask = torch.zeros(B, S, dtype=torch.int32, device="cuda")
    else:
        lens = torch.randint(1, S + 1, (B,), generator=gen, device="cuda")
        lens[0] = S
        mask = (rows[None] < lens[:, None]).to(torch.int32)
        mask[-1] = 0
    return qkv, views, mask


def _within(got, want, rel, scale=None):
    """|got - want| <= rel * max|scale| (scale: want by default) over every element."""
    got, want = got.detach().float(), want.detach().float()
    err = (got - want).abs().max()
    ref = want if scale is None else scale.detach().float()
    return bool(err <= rel * ref.abs().max()), float(err)


def _grad_scale(name, S, rdv):
    """What a gradient's error is measured against: itself, but at S = 1, where
    every row sees one key, dq and dk vanish in exact arithmetic (P = 1, so dS =
    dP - D = 0) and both sides hold rounding alone: dv's (= dO's) scale there."""
    return rdv if S == 1 and name != "dv" else None


# The flash kernels vs their plain versions, which share their semantics on every
# row (pad rows too). fp32: summation order. bf16: outputs within two bf16 ulps at
# their largest value (2^-6 of it): the kernel rounds exp(s - m) where the plain
# forward rounds the normalized probabilities, and P, dS differ by rounding flips.
FLASH_REL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}
# D = rowsum(dO * O), which the dQ kernel computes in fp32, vs the plain formula: the
# summation order alone
D_REL = 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [37, 200, 512, 1, 64, 65, 513])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_kernels(gen, dtype, S, hd):
    """Forward (o and lse) and both backward kernels vs their plain versions on
    odd S, with pad rows and an all-pad sequence; the dQ kernel's D vs the plain
    formula; each launches once. bf16 hd 64 and 128 take the wgmma bodies, hd 32
    the mma.sync ones."""
    from denseretrievaltoolkits_torch.ops import flash

    B, nh = 3, 2
    _, (q, k, v), mask = _flash_case(gen, B, S, nh, hd, dtype)
    scale = hd ** -0.5
    n = (flash.flash_fwd.launches, flash.flash_bwd_dkv.launches, flash.flash_bwd_dq.launches)
    o, lse = flash.flash_fwd(q, k, v, mask, scale)
    torch.cuda.synchronize()
    ro, rlse = flash._reference_flash_fwd(q, k, v, mask, scale)
    assert torch.isfinite(o).all()
    assert _within(o, ro, FLASH_REL[dtype])[0]
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    do = _randn(gen, B, S, nh, hd, dtype=dtype)
    dqkv = torch.empty(B, S, 3, nh, hd, dtype=dtype, device="cuda")
    D = flash.flash_bwd_dq(q, k, v, mask, rlse, do, ro, scale, dqkv)
    flash.flash_bwd_dkv(q, k, v, mask, rlse, do, D, scale, dqkv)
    torch.cuda.synchronize()
    ok, err = _within(D, flash._reference_flash_d(ro, do), D_REL)
    assert ok, ("D", err)
    D = flash._reference_flash_d(ro, do)
    dq, dk, dv = dqkv.unbind(2)
    rdk, rdv = flash._reference_flash_bwd_dkv(q, k, v, mask, rlse, do, D, scale)
    rdq = flash._reference_flash_bwd_dq(q, k, v, mask, rlse, do, D, scale)
    for name, got, want in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        ok, err = _within(got, want, FLASH_REL[dtype], _grad_scale(name, S, rdv))
        assert ok, (name, err)
    assert (flash.flash_fwd.launches, flash.flash_bwd_dkv.launches,
            flash.flash_bwd_dq.launches) == tuple(x + 1 for x in n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_on_card(gen, dtype):
    """flash_attention_qkv under autograd vs autograd through the plain version
    on qkv's views: values as above; qkv's gradient within 1e-4 (fp32) or 3e-2
    (bf16) of its largest entry (autograd through the plain version rounds dP
    to bf16, the kernels round dS)."""
    from denseretrievaltoolkits_torch.ops import flash

    B, S, nh, hd = 4, 300, 12, 64
    qkv, _, mask = _flash_case(gen, B, S, nh, hd, dtype)
    g = _randn(gen, B, S, nh, hd, dtype=dtype) * mask[:, :, None, None].to(dtype)
    grads = []
    plain = lambda t, m, nh, hd: flash._reference_flash_attention(  # noqa: E731
        *flash.split_qkv(t, nh, hd), m, hd)
    for fn in (flash.flash_attention_qkv, plain):
        leaf = qkv.clone().requires_grad_(True)
        out = fn(leaf, mask, nh, hd)
        out.backward(g)
        grads.append((out.detach(), leaf.grad))
    assert _within(grads[0][0], grads[1][0], FLASH_REL[dtype])[0]
    ok, err = _within(grads[0][1], grads[1][1], 1e-4 if dtype == torch.float32 else 3e-2)
    assert ok, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [37, 156, 512, 1, 64, 65, 513])
def test_fused_qkv_attention_kernel(gen, dtype, S):
    """K18 (the flash forward in bias mode) vs ``_reference_attention`` on every
    row, all-pad sequence included; the recompute backward equals the plain one."""
    B, nh, hd = 3, 12, 64
    qkv, _, mask = _flash_case(gen, B, S, nh, hd, dtype)
    n = attn.fused_qkv_attention.launches
    leaf = qkv.clone().requires_grad_(True)
    out = attn.fused_qkv_attention(leaf, mask, hd ** -0.5, nh, hd)
    torch.cuda.synchronize()
    assert attn.fused_qkv_attention.launches == n + 1
    ref_leaf = qkv.clone().requires_grad_(True)
    ref = attn._reference_attention(ref_leaf, mask, hd ** -0.5, nh, hd)
    assert torch.isfinite(out).all()
    assert _within(out, ref, FLASH_REL[dtype])[0]
    g = _randn(gen, *out.shape, dtype=dtype)
    out.backward(g)
    ref.backward(g)
    torch.testing.assert_close(leaf.grad, ref_leaf.grad, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 64, 65, 513])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("kind", ["runs40", "all_pad"])
def test_flash_forward_on_other_masks(gen, dtype, S, hd, kind):
    """The forward in both modes on masks that are no prefix (runs of 40: key tiles
    skipped in the middle of a sequence) and with every sequence all padding (bias
    mode: every key -1e9, nothing skipped): F-fwd's o and lse vs
    ``_reference_flash_fwd``, K18 vs ``_reference_attention``; the backward
    kernels on the forward kernel's own o and lse vs their plain versions (tiles
    skipped in the middle of a sequence there too), and the dQ kernel's D."""
    from denseretrievaltoolkits_torch.ops import flash

    B, nh = 3, 2
    qkv, (q, k, v), mask = _flash_case(gen, B, S, nh, hd, dtype, kind)
    scale = hd ** -0.5
    o, lse = flash.flash_fwd(q, k, v, mask, scale)
    out = attn.fused_qkv_attention(qkv, mask, scale, nh, hd)
    torch.cuda.synchronize()
    ro, rlse = flash._reference_flash_fwd(q, k, v, mask, scale)
    assert torch.isfinite(o).all() and torch.isfinite(out).all()
    assert _within(o, ro, FLASH_REL[dtype])[0]
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    assert _within(out, attn._reference_attention(qkv, mask, scale, nh, hd), FLASH_REL[dtype])[0]
    do = _randn(gen, B, S, nh, hd, dtype=dtype)
    dqkv = torch.empty(B, S, 3, nh, hd, dtype=dtype, device="cuda")
    D = flash.flash_bwd_dq(q, k, v, mask, lse, do, o, scale, dqkv)
    flash.flash_bwd_dkv(q, k, v, mask, lse, do, D, scale, dqkv)
    torch.cuda.synchronize()
    ok, err = _within(D, flash._reference_flash_d(o, do), D_REL)
    assert ok, ("D", err)
    D = flash._reference_flash_d(o, do)
    rdk, rdv = flash._reference_flash_bwd_dkv(q, k, v, mask, lse, do, D, scale)
    rdq = flash._reference_flash_bwd_dq(q, k, v, mask, lse, do, D, scale)
    for name, got, want in zip(("dq", "dk", "dv"), dqkv.unbind(2), (rdq, rdk, rdv)):
        ok, err = _within(got, want, FLASH_REL[dtype], _grad_scale(name, S, rdv))
        assert ok, (name, err)


def test_flash_refuses_what_it_cannot_run(gen):
    """Head dims the kernels do not take, mixed devices and q/k/v that do not
    share strides raise; nothing runs the plain version instead."""
    from denseretrievaltoolkits_torch.ops import flash

    def case(hd, dtype, nh=2):
        return _flash_case(gen, 2, 40, nh, hd, dtype)

    for hd, dtype in ((24, torch.bfloat16), (12, torch.float32), (144, torch.float32)):
        _, (q, k, v), mask = case(hd, dtype)
        with pytest.raises(ValueError, match="head dim"):
            flash.flash_attention(q, k, v, mask, hd)
    _, (q, k, v), mask = case(32, torch.bfloat16)
    with pytest.raises(ValueError, match="every operand must be on"):
        flash.flash_attention(q, k, v, mask.cpu(), 32)
    with pytest.raises(ValueError, match="share strides"):
        flash.flash_fwd(q, k.contiguous(), v, mask, 32 ** -0.5)
    with pytest.raises(ValueError, match="every operand must be on"):
        attn.fused_qkv_attention(torch.cat([q, k, v], -1).flatten(2).contiguous(), mask.cpu(),
                                 0.125, 2, 32)


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


@pytest.mark.parametrize("Q,P", [(32, 256), (64, 512), (100, 700), (5, 10), (1000, 8000)])
def test_contrastive_bwd_wgmma_kernel(gen, Q, P):
    """K4's tensor-core body (H = 768, fp16 pairs, a cluster of four CTAs a
    64-row tile): dq and dp within 2e-5 of max|grad| of the plain versions
    (``chip_smoke.py``'s bound), ragged Q and P, the training path's Q=32,
    P=256; ``launches_generic`` stays; a second call repeats bit for bit."""
    from denseretrievaltoolkits_torch.ops import contrastive as con

    stride = P // Q
    q, p = _randn(gen, Q, 768, scale=0.3), _randn(gen, P, 768, scale=0.3)
    gout = torch.tensor(1.7, device="cuda")
    lse, _ = con._reference_contrastive_fwd(q, p, stride)
    n_gen = (con.contrastive_bwd_dq.launches_generic, con.contrastive_bwd_dp.launches_generic)
    dq = con.contrastive_bwd_dq(q, p, lse, stride, gout)
    dp = con.contrastive_bwd_dp(q, p, lse, stride, gout)
    torch.cuda.synchronize()
    assert con.contrastive_bwd_dq.last_body == con.contrastive_bwd_dp.last_body == "wgmma"
    assert (con.contrastive_bwd_dq.launches_generic,
            con.contrastive_bwd_dp.launches_generic) == n_gen
    rdq, rdp = con._reference_contrastive_bwd(q, p, lse, stride, gout)
    for got, want in ((dq, rdq), (dp, rdp)):
        assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())
    assert torch.equal(con.contrastive_bwd_dq(q, p, lse, stride, gout), dq)
    assert torch.equal(con.contrastive_bwd_dp(q, p, lse, stride, gout), dp)


def _ffma_fwd(q, p, stride):
    """K3's FFMA body (``contrastive_fwd_kernel``) on the same inputs: its C entry given no
    scratch, which the tensor-core body needs."""
    import ctypes

    from denseretrievaltoolkits_torch.ops import _native

    lse = torch.empty(q.shape[0], device="cuda")
    tgt = torch.empty_like(lse)
    body = ctypes.c_int(-1)
    _native.check(_native.library().drt_contrastive_fwd(
        q.data_ptr(), p.data_ptr(), lse.data_ptr(), tgt.data_ptr(), q.shape[0], p.shape[0],
        q.shape[1], stride, 0, ctypes.byref(body), _native.stream_ptr(q)), "drt_contrastive_fwd")
    assert body.value == 0
    return lse, tgt


@pytest.mark.parametrize("Q,P,H", [(32, 256, 768), (64, 512, 768), (100, 700, 768), (5, 10, 768),
                                   (1000, 8000, 768), (64, 512, 256), (64, 512, 1024)])
def test_contrastive_fwd_wgmma_kernel(gen, Q, P, H):
    """K3's tensor-core body (H % 64 == 0, fp16 pairs, 128-row query tiles, the passage axis
    split across CTAs): lse and tgt within the reference's 1e-5 of the plain version, ragged
    Q and P, the training path's Q=32, P=256; the error against fp64 at most 2x the FFMA
    body's on the same inputs (or one fp32 ulp of the largest value, where both round alike);
    ``launches_generic`` stays; a second call repeats bit for bit."""
    from denseretrievaltoolkits_torch.ops import contrastive as con

    stride = P // Q
    q, p = _randn(gen, Q, H, scale=0.3), _randn(gen, P, H, scale=0.3)
    n_gen = con.contrastive_fwd.launches_generic
    lse, tgt = con.contrastive_fwd(q, p, stride)
    torch.cuda.synchronize()
    assert con.contrastive_fwd.last_body == "wgmma"
    assert con.contrastive_fwd.launches_generic == n_gen
    rlse, rtgt = con._reference_contrastive_fwd(q, p, stride)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tgt, rtgt, rtol=1e-5, atol=1e-5)
    sd = q.double() @ p.double().T
    rows = torch.arange(Q, device="cuda")
    exact = (torch.logsumexp(sd, 1), sd[rows, rows * stride])
    for got, ffma, want in zip((lse, tgt), _ffma_fwd(q, p, stride), exact):
        floor = 2.0 ** -23 * float(want.abs().max())
        err, ffma_err = (float((x.double() - want).abs().max()) for x in (got, ffma))
        assert err <= max(2 * ffma_err, floor), (err, ffma_err)
    again = con.contrastive_fwd(q, p, stride)
    assert torch.equal(again[0], lse) and torch.equal(again[1], tgt)


def test_contrastive_fwd_generic_body(gen):
    """K3 at a width the tensor-core body does not take (H % 64 != 0) runs the FFMA body,
    counted on ``launches_generic`` too, within 1e-5 of the plain version."""
    from denseretrievaltoolkits_torch.ops import contrastive as con

    Q, P, H = 40, 160, 48
    q, p = _randn(gen, Q, H, scale=0.3), _randn(gen, P, H, scale=0.3)
    n = con.contrastive_fwd.launches_generic
    lse, tgt = con.contrastive_fwd(q, p, 4)
    torch.cuda.synchronize()
    assert con.contrastive_fwd.last_body == "ffma"
    assert con.contrastive_fwd.launches_generic == n + 1
    rlse, rtgt = con._reference_contrastive_fwd(q, p, 4)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tgt, rtgt, rtol=1e-5, atol=1e-5)


def test_contrastive_bwd_generic_body(gen):
    """K4 at a width the tensor-core body does not take (H != 768) runs the FFMA
    body, counted on ``launches_generic`` too, within 1e-5 of max|grad|."""
    from denseretrievaltoolkits_torch.ops import contrastive as con

    Q, P, H = 40, 160, 128
    q, p = _randn(gen, Q, H, scale=0.3), _randn(gen, P, H, scale=0.3)
    gout = torch.tensor(1.0, device="cuda")
    lse, _ = con._reference_contrastive_fwd(q, p, 4)
    n = (con.contrastive_bwd_dq.launches_generic, con.contrastive_bwd_dp.launches_generic)
    dq = con.contrastive_bwd_dq(q, p, lse, 4, gout)
    dp = con.contrastive_bwd_dp(q, p, lse, 4, gout)
    torch.cuda.synchronize()
    assert con.contrastive_bwd_dq.last_body == con.contrastive_bwd_dp.last_body == "ffma"
    assert (con.contrastive_bwd_dq.launches_generic,
            con.contrastive_bwd_dp.launches_generic) == (n[0] + 1, n[1] + 1)
    rdq, rdp = con._reference_contrastive_bwd(q, p, lse, 4, gout)
    for got, want in ((dq, rdq), (dp, rdp)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


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


@pytest.mark.parametrize("J", [8, 32])
@pytest.mark.parametrize("H", [768, 384, 256, 128])  # 6, 3, 2 and 1 k-slices of 128 dims
def test_block_topj_int4_wgmma_kernel(gen, H, J):
    """K10's s8 wgmma body with exact query digits (``int4_certified.cu``): ids
    equal to the plain version's, scores within 1e-5, over 1000-row blocks (not a
    multiple of the 128-row tile) with n_valid inside the last, exact ties inside
    a block, a zero row, an all-zero query (every score +0, ids ascending) and a
    query tile cut short (70 queries); ``launches_int4_generic`` stays; the
    certified search on the card equals the one on the CPU."""
    c, sc = _int4_rows(gen, 5000, H)  # row 3 is zero
    c[700:710] = c[700]  # exact ties inside one block
    sc[700:710] = sc[700]
    q = _randn(gen, 70, H, scale=3.0)
    q[5] = 0
    q[6] *= 1e-4  # small and large queries: each takes its own step
    n, n_gen = topk.block_topj.launches_int4, topk.block_topj.launches_int4_generic
    v, i = topk.block_topj(q, c, J, 1000, 4990, sc, int4=True)
    torch.cuda.synchronize()
    assert topk.block_topj.launches_int4 == n + 1
    assert topk.block_topj.launches_int4_generic == n_gen
    rv, ri = topk._block_topj_reference(q, c, J, 1000, 4990, sc, int4=True)
    assert torch.equal(i, ri)
    torch.testing.assert_close(v, rv, rtol=1e-5, atol=1e-5)
    assert bool((v[5] == 0).all()) and not bool(torch.signbit(v[5]).any())
    assert bool((i[5] == torch.arange(J, device="cuda") + 1000 * torch.arange(
        5, device="cuda")[:, None]).all())
    s, ids = topk.certified_topk(q, c, 50, block_size=512, scales=sc, int4=True)
    cs, cids = topk.certified_topk(q.cpu(), c.cpu(), 50, block_size=512, scales=sc.cpu(),
                                   int4=True)
    assert torch.equal(ids.cpu(), cids)
    torch.testing.assert_close(s.cpu(), cs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H,offset", [(64, 0), (50, 0), (768, 4)])
def test_block_topj_int4_generic_body(gen, H, offset):
    """K10 at the shapes ``int4_certified.cu`` does not take (H % 128 != 0, or
    rows 4 bytes off 16-byte alignment) runs ``block_topj.cu``'s FFMA body,
    counted on ``launches_int4_generic`` too: the plain version's ids, scores
    within 1e-5."""
    c, sc = _int4_rows(gen, 3000, H)
    if offset:
        buf = torch.empty(c.numel() + offset, dtype=torch.int8, device="cuda")
        moved = buf[offset:].view(c.shape)
        moved.copy_(c)
        c = moved
    assert (c.data_ptr() % 16 != 0) == bool(offset)
    q = _randn(gen, 70, H)
    n, n_gen = topk.block_topj.launches_int4, topk.block_topj.launches_int4_generic
    v, i = topk.block_topj(q, c, 8, 1024, 2990, sc, int4=True)
    torch.cuda.synchronize()
    assert topk.block_topj.launches_int4 == n + 1
    assert topk.block_topj.launches_int4_generic == n_gen + 1
    rv, ri = topk._block_topj_reference(q, c, 8, 1024, 2990, sc, int4=True)
    assert torch.equal(i, ri)
    torch.testing.assert_close(v, rv, rtol=1e-5, atol=1e-5)


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


# --- K11 and K12 on flat_serve.cu's wgmma bodies -----------------------------------------------

_SERVE_COUNTER = {"K12 int8": "launches", "K12 sq4": "launches_int4", "K11": "launches_int4"}


def _serve_case(gen, body, H, N=5000, Q=1000):
    """Rows for ``body`` (int8 by the plain K7, int4 by the plain K9) with planted rows: exact
    ties inside a block (700-709), a zero row scoring -0 (row 3, scale -0) beside zero rows
    scoring +0 (rows 4 and 900, whose +0 comes after a -0 at the same score), and queries
    (a zero query among them); returns (call, ref, wrapper) of the kernel and its plain
    version at (J, block, n_valid)."""
    from denseretrievaltoolkits_torch.ops.quant import (_quantize_int4_reference,
                                                        _quantize_int8_reference,
                                                        quantize_queries)

    x = _randn(gen, N, H)
    c, sc = (_quantize_int8_reference if body == "K12 int8" else _quantize_int4_reference)(x)
    c[700:710] = c[700]
    sc[700:710] = sc[700]
    c[3] = c[4] = c[900] = 0
    sc[3] = -0.0
    q = _randn(gen, Q, H, scale=3.0)
    q[5] = 0
    int4 = body != "K12 int8"
    if body == "K11":
        qb = q.to(torch.bfloat16)
        return (lambda J, b, nv, rows=c: topk.block_topj_serve(qb, rows, J, b, nv, sc, int4=True),
                lambda J, b, nv: topk._block_topj_serve_reference(qb, c, J, b, nv, sc, int4=True),
                topk.block_topj_serve, (qb, c, sc))
    qi, qs = quantize_queries(q)
    return (lambda J, b, nv, rows=c: topk.block_topj_i8q(qi, qs, rows, sc, J, b, nv, int4=int4),
            lambda J, b, nv: topk._block_topj_i8q_reference(qi, qs, c, sc, J, b, nv, int4=int4),
            topk.block_topj_i8q, (qi, c, sc))


def _assert_k11_lists(got, want, qb, c, sc):
    """K11's lists against the plain version's: scores rank-wise within 1e-4 of max(1,
    |score|), empty entries alike; where ids differ (near ties of the two fp32 sums), both
    rows score the kernel's score in fp64 within 1e-4 of the terms' magnitudes."""
    from denseretrievaltoolkits_torch.ops.quant import unpack_int4

    (v, i), (rv, ri) = got, want
    assert torch.equal(i < 0, ri < 0)
    live = ri >= 0
    assert bool(((v - rv).abs() <= 1e-4 * rv.abs().clamp(min=1.0))[live].all())
    qi_, blk, j = torch.nonzero(i != ri, as_tuple=True)
    if qi_.numel():
        qd = qb.double()[qi_]
        for ids in (i[qi_, blk, j], ri[qi_, blk, j]):
            rows = unpack_int4(c[ids.long()]).double() * sc[ids.long()].double()[:, None]
            f64 = (qd * rows).sum(1)
            mag = (qd.abs() * rows.abs()).sum(1)
            assert bool(((f64 - v[qi_, blk, j].double()).abs() <= 1e-4 * mag.clamp(min=1.0)).all())


@pytest.mark.parametrize("block", [512, 1000, 4096])
@pytest.mark.parametrize("J", [4, 7, 11, 32])
@pytest.mark.parametrize("H", [768, 256])
@pytest.mark.parametrize("body", ["K12 int8", "K12 sq4", "K11"])
def test_serve_wgmma_kernel(gen, body, H, J, block):
    """K11 and both K12 bodies on ``flat_serve.cu``'s wgmma body: K12's lists bit-equal to the
    plain version's, K11's within 1e-4 of max(1, |score|); 1000 queries (a tile cut short),
    blocks of 512, 1000 (no multiple of the 64-row tile) and 4096 rows, n_valid inside a
    tile; -0 and +0 rows and exact ties rank as the plain version ranks them; one launch
    each, ``last_body`` "flat_serve", the ``_generic`` counters unmoved."""
    call, ref, wrapper, (qx, c, sc) = _serve_case(gen, body, H)
    counter = _SERVE_COUNTER[body]
    n, n_gen = getattr(wrapper, counter), getattr(wrapper, counter + "_generic")
    got = call(J, block, 4990)
    torch.cuda.synchronize()
    assert wrapper.last_body == "flat_serve"
    assert (getattr(wrapper, counter), getattr(wrapper, counter + "_generic")) == (n + 1, n_gen)
    want = ref(J, block, 4990)
    if body == "K11":
        _assert_k11_lists(got, want, qx, c, sc)
    else:
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))  # signs too
    # the zero query: every score +-0, -0 only for row 3; its lists rank the +0 rows first
    v5, i5 = got[0][5], got[1][5]
    assert bool((v5[i5 >= 0] == 0).all())
    assert bool((torch.signbit(v5) & (i5 >= 0) == (i5 == 3)).all())


@pytest.mark.parametrize("J", [7, 32])
def test_serve_wgmma_kernel_two_warpgroups(gen, J):
    """K12 int8 at H = 1024, where two CTAs no longer fit an SM and ``flat_serve.cu`` runs two
    consumer warpgroups on the row tiles in turn (each tile's 8 stages deeper than half the
    ring): bit-equal to the plain version over 1000-row blocks."""
    call, ref, wrapper, _ = _serve_case(gen, "K12 int8", 1024)
    n = wrapper.launches
    got = call(J, 1000, 4990)
    torch.cuda.synchronize()
    assert wrapper.last_body == "flat_serve" and wrapper.launches == n + 1
    want = ref(J, 1000, 4990)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("body,H,offset", [("K12 int8", 64, 0), ("K12 sq4", 64, 0),
                                           ("K11", 64, 0), ("K11", 768, 4)])
def test_serve_generic_body(gen, body, H, offset):
    """K11 / K12 at shapes ``flat_serve.cu`` does not take (H % 128 != 0, or int4 rows 4 bytes
    off 16-byte alignment for K11; K12's wrapper refuses unaligned rows) run
    ``block_topj.cu``'s bodies, counted on ``<counter>_generic`` too, as the plain version."""
    call, ref, wrapper, (qx, c, sc) = _serve_case(gen, body, H, N=3000, Q=70)
    rows = c
    if offset:
        buf = torch.empty(c.numel() + offset, dtype=c.dtype, device="cuda")
        rows = buf[offset:].view(c.shape)
        rows.copy_(c)
    counter = _SERVE_COUNTER[body]
    n, n_gen = getattr(wrapper, counter), getattr(wrapper, counter + "_generic")
    got = call(7, 1024, 2990, rows=rows)
    torch.cuda.synchronize()
    assert wrapper.last_body == "block_topj"
    assert (getattr(wrapper, counter), getattr(wrapper, counter + "_generic")) == (n + 1,
                                                                                   n_gen + 1)
    want = ref(7, 1024, 2990)
    if body == "K11":
        _assert_k11_lists(got, want, qx, c, sc)
    else:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --- K6 and K8 on the Hopper bodies: flat_serve.cu (bf16 / int8 rows), flat_certified.cu (fp32) --

# body -> (wrapper, counter, last_body, row dtype, tolerance against the plain version)
_FLAT8 = {"K6": (topk.block_topj, "launches_int8", "flat_serve", torch.int8, 1e-5),
          "K8 fp32": (topk.block_topj_serve, "launches", "flat_certified", torch.float32, 1e-5),
          "K8 bf16": (topk.block_topj_serve, "launches", "flat_serve", torch.bfloat16, 1e-4),
          "K8 int8": (topk.block_topj_serve, "launches", "flat_serve", torch.int8, 1e-4)}


def _assert_lists_near(got, want, q, rows_of, tol):
    """Per-block lists against the plain version's: empty entries alike; at each rank the two
    scores within ``tol`` of the terms' magnitudes (sum_d |q_d x_d| of the plain version's row
    there, at least 1: two fp32 sums of cancelling terms part by more than ``tol`` of their
    value); where ids differ (near ties of the two sums), both rows (``rows_of(ids)``: fp64
    rows as the kernel scores them) score the kernel's score in fp64 within ``tol`` of their
    terms' magnitudes under the queries ``q``."""
    (v, i), (rv, ri) = got, want
    assert torch.equal(i < 0, ri < 0)
    for a in range(0, q.shape[0], 100):  # fp64 rows of 100 queries' lists at a time
        qd, vv, ii, rr, rii = (t[a:a + 100] for t in (q.double(), v, i, rv, ri))
        live = rii >= 0
        rows = rows_of(rii.clamp(min=0).reshape(-1).long()).reshape(*rii.shape, -1)
        mag = torch.einsum("qd,qbjd->qbj", qd.abs(), rows.abs()).clamp(min=1.0)
        assert bool(((vv.double() - rr.double()).abs() <= tol * mag)[live].all())
        qi_, blk, j = torch.nonzero(ii != rii, as_tuple=True)
        for ids in (ii[qi_, blk, j], rii[qi_, blk, j]):
            rows = rows_of(ids.long())
            f64 = (qd[qi_] * rows).sum(1)
            m = (qd[qi_].abs() * rows.abs()).sum(1).clamp(min=1.0)
            assert bool(((f64 - vv[qi_, blk, j].double()).abs() <= tol * m).all())


def _flat8_case(gen, body, H, N=5000, Q=1000):
    """Rows for ``body`` (int8 by the plain K7) with planted rows: exact ties inside a block
    (700-709), zero rows (3, 4, 900; int8 row 3 scores -0 by its scale -0), rows of other
    magnitudes, and queries (row 5 zero); returns (call, ref, rows_of, q, rows)."""
    from denseretrievaltoolkits_torch.ops.quant import _quantize_int8_reference

    wrapper, _, _, dtype, _ = _FLAT8[body]
    x = _randn(gen, N, H)
    x[1500:1600] *= 1e-3
    x[2500:2600] *= 1e3
    q = _randn(gen, Q, H, scale=3.0)
    q[5] = 0
    if dtype == torch.int8:
        c, sc = _quantize_int8_reference(x)
        sc[700:710] = sc[700]
        sc[3] = -0.0
        qc = q.to(torch.bfloat16)
    else:
        c, sc, qc = x.to(dtype), None, q.to(dtype)
    c[700:710] = c[700]
    c[3] = c[4] = c[900] = 0
    plain = (topk._block_topj_reference if wrapper is topk.block_topj
             else topk._block_topj_serve_reference)

    def rows_of(ids):
        rows = c[ids].double()
        return rows if sc is None else rows * sc[ids].double()[:, None]

    return (lambda J, b, nv, rows=c: wrapper(qc, rows, J, b, nv, sc),
            lambda J, b, nv: plain(qc, c, J, b, nv, sc), rows_of, qc, c)


@pytest.mark.parametrize("block", [512, 1000, 4096])
@pytest.mark.parametrize("H", [768, 256])
@pytest.mark.parametrize("body,J", [("K6", 8), ("K6", 32)] + [
    (b, j) for b in ("K8 fp32", "K8 bf16", "K8 int8") for j in (6, 7, 11, 32)])
def test_flat8_wgmma_kernel(gen, body, J, H, block):
    """K6 (bf16 queries x int8 rows, certified) and K8 over fp32, bf16 and int8 rows on their
    Hopper bodies: scores within 1e-5 (K6, K8 fp32) or 1e-4 (K8 bf16 / int8) of the plain
    version's and ids equal up to near ties, over 1000 queries (a tile cut short), blocks of
    512, 1000 (no multiple of the 64-row tile) and 4096 rows, n_valid inside a tile; the zero
    query ranks its +-0 scores as the plain version does (K6: every -0 made +0, ids ascending;
    K8: -0 only for int8 row 3, below the +0 rows); one launch each, ``last_body`` the new
    body's, ``_generic`` unmoved."""
    call, ref, rows_of, qc, _ = _flat8_case(gen, body, H)
    wrapper, counter, last, dtype, tol = _FLAT8[body]
    n, n_gen = getattr(wrapper, counter), getattr(wrapper, counter + "_generic")
    got = call(J, block, 4990)
    torch.cuda.synchronize()
    assert wrapper.last_body == last
    assert (getattr(wrapper, counter), getattr(wrapper, counter + "_generic")) == (n + 1, n_gen)
    want = ref(J, block, 4990)
    _assert_lists_near(got, want, qc, rows_of, tol)
    v5, i5 = got[0][5], got[1][5]
    assert torch.equal(i5, want[1][5])  # every score +-0: the order is the ids'
    assert bool((v5[i5 >= 0] == 0).all())
    minus = i5 == 3 if body == "K8 int8" else torch.zeros_like(i5, dtype=torch.bool)
    assert torch.equal(torch.signbit(v5) & (i5 >= 0), minus)


@pytest.mark.parametrize("body", list(_FLAT8))
def test_flat8_generic_body(gen, body):
    """K6 and K8 on rows off 16-byte alignment (4 bytes) run ``block_topj.cu``'s body, counted
    on ``<counter>_generic`` too, within the plain version's tolerance."""
    call, ref, rows_of, qc, c = _flat8_case(gen, body, 768, N=3000, Q=70)
    wrapper, counter, _, _, tol = _FLAT8[body]
    off = 4 // c.element_size()
    buf = torch.empty(c.numel() + off, dtype=c.dtype, device="cuda")
    rows = buf[off:].view(c.shape)
    rows.copy_(c)
    n, n_gen = getattr(wrapper, counter), getattr(wrapper, counter + "_generic")
    got = call(7, 1024, 2990, rows=rows)
    torch.cuda.synchronize()
    assert wrapper.last_body == "block_topj"
    assert (getattr(wrapper, counter), getattr(wrapper, counter + "_generic")) == (n + 1,
                                                                                   n_gen + 1)
    _assert_lists_near(got, ref(7, 1024, 2990), qc, rows_of, tol)


@pytest.mark.parametrize("J", [6, 12])
@pytest.mark.parametrize("body", list(_FLAT8))
def test_flat8_ctas_walk_several_blocks(gen, body, J):
    """70,000 rows in 512-row blocks (the IVF side scans'), 1000 queries: enough (query tile,
    block) pairs that each CTA walks several blocks in turn (up to 4096 rows, its query tile
    resident, the last CTAs fewer), n_valid inside the last block: the plain version's lists."""
    call, ref, rows_of, qc, _ = _flat8_case(gen, body, 768, N=70_000)
    wrapper, _, last, _, tol = _FLAT8[body]
    got = call(J, 512, 69_990)
    torch.cuda.synchronize()
    assert wrapper.last_body == last
    _assert_lists_near(got, ref(J, 512, 69_990), qc, rows_of, tol)


@pytest.mark.parametrize("body", ["K6", "K8 bf16", "K8 int8"])
def test_flat8_wgmma_kernel_other_widths(gen, body):
    """bf16 and int8 rows at H = 192 (int8: the last 128-byte stage half past the row, read
    as zeros) and H = 1024 (fewer ring stages): the plain version's lists."""
    for H in (192, 1024):
        call, ref, rows_of, qc, _ = _flat8_case(gen, body, H, N=3000, Q=130)
        wrapper, _, last, _, tol = _FLAT8[body]
        got = call(11, 1000, 2990)
        torch.cuda.synchronize()
        assert wrapper.last_body == last, H
        _assert_lists_near(got, ref(11, 1000, 2990), qc, rows_of, tol)


# --- the IVF cell kernels: K13 (fixed-capacity cells) and K14 (ragged block list) --------------

def _ivf_case(gen, body, H, nlist=6, Qcap=72, N=1152):
    """A query slab (72 slots: two tiles of 64), N rows with empty slots, the
    scales of int8 rows and the slot scales of i8q, for one body."""
    from denseretrievaltoolkits_torch.ops.quant import quantize_queries

    x = _randn(gen, N, H)
    row_ids = torch.arange(N, dtype=torch.int32, device="cuda")
    row_ids[100:128] = -1   # a tail of empty slots
    row_ids[600:650] = -1
    q = _randn(gen, nlist * Qcap, H)
    scales = qscales = None
    if body in ("int8", "i8q"):
        values, scales = _int8_rows(gen, N, H)
        if body == "i8q":
            slab, qscales = quantize_queries(q)
            slab, qscales = slab.reshape(nlist, Qcap, H), qscales.reshape(nlist, Qcap)
        else:
            slab = q.to(torch.bfloat16).reshape(nlist, Qcap, H)
    else:
        dtype = torch.float32 if body == "float32" else torch.bfloat16
        values, slab = x.to(dtype), q.to(dtype).reshape(nlist, Qcap, H)
        values[300:305] = values[300]  # exact ties inside one block
    return slab, values, row_ids, scales, qscales


def _assert_ivf_lists(got, want, slab, values, row_ids, scales, qscales, cells_of_sel, rel):
    """Kernel lists vs the plain version's [n_sel, Qcap, J]: scores within
    ``rel``, ids equal except where two rows tie (every kernel id rescored in
    fp64 under the kernel's formula gives its score), -1 exactly where the
    plain version has no row."""
    (v, i), (rv, ri) = got, want
    assert v.shape == rv.shape and i.dtype == torch.int32
    assert torch.equal(i < 0, ri < 0)
    fin = ri >= 0
    torch.testing.assert_close(v[fin], rv[fin], rtol=rel, atol=1e-5)
    n_sel, Qcap, J = i.shape
    rows = i.clamp(min=0).long()
    cell = cells_of_sel.long()[:, None, None].expand(n_sel, Qcap, J)
    slot = torch.arange(Qcap, device="cuda")[None, :, None].expand(n_sel, Qcap, J)
    q = slab.double()[cell, slot]
    s = (q * values.double()[rows]).sum(-1)
    if scales is not None:
        s = s * scales.double()[rows]
    if qscales is not None:
        s = s * qscales.double()[cell, slot]
    torch.testing.assert_close(s[fin], v[fin].double(), rtol=rel, atol=1e-4)
    assert (row_ids[rows][fin] >= 0).all()
    differ = (i != ri) & fin
    assert differ.float().mean() < 0.01, "ids differ beyond ties"


@pytest.mark.parametrize("body,H", [("float32", 64), ("float32", 48), ("bfloat16", 64),
                                    ("bfloat16", 48), ("int8", 64), ("int8", 48), ("i8q", 64),
                                    ("i8q", 768)])
@pytest.mark.parametrize("J,sel", [(7, None), (32, None), (5, 40)])
def test_cell_topj_kernel(gen, body, H, J, sel):
    """K13 over 6 cells of C=192 rows in 96-row blocks: the plain version's
    lists (fp32 / bf16 / int8 / i8q bodies, tensor-core and
    CUDA-core paths, selection blocks narrower than the storage block)."""
    from denseretrievaltoolkits_torch.ops import ivf_bulk

    slab, values, row_ids, scales, qscales = _ivf_case(gen, body, H)
    nlist, C, block = 6, 192, 96
    counter = {"i8q": "launches_i8q", "int8": "launches_int8"}.get(body, "launches")
    n = getattr(ivf_bulk.cell_topj, counter)
    args = (slab, values.reshape(nlist, C, H), row_ids.reshape(nlist, C),
            None if scales is None else scales.reshape(nlist, C), J, block)
    got = ivf_bulk.cell_topj(*args, sel=sel, qscales=qscales)
    torch.cuda.synchronize()
    assert getattr(ivf_bulk.cell_topj, counter) == n + 1
    want = ivf_bulk._ivf_topj_reference(slab, values, row_ids, scales, qscales, None, C // block,
                                        J, block, block if sel is None else sel)
    per = -(-block // (block if sel is None else sel))
    cells = torch.arange(nlist * C // block, device="cuda").repeat_interleave(per) // (C // block)
    _assert_ivf_lists(got, want, slab, values, row_ids, scales, qscales, cells,
                      0 if body == "i8q" else 1e-5)
    if body == "i8q":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("body,H", [("float32", 64), ("bfloat16", 64), ("bfloat16", 48),
                                    ("int8", 64), ("i8q", 64)])
@pytest.mark.parametrize("J,sel", [(9, None), (3, 50)])
def test_ragged_topj_kernel(gen, body, H, J, sel):
    """K14 over 9 blocks of 128 rows whose block -> cell map skips cell 2
    (empty) and gives cell 3 three blocks: the plain version's lists."""
    from denseretrievaltoolkits_torch.ops import ivf_bulk

    slab, values, row_ids, scales, qscales = _ivf_case(gen, body, H)
    block_cell = torch.tensor([0, 0, 1, 3, 3, 3, 4, 5, 5], dtype=torch.int32, device="cuda")
    counter = {"i8q": "launches_i8q", "int8": "launches_int8"}.get(body, "launches")
    n = getattr(ivf_bulk.ragged_topj, counter)
    got = ivf_bulk.ragged_topj(block_cell, slab, values, row_ids, scales, J, 128, sel=sel,
                               qscales=qscales)
    torch.cuda.synchronize()
    assert getattr(ivf_bulk.ragged_topj, counter) == n + 1
    s = 128 if sel is None else sel
    want = ivf_bulk._ivf_topj_reference(slab, values, row_ids, scales, qscales, block_cell, 1, J,
                                        128, s)
    cells = block_cell.repeat_interleave(-(-128 // s))
    _assert_ivf_lists(got, want, slab, values, row_ids, scales, qscales, cells,
                      0 if body == "i8q" else 1e-5)


def test_ivf_kernels_refuse_what_they_cannot_run(gen):
    """J past 32 or the selection block, int8 slots at H % 64, or a bf16 slab
    over fp32 cells raise before any launch."""
    from denseretrievaltoolkits_torch.ops import ivf_bulk

    slab, values, row_ids, scales, qscales = _ivf_case(gen, "i8q", 64)
    n = ivf_bulk.ragged_topj.launches_i8q
    bc = torch.zeros(9, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="J"):
        ivf_bulk.ragged_topj(bc, slab, values, row_ids, scales, 33, 128, qscales=qscales)
    with pytest.raises(ValueError, match="H % 64"):
        ivf_bulk.ragged_topj(bc, slab[:, :, :48].contiguous(), values[:, :48].contiguous(),
                             row_ids, scales, 8, 128, qscales=qscales)
    with pytest.raises(TypeError):
        ivf_bulk.ragged_topj(bc, slab.float(), values.float(), row_ids, None, 8, 128,
                             qscales=qscales)
    assert ivf_bulk.ragged_topj.launches_i8q == n


def _ivf_body_call(layout, body, slab, values, row_ids, scales, qscales, nlist, J, block, sel,
                   slots, block_cell=None):
    """K13 (fixed: nlist cells of equal size) or K14 (ragged: ``block_cell``)
    through its wrapper; returns (lists, the plain version's lists, the cell
    of each selection block, the wrapper)."""
    from denseretrievaltoolkits_torch.ops import ivf_bulk

    N, H = values.shape
    per = -(-block // sel)
    if layout == "fixed":
        C = N // nlist
        fn = ivf_bulk.cell_topj
        got = fn(slab, values.reshape(nlist, C, H), row_ids.reshape(nlist, C),
                 None if scales is None else scales.reshape(nlist, C), J, block, sel, qscales,
                 slots)
        want = ivf_bulk._ivf_topj_reference(slab, values, row_ids, scales, qscales, None,
                                            C // block, J, block, sel, slots)
        cells = torch.arange(N // block, device="cuda").repeat_interleave(per) // (C // block)
    else:
        fn = ivf_bulk.ragged_topj
        got = fn(block_cell, slab, values, row_ids, scales, J, block, sel, qscales, slots)
        want = ivf_bulk._ivf_topj_reference(slab, values, row_ids, scales, qscales, block_cell,
                                            1, J, block, sel, slots)
        cells = block_cell.repeat_interleave(per)
    torch.cuda.synchronize()
    return got, want, cells, fn


_IVF_COUNTER = {"i8q": "launches_i8q", "int8": "launches_int8"}


@pytest.mark.parametrize("body", ["float32", "bfloat16", "int8", "i8q"])
@pytest.mark.parametrize("layout", ["fixed", "ragged"])
def test_ivf_cell_slots_and_empty_rows(gen, body, layout):
    """The IVF cell kernel body with ``slots``: cells with 0, 1, a partial
    tile (slots 40 of 72: the second 64-slot tile empty) and every slot
    filled; a storage block whose rows are all empty and a 128-row tile
    inside a block that is all empty. Filled slots' lists as the plain
    version's (i8q bit-equal); every other list (-inf, -1); the new body ran
    (its counter, not ``launches_generic``)."""
    H = 128  # every body's new shape: bf16 / int8 rows H % 64, i8q H % 128
    slab, values, row_ids, scales, qscales = _ivf_case(gen, body, H)
    row_ids[384:512] = -1   # the fifth 96-row block, and the head of the sixth
    row_ids[768:960] = -1   # fixed: cell 4's two blocks; ragged: blocks 8 and 9
    nlist, block = 6, 96
    block_cell = torch.tensor([0, 0, 1, 3, 3, 3, 4, 5, 5, 2, 2, 1], dtype=torch.int32,
                              device="cuda")
    slots = torch.tensor([72, 0, 1, 40, 72, 65], dtype=torch.int32, device="cuda")
    counter = _IVF_COUNTER.get(body, "launches")
    from denseretrievaltoolkits_torch.ops import ivf_bulk
    fn = ivf_bulk.cell_topj if layout == "fixed" else ivf_bulk.ragged_topj
    n, n_gen = getattr(fn, counter), fn.launches_generic
    got, want, cells, fn = _ivf_body_call(layout, body, slab, values, row_ids, scales, qscales,
                                          nlist, 9, block, 96, slots, block_cell)
    assert getattr(fn, counter) == n + 1 and fn.launches_generic == n_gen
    filled = (torch.arange(72, device="cuda")[None, :] < slots.long()[cells][:, None])
    assert bool((got[1][~filled] == -1).all()) and bool((got[0][~filled] == float("-inf")).all())
    assert bool((got[1][filled] >= 0).any())
    _assert_ivf_lists(got, want, slab, values, row_ids, scales, qscales, cells,
                      0 if body == "i8q" else 1e-5)
    if body == "i8q":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("body", ["float32", "bfloat16", "int8", "i8q"])
@pytest.mark.parametrize("J,sel,block", [(32, 128, 512), (31, 512, 1024), (20, 2048, 2048)])
def test_ivf_cell_selection_at_full_width(gen, body, J, sel, block):
    """The main paths' selections at H = 768: J 32 over 128-row selection
    blocks (every tile a first tile: the bitonic pass), 31 over 512 and 20
    over 2048 (insertions after the first tile), K14 over 3 cells with one
    block empty and slots 80 / 23 / 64 of Qcap 80. Scores within 1e-5 (fp32)
    or 1e-4 (bf16 products summed in fp32 in another order over 768 terms);
    i8q bit-equal."""
    from denseretrievaltoolkits_torch.ops.quant import quantize_queries

    H, nlist, Qcap = 768, 3, 80
    n_blocks = 6 if block < 2048 else 4
    N = n_blocks * block
    x = _randn(gen, N, H)
    row_ids = torch.arange(N, dtype=torch.int32, device="cuda")
    row_ids[block + 7:block + 300] = -1
    row_ids[3 * block:4 * block] = -1  # an empty block
    q = _randn(gen, nlist * Qcap, H)
    scales = qscales = None
    if body in ("int8", "i8q"):
        values, scales = _int8_rows(gen, N, H)
        if body == "i8q":
            slab, qscales = quantize_queries(q)
            slab, qscales = slab.reshape(nlist, Qcap, H), qscales.reshape(nlist, Qcap)
        else:
            slab = q.to(torch.bfloat16).reshape(nlist, Qcap, H)
    else:
        dtype = torch.float32 if body == "float32" else torch.bfloat16
        values, slab = x.to(dtype), q.to(dtype).reshape(nlist, Qcap, H)
    block_cell = torch.tensor([0, 2, 1, 1, 0, 2][:n_blocks], dtype=torch.int32, device="cuda")
    slots = torch.tensor([80, 23, 64], dtype=torch.int32, device="cuda")
    counter = _IVF_COUNTER.get(body, "launches")
    from denseretrievaltoolkits_torch.ops import ivf_bulk
    n, n_gen = getattr(ivf_bulk.ragged_topj, counter), ivf_bulk.ragged_topj.launches_generic
    got, want, cells, _ = _ivf_body_call("ragged", body, slab, values, row_ids, scales, qscales,
                                         nlist, J, block, sel, slots, block_cell)
    assert getattr(ivf_bulk.ragged_topj, counter) == n + 1
    assert ivf_bulk.ragged_topj.launches_generic == n_gen
    _assert_ivf_lists(got, want, slab, values, row_ids, scales, qscales, cells,
                      0 if body == "i8q" else 1e-5 if body == "float32" else 1e-4)
    if body == "i8q":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("body,H", [("bfloat16", 48), ("int8", 80), ("i8q", 64)])
def test_ivf_cell_other_body(gen, body, H):
    """A shape the new bodies do not take (bf16 / int8 rows at H % 64 != 0,
    i8q at H % 128 != 0) runs the block top-J family's body and counts on
    ``launches_generic``; with ``slots`` its lists past each count are
    (-inf, -1) as well."""
    from denseretrievaltoolkits_torch.ops import ivf_bulk

    slab, values, row_ids, scales, qscales = _ivf_case(gen, body, H)
    slots = torch.tensor([72, 0, 1, 40, 72, 65], dtype=torch.int32, device="cuda")
    counter = _IVF_COUNTER.get(body, "launches")
    fn = ivf_bulk.cell_topj
    n, n_gen = getattr(fn, counter), fn.launches_generic
    got, want, cells, _ = _ivf_body_call("fixed", body, slab, values, row_ids, scales, qscales,
                                         6, 7, 96, 96, slots)
    assert getattr(fn, counter) == n + 1 and fn.launches_generic == n_gen + 1
    _assert_ivf_lists(got, want, slab, values, row_ids, scales, qscales, cells,
                      0 if body == "i8q" else 1e-5)


@pytest.mark.parametrize("kind,dtype", [("fixed", "float32"), ("fixed", "bfloat16"),
                                        ("fixed", "int8"), ("ragged", "int8"),
                                        ("ragged", "bfloat16")])
def test_ivf_index_modes_on_card(gen, tmp_path, kind, dtype):
    """An IVF index built on the CPU, saved and loaded onto the card, searches
    as on the CPU (the plain versions) in every mode: the same tuned Qcap, hot
    set and drops, ids equal up to ties; K13 / K14 launch."""
    from denseretrievaltoolkits_torch.index import ivf
    from denseretrievaltoolkits_torch.index.io import load_index
    from denseretrievaltoolkits_torch.ops import ivf_bulk

    centres = _randn(gen, 48, 64)
    rows = centres[torch.randint(0, 48, (6000,), generator=gen, device="cuda")]
    x = (rows + 0.4 * _randn(gen, 6000, 64)).cpu().numpy()
    q = (centres[torch.randint(0, 48, (300,), generator=gen, device="cuda")]
         + 0.4 * _randn(gen, 300, 64)).cpu().numpy()
    if kind == "ragged":
        cpu = ivf.IVFRaggedIndex(64, nlist=32, nprobe=6, dtype=dtype, block=64, device="cpu")
        fn = ivf_bulk.ragged_topj
    else:
        cpu = ivf.IVFFlatIndex(64, nlist=32, nprobe=6, dtype=dtype, device="cpu")
        fn = ivf_bulk.cell_topj
    cpu.train(x, iters=5)
    cpu.add(x)
    cpu.save(str(tmp_path / "i"))
    card = load_index(str(tmp_path / "i"))
    assert card.device.type == "cuda" and card._values.is_cuda
    modes = ("bulk", "i8q", "probe", "exact") if dtype == "int8" else ("bulk", "probe", "exact")
    for mode in modes:
        counter = "launches_i8q" if mode == "i8q" else (
            "launches_int8" if dtype == "int8" else "launches")
        n = getattr(fn, counter)
        s, d = card.search(q, 50, mode=mode)
        rs, rd = cpu.search(q, 50, mode=mode)
        if mode in ("bulk", "i8q"):
            assert getattr(fn, counter) > n
            assert card._bulk_state["qcap"] == cpu._bulk_state["qcap"]
            assert card.last_dropped == cpu.last_dropped
            assert sorted(card._bulk_state["hot"].tolist()) == sorted(
                cpu._bulk_state["hot"].tolist())
        recall = sum(len(set(a) & set(b)) for a, b in zip(d, rd)) / rd.size
        assert recall >= 0.99, (mode, recall)
        np.testing.assert_allclose(s, rs, rtol=1e-4, atol=1e-4)


# --- the PQ kernels: K15 (bf16 table, 8- and 4-bit codes), K16 (int8 table), K17 (IVF-PQ) -----

def _pq_case(gen, H, M, nbits, N, i8dec=False):
    """Random codebooks [M, k, H/M], codes of N random rows under them, and
    the kernels' table (K16: int8 entries and the per-dim scale)."""
    from denseretrievaltoolkits_torch.ops import pq

    cb = _randn(gen, M, 1 << nbits, H // M).cpu()
    codes = pq.pq_encode_device(_randn(gen, N, H), cb.cuda())
    if i8dec:
        table, scale = pq.bdcb_table(*pq.build_bdcb_i8(cb.numpy()))
    else:
        table, scale = pq.bdcb_table(pq.build_bdcb(cb.numpy()), k=1 << nbits)
    return cb.cuda(), codes, table.cuda(), None if scale is None else scale.cuda()


def _decoded_rows(table, scale, codes, rows, nbits):
    """fp64 decoded rows (the kernels' bf16 values) of the code columns ``rows``."""
    from denseretrievaltoolkits_torch.ops import pq

    tab = pq._decoded_table(table, scale).double()
    idx = pq._code_ids(codes[:, rows.reshape(-1)], 1 << nbits)
    M, _, d = tab.shape
    dec = tab[torch.arange(M, device="cuda")[:, None], idx].permute(1, 0, 2)
    return dec.reshape(*rows.shape, M * d)


# (Q, N, block, n_valid, PQ_CHUNK_ROWS) of test_pq_topj_kernel: one chunk of 512-row
# blocks; three chunks of two blocks (the last chunk one short block, n_valid inside
# it) under 200 queries (a second, partial 128-query tile); one query over 100-row blocks
# (shorter than the scoring body's 128-row tile) in three chunks of ten blocks
PQ_SHAPES = {"one-chunk": (70, 2300, 512, 2200, None),
             "three-chunks-q200": (200, 2300, 512, 2200, 1024),
             "q1-block100": (1, 2300, 100, 2250, 1000)}


@pytest.mark.parametrize("nbits,i8dec,H,M", [(8, False, 768, 96), (8, True, 768, 96),
                                             (8, True, 128, 8), (8, False, 256, 128),
                                             (4, False, 768, 192), (4, False, 128, 16),
                                             (4, False, 1024, 256), (8, True, 384, 24)])
@pytest.mark.parametrize("J", [6, 32])
@pytest.mark.parametrize("shape", sorted(PQ_SHAPES))
def test_pq_topj_kernel(gen, monkeypatch, nbits, i8dec, H, M, J, shape):
    """K15 / K16 (the decode pass, then the scoring body, per chunk) against
    their plain version over 2300 rows at each PQ_SHAPES case (a short last
    block, rows past n_valid masked): one launch of each kernel a chunk;
    scores within 1e-5, every kernel id rescored in fp64 under the kernel's
    formula (bf16 q x decoded bf16 row) gives its score, ids equal but at
    ties. d_sub 2 to 16, H 128 to 1024."""
    from denseretrievaltoolkits_torch.ops import pq

    Q, N, block, n_valid, target = PQ_SHAPES[shape]
    if target is not None:
        monkeypatch.setattr(pq, "PQ_CHUNK_ROWS", target)
    n_chunks = -(-N // pq.pq_chunk_rows(N, block))
    assert n_chunks == (1 if target is None else 3)
    cb, codes, table, scale = _pq_case(gen, H, M, nbits, N, i8dec)
    q = _randn(gen, Q, H).to(torch.bfloat16)
    counter = "launches_4bit" if nbits == 4 else ("launches_i8dec" if i8dec else "launches")
    n, n_dec = getattr(pq.pq_topj_blocks, counter), pq.pq_topj_blocks.launches_decode
    v, i = pq.pq_topj_blocks(q, codes, table, J, block, n_valid, scale, nbits)
    torch.cuda.synchronize()
    assert getattr(pq.pq_topj_blocks, counter) == n + n_chunks
    assert pq.pq_topj_blocks.launches_decode == n_dec + n_chunks
    n_blocks = -(-N // block)
    rv, ri = pq._pq_topj_reference(q, codes, table, J, block, n_valid, scale, nbits,
                                   chunk_rows=n_blocks * block)  # unchunked
    assert v.shape == rv.shape == (Q, n_blocks, J) and torch.equal(i < 0, ri < 0)
    fin = ri >= 0
    torch.testing.assert_close(v[fin], rv[fin], rtol=1e-5, atol=1e-5)
    assert (i[fin] < n_valid).all()
    starts = torch.arange(n_blocks, device="cuda")[None, :, None] * block
    assert ((i >= starts) & (i < starts + block))[fin].all()  # each id in its own block
    dec = _decoded_rows(table, scale, codes, i.clamp(min=0).long(), nbits)
    s = (q.double()[:, None, None, :] * dec).sum(-1)
    torch.testing.assert_close(s[fin], v[fin].double(), rtol=1e-5, atol=1e-4)
    assert ((i != ri) & fin).float().mean() < 0.01


def test_pq_serve_topk_runs_the_kernels(gen):
    """The serve search: k=100 over 40,000 rows in 1024-row blocks (J=8) and
    k=1000 (the reference's J of 52 halves the block until J <= 32): the
    kernels launch, once a chunk (two chunks of 32,768 rows), the exact scan
    never; the ranking is the plain version's up to ties."""
    from denseretrievaltoolkits_torch.ops import pq

    from denseretrievaltoolkits_torch.ops.topk import serve_plan

    cb, codes, table, scale = _pq_case(gen, 256, 32, 8, 40000, i8dec=True)
    q = _randn(gen, 50, 256)
    for k in (100, 1000):
        n, scans = pq.pq_topj_blocks.launches_i8dec, pq.pq_serve_topk.exact_scans
        s, ids = pq.pq_serve_topk(q, codes, cb, table, k, 1024, scale=scale)
        torch.cuda.synchronize()
        n_chunks = -(-40000 // pq.pq_chunk_rows(40000, serve_plan(k, 40000, 40000, 1024)[0]))
        assert pq.pq_topj_blocks.launches_i8dec == n + n_chunks and ids.shape == (50, k)
        assert pq.pq_serve_topk.exact_scans == scans
        rs, rids = pq.pq_serve_topk(q.cpu(), codes.cpu(), cb.cpu(), table.cpu(), k, 1024,
                                    scale=scale.cpu())
        overlap = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids.cpu(), rids))
        assert overlap >= 0.999 * rids.numel()
        torch.testing.assert_close(s.cpu(), rs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nbits,M", [(8, 96), (4, 192), (4, 48)])
@pytest.mark.parametrize("J,sel", [(9, None), (3, 50)])
def test_ragged_topj_pq_kernel(gen, nbits, M, J, sel):
    """K17 over 9 blocks of 128 code columns whose block -> cell map skips
    cell 2 and gives cell 3 three blocks, 72 slots per cell (two query tiles),
    per-slot offsets, empty rows masked: the plain version's lists, every id
    rescored in fp64 (bf16 slot x decoded row + offset)."""
    from denseretrievaltoolkits_torch.ops import ivf_pq

    H, nlist, Qcap, block = 768, 6, 72, 128
    _, codes, table, _ = _pq_case(gen, H, M, nbits, 9 * block)
    block_cell = torch.tensor([0, 0, 1, 3, 3, 3, 4, 5, 5], dtype=torch.int32, device="cuda")
    row_ids = torch.arange(9 * block, dtype=torch.int32, device="cuda")
    row_ids[100:128] = -1
    row_ids[600:650] = -1
    slab = _randn(gen, nlist, Qcap, H).to(torch.bfloat16)
    poff = _randn(gen, nlist, Qcap, scale=5.0)
    n = ivf_pq.ragged_topj_pq.launches
    v, i = ivf_pq.ragged_topj_pq(block_cell, slab, codes, row_ids, poff, table, J, block, sel,
                                 nbits)
    torch.cuda.synchronize()
    assert ivf_pq.ragged_topj_pq.launches == n + 1
    s_ = block if sel is None else sel
    rv, ri = ivf_pq._ivf_pq_topj_reference(slab, codes, row_ids, poff, table, block_cell, J,
                                           block, s_, nbits)
    assert v.shape == rv.shape and torch.equal(i < 0, ri < 0)
    fin = ri >= 0
    torch.testing.assert_close(v[fin], rv[fin], rtol=1e-5, atol=1e-5)
    n_sel = v.shape[0]
    cells = block_cell.repeat_interleave(-(-block // s_)).long()[:, None].expand(n_sel, Qcap)
    slots = torch.arange(Qcap, device="cuda")[None, :].expand(n_sel, Qcap)
    dec = _decoded_rows(table, None, codes, i.clamp(min=0).long(), nbits)
    s = (slab.double()[cells, slots][:, :, None, :] * dec).sum(-1) \
        + poff.double()[cells, slots][:, :, None]
    torch.testing.assert_close(s[fin], v[fin].double(), rtol=1e-5, atol=1e-4)
    assert (row_ids[i.clamp(min=0).long()][fin] >= 0).all()
    assert ((i != ri) & fin).float().mean() < 0.01


@pytest.mark.parametrize("J", [8, 9])  # two lanes a slot (J <= 8), the warp merge
@pytest.mark.parametrize("nbits,M,block", [(4, 192, 128), (4, 96, 128), (4, 12, 128),
                                           (8, 96, 128), (8, 384, 128), (8, 768, 128),
                                           (8, 6, 72), (4, 192, 72)])
def test_ragged_topj_pq_kernel_filled_slots(gen, nbits, M, block, J):
    """K17 (``ivf_cell.cu``'s PQ rows) with each cell's filled slots: d_sub 4, 8
    and 64 at 4-bit, 1, 2, 8 and 128 at 8-bit; 72-row blocks (N % 16 != 0: the
    producer warp copies the codes, which TMA cannot map); a cell with no
    filled slot, one with a partial second 64-slot tile, a 128-row tile with no
    stored row and offsets of scale 5; both selections. Filled slots' lists
    equal the plain version's up to ties (scores within 1e-4); every other list
    (-inf, -1)."""
    from denseretrievaltoolkits_torch.ops import ivf_pq

    H, nlist, Qcap = 768, 6, 72
    nb = 11
    _, codes, table, _ = _pq_case(gen, H, M, nbits, nb * block)
    block_cell = torch.tensor([0, 0, 1, 3, 3, 3, 4, 5, 5, 2, 2], dtype=torch.int32,
                              device="cuda")
    row_ids = torch.arange(nb * block, dtype=torch.int32, device="cuda")
    row_ids[block - 20:block] = -1
    row_ids[3 * block:5 * block] = -1  # cell 3's first two blocks: whole tiles empty
    row_ids[6 * block + 10:6 * block + 30] = -1
    slab = _randn(gen, nlist, Qcap, H).to(torch.bfloat16)
    poff = _randn(gen, nlist, Qcap, scale=5.0)
    slots = torch.tensor([72, 0, 5, 70, 40, 64], dtype=torch.int32, device="cuda")
    n = ivf_pq.ragged_topj_pq.launches
    v, i = ivf_pq.ragged_topj_pq(block_cell, slab, codes, row_ids, poff, table, J, block, None,
                                 nbits, slots)
    torch.cuda.synchronize()
    assert ivf_pq.ragged_topj_pq.launches == n + 1
    rv, ri = ivf_pq._ivf_pq_topj_reference(slab, codes, row_ids, poff, table, block_cell, J,
                                           block, block, nbits, slots)
    cells = block_cell.long()
    filled = (torch.arange(Qcap, device="cuda")[None, :] < slots.long()[cells][:, None])
    filled = filled[:, :, None].expand_as(v)
    assert bool((i[~filled] == -1).all()) and bool((v[~filled] == float("-inf")).all())
    assert torch.equal(i < 0, ri < 0) and bool((i[filled] >= 0).any())
    fin = ri >= 0
    torch.testing.assert_close(v[fin], rv[fin], rtol=1e-4, atol=1e-4)
    slot = torch.arange(Qcap, device="cuda")[None, :, None].expand_as(i)
    cell = cells[:, None, None].expand_as(i)
    dec = _decoded_rows(table, None, codes, i.clamp(min=0).long(), nbits)
    s = (slab.double()[cell, slot] * dec).sum(-1) + poff.double()[cell, slot]
    torch.testing.assert_close(s[fin], v[fin].double(), rtol=1e-4, atol=1e-4)
    assert bool((row_ids[i.clamp(min=0).long()][fin] >= 0).all())
    assert ((i != ri) & fin).float().mean() < 0.01


def test_pq_kernels_refuse_what_they_cannot_run(gen):
    """fp32 queries, J past 32, an int8 table under 4-bit codes, a geometry
    off the decode layout (128 does not divide H) and wrong offsets raise
    before any launch."""
    from denseretrievaltoolkits_torch.ops import ivf_pq, pq

    cb, codes, table, scale = _pq_case(gen, 256, 32, 8, 1024, i8dec=True)
    q = _randn(gen, 8, 256)
    counts = (pq.pq_topj_blocks.launches_i8dec, pq.pq_topj_blocks.launches,
              ivf_pq.ragged_topj_pq.launches)
    with pytest.raises(ValueError, match="bf16"):
        pq.pq_topj_blocks(q, codes, table, 8, 512, 1024, scale)
    with pytest.raises(ValueError, match="J"):
        pq.pq_topj_blocks(q.to(torch.bfloat16), codes, table, 33, 512, 1024, scale)
    with pytest.raises(TypeError):
        pq.pq_topj_blocks(q.to(torch.bfloat16), codes, table, 8, 512, 1024, None)
    _, c4, _, _ = _pq_case(gen, 256, 64, 4, 1024)
    with pytest.raises(ValueError):
        pq.pq_topj_blocks(q.to(torch.bfloat16), c4, table, 8, 512, 1024, scale, nbits=4)
    c3 = torch.zeros(24, 1024, dtype=torch.int8, device="cuda")
    t3 = torch.zeros(24, 256, 8, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="128"):
        pq.pq_topj_blocks(_randn(gen, 8, 192).to(torch.bfloat16), c3, t3, 8, 512, 1024)
    bc = torch.zeros(2, dtype=torch.int32, device="cuda")
    rid = torch.arange(1024, dtype=torch.int32, device="cuda")
    slab = _randn(gen, 1, 8, 256).to(torch.bfloat16)
    _, c8, t8, _ = _pq_case(gen, 256, 32, 8, 1024)
    with pytest.raises(ValueError, match="offsets"):
        ivf_pq.ragged_topj_pq(bc, slab, c8, rid, _randn(gen, 1, 7), t8, 8, 512)
    assert counts == (pq.pq_topj_blocks.launches_i8dec, pq.pq_topj_blocks.launches,
                      ivf_pq.ragged_topj_pq.launches)


@pytest.mark.parametrize("spec", ["PQ32", "PQ64x4", "IVF16,PQ32x4", "IVFR16,PQ32"])
def test_pq_index_modes_on_card(gen, tmp_path, spec):
    """A PQ / IVF-PQ index built on the CPU, saved and loaded onto the card,
    searches as on the CPU (the plain versions) in every mode: K16 / K15 /
    K17 launch, the PQ exact scan is never taken on the serve path, ids
    agree up to ties."""
    from denseretrievaltoolkits_torch.index.flat import index_factory
    from denseretrievaltoolkits_torch.index.io import load_index
    from denseretrievaltoolkits_torch.ops import ivf_pq, pq

    centres = _randn(gen, 48, 256)
    x = (centres[torch.randint(0, 48, (9000,), generator=gen, device="cuda")]
         + 0.4 * _randn(gen, 9000, 256)).cpu().numpy()
    q = (centres[torch.randint(0, 48, (300,), generator=gen, device="cuda")]
         + 0.4 * _randn(gen, 300, 256)).cpu().numpy()
    cpu = index_factory(256, spec, nprobe=6, device="cpu")
    cpu.train(x[:4096])
    cpu.add(x)
    cpu.save(str(tmp_path / "i"))
    card = load_index(str(tmp_path / "i"))
    assert card.device.type == "cuda"
    ivfpq = spec.startswith("IVF")
    for mode in ("bulk", "exact") if ivfpq else ("serve", "exact"):
        if ivfpq:
            counter = (ivf_pq.ragged_topj_pq, "launches")
        else:
            counter = (pq.pq_topj_blocks, "launches_4bit" if "x4" in spec else "launches_i8dec")
        n, scans = getattr(*counter), pq.pq_serve_topk.exact_scans
        s, d = card.search(q, 50, mode=mode)
        rs, rd = cpu.search(q, 50, mode=mode)
        assert pq.pq_serve_topk.exact_scans == scans
        if mode != "exact":
            assert getattr(*counter) > n
        if ivfpq and mode == "bulk":
            assert card._bulk_state["qcap"] == cpu._bulk_state["qcap"]
            assert card.last_dropped == cpu.last_dropped
        recall = sum(len(set(a) & set(b)) for a, b in zip(d, rd)) / rd.size
        assert recall >= 0.99, (mode, recall)
        np.testing.assert_allclose(s, rs, rtol=1e-4, atol=1e-4)
