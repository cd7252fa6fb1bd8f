"""The torch port's contrastive losses vs the JAX reference.

K3/K4 (``ops/contrastive.py``): on the CPU the port's wrappers run their
plain versions; the JAX fused loss runs its Pallas kernels in interpret mode,
as ``tests/test_fused_contrastive.py`` runs them. The same numpy-seeded reps
go to both. Tolerances are the reference's own: 1e-5 relative on the loss,
1e-5 absolute on the grads (test_fused_contrastive.py:31, 46).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from denseretrievaltoolkits_tpu.ops import contrastive as jcon
from denseretrievaltoolkits_tpu.train import losses as jlosses
from denseretrievaltoolkits_torch.ops import contrastive as tcon
from denseretrievaltoolkits_torch.train import losses as tlosses


def _reps(Q, P, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Q, H)).astype(np.float32),
            rng.normal(size=(P, H)).astype(np.float32))


def _port_loss_and_grads(fn, q, p):
    tq = torch.from_numpy(q).requires_grad_(True)
    tp = torch.from_numpy(p).requires_grad_(True)
    loss = fn(tq, tp)
    loss.backward()
    return float(loss.detach()), tq.grad.numpy(), tp.grad.numpy()


# tile-exact, two more stride shapes, Q not a multiple of the query tile (6 -> 8),
# P not a multiple of the passage tile (600 -> 608, stride 75)
@pytest.mark.parametrize("Q,P,H", [(8, 16, 64), (16, 16, 128), (8, 64, 64), (6, 12, 32),
                                   (8, 600, 32)])
def test_fused_loss_and_grads_match_jax(Q, P, H):
    q, p = _reps(Q, P, H, seed=Q + P + H)
    stride = P // Q
    ref, (jgq, jgp) = jax.value_and_grad(
        lambda a, b: jcon.fused_contrastive_loss(a, b, stride), argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(p))
    loss, gq, gp = _port_loss_and_grads(
        lambda a, b: tcon.fused_contrastive_loss(a, b, stride), q, p)
    np.testing.assert_allclose(loss, float(ref), rtol=1e-5)
    np.testing.assert_allclose(gq, np.asarray(jgq), atol=1e-5)
    np.testing.assert_allclose(gp, np.asarray(jgp), atol=1e-5)
    # CPU tensors never launch a kernel
    assert tcon.contrastive_fwd.launches == 0
    assert tcon.contrastive_bwd_dq.launches == tcon.contrastive_bwd_dp.launches == 0


def test_plain_kernel_versions_match_jax_kernels():
    """K3's plain version against the lse the Pallas forward saves, and K4's
    closed form (with an upstream scalar) against the Pallas backward."""
    q, p = _reps(6, 24, 32, seed=7)
    stride, gout = 4, 1.7
    _, jlse = jcon._fwd_impl(jnp.asarray(q), jnp.asarray(p), stride)
    lse, tgt = tcon._reference_contrastive_fwd(torch.from_numpy(q), torch.from_numpy(p), stride)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:6, 0], rtol=1e-6)
    np.testing.assert_allclose(tgt.numpy(), (q * p[::stride][:6]).sum(1), rtol=1e-5)
    jdq, jdp = jcon._vjp_bwd(stride, (jnp.asarray(q), jnp.asarray(p), jlse[:6]),
                             jnp.float32(gout))
    dq, dp = tcon._reference_contrastive_bwd(torch.from_numpy(q), torch.from_numpy(p), lse,
                                             stride, torch.tensor(gout))
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), atol=1e-5)
    np.testing.assert_allclose(dp.numpy(), np.asarray(jdp), atol=1e-5)


def test_upstream_scalar_scales_the_grads():
    q, p = _reps(4, 8, 16, seed=3)
    _, gq1, gp1 = _port_loss_and_grads(lambda a, b: tcon.fused_contrastive_loss(a, b, 2), q, p)
    _, gq3, gp3 = _port_loss_and_grads(
        lambda a, b: 3.0 * tcon.fused_contrastive_loss(a, b, 2), q, p)
    np.testing.assert_allclose(gq3, 3 * gq1, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gp3, 3 * gp1, rtol=1e-6, atol=1e-7)


def test_plain_contrastive_loss_matches_jax():
    q, p = _reps(5, 15, 32, seed=11)
    (jloss, jscores), (jgq, jgp) = jax.value_and_grad(
        jlosses.contrastive_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(q), jnp.asarray(p))
    tq = torch.from_numpy(q).requires_grad_(True)
    tp = torch.from_numpy(p).requires_grad_(True)
    loss, scores = tlosses.contrastive_loss(tq, tp)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(jscores), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgq), atol=1e-5)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), atol=1e-5)
    np.testing.assert_array_equal(tlosses.stride_targets(5, 15).numpy(),
                                  np.asarray(jlosses.stride_targets(5, 15)))


@pytest.mark.parametrize("Q,P", [(5, 12), (8, 16)])
def test_auto_dispatch(Q, P):
    """P % Q != 0: the plain loss with scores; stride form: fused, no scores."""
    q, p = _reps(Q, P, 64, seed=Q * P)
    jloss, jscores = jcon.contrastive_loss_auto(jnp.asarray(q), jnp.asarray(p))
    loss, scores = tcon.contrastive_loss_auto(torch.from_numpy(q), torch.from_numpy(p))
    assert (scores is None) == (jscores is None) == (P % Q == 0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_bad_stride_raises():
    q, p = _reps(4, 8, 16, seed=0)
    with pytest.raises(ValueError, match="outside P=8"):
        tcon.fused_contrastive_loss(torch.from_numpy(q), torch.from_numpy(p), 3)


@pytest.mark.parametrize("name", ["mr", "smr", "bce", "ce"])
@pytest.mark.parametrize("margin", [1.0, 0.3])
def test_rr_losses_match_jax(name, margin):
    rng = np.random.default_rng(5)
    shape = (6, 2) if name == "ce" else (6, 1)  # ce: 2-way [neg, pos] logits
    pos = rng.normal(size=shape).astype(np.float32)
    neg = rng.normal(size=shape).astype(np.float32)
    ref = jlosses.rr_loss_functions[name](jnp.asarray(pos), jnp.asarray(neg), margin)
    out = tlosses.rr_loss_functions[name](torch.from_numpy(pos), torch.from_numpy(neg), margin)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6, atol=1e-7)


# --- K4's tensor-core products (csrc/contrastive.cu), emulated ------------------------------

def _emulated_bwd(q, p, lse, stride, scheme):
    """dq, dp as K4's tensor-core body forms them, with test_torch_topk.py's split
    emulation: the scores' partial sums over four quarters of H (q and p each with one
    exponent, from their largest magnitude), added in fp32 in quarter order; g x 2^13 split
    with no further scale; the gradient products of the split operands summed in fp32, the
    scales taken back out."""
    from test_torch_topk import split_exp, split_matmul, split_pair

    n_q, H = q.shape
    e_q, e_p = split_exp(q.abs().amax()).reshape(1, 1), split_exp(p.abs().amax()).reshape(1, 1)
    s = torch.zeros(n_q, p.shape[0])
    for d in range(0, H, H // 4):
        s = s + split_matmul(q[:, d:d + H // 4], p[:, d:d + H // 4], scheme, e_q, e_p)
    rows = torch.arange(n_q)
    g = torch.exp(s - lse[:, None])
    g[rows, rows * stride] -= 1.0
    g = g * 8192.0
    zero = torch.zeros(1, 1, dtype=e_q.dtype)

    def grad(gm, walk, e_w):  # gm [own, walk] . walk [walk, H], scales taken out
        gh, gl = split_pair(gm, scheme, zero)
        wh, wl = split_pair(walk, scheme, e_w)
        out = gh @ wh + gh @ wl + gl @ wh
        return out / 8192.0 / n_q if scheme == "tf32" else torch.ldexp(out, -e_w) / 8192.0 / n_q

    return grad(g, p, e_p), grad(g.T.contiguous(), q, e_q)


@pytest.mark.parametrize("scheme", ["fp16", "tf32"])
@pytest.mark.parametrize("Q,P", [(32, 256), (64, 512)])
def test_split_products_hold_the_k4_bound(scheme, Q, P):
    """K4's split products, emulated at H = 768 on chip_smoke.py's data (0.3 N(0, 1)), stay
    within its bound: dq and dp within 2e-5 of max|grad| of the fp64 gradients and of the
    port's plain (fp32) version."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(0.3 * rng.normal(size=(Q, 768)).astype(np.float32))
    p = torch.from_numpy(0.3 * rng.normal(size=(P, 768)).astype(np.float32))
    stride = P // Q
    qd, pd = q.double(), p.double()
    lse = torch.logsumexp(qd @ pd.T, 1)
    gd = torch.exp(qd @ pd.T - lse[:, None])
    gd[torch.arange(Q), torch.arange(Q) * stride] -= 1.0
    exact = (gd @ pd / Q, gd.T @ qd / Q)
    plain = tcon._reference_contrastive_bwd(q, p, lse.float(), stride, 1.0)
    got = _emulated_bwd(q, p, lse.float(), stride, scheme)
    for g, e, pl in zip(got, exact, plain):
        bound = 2e-5 * float(e.abs().max())
        assert float((g.double() - e.double()).abs().max()) <= bound
        assert float((g.double() - pl.double()).abs().max()) <= bound


# --- K3's tensor-core products (csrc/contrastive.cu), emulated ------------------------------

def _emulated_fwd(q, p, stride, parts, tile=128):
    """lse, tgt as K3's tensor-core body forms them, with test_torch_topk.py's split
    emulation: q and p each scaled by one power of two (from its largest magnitude) and split
    into fp16 pairs; each 64-dim stage's three products summed in fp32, the stages' sums added
    in fp32 in stage order and scaled back; the passages in 128-column tiles, `parts` runs of
    them, each with an online log-sum-exp and target score; the parts merged in part order."""
    from test_torch_topk import split_exp, split_matmul

    n_q, H = q.shape
    e_q, e_p = split_exp(q.abs().amax()).reshape(1, 1), split_exp(p.abs().amax()).reshape(1, 1)
    s = torch.zeros(n_q, p.shape[0])
    for d in range(0, H, 64):  # scaled by powers of two, the fp32 sums round alike
        s = s + split_matmul(q[:, d:d + 64], p[:, d:d + 64], "fp16", e_q, e_p)
    rows = torch.arange(n_q)
    tgt_all = s[rows, rows * stride]
    n_tiles = -(-p.shape[0] // tile)
    per = -(-n_tiles // parts)
    ms, ls = [], []
    for part in range(parts):
        m = torch.full((n_q,), float("-inf"))
        l = torch.zeros(n_q)
        for t in range(part * per, min((part + 1) * per, n_tiles)):
            st = s[:, t * tile:(t + 1) * tile]
            mn = torch.maximum(m, st.amax(1))
            l = l * torch.exp(m - mn) + torch.exp(st - mn[:, None]).sum(1)
            m = mn
        ms.append(m)
        ls.append(l)
    M = torch.stack(ms).amax(0)
    L = sum(li * torch.exp(mi - M) for mi, li in zip(ms, ls))
    return torch.log(L) + M, tgt_all


@pytest.mark.parametrize("Q,P,parts", [(32, 256, 2), (64, 512, 4), (100, 700, 6)])
def test_split_products_hold_the_k3_bound(Q, P, parts):
    """K3's split products and its online log-sum-exp over 128-column tiles split into parts,
    emulated at H = 768 on chip_smoke.py's data (0.3 N(0, 1)), stay within the reference's
    1e-5: lse and tgt against the fp64 values and against the Pallas forward (interpret mode)
    of the JAX fused loss, and the loss against the JAX loss."""
    rng = np.random.default_rng(5)
    q = (0.3 * rng.normal(size=(Q, 768))).astype(np.float32)
    p = (0.3 * rng.normal(size=(P, 768))).astype(np.float32)
    stride = P // Q
    lse, tgt = _emulated_fwd(torch.from_numpy(q), torch.from_numpy(p), stride, parts)
    sd = torch.from_numpy(q).double() @ torch.from_numpy(p).double().T
    rows = torch.arange(Q)
    np.testing.assert_allclose(lse.double().numpy(), torch.logsumexp(sd, 1).numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tgt.double().numpy(), sd[rows, rows * stride].numpy(),
                               rtol=0, atol=1e-5)
    jloss, jlse = jcon._fwd_impl(jnp.asarray(q), jnp.asarray(p), stride)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:Q, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(float((lse - tgt).sum() / Q), float(jloss), rtol=1e-5)
