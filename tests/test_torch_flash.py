"""The torch port's flash attention and K18 vs the JAX reference, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The JAX side
runs the stock Pallas flash kernel that ``models/bert.py:_flash_attention``
calls, in interpret mode (``force_tpu_interpret_mode``), and K18 through its
own interpret path; on the CPU the port's wrappers run their plain versions.

The reference pads S to a multiple of 128 with segment id 0, so its pad
queries also average the zero padding keys: real rows are compared, pad rows
only checked finite.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from denseretrievaltoolkits_tpu.config import ModelArguments, TrainingArguments
from denseretrievaltoolkits_tpu.data.collators import pad_batch
from denseretrievaltoolkits_tpu.models import bert as jbert
from denseretrievaltoolkits_tpu.ops import attn as jattn
from denseretrievaltoolkits_torch.models import bert as tbert
from denseretrievaltoolkits_torch.models import biencoder as tbi
from denseretrievaltoolkits_torch.models.convert import init_params_numpy, params_from_jax
from denseretrievaltoolkits_torch.ops import attn as tattn
from denseretrievaltoolkits_torch.ops import flash
from denseretrievaltoolkits_torch.train.trainer import Trainer

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mask(B, S):
    """Ragged 0/1 mask: a full row, a half row, and the last sequence all padding."""
    mask = np.ones((B, S), np.int32)
    mask[1, S // 2:] = 0
    mask[-1] = 0
    return mask


def _qkv(shape, dtype, seed):
    """q, k, v rounded through ``dtype`` once, as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    j = [jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(JDT[dtype])
         for _ in range(3)]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(TDT[dtype]) for x in j]
    return j, t


def _bf16_tol(ref):
    """Two bf16 ulps at the largest |value| of ``ref``."""
    return 2.0 * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _stock_flash(q, k, v, mask, hd):
    with pltpu.force_tpu_interpret_mode():
        return jbert._flash_attention(q, k, v, jnp.asarray(mask), hd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [37, 150])
@pytest.mark.parametrize("hd", [16, 64])
def test_flash_forward_matches_stock_kernel(dtype, S, hd):
    """Real rows within 2e-5 (fp32: summation order) or two bf16 ulps at the
    output's scale (the stock kernel rounds exp(s - m) before normalizing, the
    port the normalized probabilities); pad rows finite."""
    B, nh = 3, 2
    mask = _mask(B, S)
    (jq, jk, jv), (tq, tk, tv) = _qkv((B, S, nh, hd), dtype, seed=S + hd)
    ref = np.asarray(_stock_flash(jq, jk, jv, mask, hd).astype(jnp.float32))
    n = flash.flash_fwd.launches
    out = flash.flash_attention(tq, tk, tv, torch.from_numpy(mask), hd)
    assert flash.flash_fwd.launches == n  # CPU tensors never launch
    assert out.dtype == TDT[dtype] and out.shape == (B, S, nh, hd)
    out = out.float().numpy()
    real = mask.astype(bool)
    tol = 2e-5 if dtype == "float32" else _bf16_tol(ref[real])
    np.testing.assert_allclose(out[real], ref[real], rtol=0, atol=tol)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("S", [37, 150])
def test_flash_gradients_match_stock_kernel(S):
    """dq, dk, dv (fp32) vs ``jax.grad`` through the stock kernel's VJP (its
    dK/dV and dQ kernels) within 1e-4, under a cotangent that is zero on pad
    rows: then pad rows contribute nothing on either side, and the gradients
    agree on every row."""
    B, nh, hd = 3, 2, 16
    mask = _mask(B, S)
    (jq, jk, jv), (tq, tk, tv) = _qkv((B, S, nh, hd), "float32", seed=7)
    rng = np.random.default_rng(8)
    cot = (rng.standard_normal((B, S, nh, hd)) * mask[:, :, None, None]).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(lambda q, k, v: jnp.sum(jbert._flash_attention(
            q, k, v, jnp.asarray(mask), hd) * cot), argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = flash.flash_attention(*leaves, torch.from_numpy(mask), hd)
    (out * torch.from_numpy(cot)).sum().backward()
    for name, got, ref in zip("qkv", leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), rtol=0, atol=1e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_dq_returns_stock_d(dtype):
    """The dQ wrapper's plain path computes D = rowsum(dO * O) by the stock VJP's
    formula (flash_attention.py:273-275, run here by JAX on the same numpy inputs in
    the stock kernel's [B, nh, S, hd] layout): equal up to summation order. It
    returns D, writes dq as ``_reference_flash_bwd_dq`` does with that D, and leaves
    the rest of the gradient alone."""
    B, S, nh, hd = 3, 37, 2, 16
    mask = _mask(B, S)
    seg = torch.from_numpy(mask)
    (_, _, _), (tq, tk, tv) = _qkv((B, S, nh, hd), dtype, seed=11)
    rng = np.random.default_rng(12)
    jo, jdo = (jnp.asarray(rng.standard_normal((B, S, nh, hd)).astype(np.float32)).astype(JDT[dtype])
               for _ in range(2))
    to, tdo = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(TDT[dtype]) for x in (jo, jdo))
    o_t, do_t = (jnp.transpose(x, (0, 2, 1, 3)) for x in (jo, jdo))
    want = np.asarray(jnp.sum(o_t.astype(jnp.float32) * do_t.astype(jnp.float32), axis=-1))
    scale = hd ** -0.5
    _, lse = flash.flash_fwd(tq, tk, tv, seg, scale)
    dqkv = torch.full((B, S, 3, nh, hd), 7.0, dtype=TDT[dtype])
    n = flash.flash_bwd_dq.launches
    D = flash.flash_bwd_dq(tq, tk, tv, seg, lse, tdo, to, scale, dqkv)
    assert flash.flash_bwd_dq.launches == n  # CPU tensors never launch
    assert D.dtype == torch.float32 and D.shape == (B, nh, S) and D.is_contiguous()
    np.testing.assert_allclose(D.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    want_dq = flash._reference_flash_bwd_dq(tq, tk, tv, seg, lse, tdo, D, scale)
    torch.testing.assert_close(dqkv[:, :, 0], want_dq, rtol=0, atol=0)
    assert bool((dqkv[:, :, 1:] == 7).all())


def test_flash_reads_qkv_views_and_writes_one_gradient():
    """``flash_attention_qkv`` over one [B,S,3H] tensor: the same output as
    ``flash_attention`` on contiguous copies of its q, k and v views, and one
    [B,S,3H] gradient, handed straight to qkv (no slice backwards between),
    whose thirds are dq, dk, dv."""
    B, S, nh, hd = 2, 21, 3, 8
    H = nh * hd
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((B, S, 3 * H)).astype(np.float32))
    mask = torch.from_numpy(_mask(B, S))
    qkv.requires_grad_(True)
    out = flash.flash_attention_qkv(qkv, mask, nh, hd)
    assert out.grad_fn.next_functions[0][0].variable is qkv
    cot = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    (out * cot).sum().backward()
    copies = [t.detach().clone().requires_grad_(True) for t in flash.split_qkv(qkv, nh, hd)]
    want = flash.flash_attention(*copies, mask, hd)
    (want * cot).sum().backward()
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)
    got = qkv.grad.view(B, S, 3, nh, hd)
    for i, c in enumerate(copies):
        torch.testing.assert_close(got[:, :, i], c.grad, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype,S,all_pad", [("float32", 48, True), ("bfloat16", 48, True),
                                             ("float32", 37, False)])
def test_fused_qkv_attention_matches_jax_k18(dtype, S, all_pad):
    """K18 vs the JAX ``fused_qkv_attention`` (Pallas K18, interpret), values and
    qkv gradients on every row. The Pallas kernel pads S to 8 (fp32) / 16
    (bf16) rows biased -1e9, which only an all-pad sequence sees: S=48 pads
    nothing and carries one, S=37 pads and carries none."""
    B, nh, hd = 3, 2, 16
    H = nh * hd
    mask = _mask(B, S)
    if not all_pad:
        mask[-1, :5] = 1
    rng = np.random.default_rng(S)
    jqkv = jnp.asarray(rng.standard_normal((B, S, 3 * H)).astype(np.float32)).astype(JDT[dtype])
    tqkv = torch.from_numpy(np.array(jqkv.astype(jnp.float32))).to(TDT[dtype])
    cot = rng.standard_normal((B, S, H)).astype(np.float32)
    scale = 1.0 / np.sqrt(hd)
    ref, vjp = jax.vjp(lambda t: jattn.fused_qkv_attention(t, jnp.asarray(mask), scale, nh, hd),
                       jqkv)
    (ref_g,) = vjp(jnp.asarray(cot).astype(JDT[dtype]))
    leaf = tqkv.clone().requires_grad_(True)
    n = tattn.fused_qkv_attention.launches
    out = tattn.fused_qkv_attention(leaf, torch.from_numpy(mask), scale, nh, hd)
    assert tattn.fused_qkv_attention.launches == n
    out.backward(torch.from_numpy(cot).to(TDT[dtype]))
    ref, ref_g = (np.asarray(x.astype(jnp.float32)) for x in (ref, ref_g))
    got, got_g = out.detach().float().numpy(), leaf.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
        np.testing.assert_allclose(got_g, ref_g, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=_bf16_tol(ref))
        np.testing.assert_allclose(got_g, ref_g, rtol=0, atol=_bf16_tol(ref_g))


CFG = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, max_position_embeddings=40)


def test_encoder_flash_matches_jax_on_real_rows():
    """``BertEncoder(attention='flash')`` (fp32) vs ``bert_encode``, which runs
    'flash' as 'xla' off the TPU, on real rows within 2e-5; every row finite."""
    tree = init_params_numpy(tbert.BertConfig(**CFG), 0)
    rng = np.random.default_rng(1)
    for group in tree.values():
        for name, arr in group.items():
            if "bias" in name or "ln_" in name:
                group[name] = (arr + 0.1 * rng.standard_normal(arr.shape)).astype(np.float32)
    B, S = 4, 33
    mask = np.zeros((B, S), np.int32)
    for b, n in enumerate([S, 17, 4, 0]):
        mask[b, :n] = 1
    ids = np.where(mask == 1, rng.integers(1, CFG["vocab_size"], (B, S)), 0).astype(np.int32)
    ref = jbert.bert_encode(jax.tree.map(jnp.asarray, tree), jbert.BertConfig(**CFG),
                            jnp.asarray(ids), jnp.asarray(mask), attention="flash")
    enc = tbert.BertEncoder(tbert.BertConfig(**CFG), torch.float32, "flash")
    enc.load_state_dict(params_from_jax(tree))
    with torch.inference_mode():
        out = enc(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    real = mask.astype(bool)
    np.testing.assert_allclose(out[real], np.asarray(ref)[real], rtol=2e-5, atol=2e-5)
    assert np.isfinite(out).all()


def test_trainer_step_flash_equals_xla(tmp_path):
    """One ``Trainer`` step (fp32, sgd) with attention='flash' equals the same
    step with 'xla' from the same weights: loss within 1e-5 relative, every
    parameter after the update within 1e-6 (the two differ only in pad rows,
    which the CLS pooling never reads, and in fp32 summation order). SGD keeps
    the update linear in the gradient: Adam's first step would blow up the
    summation noise of gradients that are zero in exact arithmetic (the k
    bias, which shifts a row's scores by a constant)."""
    cfg = tbert.BertConfig(vocab_size=61, hidden_size=32, num_hidden_layers=2,
                           num_attention_heads=4, intermediate_size=64,
                           max_position_embeddings=24)
    rng = np.random.default_rng(4)
    seqs = lambda n, lo, hi: [rng.integers(1, 61, int(rng.integers(lo, hi))).tolist()  # noqa
                              for _ in range(n)]
    batch = (pad_batch(seqs(4, 2, 8), 8, 0), pad_batch(seqs(8, 3, 16), 16, 0))
    models, losses = {}, {}
    for attention in ("xla", "flash"):
        model = tbi.DRModel.build(ModelArguments(attention=attention, pooling="first"),
                                  bert_config=cfg, seed=5, device="cpu")
        targs = TrainingArguments(output_dir=str(tmp_path / attention), train_batch_size=4,
                                  learning_rate=1e-2, optimizer="sgd", max_epochs=1)
        losses[attention] = float(Trainer(targs, model).train_step(batch))
        models[attention] = model
    np.testing.assert_allclose(losses["flash"], losses["xla"], rtol=1e-5)
    want = dict(models["xla"].named_parameters())
    for name, prm in models["flash"].named_parameters():
        torch.testing.assert_close(prm, want[name], rtol=0, atol=1e-6, msg=name)


def _tile_masks(S, seed):
    """0/1 masks [6, S]: a prefix, a non-prefix random one, all real, all pad, runs of
    40 alternating, and a prefix of one key."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((6, S), np.int32)
    mask[0, :rng.integers(1, S + 1)] = 1
    mask[1] = rng.integers(0, 2, S)
    mask[2] = 1
    mask[4] = (np.arange(S) // 40) % 2
    mask[5, 0] = 1
    return mask


def _per_tile(x, bm, bn):
    """any() of a bool [B, S, S] over each (bm x bn) tile: [B, ceil(S/bm), ceil(S/bn)]."""
    B, S, _ = x.shape
    nq, nk = -(-S // bm), -(-S // bn)
    pad = torch.nn.functional.pad(x, (0, nk * bn - S, 0, nq * bm - S))
    return pad.view(B, nq, bm, nk, bn).any(4).any(2)


# (row tile, column tile) of the kernels: the forward's and dQ's 64 x 64 and 128 x 64
# (query rows x keys); dK/dV's 128 x 64 (key rows x queries, the same call, the rule
# being symmetric) and its transpose 64 x 128
TILE_SHAPES = pytest.mark.parametrize("bm,bn", [(64, 64), (128, 64), (64, 128)],
                                      ids=["64", "128", "64x128"])


@pytest.mark.parametrize("S", [1, 63, 64, 65, 156, 513])
@TILE_SHAPES
def test_visible_tiles_segment_mode(S, bm, bn):
    """Segment mode: a pair of tiles the helper leaves out is all -inf in
    ``_scores``, and every pair holding a visible score is marked visible (on 0/1
    masks the two coincide); the rule is symmetric in rows and columns, so the
    transposed call gives the transposed pairs."""
    mask = torch.from_numpy(_tile_masks(S, seed=S + bm))
    rng = np.random.default_rng(S)
    q, k = (torch.from_numpy(rng.standard_normal((6, S, 2, 8)).astype(np.float32))
            for _ in range(2))
    vis = flash._visible_tiles(mask, bm, bn, bias=False)
    assert vis.shape == (6, -(-S // bm), -(-S // bn)) and vis.dtype == torch.bool
    seen = torch.isfinite(flash._scores(q, k, mask, 0.35)).any(1)  # [B, S, S] over heads
    assert torch.equal(_per_tile(seen, bm, bn), vis)
    assert torch.equal(flash._visible_tiles(mask, bn, bm, bias=False).transpose(1, 2), vis)
    assert vis[2].all() and vis[3].all()  # one segment: nothing to skip


@pytest.mark.parametrize("S", [1, 63, 64, 65, 156, 513])
@TILE_SHAPES
def test_visible_tiles_bias_mode(S, bm, bn):
    """Bias mode: the keys of a tile the helper leaves out contribute exactly 0 to
    ``_reference_attention`` (their values changed, the output keeps every bit),
    every pair holding a probability above 0 is marked visible, and an all-pad
    sequence skips nothing."""
    mask = _tile_masks(S, seed=S + bm)
    B, nh, hd = mask.shape[0], 2, 8
    H = nh * hd
    rng = np.random.default_rng(S + 1)
    qkv = torch.from_numpy(rng.standard_normal((B, S, 3 * H)).astype(np.float32))
    tmask = torch.from_numpy(mask)
    vis = flash._visible_tiles(tmask, bm, bn, bias=True)
    assert vis[3].all()
    skipped = ~vis.any(1)  # [B, key tiles]: invisible to every query tile alike
    assert torch.equal(vis, ~skipped[:, None, :].expand_as(vis))
    keys = skipped.repeat_interleave(bn, dim=1)[:, :S]  # [B, S]
    assert not (keys & tmask.bool()).any()
    moved = qkv.clone()
    moved[..., 2 * H:][keys] = torch.from_numpy(
        1e4 * rng.standard_normal((int(keys.sum()), H)).astype(np.float32))
    ref = tattn._reference_attention(qkv, tmask, 0.35, nh, hd)
    assert torch.equal(tattn._reference_attention(moved, tmask, 0.35, nh, hd), ref)
    s = torch.einsum("bqhd,bkhd->bhqk", *(qkv[..., i * H:(i + 1) * H].view(B, S, nh, hd)
                                          for i in range(2))) * 0.35
    p = torch.softmax(s + (1.0 - tmask.float())[:, None, None, :] * -1e9, -1)
    assert not (_per_tile((p > 0).any(1), bm, bn) & ~vis).any()
