"""The torch port's BERT encoder and its K1/K2 plain versions vs the JAX reference.

Inputs and weights are made with numpy from a seed and fed to both packages.
On the CPU the port's fused path runs the kernels' plain versions; the JAX
fused path runs its Pallas kernels in interpret mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from denseretrievaltoolkits_tpu.models import bert as jbert
from denseretrievaltoolkits_tpu.ops import attn as jattn
from denseretrievaltoolkits_torch.models import bert as tbert
from denseretrievaltoolkits_torch.models.convert import (
    init_params_numpy,
    load_jax_params,
    params_from_jax,
)
from denseretrievaltoolkits_torch.ops import attn as tattn

CFG = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, max_position_embeddings=40)


def _tree(seed=0):
    """Seeded pytree with non-trivial biases and LayerNorm params."""
    tree = init_params_numpy(tbert.BertConfig(**CFG), seed)
    rng = np.random.default_rng(seed + 1)
    for group in tree.values():
        for name, arr in group.items():
            if "bias" in name or "ln_" in name:
                group[name] = (arr + 0.1 * rng.standard_normal(arr.shape)).astype(np.float32)
    return tree


def _inputs(B=4, S=16, seed=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, CFG["vocab_size"], (B, S)).astype(np.int32)
    mask = np.zeros((B, S), np.int32)
    for b, n in enumerate([S, 9, 3, 0][:B]):  # ragged, with one all-pad row
        mask[b, :n] = 1
    ids = np.where(mask == 1, ids, 0).astype(np.int32)
    return ids, mask


def _port(tree, attention, dtype=torch.float32):
    enc = tbert.BertEncoder(tbert.BertConfig(**CFG), dtype, attention)
    enc.load_state_dict(params_from_jax(tree))
    return enc


@pytest.mark.parametrize("attention", ["xla", "fused"])
def test_encoder_matches_jax_fp32(attention):
    """fp32 last_hidden_state within 2e-5 (the reference's own fused-vs-xla
    tolerance, tests/test_bert_parity.py:226). On the fused path the Pallas
    kernel's erf approximation (~1.5e-7 before LN) stays under it at F=128."""
    tree = _tree()
    ids, mask = _inputs()
    ref = jbert.bert_encode(jax.tree.map(jnp.asarray, tree), jbert.BertConfig(**CFG),
                            jnp.asarray(ids), jnp.asarray(mask), attention=attention)
    with torch.inference_mode():
        out = _port(tree, attention)(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    assert np.isfinite(out.numpy()).all()  # the all-pad row stays finite


def test_pooler_matches_jax():
    tree = _tree()
    ids, mask = _inputs()
    jp = jax.tree.map(jnp.asarray, tree)
    hidden = jbert.bert_encode(jp, jbert.BertConfig(**CFG), jnp.asarray(ids), jnp.asarray(mask))
    ref = jbert.bert_pooler(jp, hidden)
    enc = _port(tree, "xla")
    with torch.inference_mode():
        out = enc.pooler(torch.from_numpy(np.asarray(hidden)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def _block_inputs(B, S, H, F, seed, dtype):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    mask = np.ones((B, S), np.int32)
    mask[1, S // 2:] = 0
    mask[-1] = 0
    arrays = dict(qkv=f(B, S, 3 * H), x=f(B, S, H), ok=f(H, H, scale=0.05), ob=f(H, scale=0.05),
                  ls=1 + f(H, scale=0.1), lb=f(H, scale=0.1), wi=f(H, F, scale=0.05),
                  bi=f(F, scale=0.05), wo=f(F, H, scale=0.05), bo=f(H, scale=0.05))
    # round through the compute dtype once so both sides see identical values
    jx = {k: jnp.asarray(v).astype(dtype if k not in ("ls", "lb") else jnp.float32)
          for k, v in arrays.items()}
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tx = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
        tdt if k not in ("ls", "lb") else torch.float32) for k, v in jx.items()}
    return mask, jx, tx


# bf16: post-LN values are O(1); 3e-2 is two bf16 ulps at |y| < 4, and the mean
# bound catches systematic drift. fp32: summation order only.
TOL = {"bfloat16": (3e-2, 1e-3), "float32": (2e-5, 2e-6)}


# (B, S, nh, hd) of K1's plain-version checks: the first keeps its ids ("bfloat16",
# "float32"); then the serving path's S=156 at bert-base's hd (K1's Hopper body on
# the card) and S=257, one past that body's limit (the mma.sync body)
_K1_SHAPES = ((3, 20, 4, 16), (2, 156, 2, 64), (2, 257, 2, 64))


@pytest.mark.parametrize("dtype,shape", [
    pytest.param(dtype, shape, id=dtype if shape == _K1_SHAPES[0]
                 else f"{dtype}-B{shape[0]}-S{shape[1]}-nh{shape[2]}-hd{shape[3]}")
    for shape in _K1_SHAPES for dtype in ("bfloat16", "float32")])
def test_attention_ln_plain_matches_reference(dtype, shape):
    """K1's plain version vs the JAX ``_reference_attention_ln`` (residual
    added in fp32), the contract K1 is held to in bf16, on a ragged mask with an
    all-pad sequence (``_block_inputs``). Every row is compared: the reference
    pads nothing, so pad rows and the all-pad sequence (a uniform average over
    its S keys on both sides) agree like real rows."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    B, S, nh, hd = shape
    mask, j, t = _block_inputs(B, S, nh * hd, 128, 3, jdt)
    scale = 0.25 if hd == 16 else hd ** -0.5
    ref = jattn._reference_attention_ln(j["qkv"], j["x"], jnp.asarray(mask), j["ok"], j["ob"],
                                        j["ls"], j["lb"], scale, nh, hd, 1e-12)
    out = tattn.fused_attention_ln(t["qkv"], t["x"], torch.from_numpy(mask), t["ok"], t["ob"],
                                   t["ls"], t["lb"], scale, nh, hd, 1e-12)
    assert tattn.fused_attention_ln.launches == 0  # CPU tensors never launch
    d = np.abs(out.float().numpy() - np.asarray(ref.astype(jnp.float32)))
    assert d.max() <= TOL[dtype][0] and d.mean() <= TOL[dtype][1], (d.max(), d.mean())
    assert out.dtype == t["x"].dtype


@pytest.mark.parametrize("shape", _K1_SHAPES[:2])
def test_attention_ln_split_is_the_reference(shape):
    """K1's Hopper body splits the block in two launches: attention with ctx
    rounded to bf16 (stage A), then K2's second stage with depth H (stage B).
    As plain PyTorch, K2's stage-B version (``_reference_ln_stage``, which K2's
    plain version ends with) fed stage A's ctx is bit-equal to
    ``_reference_attention_ln``: running K1's projection and LayerNorm on K2's
    stage changes no rounding."""
    B, S, nh, hd = shape
    H = nh * hd
    mask, _, t = _block_inputs(B, S, H, 128, 4, jnp.bfloat16)
    mask = torch.from_numpy(mask)
    ctx = tattn._reference_attention(t["qkv"], mask, hd ** -0.5, nh, hd)
    assert ctx.dtype == torch.bfloat16
    split = tattn._reference_ln_stage(t["x"], ctx, t["ok"], t["ob"], t["ls"], t["lb"], 1e-12)
    ref = tattn._reference_attention_ln(t["qkv"], t["x"], mask, t["ok"], t["ob"], t["ls"],
                                        t["lb"], hd ** -0.5, nh, hd, 1e-12)
    assert torch.equal(split, ref)


@pytest.mark.parametrize("dtype,F", [("bfloat16", 128), ("float32", 128), ("float32", 1536)])
def test_mlp_ln_plain_matches_reference(dtype, F):
    """K2's plain version vs the JAX ``_reference_mlp_ln`` (exact gelu), also
    at a chunked width F=1536 where the Pallas kernel's erf approximation
    would exceed the fp32 tolerance."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    mask, j, t = _block_inputs(2, 12, 64, F, 4, jdt)
    ref = jattn._reference_mlp_ln(j["x"], j["wi"], j["bi"], j["wo"], j["bo"], j["ls"], j["lb"],
                                  1e-12)
    out = tattn.fused_mlp_ln(t["x"], t["wi"], t["bi"], t["wo"], t["bo"], t["ls"], t["lb"], 1e-12)
    assert tattn.fused_mlp_ln.launches == 0
    d = np.abs(out.float().numpy() - np.asarray(ref.astype(jnp.float32)))
    assert d.max() <= TOL[dtype][0] and d.mean() <= TOL[dtype][1], (d.max(), d.mean())


@pytest.mark.parametrize("rows,H,F", [
    (1, 768, 3072), (50, 768, 3072), (1024, 768, 3072), (2048, 768, 3072),
    (2048 + 17, 768, 3072), (9984, 768, 3072), (32768, 768, 3072), (50, 128, 320),
    (2048 + 17, 128, 320), (300, 1024, 4096), (5000, 256, 64), (700, 512, 1024)])
def test_mlp_ln_plan(rows, H, F):
    """K2's launch plan (the wgmma body): each stage's grid covers every row and
    column once, stage B's cluster spans H, and a stage takes 128-row tiles
    exactly where they leave at most half of the SMs without a CTA."""
    plan = tattn.mlp_ln_plan(rows, H, F)
    assert plan["bn_b"] == (128 if H == 128 else 256)
    assert plan["bn_b"] * plan["cluster"] == H and 1 <= plan["cluster"] <= 4
    assert plan["scratch"] == (rows, F)
    assert plan["bn_a"] == 128
    for stage, col_tiles in (("a", -(-F // plan["bn_a"])), ("b", plan["cluster"])):
        bm, (gx, gy) = plan["bm_" + stage], plan["grid_" + stage]
        assert bm in (64, 128) and gx == col_tiles
        assert (gy - 1) * bm < rows <= gy * bm
        assert (bm == 128) == (-(-rows // 128) * col_tiles >= tattn.H100_SMS / 2)


def test_mlp_ln_plan_bodies():
    """Where the plan sends K2: the serving path's shape to 128-row tiles and
    clusters of three; the CUDA-core body (no plan) for float32, widths off
    64 * {2, 4, 8, 12, 16}, F % 64 != 0, unaligned operands and no rows; the
    tile rows follow the card's SM count."""
    assert tattn.mlp_ln_plan(9984, 768, 3072) == {
        "bm_a": 128, "bn_a": 128, "grid_a": (24, 78), "bm_b": 128, "bn_b": 256, "cluster": 3,
        "grid_b": (3, 78), "scratch": (9984, 3072)}
    plan = tattn.mlp_ln_plan(2048, 768, 3072)  # the query tower: stage B on 64-row tiles
    assert (plan["bm_a"], plan["bm_b"], plan["grid_b"]) == (128, 64, (3, 32))
    for args in ((50, 768, 3072, torch.float32), (50, 96, 600), (50, 640, 2560),
                 (50, 1536, 6144), (50, 768, 3000), (50, 768, 32), (0, 768, 3072)):
        assert tattn.mlp_ln_plan(*args) is None, args
    assert tattn.mlp_ln_plan(50, 768, 3072, aligned=False) is None
    assert tattn.mlp_ln_plan(1024, 768, 3072)["bm_a"] == 128
    assert tattn.mlp_ln_plan(2048, 768, 3072, sms=96)["bm_b"] == 128


# (B, S, H, nh, hd, dtype, aligned): bert-base's passages at every S around the Hopper
# body's limit of 256 keys, then what keeps the older bodies: float32, hd 32, H 1088
# (17 heads: no wgmma width) and unaligned operands; H 1024 (clusters of four) and hd
# 128 take the Hopper body
_ATTN_PLAN_CASES = [(64, S, 768, 12, 64, torch.bfloat16, True)
                    for S in (1, 32, 128, 156, 256, 257, 512)] + [
    (64, 156, 768, 12, 64, torch.float32, True), (64, 156, 768, 24, 32, torch.bfloat16, True),
    (64, 156, 1024, 16, 64, torch.bfloat16, True), (64, 156, 1088, 17, 64, torch.bfloat16, True),
    (64, 156, 768, 12, 64, torch.bfloat16, False), (8, 200, 768, 6, 128, torch.bfloat16, True)]


@pytest.mark.parametrize("B,S,H,nh,hd,dtype,aligned", _ATTN_PLAN_CASES)
def test_attn_ln_plan(B, S, H, nh, hd, dtype, aligned):
    """K1's launch plan: the Hopper body exactly for bf16 at hd 64 / 128, H in
    64 * {2, 4, 8, 12, 16}, S <= 256 and aligned operands (else None: the
    mma.sync or CUDA-core body); stage A's grid is one CTA a (sequence, head),
    its query tiles cover S once with at most 256 keys, the scratch holds ctx
    for every row, and stage B is K2's stage B planned at depth H."""
    plan = tattn.attn_ln_plan(B, S, H, nh, hd, dtype, aligned)
    hopper = (dtype == torch.bfloat16 and hd in (64, 128) and H in (128, 256, 512, 768, 1024)
              and S <= tattn.ATTN_LN_MAX_S and aligned)
    assert (plan is not None) == hopper
    assert tattn.ATTN_LN_MAX_S == 256
    if plan is None:
        return
    assert plan["grid_a"] == (nh, B) and plan["bm_a"] == 64
    assert (plan["q_tiles"] - 1) * 64 < S <= plan["q_tiles"] * 64 <= 256
    assert plan["scratch"] == (B * S, H)
    stage_b = tattn.mlp_ln_plan(B * S, H, H)
    assert {k: plan[k] for k in ("bm_b", "bn_b", "cluster", "grid_b")} == {
        k: stage_b[k] for k in ("bm_b", "bn_b", "cluster", "grid_b")}
    if (B, S, H) == (64, 156, 768):  # the serving path's passages
        assert plan == {"grid_a": (12, 64), "bm_a": 64, "q_tiles": 3, "scratch": (9984, 768),
                        "bm_b": 128, "bn_b": 256, "cluster": 3, "grid_b": (3, 78)}


def test_fused_bf16_encoder_tracks_xla_bf16():
    """bf16 end to end: the fused and xla paths add the residual in different
    precisions (bert.py:223-226), so they agree only to bf16 noise."""
    tree = _tree()
    ids, mask = _inputs()
    with torch.inference_mode():
        args = (torch.from_numpy(ids).long(), torch.from_numpy(mask))
        fused = _port(tree, "fused", torch.bfloat16)(*args).float()
        xla = _port(tree, "xla", torch.bfloat16)(*args).float()
    real = torch.from_numpy(mask).bool()
    assert torch.isfinite(fused).all()
    assert (fused - xla)[real].abs().mean() < 3e-2


def test_load_jax_params_roundtrip(tmp_path):
    tree = _tree()
    jbert.save_params(jax.tree.map(jnp.asarray, tree), str(tmp_path))
    back = load_jax_params(str(tmp_path))
    sd_a, sd_b = params_from_jax(tree), params_from_jax(back)
    assert sd_a.keys() == sd_b.keys()
    for k in sd_a:
        torch.testing.assert_close(sd_a[k], sd_b[k], rtol=0, atol=0)


def test_flash_and_lora_raise():
    """attention='flash' builds (its kernels are ported, tests/test_torch_flash.py);
    an unknown attention raises. LoRA adapters load (tests/test_torch_lora.py), but
    an incomplete set of their four leaves raises, and so does an unknown leaf."""
    assert tbert.BertEncoder(tbert.BertConfig(**CFG), attention="flash").attention == "flash"
    with pytest.raises(ValueError, match="Unknown attention"):
        tbert.BertEncoder(tbert.BertConfig(**CFG), attention="splash")
    tree = _tree()
    tree["layers"]["lora_q_A"] = np.zeros((2, 64, 4), np.float32)
    with pytest.raises(ValueError, match="LoRA"):
        params_from_jax(tree)
    tree["layers"].update(lora_q_B=np.zeros((2, 4, 64), np.float32),
                          lora_v_A=np.zeros((2, 64, 4), np.float32),
                          lora_v_B=np.zeros((2, 4, 64), np.float32))
    assert params_from_jax(tree)["layers.1.lora_v_B"].shape == (4, 64)
    tree["layers"]["prefix_kernel"] = np.zeros((2, 64), np.float32)
    with pytest.raises(NotImplementedError, match="prefix_kernel"):
        params_from_jax(tree)
