"""The port's LoRA adapters against the JAX package's, on the CPU.

Weights are made with numpy from a seed; the JAX package's adapters
(``models/lora.py:add_lora``, then non-zero B) are carried into the port by
``params_from_jax`` and back by ``params_to_jax``, so both run the same
numbers. fp32 within 2e-5 (``tests/test_bert_parity.py:226``); bf16 within two
bf16 ulps and, on the mean, 1.1x the base towers' own gap. Training: the trainer trajectory's
tolerances of ``tests/test_torch_train.py``; the frozen base bit-unchanged. T5 towers
take ``add_lora_t5``'s adapters on the encoder's q and v; the reference has no T5 merge
or export, so the port's raise.
"""

import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from denseretrievaltoolkits_tpu.config import ModelArguments, TrainingArguments
from denseretrievaltoolkits_tpu.models import bert as jbert
from denseretrievaltoolkits_tpu.models import biencoder as jbi
from denseretrievaltoolkits_tpu.models import lora as jlora
from denseretrievaltoolkits_tpu.models import t5 as jt5
from denseretrievaltoolkits_tpu.train.trainer import Trainer as JaxTrainer
from denseretrievaltoolkits_torch.data.collators import pad_batch
from denseretrievaltoolkits_torch.data.loaders import DataLoader
from denseretrievaltoolkits_torch.models import bert as tbert
from denseretrievaltoolkits_torch.models import biencoder as tbi
from denseretrievaltoolkits_torch.models import lora as tlora
from denseretrievaltoolkits_torch.models import t5 as tt5
from denseretrievaltoolkits_torch.models.convert import (
    init_params_numpy,
    params_from_jax,
    params_to_jax,
)
from denseretrievaltoolkits_torch.ops import attn as tattn
from denseretrievaltoolkits_torch.train.trainer import Trainer

CFG = dict(vocab_size=61, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=64, max_position_embeddings=24)
RANK = 4


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(n, S, seed):
    """Ragged token batch: lengths 2..S, pad id 0."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, CFG["vocab_size"], (n, S)).astype(np.int32)
    lens = rng.integers(2, S + 1, n)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    return {"input_ids": np.where(mask == 1, ids, 0).astype(np.int32), "attention_mask": mask}


def _adapted_tree(seed=0, b_scale=0.3):
    """A seeded base tree with the JAX package's adapters, B made non-zero."""
    base = jax.tree.map(jnp.asarray, init_params_numpy(tbert.BertConfig(**CFG), seed))
    tree = jax.tree.map(np.asarray, jlora.add_lora(base, jax.random.key(seed + 1), rank=RANK))
    rng = np.random.default_rng(seed + 2)
    for name in ("lora_q_B", "lora_v_B"):
        tree["layers"][name] = (b_scale * rng.standard_normal(tree["layers"][name].shape)
                                ).astype(np.float32)
    return tree


def _port_tower(tree, attention="xla", dtype=torch.float32):
    enc = tbert.BertEncoder(tbert.BertConfig(**CFG), dtype, attention)
    if "lora_q_A" in tree["layers"]:
        tlora.add_lora_shaped(enc, RANK)
    enc.load_state_dict(params_from_jax(tree))
    return enc


def _encode(enc, batch):
    with torch.inference_mode():
        return enc(torch.from_numpy(batch["input_ids"]).long(),
                   torch.from_numpy(batch["attention_mask"])).float().numpy()


def test_init_is_identity():
    """B = 0: the adapted tower equals its base exactly, on the port's own draws
    (A ~ N(0, 1) H^-0.5) and with JAX's carried across."""
    tree = init_params_numpy(tbert.BertConfig(**CFG), 3)
    batch = _batch(4, 12, 1)
    base = _encode(_port_tower(tree), batch)
    adapted = tlora.add_lora(_port_tower(tree), RANK, seed=7)
    assert tlora.has_lora(adapted)
    a = adapted.layers[1].lora_q_A.detach().numpy()
    assert a.shape == (32, RANK) and abs(a.std() * 32 ** 0.5 - 1) < 0.2
    assert not adapted.layers[0].lora_v_B.detach().any()
    np.testing.assert_array_equal(_encode(adapted, batch), base)
    jtree = _adapted_tree(3, b_scale=0.0)
    np.testing.assert_array_equal(_encode(_port_tower(jtree), batch),
                                  _encode(_port_tower(jax.tree.map(np.asarray, init_params_numpy(
                                      tbert.BertConfig(**CFG), 3))), batch))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attention", ["xla", "fused"])
def test_adapted_tower_matches_jax(dtype, attention):
    """Non-zero B against JAX ``bert_encode`` of the same tree. On 'fused' both run
    the xla block on their LoRA layers."""
    tree = _adapted_tree()
    batch = _batch(4, 12, 2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.asarray(jbert.bert_encode(jax.tree.map(jnp.asarray, tree), jbert.BertConfig(**CFG),
                                       jnp.asarray(batch["input_ids"]),
                                       jnp.asarray(batch["attention_mask"]), compute_dtype=jdt,
                                       attention=attention).astype(jnp.float32))
    out = _encode(_port_tower(tree, attention, getattr(torch, dtype)), batch)
    base_tree = init_params_numpy(tbert.BertConfig(**CFG), 0)
    # the base towers on 'xla', the block the adapted layers run on 'fused' too
    base = _encode(_port_tower(base_tree, "xla", getattr(torch, dtype)), batch)
    assert np.abs(out - base).max() > 0.1  # the adapters moved the output
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
        return
    # bf16: each element within two bf16 ulps (2^-5 below |y| = 4, |y| 2^-6 above), and
    # the mean gap within 1.1x the base tower's own (the two packages' bf16 encoders
    # already differ by up to 2^-5 and ~3e-3 on the mean without adapters)
    base_ref = np.asarray(jbert.bert_encode(
        jax.tree.map(jnp.asarray, base_tree), jbert.BertConfig(**CFG),
        jnp.asarray(batch["input_ids"]), jnp.asarray(batch["attention_mask"]),
        compute_dtype=jdt).astype(jnp.float32))
    gap = np.abs(out - ref)
    assert (gap <= np.maximum(2 ** -5, np.abs(ref) * 2 ** -6)).all()
    assert gap.mean() <= 1.1 * np.abs(base - base_ref).mean()


def test_flash_tower_takes_the_adapted_qkv():
    """On 'flash' the adapted qkv goes into ``flash_attention_qkv``: real rows equal JAX
    ``bert_encode`` (which runs 'flash' as 'xla' off the TPU) within 2e-5; pad rows stay
    finite (tests/test_torch_flash.py)."""
    tree = _adapted_tree(6)
    batch = _batch(4, 12, 7)
    ref = np.asarray(jbert.bert_encode(jax.tree.map(jnp.asarray, tree), jbert.BertConfig(**CFG),
                                       jnp.asarray(batch["input_ids"]),
                                       jnp.asarray(batch["attention_mask"]), attention="flash"))
    out = _encode(_port_tower(tree, "flash"), batch)
    real = batch["attention_mask"] == 1
    np.testing.assert_allclose(out[real], ref[real], rtol=2e-5, atol=2e-5)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("remat", ["full", "attn"])
def test_remat_with_adapters(remat):
    """``remat`` recomputes the adapted blocks: the adapters' gradients equal those
    without remat (fp32, the same operations: within 1e-6)."""
    tree = _adapted_tree(8)
    batch = _batch(4, 10, 9)
    grads = []
    for r in ("", remat):
        enc = _port_tower(tree, "xla")
        enc.remat = r
        out = enc(torch.from_numpy(batch["input_ids"]).long(),
                  torch.from_numpy(batch["attention_mask"]))
        out.square().sum().backward()
        grads.append({n: p.grad for n, p in enc.named_parameters() if "lora_" in n})
    assert len(grads[0]) == 4 * CFG["num_hidden_layers"]
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=1e-6, atol=1e-6)


def test_lora_layer_never_takes_the_fused_kernels(monkeypatch):
    """On 'fused' a LoRA layer runs the xla block (bert.py:215 there): K1 and K2 are
    called 0 times and the output equals the 'xla' tower's exactly. Merged, the same
    layers call each once a layer, and agree with the adapted tower within 2e-5."""
    calls = {"k1": 0, "k2": 0}

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(tattn, "fused_attention_ln", counted("k1", tattn.fused_attention_ln))
    monkeypatch.setattr(tattn, "fused_mlp_ln", counted("k2", tattn.fused_mlp_ln))
    tree = _adapted_tree(4)
    batch = _batch(5, 14, 3)
    fused = _port_tower(tree, "fused")
    out = _encode(fused, batch)
    assert calls == {"k1": 0, "k2": 0}
    np.testing.assert_array_equal(out, _encode(_port_tower(tree, "xla"), batch))
    tlora.merge_lora(fused)
    assert not tlora.has_lora(fused)
    merged = _encode(fused, batch)
    assert calls == {"k1": 2, "k2": 2}
    np.testing.assert_allclose(merged, out, rtol=2e-5, atol=2e-5)


def _margs(**kw):
    return dict(untie_encoder=True, add_linear_head=True, projection_in_dim=32,
                projection_out_dim=24, param_efficient_method="lora", lora_rank=RANK, **kw)


def test_trainable_set_matches_lora_mask():
    """``lora_trainable`` trains what the reference's ``lora_mask`` marks True (the
    adapters and the heads) and freezes the rest (``requires_grad`` off)."""
    port = tbi.DRModel.build(ModelArguments(**_margs()), bert_config=tbert.BertConfig(**CFG),
                             seed=2, device="cpu")
    trainable = {id(p) for p in tlora.lora_trainable(port)}
    got = set()
    for name, prm in port.named_parameters():
        assert prm.requires_grad == (id(prm) in trainable), name
        if id(prm) in trainable:
            parts = name.split(".")
            got.add((parts[0], parts[-1]))
    params = {"lm_q": params_to_jax(port.lm_q.state_dict()),
              "lm_p": params_to_jax(port.lm_p.state_dict()),
              "head_q": {"kernel": port.head_q.kernel.detach().numpy()},
              "head_p": {"kernel": port.head_p.kernel.detach().numpy()}}
    mask = jax.tree_util.tree_flatten_with_path(jlora.lora_mask(params))[0]
    want = {(path[0].key, path[-1].key) for path, on in mask if on}
    assert got == want and len(want) == 10
    assert not any(on for path, on in mask if path[-1].key in ("q_kernel", "word", "kernel")
                   and path[0].key.startswith("lm"))


def test_merge_matches_jax():
    """``merge_lora`` on the port's tower and ``merge_lora_tree`` on its tree against
    JAX ``merge_lora`` (fp32; a rank-4 sum in another order: within 1e-6)."""
    tree = _adapted_tree(5)
    ref = _flat(jax.tree.map(np.asarray, jlora.merge_lora(jax.tree.map(jnp.asarray, tree))))
    merged = params_to_jax(tlora.merge_lora(_port_tower(tree)).state_dict())
    for got in (_flat(merged), _flat(tlora.merge_lora_tree(tree))):
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6, err_msg=k)


# --- training ----------------------------------------------------------------------------------

N_PASSAGES = 2


class _Rows:
    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.rows = []
        for _ in range(n):
            ps = [rng.integers(1, CFG["vocab_size"], int(rng.integers(4, 12))).tolist()
                  for _ in range(N_PASSAGES)]
            self.rows.append((ps[0][:int(rng.integers(2, 5))], ps))

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def _collate(rows):
    return (pad_batch([q for q, _ in rows], 8, 0),
            pad_batch([p for _, ps in rows for p in ps], 12, 0))


def _loader():
    return DataLoader(_Rows(12, seed=9), 4, _collate, shuffle=True, seed=3)


def _targs(tmp, **kw):
    base = dict(output_dir=str(tmp / "out"), cache_train_dir=str(tmp / "cache"),
                train_batch_size=4, max_epochs=2, learning_rate=3e-2, optimizer="adamw",
                log_every=1, save_per_train=1)
    base.update(kw)
    return TrainingArguments(**base)


def _jax_side(port):
    """The JAX package's model and params for a port model (adapters carried)."""
    s = port.spec
    jmodel = jbi.DRModel(jbi.DRModelSpec(bert_config=jbert.BertConfig(**CFG), tied=s.tied,
                                         linear_head=s.linear_head))
    params = {"lm_q": params_to_jax(port.lm_q.state_dict())}
    if not s.tied:
        params["lm_p"] = params_to_jax(port.lm_p.state_dict())
    for name in ("head_q", "head_p"):
        head = getattr(port, name)
        if head is not None:
            params[name] = {"kernel": head.kernel.detach().numpy().copy()}
    return jmodel, jax.tree.map(jnp.asarray, params)


def _lora_model(seed=6, b_scale=0.2, **kw):
    port = tbi.DRModel.build(ModelArguments(**_margs(**kw)), bert_config=tbert.BertConfig(**CFG),
                             seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():  # B non-zero, so the adapters' products are not all zero
        for name, prm in port.named_parameters():
            if name.endswith(("lora_q_B", "lora_v_B")):
                prm.copy_(torch.from_numpy(
                    (b_scale * rng.standard_normal(prm.shape)).astype(np.float32)))
    return port


STEP_CASES = [dict(optimizer="adamw"), dict(optimizer="adamw", scheduler="cosine",
                                            optimizer_kwargs={"weight_decay": 0.1},
                                            scheduler_kwargs={"n_warmup_steps": 1,
                                                              "max_steps": 3}),
              dict(optimizer="sgd", scheduler="linear", optimizer_kwargs={"momentum": 0.9},
                   scheduler_kwargs={"n_warmup_steps": 2, "max_steps": 3})]


@pytest.mark.parametrize("kw", STEP_CASES, ids=["adamw", "adamw-decay-cosine", "sgd-linear"])
def test_steps_match_jax_and_freeze_the_base(kw, tmp_path):
    """Three steps of the port Trainer against the JAX Trainer on the same weights and
    batches: losses within 1e-5 rel + 2e-6, adapters and heads within atol 5e-5; the
    frozen base bit-unchanged in both, also under weight decay (optax.adamw's default
    1e-4, and 0.1) and a schedule. The frozen parameters take no gradient."""
    port = _lora_model()
    frozen = {k: v.detach().clone() for k, v in port.state_dict().items()
              if not tlora.is_trainable(k)}
    jmodel, jparams = _jax_side(port)
    start = _flat(jparams)  # copies: the JAX Trainer donates its params
    trainer = Trainer(_targs(tmp_path / "p", **kw), port)
    jtrainer = JaxTrainer(_targs(tmp_path / "j", **kw), jmodel, jparams)
    batches = list(_loader())[:3]
    for b in batches:
        loss, jloss = float(trainer.train_step(b)), float(jtrainer.train_step(b))
        np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=2e-6)
    for k, v in port.state_dict().items():
        if k in frozen:
            torch.testing.assert_close(v, frozen[k], rtol=0, atol=0)
    assert all(p.grad is None for n, p in port.named_parameters() if not tlora.is_trainable(n))
    want, got = _flat(jtrainer.state["params"]), _flat(_jax_side(port)[1])
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=5e-5, err_msg=k)
        if "lora" in k or "head" in k:
            moved += int(np.abs(got[k] - start[k]).max() > 0)
        else:
            np.testing.assert_array_equal(want[k], start[k], err_msg=k)
    assert moved == 10


def test_save_and_build_both_ways(tmp_path):
    """The port saves an adapted model; JAX ``DRModel.build`` reloads the adapters from
    ``weights.npz`` and encodes the same reps (1e-5). A JAX-built LoRA model saved by
    JAX builds in the port with its adapters, the same reps, and trains only them."""
    port = _lora_model(seed=8)
    port.save(str(tmp_path / "port"))
    jmodel, jparams = jbi.DRModel.build(ModelArguments(model_name_or_path=str(tmp_path / "port")))
    assert "lora_q_B" in jparams["lm_q"]["layers"] and "lora_v_A" in jparams["lm_p"]["layers"]
    q, p = _batch(5, 8, 11), _batch(5, 12, 12)
    np.testing.assert_allclose(
        port.encode_query(q).numpy(),
        np.asarray(jmodel.encode_query(jparams, jax.tree.map(jnp.asarray, q))), atol=1e-5)
    np.testing.assert_allclose(
        port.encode_passage(p).numpy(),
        np.asarray(jmodel.encode_passage(jparams, jax.tree.map(jnp.asarray, p))), atol=1e-5)
    # reverse: JAX builds (random init + adapters), B made non-zero, JAX saves
    jmodel, jparams = jbi.DRModel.build(ModelArguments(param_efficient_method="lora",
                                                       lora_rank=RANK),
                                        rng=jax.random.key(4), bert_config=jbert.BertConfig(**CFG))
    layers = dict(jparams["lm_q"]["layers"])
    layers["lora_v_B"] = 0.2 * jax.random.normal(jax.random.key(5), layers["lora_v_B"].shape)
    jparams = {**jparams, "lm_q": {**jparams["lm_q"], "layers": layers}}
    jmodel.save(jparams, str(tmp_path / "jax"))
    back = tbi.DRModel.build(ModelArguments(model_name_or_path=str(tmp_path / "jax")),
                             device="cpu")
    assert back.lm_q.layers[0].lora_v_B.shape == (RANK, CFG["hidden_size"])
    np.testing.assert_allclose(
        back.encode_query(q).numpy(),
        np.asarray(jmodel.encode_query(jparams, jax.tree.map(jnp.asarray, q))), atol=1e-5)
    assert len(tlora.lora_trainable(back)) == 4 * CFG["num_hidden_layers"]


def test_grad_cache_with_adapters_matches_the_full_batch(tmp_path):
    """Grad-cache over a frozen base: the adapters' and heads' gradients equal the
    full-batch step's within atol 2e-6 (fp32 sums in another order), the base gets
    none."""
    batch = list(_loader())[0]
    grads = {}
    for label, kw in (("full", {}), ("gc", dict(grad_cache=True, gc_q_chunk_size=2,
                                                gc_p_chunk_size=4))):
        model = _lora_model(seed=10)
        trainer = Trainer(_targs(tmp_path / label, optimizer="sgd", learning_rate=0.0, **kw),
                          model)
        trainer.train_step(batch)
        grads[label] = {n: p.grad for n, p in model.named_parameters()}
    for n, g in grads["full"].items():
        if tlora.is_trainable(n):
            assert g is not None and g.abs().max() > 0, n
            torch.testing.assert_close(grads["gc"][n], g, rtol=1e-4, atol=2e-6)
        else:
            assert g is None and grads["gc"][n] is None, n


def test_resume_carries_the_adapters_optimizer_state(tmp_path):
    """From the epoch-1 checkpoint a fresh LoRA Trainer (other adapters) repeats the
    uninterrupted run's epoch 2 bit for bit: the checkpoint holds the adapters and
    their AdamW moments."""
    args = _targs(tmp_path / "a")
    straight = Trainer(args, _lora_model(seed=12), train_loader=_loader())
    straight.train()
    ckpts = sorted(glob.glob(os.path.join(args.output_dir, "checkpoint", "ep*")))
    resumed = Trainer(_targs(tmp_path / "b"), _lora_model(seed=13), train_loader=_loader())
    assert len(resumed.optimizer.optimizer.param_groups[0]["params"]) == \
        4 * 2 * CFG["num_hidden_layers"] + 2
    resumed.load(ckpts[0])
    assert resumed.start_epoch == 1 and resumed.optimizer.count == 3
    resumed.train()
    for k, v in straight.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v, rtol=0, atol=0)


# --- T5 towers (add_lora_t5) -----------------------------------------------------------------

T5_TINY = dict(vocab_size=120, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4,
               relative_attention_num_buckets=8, relative_attention_max_distance=20)


def _t5_adapted_tree(seed=0, b_scale=0.3):
    """A seeded T5 tree with the JAX package's ``add_lora_t5`` adapters, B made non-zero."""
    cfg = tt5.T5Config(**T5_TINY)
    base = jax.tree.map(jnp.asarray, tt5.init_params_numpy(cfg, seed))
    tree = jax.tree.map(np.asarray, jlora.add_lora_t5(base, jax.random.key(seed + 1), rank=RANK))
    rng = np.random.default_rng(seed + 2)
    for name in ("lora_q_B", "lora_v_B"):
        tree["encoder"][name] = (b_scale * rng.standard_normal(tree["encoder"][name].shape)
                                 ).astype(np.float32)
    return tree


def _t5_tower(tree):
    enc = tt5.T5Model(tt5.T5Config(**T5_TINY))
    if "lora_q_A" in tree["encoder"]:
        tlora.add_lora_shaped(enc, RANK)
    enc.load_state_dict(params_from_jax(tree))
    return enc


def test_t5_adapters_match_jax():
    """``add_lora_t5``: A ~ N(0, 1) d_model^-0.5 of [L, d_model, r], B = 0 of [L, r, inner],
    so the adapted tower starts at its base; with B != 0 the encoder matches JAX
    ``t5_encode`` of the same tree (fp32, 2e-5), the adapters applied on the encoder's q
    and v."""
    cfg = tt5.T5Config(**T5_TINY)
    batch = _batch(4, 12, 2)
    base_tree = tt5.init_params_numpy(cfg, 0)
    base = _encode(_t5_tower(base_tree), batch)
    adapted = tlora.add_lora(_t5_tower(base_tree), RANK, seed=7)
    a = adapted.encoder.lora_q_A.detach().numpy()
    assert a.shape == (2, 32, RANK) and abs(a.std() * 32 ** 0.5 - 1) < 0.2
    assert adapted.encoder.lora_v_B.shape == (2, RANK, 32) and not adapted.encoder.lora_v_B.any()
    np.testing.assert_array_equal(_encode(adapted, batch), base)
    tree = _t5_adapted_tree()
    ref = np.asarray(jt5.t5_encode(jax.tree.map(jnp.asarray, tree), jt5.T5Config(**T5_TINY),
                                   jnp.asarray(batch["input_ids"]),
                                   jnp.asarray(batch["attention_mask"])))
    out = _encode(_t5_tower(tree), batch)
    assert np.abs(out - base).max() > 0.1  # the adapters moved the output
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_t5_trainable_set_and_no_merge_or_export(tmp_path):
    """A T5 dual encoder with 'lora': the trainable set is ``lora_mask``'s (4 stacked
    adapters a tower and the heads); the reference has no T5 merge or export, so
    ``merge_lora``, ``merge_lora_tree`` and ``export_hf`` raise; ``t5_full`` takes no
    adapters (biencoder.py:341 there); the adapters save and build in JAX with the same
    reps."""
    tt5.save_config(tt5.T5Config(**T5_TINY), str(tmp_path / "arch"))
    kw = dict(model_name_or_path=str(tmp_path / "arch"), encoder_only=True, **_margs())
    port = tbi.DRModel.build(ModelArguments(**kw), seed=2, device="cpu")
    assert tlora.has_lora(port)
    trainable = {id(p) for p in tlora.lora_trainable(port)}
    params = {"lm_q": params_to_jax(port.lm_q.state_dict()),
              "lm_p": params_to_jax(port.lm_p.state_dict()),
              "head_q": {"kernel": port.head_q.kernel.detach().numpy()},
              "head_p": {"kernel": port.head_p.kernel.detach().numpy()}}
    mask = jax.tree_util.tree_flatten_with_path(jlora.lora_mask(params))[0]
    want = {(path[0].key, path[-1].key) for path, on in mask if on}
    got = {(n.split(".")[0], n.split(".")[-1]) for n, p in port.named_parameters()
           if id(p) in trainable}
    assert got == want and len(want) == 10
    with pytest.raises(ValueError, match="no merge"):
        tlora.merge_lora(port.lm_q)
    with pytest.raises(ValueError, match="no merge"):
        tlora.merge_lora_tree(params["lm_q"])
    with pytest.raises(ValueError, match="no HF export"):
        port.export_hf(str(tmp_path / "hf"))
    full = tbi.DRModel.build(ModelArguments(**{**kw, "encoder_only": False}), seed=2,
                             device="cpu")
    assert full.spec.backbone == "t5_full" and not tlora.has_lora(full)
    with torch.no_grad():
        port.lm_q.encoder.lora_v_B.normal_(0, 0.2)
    port.save(str(tmp_path / "saved"))
    jmodel, jparams = jbi.DRModel.build(ModelArguments(model_name_or_path=str(tmp_path / "saved")))
    assert "lora_v_B" in jparams["lm_q"]["encoder"]
    q = {k: np.asarray(v) for k, v in _batch(4, 10, 3).items()}
    np.testing.assert_allclose(
        port.encode_query(q).numpy(),
        np.asarray(jmodel.encode_query(jparams, jax.tree.map(jnp.asarray, q))), atol=1e-5)
    back = tbi.DRModel.build(ModelArguments(model_name_or_path=str(tmp_path / "saved")),
                             device="cpu")
    torch.testing.assert_close(back.encode_query(q), port.encode_query(q), rtol=0, atol=0)
