"""The torch port's DRModel serves a checkpoint the JAX package saved.

The JAX ``DRModel.build`` random init is saved with ``DRModel.save``; the
port's ``DRModel.build`` loads that directory, and both encode the same
numpy batches. fp32 reps agree within 2e-5 (sums in another order)."""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from denseretrievaltoolkits_tpu.config import ModelArguments
from denseretrievaltoolkits_tpu.models import bert as jbert
from denseretrievaltoolkits_tpu.models import biencoder as jbi
from denseretrievaltoolkits_torch.models import biencoder as tbi
from denseretrievaltoolkits_torch.models import lora
from denseretrievaltoolkits_torch.models import t5 as tt5

CFG = jbert.BertConfig(vocab_size=91, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=128, max_position_embeddings=40)


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def jax_model(request):
    args = ModelArguments(untie_encoder=not request.param, add_linear_head=True,
                          projection_in_dim=64, projection_out_dim=48)
    model, params = jbi.DRModel.build(args, jax.random.key(3), bert_config=CFG)
    return model, params


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, CFG.vocab_size, (5, 16)).astype(np.int32)
    mask = np.zeros((5, 16), np.int32)
    for b, n in enumerate([16, 11, 4, 1, 0]):  # ragged, with an all-pad row
        mask[b, :n] = 1
    return {"input_ids": np.where(mask == 1, ids, 0).astype(np.int32), "attention_mask": mask}


@pytest.mark.parametrize("pooling", ["first", "mean", "max"])
@pytest.mark.parametrize("normalize", [False, True])
def test_port_serves_jax_checkpoint(jax_model, pooling, normalize, tmp_path):
    model, params = jax_model
    linear_head = pooling == "mean"  # head on one pooling, off on the others
    spec = dataclasses.replace(model.spec, pooling=pooling, normalize=normalize,
                               linear_head=linear_head)
    jmodel = jbi.DRModel(spec)
    jparams = {k: v for k, v in params.items() if linear_head or not k.startswith("head")}
    jmodel.save(jparams, str(tmp_path))
    port = tbi.DRModelForInference.build(ModelArguments(model_name_or_path=str(tmp_path)),
                                         device="cpu")
    q, p = _batch(1), _batch(2)
    jq = np.asarray(jmodel.encode_query(jparams, jax.tree.map(jnp.asarray, q)))
    jp = np.asarray(jmodel.encode_passage(jparams, jax.tree.map(jnp.asarray, p)))
    out = port(query=q, passage=p)
    np.testing.assert_allclose(out["q_reps"].numpy(), jq, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out["p_reps"].numpy(), jp, rtol=2e-5, atol=2e-5)
    assert out["q_reps"].dtype == torch.float32
    if not spec.tied:  # the towers really are distinct modules
        assert port.lm_p is not None and port.lm_p is not port.lm_q


def test_fused_attention_build_matches_xla(jax_model, tmp_path):
    """``--attention fused`` on the CPU runs the K1/K2 plain versions; fp32 reps
    match the JAX xla path within 2e-5."""
    model, params = jax_model
    spec = dataclasses.replace(model.spec, linear_head=False)
    jparams = {k: v for k, v in params.items() if not k.startswith("head")}
    jbi.DRModel(spec).save(jparams, str(tmp_path))
    port = tbi.DRModel.build(ModelArguments(model_name_or_path=str(tmp_path),
                                            attention="fused"), device="cpu")
    assert port.spec.attention == "fused"
    q = _batch(4)
    ref = np.asarray(jbi.DRModel(spec).encode_query(jparams, jax.tree.map(jnp.asarray, q)))
    np.testing.assert_allclose(port.encode_query(q).numpy(), ref, rtol=2e-5, atol=2e-5)


def test_manifest_and_unsupported_paths(tmp_path):
    with pytest.raises(ValueError, match="pooling"):
        tbi.DRModelSpec(bert_config=CFG, pooling="sum")
    # a T5 spec builds (the port's T5 towers: tests/test_torch_t5.py); others raise
    t5_cfg = tt5.T5Config(vocab_size=91, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4)
    for backbone in ("t5", "t5_full"):
        assert tbi.DRModelSpec(bert_config=t5_cfg, backbone=backbone).backbone == backbone
    with pytest.raises(ValueError, match="backbone"):
        tbi.DRModelSpec(bert_config=CFG, backbone="roberta")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbi.DRModel.build(ModelArguments(model_name_or_path="bert-base-uncased"))
    # an architecture-only dir random-inits from its bert_config.json
    jbert.save_config(CFG, str(tmp_path))
    model = tbi.DRModel.build(ModelArguments(model_name_or_path=str(tmp_path)), seed=1,
                              device="cpu")
    reps = model.encode_passage(_batch(5))
    assert reps.shape == (5, 64) and torch.isfinite(reps).all()
    assert not os.path.exists(os.path.join(str(tmp_path), tbi.MANIFEST))
    with open(os.path.join(str(tmp_path), "bert_config.json")) as fh:
        assert json.load(fh)["hidden_size"] == 64


@pytest.mark.parametrize("source", ["random-init", "architecture-dir", "jax-checkpoint"])
def test_lora_raises_until_ported(jax_model, tmp_path, source):
    """``param_efficient_method='lora'`` builds adapters of ``lora_rank`` on every
    tower, from every source (a JAX checkpoint without adapters too, where the
    reference ignores the flag: ROADMAP queue 3, findings). B = 0, so the reps are
    the base model's exactly; only the adapters and heads train."""
    path = ""
    if source == "architecture-dir":
        jbert.save_config(CFG, str(tmp_path))
        path = str(tmp_path)
    elif source == "jax-checkpoint":
        jmodel, jparams = jax_model
        jmodel.save(jparams, str(tmp_path))
        path = str(tmp_path)
    args = ModelArguments(model_name_or_path=path, param_efficient_method="lora", lora_rank=4)
    adapted = tbi.DRModel.build(args, bert_config=CFG, device="cpu")
    towers = [adapted.lm_q] + ([adapted.lm_p] if adapted.lm_p is not None else [])
    assert all(lm.layers[-1].lora_q_A.shape == (CFG.hidden_size, 4) for lm in towers)
    if len(towers) == 2:  # untied towers start from the same adapters
        torch.testing.assert_close(towers[0].layers[1].lora_v_A, towers[1].layers[1].lora_v_A,
                                   rtol=0, atol=0)
    args.param_efficient_method = None
    base = tbi.DRModel.build(args, bert_config=CFG, device="cpu")
    assert not lora.has_lora(base)
    q = _batch(6)
    torch.testing.assert_close(adapted.encode_query(q), base.encode_query(q), rtol=0, atol=0)
    n_heads = sum(h is not None for h in (adapted.head_q, adapted.head_p))
    assert len(lora.lora_trainable(adapted)) == 4 * CFG.num_hidden_layers * len(towers) + n_heads
