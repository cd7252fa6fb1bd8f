"""``remat`` in the port's BERT encoder (``models/bert.py``) on the CPU.

'full' checkpoints each block, 'attn' only the xla path's attention; on
'fused' and 'flash' 'attn' adds nothing. Recomputation repeats the forward
exactly, so outputs and gradients equal the encoder's without remat; against
the JAX ``bert_encode(remat=...)`` they agree within the encoder's 2e-5.
Weights and inputs are numpy-seeded, fed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseretrievaltoolkits_tpu.models import bert as jbert
from denseretrievaltoolkits_torch.config import ModelArguments
from denseretrievaltoolkits_torch.models import bert as tbert
from denseretrievaltoolkits_torch.models import biencoder as tbi
from denseretrievaltoolkits_torch.models.convert import (init_params_numpy, params_from_jax,
                                                         params_to_jax)
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
    for b, n in enumerate([S, 9, 3, 5][:B]):
        mask[b, :n] = 1
    return np.where(mask == 1, ids, 0).astype(np.int32), mask


def _run(attention, remat, tree, ids, mask, cot):
    """Output and per-parameter grads of <encoder(ids), cot>."""
    enc = tbert.BertEncoder(tbert.BertConfig(**CFG), torch.float32, attention, remat=remat)
    enc.load_state_dict(params_from_jax(tree))
    out = enc(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    out.backward(torch.from_numpy(cot))
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)).numpy()
             for k, v in enc.named_parameters()}
    return out.detach().numpy(), grads


def _cotangent(ids, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (*ids.shape, CFG["hidden_size"])).astype(np.float32)


CASES = [(a, r) for a in ("xla", "fused", "flash") for r in ("full", "attn")]


@pytest.mark.parametrize("attention,remat", CASES, ids=[f"{a}-{r}" for a, r in CASES])
def test_remat_equals_no_remat(attention, remat):
    """Forward and every gradient within 1e-6 of the same encoder without
    remat (tests/test_bert_parity.py:121-131)."""
    tree, (ids, mask) = _tree(), _inputs()
    cot = _cotangent(ids)
    out, grads = _run(attention, remat, tree, ids, mask, cot)
    ref_out, ref_grads = _run(attention, "", tree, ids, mask, cot)
    np.testing.assert_allclose(out, ref_out, atol=1e-6)
    for k in ref_grads:
        np.testing.assert_allclose(grads[k], ref_grads[k], atol=1e-6, err_msg=k)


JAX_CASES = [(a, r) for a in ("xla", "fused") for r in ("full", "attn")]


@pytest.mark.parametrize("attention,remat", JAX_CASES, ids=[f"{a}-{r}" for a, r in JAX_CASES])
def test_remat_matches_jax(attention, remat):
    """The port's encoder with remat against ``bert_encode(remat=...)``:
    outputs within 2e-5 (tests/test_torch_bert.py), gradients of the same
    cotangent within rtol 1e-4, atol 2e-5 (tests/test_torch_train.py's block
    gradients)."""
    tree, (ids, mask) = _tree(), _inputs()
    cot = _cotangent(ids)
    out, grads = _run(attention, remat, tree, ids, mask, cot)
    ref, vjp = jax.vjp(lambda p: jbert.bert_encode(
        p, jbert.BertConfig(**CFG), jnp.asarray(ids), jnp.asarray(mask), remat=remat,
        attention=attention), jax.tree.map(jnp.asarray, tree))
    (jgrads,) = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-5, atol=2e-5)
    got = params_to_jax({k: torch.from_numpy(v) for k, v in grads.items()})
    for group, arrays in jgrads.items():
        for name, want in arrays.items():
            np.testing.assert_allclose(got[group][name], np.asarray(want), rtol=1e-4,
                                       atol=2e-5, err_msg=f"{group}.{name}")


@pytest.mark.parametrize("remat,per_layer", [("", 1), ("attn", 1), ("full", 2)])
def test_fused_backward_runs_the_plain_block_once_per_layer(remat, per_layer, monkeypatch):
    """On 'fused', K1's backward recomputes its block through the plain
    version once a layer; 'attn' adds no second recompute, 'full' does (the
    checkpoint re-runs the forward, which on the CPU is the plain version)."""
    calls = []
    plain = tattn._reference_attention_ln
    monkeypatch.setattr(tattn, "_reference_attention_ln",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    enc = tbert.BertEncoder(tbert.BertConfig(**CFG), torch.float32, "fused", remat=remat)
    enc.load_state_dict(params_from_jax(_tree()))
    ids, mask = _inputs()
    out = enc(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert len(calls) == CFG["num_hidden_layers"]  # the forward: the plain K1 on the CPU
    calls.clear()
    out.sum().backward()
    assert len(calls) == per_layer * CFG["num_hidden_layers"]


def _saved_bytes(attention, remat):
    """Bytes of the tensors autograd saves for the backward, outside the
    checkpointed regions (which keep only their inputs)."""
    enc = tbert.BertEncoder(tbert.BertConfig(**CFG), torch.float32, attention, remat=remat)
    enc.load_state_dict(params_from_jax(_tree()))
    ids, mask = _inputs()
    total = []

    def pack(t):
        total.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        enc(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    return sum(total)


def test_saved_activations_fall_as_the_chip_peaks_should():
    """The CPU's view of the peak-memory order the card is held to: 'full'
    keeps less than no remat on both attentions, 'attn' less on 'xla' (no
    [B, nh, S, S] probabilities) and the same on 'fused'."""
    xla, fused = _saved_bytes("xla", ""), _saved_bytes("fused", "")
    assert _saved_bytes("xla", "full") < xla and _saved_bytes("fused", "full") < fused
    assert _saved_bytes("xla", "attn") < xla
    assert _saved_bytes("fused", "attn") == fused


def test_model_build_takes_remat_and_refuses_unknown_values():
    config = tbert.BertConfig(**CFG)
    for remat in ("full", "attn"):
        model = tbi.DRModel.build(ModelArguments(remat=remat), bert_config=config,
                                  device="cpu")
        assert model.spec.remat == model.lm_q.remat == remat
    with pytest.raises(ValueError, match="Unknown remat"):
        tbi.DRModel.build(ModelArguments(remat="selective"), bert_config=config, device="cpu")
