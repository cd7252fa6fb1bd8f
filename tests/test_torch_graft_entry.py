"""``graft_entry``, the port's twin of the root ``__graft_entry__.py``, on the CPU.

``entry()``'s step against the JAX ``entry()``'s on the same weights, carried
across, within rtol / atol 2e-5 (``tests/test_torch_biencoder.py:61``). The JAX
entry is bert-base in bf16; both run here at a small fp32 config instead (the
JAX one with its ``BertConfig`` and ``DRModelSpec`` patched), the same
function and the same ``default_rng(0)`` batches. ``dryrun_multichip(2)`` runs
its data-parallel step and sharded searches over two gloo ranks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as jax_graft
from denseretrievaltoolkits_torch import graft_entry
from denseretrievaltoolkits_torch.models import bert as tbert
from denseretrievaltoolkits_tpu.models import bert as jbert
from denseretrievaltoolkits_tpu.models import biencoder as jbi

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=128, max_position_embeddings=128)


@pytest.mark.parametrize("attention", ["xla", "fused"])
def test_entry_step_matches_jax(monkeypatch, attention):
    spec_cls = jbi.DRModelSpec
    monkeypatch.setattr(jbert, "BertConfig", _config_factory(jbert.BertConfig))
    monkeypatch.setattr(jbi, "DRModelSpec", lambda **kw: spec_cls(**{**kw, "dtype": "float32"}))
    jfn, (jparams, jq, jp) = jax_graft.entry()
    jloss, jscores = jfn(jparams, jax.tree.map(jnp.asarray, jq), jax.tree.map(jnp.asarray, jp))

    fn, (model, q, p) = graft_entry.entry(config=tbert.BertConfig(**SMALL), dtype="float32",
                                          attention=attention, device="cpu")
    for a, b in ((q, jq), (p, jp)):
        assert all(np.array_equal(a[k], b[k]) for k in ("input_ids", "attention_mask"))
    model.load_tower_tree("lm_q", jax.tree.map(np.asarray, jparams["lm_q"]))
    loss, scores = fn(model, q, p)
    assert tuple(scores.shape) == (8, 16)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(jscores), rtol=2e-5,
                               atol=2e-5)


def _config_factory(real):
    def make(**kw):
        return real(**{**SMALL, **kw})
    return make


def test_entry_defaults_are_the_flagship():
    """``entry()`` without arguments builds bert-base in bf16 on 'fused' (here only its
    spec is read: the CPU has no card, so the model is built on the CPU)."""
    fn, (model, q, p) = graft_entry.entry(config=tbert.BertConfig(**SMALL), device="cpu")
    assert model.spec.dtype == "bfloat16" and model.spec.attention == "fused"
    assert dataclasses.asdict(tbert.BertConfig())["hidden_size"] == 768
    loss, _ = fn(model, q, p)
    assert np.isfinite(float(loss))


def test_dryrun_multichip_two_ranks():
    out = graft_entry.dryrun_multichip(2, device="cpu")
    # tp = 2 for even n, as the JAX dry run (__graft_entry__.py:140-142)
    assert out["mesh"] == {"data": 1, "model": 2} and np.isfinite(out["loss"])
    assert sorted(out["searches"]) == sorted(
        ["float32/exact", "int8/exact", "int8/serve", "int8/i8q", "int4/i8q", "IVFR8,SQ8",
         "PQ8", "IVF8,PQ64x4"])
    # exact int8 and float32 agree on most of the top 10 of N(0, 1) rows
    f32, i8 = np.array(out["searches"]["float32/exact"]), np.array(out["searches"]["int8/exact"])
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(f32, i8)]) >= 0.7
    with pytest.raises(ValueError, match="tiny"):
        graft_entry.dryrun_multichip(2, size="huge", device="cpu")


def test_entry_points_default_to_the_card():
    """Without a card the defaults raise before building anything or starting a rank."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run on it")
    for call in (graft_entry.entry, lambda: graft_entry.dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            call()
