"""The port's grad-cache step (``train/grad_cache.py`` through ``Trainer``) on the CPU.

Against the JAX ``Trainer.train_step`` with ``grad_cache=True`` on the same
weights (the port's, reaching JAX through ``params_to_jax``) and the same
numpy-seeded batches, at the ``TINY`` config of ``tests/test_gradcache_mining.py``;
and against the port's own full-batch step. On the CPU the port's K1-K4
wrappers run their plain versions; the JAX package runs its Pallas kernels in
interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseretrievaltoolkits_tpu.config import ModelArguments, TrainingArguments
from denseretrievaltoolkits_tpu.models import bert as jbert
from denseretrievaltoolkits_tpu.models import biencoder as jbi
from denseretrievaltoolkits_tpu.train.trainer import Trainer as JaxTrainer
from denseretrievaltoolkits_torch.models import bert as tbert
from denseretrievaltoolkits_torch.models import biencoder as tbi
from denseretrievaltoolkits_torch.models.convert import params_to_jax
from denseretrievaltoolkits_torch.train import grad_cache
from denseretrievaltoolkits_torch.train.trainer import Trainer

TINY = dict(vocab_size=97, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=32, max_position_embeddings=48)


def _batch(n, S, seed):
    """Ragged token batch: lengths 2..S, pad id 0."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, TINY["vocab_size"], (n, S)).astype(np.int32)
    lens = rng.integers(2, S + 1, n)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    return {"input_ids": np.where(mask == 1, ids, 0).astype(np.int32), "attention_mask": mask}


def _build(fused_loss=False, untied=False, attention="xla", seed=5, remat=""):
    args = ModelArguments(fused_loss=fused_loss, untie_encoder=untied, add_linear_head=untied,
                          attention=attention, projection_in_dim=16, projection_out_dim=12,
                          remat=remat)
    return tbi.DRModel.build(args, bert_config=tbert.BertConfig(**TINY), seed=seed, device="cpu")


def _args(tmp, **kw):
    kw.setdefault("learning_rate", 1e-3)
    kw.setdefault("optimizer", "adamw")
    return TrainingArguments(output_dir=str(tmp / "o"), cache_train_dir=str(tmp / "c"),
                             log_every=0, **kw)


def _jax_pair(port):
    s = port.spec
    model = jbi.DRModel(jbi.DRModelSpec(
        bert_config=jbert.BertConfig(**TINY), tied=s.tied, linear_head=s.linear_head,
        attention=s.attention, fused_loss=s.fused_loss, remat=s.remat))
    params = {"lm_q": params_to_jax(port.lm_q.state_dict())}
    if not s.tied:
        params["lm_p"] = params_to_jax(port.lm_p.state_dict())
    for name in ("head_q", "head_p"):
        head = getattr(port, name)
        if head is not None:
            params[name] = {"kernel": head.kernel.detach().numpy().copy()}
    return model, jax.tree.map(jnp.asarray, params)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_tree(port):
    tree = {"lm_q": params_to_jax(port.lm_q.state_dict())}
    if not port.spec.tied:
        tree["lm_p"] = params_to_jax(port.lm_p.state_dict())
    for name in ("head_q", "head_p"):
        head = getattr(port, name)
        if head is not None:
            tree[name] = {"kernel": head.kernel.detach().numpy()}
    return tree


# (fused_loss, untied, attention, Q, P, q chunk size, p chunk size): B = 8 at size 3 runs 2
# chunks of 4, B = 6 at size 4 one chunk of 6; Q = 4, P = 10 has P % Q != 0 (the plain
# loss with fused_loss, on both sides); 'fused' attention runs K1 / K2's plain versions
# against the Pallas kernels in interpret mode
CASES = [(False, False, "xla", 8, 16, 3, 4), (True, True, "xla", 6, 12, 4, 8),
         (True, False, "xla", 4, 10, 2, 5), (True, False, "fused", 8, 16, 3, 4)]


@pytest.mark.parametrize("fused_loss,untied,attention,Q,P,qc,pc", CASES,
                         ids=[f"fused_loss={c[0]}-untied={c[1]}-{c[2]}-Q{c[3]}P{c[4]}"
                              f"-chunks{c[5]},{c[6]}" for c in CASES])
def test_grad_cache_step_matches_jax(tmp_path, fused_loss, untied, attention, Q, P, qc, pc):
    """One grad-cache step: the loss within 1e-5 relative and the updated
    params within atol 5e-5, rtol 1e-4 of the JAX grad-cache step's (the
    full-batch step's tolerances, tests/test_torch_train.py). The step is SGD
    at lr 1, so the params differ by the gradients' difference: Adam's first
    step is lr x sign(grad), which turns fp32 noise in a gradient that is 0 in
    exact arithmetic (an untied passage tower's last LayerNorm bias: the
    passage-rep gradients sum to 0) into a whole lr either way."""
    port = _build(fused_loss, untied, attention)
    jmodel, jparams = _jax_pair(port)
    batch = (_batch(Q, 10, 1), _batch(P, 12, 2))
    kw = dict(grad_cache=True, gc_q_chunk_size=qc, gc_p_chunk_size=pc, optimizer="sgd",
              learning_rate=1.0)
    ref = JaxTrainer(_args(tmp_path / "jax", **kw), jmodel, jparams)
    ref_loss = float(ref.train_step(batch))
    loss = float(Trainer(_args(tmp_path / "port", **kw), port).train_step(batch))
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    want, got = _flat(ref.state["params"]), _flat(_port_tree(port))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=5e-5, err_msg=k)


@pytest.mark.parametrize("remat", ["full", "attn"])
def test_grad_cache_with_remat_matches_jax(tmp_path, remat):
    """Pass 3 re-encodes under ``remat``: the same step as JAX's grad-cache
    step with the same ``remat``, within the tolerances above."""
    port = _build(fused_loss=True, remat=remat)
    jmodel, jparams = _jax_pair(port)
    batch = (_batch(8, 10, 7), _batch(16, 12, 8))
    kw = dict(grad_cache=True, gc_q_chunk_size=4, gc_p_chunk_size=8, optimizer="sgd",
              learning_rate=1.0)
    ref = JaxTrainer(_args(tmp_path / "jax", **kw), jmodel, jparams)
    ref_loss = float(ref.train_step(batch))
    loss = float(Trainer(_args(tmp_path / "port", **kw), port).train_step(batch))
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    want, got = _flat(ref.state["params"]), _flat(_port_tree(port))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=5e-5, err_msg=k)


@pytest.mark.parametrize("side", ["query", "passage"])
def test_indivisible_batch_raises_on_both_sides(tmp_path, side):
    """B = 9 at chunk size 2 asks for 4 chunks, which 9 rows do not fill
    evenly: the JAX step asserts, the port raises, neither pads."""
    port = _build()
    jmodel, jparams = _jax_pair(port)
    q, p = (9, 18) if side == "query" else (4, 9)
    batch = (_batch(q, 8, 3), _batch(p, 8, 4))
    kw = dict(grad_cache=True, gc_q_chunk_size=2, gc_p_chunk_size=2)
    with pytest.raises(AssertionError, match="not divisible into 4 chunks"):
        JaxTrainer(_args(tmp_path / "jax", **kw), jmodel, jparams).train_step(batch)
    with pytest.raises(ValueError, match="9 rows is not divisible into 4 chunks"):
        Trainer(_args(tmp_path / "port", **kw), port).train_step(batch)


@pytest.mark.parametrize("rows,size,n", [(8, 3, 2), (6, 4, 1), (16, 4, 4), (3, 8, 1)])
def test_chunk_count_is_the_references(rows, size, n):
    assert grad_cache.n_chunks(rows, size) == n
    with pytest.raises(ValueError, match="chunk size must be >= 1"):
        grad_cache.n_chunks(rows, 0)


@pytest.mark.parametrize("fused_loss", [False, True])
def test_grad_cache_matches_the_full_batch_step(tmp_path, fused_loss):
    """The chunked step against the port's own full-batch step from the same
    weights: the loss within 1e-5, every updated param within 2e-5
    (tests/test_gradcache_mining.py:45-64)."""
    batch = (_batch(8, 10, 5), _batch(16, 12, 6))
    full, chunked = _build(fused_loss), _build(fused_loss)
    loss_full = float(Trainer(_args(tmp_path / "a"), full).train_step(batch))
    loss_gc = float(Trainer(_args(tmp_path / "b", grad_cache=True, gc_q_chunk_size=2,
                                  gc_p_chunk_size=4), chunked).train_step(batch))
    assert abs(loss_full - loss_gc) < 1e-5
    for (name, a), b in zip(full.named_parameters(), chunked.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), atol=2e-5,
                                   err_msg=name)


def test_grad_cache_trains(tmp_path):
    """The loss falls over 8 grad-cache steps on one batch; each step's loss
    is a detached device scalar."""
    trainer = Trainer(_args(tmp_path, grad_cache=True, gc_q_chunk_size=2, gc_p_chunk_size=4),
                      _build(fused_loss=True, seed=1))
    batch = (_batch(4, 10, 7), _batch(8, 12, 8))
    losses = [trainer.train_step(batch) for _ in range(8)]
    assert all(isinstance(x, torch.Tensor) and not x.requires_grad and x.dim() == 0
               for x in losses)
    assert float(losses[-1]) < float(losses[0])
    assert trainer.step == 8
