"""The port's T5 towers against the JAX package's, on the CPU.

Weights are made with numpy from a seed (``t5.init_params_numpy``) and given to
both packages: the JAX functions take the numpy tree, the port's modules load it
through ``models/convert.py``. Tiny widths (``tests/test_t5_models.py``'s
``TINY_T5``: d_model 32, 4 heads of 8, 2 layers, 8 buckets over 20 positions).

Tolerances: fp32 within rtol 1e-5, atol 2e-5 (sums in another order). bf16: the
JAX package on XLA:CPU keeps excess precision between fused bf16 operations, so its
bf16 is no strict reference; the port's bf16 must lie within 4 bf16 ulps of the
largest |value| everywhere (readings 2-2.125 ulps), and on the mean within 1.5x of
the distance between JAX's own bf16 and fp32 results (readings 0.70-0.93 on the
encoder, 0.90-1.19 on the logits, seeds 0-3). The trainer trajectory takes
``tests/test_torch_train.py``'s tolerances.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from denseretrievaltoolkits_tpu.config import ModelArguments, TrainingArguments
from denseretrievaltoolkits_tpu.models import biencoder as jbi
from denseretrievaltoolkits_tpu.models import linear as jlinear
from denseretrievaltoolkits_tpu.models import t5 as jt5
from denseretrievaltoolkits_tpu.train.trainer import Trainer as JaxTrainer
from denseretrievaltoolkits_torch.data.collators import pad_batch
from denseretrievaltoolkits_torch.data.loaders import DataLoader
from denseretrievaltoolkits_torch.models import biencoder as tbi
from denseretrievaltoolkits_torch.models import t5 as tt5
from denseretrievaltoolkits_torch.models.convert import params_from_jax, params_to_jax
from denseretrievaltoolkits_torch.train.trainer import Trainer

TINY = dict(vocab_size=120, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4,
            relative_attention_num_buckets=8, relative_attention_max_distance=20)
FP32 = dict(rtol=1e-5, atol=2e-5)


def _cfg(gated=False, tied=True):
    return tt5.T5Config(**TINY, is_gated_act=gated, tie_word_embeddings=tied)


def _jcfg(cfg):
    return jt5.T5Config(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(n, S, seed):
    """Ragged token batch: lengths 1..S, pad id 0."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, TINY["vocab_size"], (n, S)).astype(np.int32)
    lens = np.concatenate([[S, 1], rng.integers(1, S + 1, n - 2)])
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    return {"input_ids": np.where(mask == 1, ids, 0).astype(np.int32), "attention_mask": mask}


def _tower(cfg, tree, dtype=torch.float32, **kw):
    m = tt5.T5Model(cfg, dtype=dtype, param_dtype=torch.float32,
                    with_decoder="decoder" in tree, **kw)
    m.load_state_dict(params_from_jax(tree))
    return m


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _bf16_close(got, want, want32):
    """The bf16 tolerance of the module docstring."""
    got, want, want32 = (np.asarray(x, np.float64) for x in (got, want, want32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= 4 * ulp
    assert np.abs(got - want).mean() <= 1.5 * np.abs(want - want32).mean()


# --- buckets and the bias ----------------------------------------------------------------------

@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidirectional", "causal"])
@pytest.mark.parametrize("buckets,distance", [(32, 128), (8, 20)])
def test_buckets_equal_jax(buckets, distance, bidirectional):
    """Bucket ids integer-equal to JAX's at every offset in [-1024, 1024], those that land
    exactly on an integer in fp32 (+-16, 32, 64 at (32, 128)) included."""
    rel = np.arange(-1024, 1025)
    want = np.asarray(jt5._relative_position_bucket(jnp.asarray(rel), bidirectional, buckets,
                                                    distance))
    got = tt5.relative_position_bucket(torch.from_numpy(rel).long(), bidirectional, buckets,
                                       distance)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidirectional", "causal"])
def test_position_bias_matches_jax(bidirectional):
    """The [1, heads, q, k] bias, equal to JAX's; its host table is built once per
    shape and shared."""
    cfg = _cfg()
    table = np.random.default_rng(3).standard_normal((8, 4)).astype(np.float32)
    want = np.asarray(jt5._position_bias(jnp.asarray(table), 7, 11, _jcfg(cfg), bidirectional))
    got = tt5.position_bias(torch.from_numpy(table), 7, 11, cfg, bidirectional)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tt5.bucket_table(7, 11, cfg, bidirectional) is tt5.bucket_table(7, 11, cfg,
                                                                          bidirectional)


# --- encoder and decoder -----------------------------------------------------------------------

def test_init_params_numpy_has_the_reference_layout():
    for gated, tied in ((False, True), (True, False)):
        cfg = _cfg(gated, tied)
        ours = tt5.init_params_numpy(cfg, 0, with_decoder=True)
        ref = jt5.init_params(jax.random.key(0), _jcfg(cfg), with_decoder=True)
        assert {k: v.shape for k, v in _flat(ours).items()} == \
            {k: v.shape for k, v in _flat(ref).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [False, True], ids=["relu", "gated"])
def test_encoder_matches_jax(gated, dtype):
    cfg = _cfg(gated)
    tree = tt5.init_params_numpy(cfg, 1)
    b = _batch(5, 23, 2)
    jp = jax.tree.map(jnp.asarray, tree)

    def ref(dt):
        return np.asarray(jt5.t5_encode(jp, _jcfg(cfg), jnp.asarray(b["input_ids"]),
                                        jnp.asarray(b["attention_mask"]), compute_dtype=dt
                                        ).astype(jnp.float32))

    m = _tower(cfg, tree, getattr(torch, dtype))
    with torch.no_grad():
        got = m(_t(b["input_ids"]), _t(b["attention_mask"]))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref(jnp.float32), **FP32)
    else:
        _bf16_close(got.float().numpy(), ref(jnp.bfloat16), ref(jnp.float32))


@pytest.mark.parametrize("remat", ["full", "attn"])
def test_remat_is_bit_equal(remat):
    """A checkpointed encoder block recomputes the same forward: loss and every
    gradient bit-equal to no remat."""
    cfg = _cfg(gated=True)
    tree = tt5.init_params_numpy(cfg, 2)
    b = _batch(4, 13, 3)
    out = []
    for r in ("", remat):
        m = _tower(cfg, tree, remat=r)
        h = m(_t(b["input_ids"]), _t(b["attention_mask"]))
        (h.square().mean()).backward()
        out.append((h.detach(), {n: p.grad.clone() for n, p in m.named_parameters()}))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    for n, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][n], g, rtol=0, atol=0, msg=n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_decode_step0_matches_jax(tied, dtype):
    """Step-0 logits (tied: scaled by d_model^-0.5 against ``shared``; untied: ``lm_head``)
    and the step-0 hidden state, over the same encoder output."""
    cfg = _cfg(gated=not tied, tied=tied)
    tree = tt5.init_params_numpy(cfg, 4, with_decoder=True)
    assert ("lm_head" in tree) == (not tied)
    b = _batch(5, 17, 5)
    jp = jax.tree.map(jnp.asarray, tree)
    mask = jnp.asarray(b["attention_mask"])

    def ref(dt, logits):
        enc = jt5.t5_encode(jp, _jcfg(cfg), jnp.asarray(b["input_ids"]), mask, compute_dtype=dt)
        return np.asarray(jt5.t5_decode_step0(jp, _jcfg(cfg), enc, mask, compute_dtype=dt,
                                              return_logits=logits))

    m = _tower(cfg, tree, getattr(torch, dtype))
    with torch.no_grad():
        enc = m(_t(b["input_ids"]), _t(b["attention_mask"]))
        logits = m.decode_step0(enc, _t(b["attention_mask"]))
        hidden = m.decode_step0(enc, _t(b["attention_mask"]), return_logits=False)
    assert logits.shape == (5, TINY["vocab_size"]) and logits.dtype == torch.float32
    assert hidden.shape == (5, TINY["d_model"]) and hidden.dtype == torch.float32
    for got, logits_ in ((logits, True), (hidden, False)):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), ref(jnp.float32, logits_), **FP32)
        else:
            _bf16_close(got.numpy(), ref(jnp.bfloat16, logits_), ref(jnp.float32, logits_))
    with pytest.raises(ValueError, match="no decoder"):
        _tower(cfg, tt5.init_params_numpy(cfg, 4)).decode_step0(enc, _t(b["attention_mask"]))


# --- the dual encoder ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def arch(tmp_path_factory):
    """An architecture-only T5 dir (``t5_config.json``: gated, untied)."""
    path = str(tmp_path_factory.mktemp("t5-arch"))
    tt5.save_config(_cfg(gated=True, tied=False), path)
    return path


def _arch_args(arch, backbone, **kw):
    return ModelArguments(model_name_or_path=arch, encoder_only=backbone == "t5", **kw)


def _dr(arch, backbone, fused_loss=False, pooling="mean", seed=6, **kw):
    """A port DRModel built from the architecture-only dir (seeded random init)."""
    return tbi.DRModel.build(_arch_args(arch, backbone, fused_loss=fused_loss, pooling=pooling,
                                        **kw), seed=seed, device="cpu")


def _jax_side(port):
    s = port.spec
    jmodel = jbi.DRModel(jbi.DRModelSpec(
        bert_config=_jcfg(s.bert_config), tied=s.tied, pooling=s.pooling, backbone=s.backbone,
        linear_head=s.linear_head, normalize=s.normalize, fused_loss=s.fused_loss))
    params = {"lm_q": params_to_jax(port.lm_q.state_dict())}
    if not s.tied:
        params["lm_p"] = params_to_jax(port.lm_p.state_dict())
    for name in ("head_q", "head_p"):
        head = getattr(port, name)
        if head is not None:
            params[name] = {"kernel": head.kernel.detach().numpy().copy()}
    return jmodel, jax.tree.map(jnp.asarray, params)


def _grads(module):
    return {k: v.grad if v.grad is not None else torch.zeros_like(v)
            for k, v in module.named_parameters()}


CASES = [("t5", False), ("t5", True), ("t5_full", False), ("t5_full", True)]


@pytest.mark.parametrize("backbone,fused_loss", CASES,
                         ids=[f"{b}-fused_loss={f}" for b, f in CASES])
def test_drmodel_reps_loss_and_grads_match_jax(arch, backbone, fused_loss):
    """``t5`` (mean-pooled encoder) and ``t5_full`` (the decoder's step-0 state): reps
    within fp32 tolerance, the loss within 1e-5 relative, every gradient within atol
    5e-5, rtol 1e-4 of ``jax.value_and_grad`` (the JAX fused loss in interpret mode)."""
    port = _dr(arch, backbone, fused_loss)
    assert port.spec.backbone == backbone
    assert (port.lm_q.decoder is not None) == (backbone == "t5_full")
    q, p = _batch(4, 9, 7), _batch(8, 15, 8)
    jmodel, jparams = _jax_side(port)
    jq, jpb = jax.tree.map(jnp.asarray, q), jax.tree.map(jnp.asarray, p)
    np.testing.assert_allclose(port.encode_query(q).numpy(),
                               np.asarray(jmodel.encode_query(jparams, jq)), **FP32)
    np.testing.assert_allclose(port.encode_passage(p).numpy(),
                               np.asarray(jmodel.encode_passage(jparams, jpb)), **FP32)
    ref, jgrads = jax.value_and_grad(lambda prm: jmodel.forward(prm, jq, jpb)["loss"])(jparams)
    out = port(q, p)
    out["loss"].backward()
    assert ("scores" in out) == (not fused_loss)
    np.testing.assert_allclose(float(out["loss"].detach()), float(ref), rtol=1e-5)
    want, got = _flat(jgrads), _flat({"lm_q": params_to_jax(_grads(port.lm_q))})
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=5e-5, err_msg=k)


def test_attention_is_ignored_and_serving_stores_compute_dtype(arch):
    """``attention`` does not apply to T5 towers (reference: 'bert only'): 'fused' builds
    and encodes as 'xla'. ``DRModelForInference`` stores the matrices in the compute
    dtype; ``shared``, the bias tables, the norms and ``lm_head`` stay fp32."""
    q = _batch(3, 9, 9)
    xla = _dr(arch, "t5", pooling="first").encode_query(q)
    fused = _dr(arch, "t5", pooling="first", attention="fused")
    assert fused.spec.attention == "fused"
    torch.testing.assert_close(fused.encode_query(q), xla, rtol=0, atol=0)
    serve = tbi.DRModelForInference.build(_arch_args(arch, "t5_full", dtype="bfloat16"), seed=6,
                                          device="cpu")
    dt = {n: p.dtype for n, p in serve.lm_q.named_parameters()}
    assert dt["encoder.attn_q"] == dt["decoder.cross_o"] == torch.bfloat16
    assert {dt[n] for n in ("shared", "enc_rel_bias", "dec_rel_bias", "encoder.attn_ln",
                            "lm_head")} == {torch.float32}
    assert serve.encode_passage(q).dtype == torch.float32


@pytest.mark.parametrize("backbone", ["t5", "t5_full"])
def test_save_and_build_across_packages(arch, backbone, tmp_path):
    """Port -> JAX: the port's ``save`` (untied, with heads) is built by the JAX
    ``DRModel.build`` and encodes the same reps; JAX -> port: a JAX ``save`` of its own
    init is built by the port's."""
    port = _dr(arch, backbone, untie_encoder=True, add_linear_head=True, projection_in_dim=32,
               projection_out_dim=24)
    with torch.no_grad():
        port.lm_p.encoder.wo.add_(0.01)  # make the towers differ
    port.save(str(tmp_path / "port"))
    with open(tmp_path / "port" / "query_model" / "t5_config.json") as fh:
        assert json.load(fh)["d_model"] == 32
    jmodel, jparams = jbi.DRModel.build(ModelArguments(model_name_or_path=str(tmp_path / "port")))
    assert jmodel.spec.backbone == backbone and not jmodel.spec.tied
    p = _batch(4, 12, 10)
    np.testing.assert_allclose(port.encode_passage(p).numpy(),
                               np.asarray(jmodel.encode_passage(jparams, p)), **FP32)
    np.testing.assert_allclose(port.encode_query(p).numpy(),
                               np.asarray(jmodel.encode_query(jparams, p)), **FP32)

    cfg = _jcfg(_cfg())
    spec = jbi.DRModelSpec(bert_config=cfg, backbone=backbone, pooling="first",
                           linear_head=True)
    jmodel = jbi.DRModel(spec)
    jparams = {"lm_q": jt5.init_params(jax.random.key(1), cfg,
                                       with_decoder=backbone == "t5_full"),
               "head_q": jlinear.init_head(jax.random.key(2), 32, 32)}
    jmodel.save(jparams, str(tmp_path / "jax"))
    built = tbi.DRModel.build(ModelArguments(model_name_or_path=str(tmp_path / "jax")),
                              device="cpu")
    assert built.spec.backbone == backbone and built.spec.linear_head
    np.testing.assert_allclose(built.encode_query(p).numpy(),
                               np.asarray(jmodel.encode_query(jparams, p)), **FP32)


def test_export_hf_and_unknown_sources_raise(arch, tmp_path):
    port = _dr(arch, "t5")
    with pytest.raises(ValueError, match="no HF export"):
        port.export_hf(str(tmp_path))
    with pytest.raises(NotImplementedError, match="needs a download"):
        tbi.DRModel.build(ModelArguments(model_name_or_path="google-t5/t5-base"), device="cpu")


# --- training ----------------------------------------------------------------------------------

class _Rows:
    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.rows = []
        for _ in range(n):
            ps = [rng.integers(1, TINY["vocab_size"], int(rng.integers(4, 12))).tolist()
                  for _ in range(2)]
            self.rows.append((ps[0][:int(rng.integers(2, 5))], ps))

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def _collate(rows):
    return (pad_batch([q for q, _ in rows], 8, 0),
            pad_batch([p for _, ps in rows for p in ps], 12, 0))


def _logged_losses(args):
    with open(os.path.join(args.output_dir, "train_log.jsonl")) as fh:
        return [r["loss"] for r in map(json.loads, fh) if "loss" in r]


@pytest.mark.parametrize("backbone", ["t5", "t5_full"])
def test_t5_trainer_trajectory_matches_jax(arch, backbone, tmp_path):
    """4 adamw steps (2 epochs of 2 shuffled batches) from the same weights: per-step
    losses within rtol 1e-5, atol 2e-6; final encoder parameters within atol 5e-5."""
    port = _dr(arch, backbone, fused_loss=True, seed=8)
    jmodel, jparams = _jax_side(port)

    def args(root):
        return TrainingArguments(output_dir=str(root / "out"), cache_train_dir=str(root / "c"),
                                 train_batch_size=4, max_epochs=2, learning_rate=3e-3,
                                 optimizer="adamw", log_every=1, save_per_train=10)

    def loader():
        return DataLoader(_Rows(8, seed=9), 4, _collate, shuffle=True, seed=3)

    trainer = Trainer(args(tmp_path / "port"), port, train_loader=loader())
    trainer.train()
    jtrainer = JaxTrainer(args(tmp_path / "jax"), jmodel, jparams, train_loader=loader())
    jtrainer.train()
    ours = _logged_losses(trainer.training_args)
    ref = _logged_losses(jtrainer.training_args)
    assert len(ours) == len(ref) == 4
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=2e-6)
    want = _flat({"lm_q": jtrainer.state["params"]["lm_q"]["encoder"]})
    got = _flat({"lm_q": params_to_jax(port.lm_q.state_dict())["encoder"]})
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=5e-5, err_msg=k)
