"""The torch port's training path vs the JAX reference, on the CPU.

Weights and batches are made with numpy from a seed and given to both
packages (the port's weights reach JAX through ``params_to_jax``). fp32,
2 layers, H=32. On the CPU the port's K1-K4 wrappers run their plain
versions; the JAX package runs its Pallas kernels in interpret mode.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from denseretrievaltoolkits_tpu.config import ModelArguments, TrainingArguments
from denseretrievaltoolkits_tpu.data.collators import pad_batch
from denseretrievaltoolkits_tpu.data.loaders import DataLoader
from denseretrievaltoolkits_tpu.models import bert as jbert
from denseretrievaltoolkits_tpu.models import biencoder as jbi
from denseretrievaltoolkits_tpu.ops import attn as jattn
from denseretrievaltoolkits_tpu.train import schedulers as jsched
from denseretrievaltoolkits_tpu.train.trainer import Trainer as JaxTrainer
from denseretrievaltoolkits_torch.models import bert as tbert
from denseretrievaltoolkits_torch.models import biencoder as tbi
from denseretrievaltoolkits_torch.models.convert import (
    init_params_numpy,
    params_from_jax,
    params_to_jax,
    save_jax_params,
)
from denseretrievaltoolkits_torch.ops import attn as tattn
from denseretrievaltoolkits_torch.parallel.mesh import make_mesh
from denseretrievaltoolkits_torch.train import optimizers as topt
from denseretrievaltoolkits_torch.train import schedulers as tsched
from denseretrievaltoolkits_torch.train.trainer import Trainer

CFG = dict(vocab_size=61, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=64, max_position_embeddings=24)
N_PASSAGES = 2  # train_n_passages: P = 2 Q, stride 2


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


def _grads(module):
    """Per-parameter grads; a parameter the loss does not reach (the pooler)
    has none in torch and zeros in JAX."""
    return {k: v.grad if v.grad is not None else torch.zeros_like(v)
            for k, v in module.named_parameters()}


def _jax_params(port):
    params = {"lm_q": params_to_jax(port.lm_q.state_dict())}
    if not port.spec.tied:
        params["lm_p"] = params_to_jax(port.lm_p.state_dict())
    for name in ("head_q", "head_p"):
        head = getattr(port, name)
        if head is not None:
            params[name] = {"kernel": head.kernel.detach().numpy().copy()}
    return jax.tree.map(jnp.asarray, params)


def _jax_model(port):
    s = port.spec
    return jbi.DRModel(jbi.DRModelSpec(
        bert_config=jbert.BertConfig(**CFG), tied=s.tied, pooling=s.pooling,
        linear_head=s.linear_head, normalize=s.normalize, attention=s.attention,
        fused_loss=s.fused_loss))


def _build(seed=5, **kw):
    args = ModelArguments(projection_in_dim=32, projection_out_dim=24, **kw)
    return tbi.DRModel.build(args, bert_config=tbert.BertConfig(**CFG), seed=seed, device="cpu")


# --- schedules and optimizers -------------------------------------------------------------

SCHED_KW = {"inverse": dict(n_warmup_steps=3), "cosine": dict(n_warmup_steps=3, max_steps=10),
            "linear": dict(n_warmup_steps=3, max_steps=10), "constant": dict(n_warmup_steps=3)}


@pytest.mark.parametrize("name", sorted(SCHED_KW))
def test_schedules_match_jax(name):
    ref = jsched.get_schedule(name, 2e-3, SCHED_KW[name])
    port = tsched.get_schedule(name, 2e-3, SCHED_KW[name])
    steps = range(0, 11)
    # the reference evaluates in fp32: 1e-9 is a few fp32 ulps of max_lr
    np.testing.assert_allclose([port(t) for t in steps], [float(ref(jnp.int32(t))) for t in steps],
                               rtol=1e-6, atol=1e-9)
    assert tsched.get_schedule(None, 2e-3, {}) == jsched.get_schedule(None, 2e-3, {}) == 2e-3


def test_optimizer_applies_the_schedule_at_update_t(tmp_path):
    """optax evaluates the schedule at the count of updates done before this
    one; the schedules clamp it to >= 1, so updates 0 and 1 share one lr."""
    args = TrainingArguments(optimizer="sgd", scheduler="linear", learning_rate=1.0,
                             scheduler_kwargs=dict(n_warmup_steps=2, max_steps=6),
                             output_dir=str(tmp_path), cache_train_dir=str(tmp_path / "c"))
    ref_opt = optax.sgd(jsched.get_schedule("linear", 1.0, args.scheduler_kwargs))
    state = ref_opt.init(jnp.zeros(()))
    p = torch.nn.Parameter(torch.zeros(()))
    opt = topt.get_optimizer(args, [p])
    for t in range(6):
        update, state = ref_opt.update(jnp.ones(()), state)
        p.grad = torch.ones(())
        before = float(p.detach())
        opt.step()
        np.testing.assert_allclose(float(p.detach()) - before, float(update), rtol=1e-6)
    assert [round(tsched.get_schedule("linear", 1.0, args.scheduler_kwargs)(t), 6)
            for t in range(3)] == [0.5, 0.5, 1.0]


OPTIMIZERS = [("adam", {}), ("adam", {"b1": 0.8, "eps": 1e-6}), ("adamw", {}),
              ("adamw", {"weight_decay": 0.05, "b2": 0.99}), ("sgd", {}),
              ("sgd", {"momentum": 0.9, "nesterov": True})]


@pytest.mark.parametrize("name,kwargs", OPTIMIZERS, ids=[f"{n}-{sorted(k)}" for n, k in OPTIMIZERS])
def test_optimizer_updates_match_optax(name, kwargs, tmp_path):
    """Three updates with warmup: params after each match optax's. Adam's
    tolerance: optax takes the bias corrections 1 - b**t in fp32 (1 - fp32(0.999)
    is 1.3e-5 off), torch in float64, which moves an update of size <= lr=0.1
    by up to ~7e-6 of it; sgd agrees to fp32 rounding."""
    rng = np.random.default_rng(1)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    args = TrainingArguments(optimizer=name, optimizer_kwargs=kwargs, learning_rate=0.1,
                             scheduler="linear", scheduler_kwargs=dict(n_warmup_steps=2,
                                                                       max_steps=5),
                             output_dir=str(tmp_path), cache_train_dir=str(tmp_path / "c"))
    ref = getattr(optax, name)(jsched.get_schedule("linear", 0.1, args.scheduler_kwargs),
                               **kwargs)
    jp = jax.tree.map(jnp.asarray, params)
    state = ref.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = topt.get_optimizer(args, tp.values())
    for g in grads:
        updates, state = ref.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7 if name == "sgd" else 2e-6)


def test_optimizer_names(tmp_path, caplog):
    p = [torch.nn.Parameter(torch.zeros(2))]

    def args(name, **kw):
        return TrainingArguments(optimizer=name, output_dir=str(tmp_path),
                                 cache_train_dir=str(tmp_path / "c"), **kw)

    opt = topt.get_optimizer(args("lamb"), p)
    assert isinstance(opt.optimizer, torch.optim.AdamW) and "defaulting to adamw" in caplog.text
    assert opt.optimizer.defaults["weight_decay"] == 1e-4  # optax's, not torch's 1e-2
    # adagrad, rmsprop and adafactor are optax's formulas (tests/test_torch_optimizers.py)
    for name, cls in (("adagrad", topt.Adagrad), ("rmsprop", topt.RMSProp),
                      ("adafactor", topt.Adafactor)):
        assert isinstance(topt.get_optimizer(args(name), p).optimizer, cls)
    with pytest.raises(NotImplementedError, match="eps_root"):
        topt.get_optimizer(args("adam", optimizer_kwargs={"eps_root": 1e-8}), p)


# --- K1 / K2 under autograd -----------------------------------------------------------------

def _block_arrays(seed, B=3, S=10, nh=4, hd=8, F=64):
    rng = np.random.default_rng(seed)
    H = nh * hd
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    mask = np.ones((B, S), np.int32)
    mask[1, 6:] = 0
    return mask, dict(qkv=f(B, S, 3 * H), x=f(B, S, H), ok=f(H, H, scale=0.1),
                      ob=f(H, scale=0.1), ls=1 + f(H, scale=0.1), lb=f(H, scale=0.1),
                      wi=f(H, F, scale=0.1), bi=f(F, scale=0.1), wo=f(F, H, scale=0.1),
                      bo=f(H, scale=0.1), g=f(B, S, H))


@pytest.mark.parametrize("block", ["K1", "K2"])
def test_block_grads_match_jax_custom_vjp(block):
    """The recompute backward of K1/K2 against the JAX custom_vjp of the same
    fused functions (Pallas forward in interpret mode), fp32."""
    mask, a = _block_arrays(3)
    nh, hd = 4, 8
    if block == "K1":
        names = ("qkv", "x", "ok", "ob", "ls", "lb")
        jfn = lambda *t: jattn.fused_attention_ln(t[0], t[1], jnp.asarray(mask), *t[2:],  # noqa
                                                  0.35, nh, hd, 1e-12)
        tfn = lambda *t: tattn.fused_attention_ln(t[0], t[1], torch.from_numpy(mask),  # noqa
                                                  *t[2:], 0.35, nh, hd, 1e-12)
    else:
        names = ("x", "wi", "bi", "wo", "bo", "ls", "lb")
        jfn = lambda *t: jattn.fused_mlp_ln(*t, 1e-12)  # noqa: E731
        tfn = lambda *t: tattn.fused_mlp_ln(*t, 1e-12)  # noqa: E731
    out, vjp = jax.vjp(jfn, *[jnp.asarray(a[n]) for n in names])
    jgrads = vjp(jnp.asarray(a["g"]))
    ts = [torch.from_numpy(a[n]).requires_grad_(True) for n in names]
    tout = tfn(*ts)
    tout.backward(torch.from_numpy(a["g"]))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), rtol=2e-5, atol=2e-5)
    for n, t, jg in zip(names, ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=2e-5,
                                   err_msg=n)


# --- DRModel.forward: loss and per-parameter grads -------------------------------------------

FORWARD_CASES = [("xla", False, False), ("xla", True, False), ("fused", False, False),
                 ("fused", True, False), ("xla", False, True)]


@pytest.mark.parametrize("attention,fused_loss,untied", FORWARD_CASES,
                         ids=[f"{a}-fused_loss={f}-untied={u}" for a, f, u in FORWARD_CASES])
def test_forward_loss_and_grads_match_jax(attention, fused_loss, untied):
    """Loss within 1e-5 relative and every parameter's grad within atol 5e-5,
    rtol 1e-4 of ``jax.value_and_grad`` (fp32 sums in another order: readings
    up to 2.1e-5 on grads as large as 22). The untied case adds heads."""
    port = _build(attention=attention, fused_loss=fused_loss, untie_encoder=untied,
                  add_linear_head=untied)
    q, p = _batch(4, 8, 1), _batch(4 * N_PASSAGES, 12, 2)
    jmodel, jparams = _jax_model(port), _jax_params(port)
    ref, jgrads = jax.value_and_grad(lambda prm: jmodel.forward(
        prm, jax.tree.map(jnp.asarray, q), jax.tree.map(jnp.asarray, p))["loss"])(jparams)
    out = port(q, p)
    out["loss"].backward()
    assert ("scores" in out) == (not fused_loss)
    np.testing.assert_allclose(float(out["loss"].detach()), float(ref), rtol=1e-5)
    grads = {"lm_q": params_to_jax(_grads(port.lm_q))}
    if untied:
        grads["lm_p"] = params_to_jax(_grads(port.lm_p))
        grads["head_q"] = {"kernel": port.head_q.kernel.grad.numpy()}
        grads["head_p"] = {"kernel": port.head_p.kernel.grad.numpy()}
    want, got = _flat(jgrads), _flat(grads)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=5e-5, err_msg=k)


def test_params_are_fp32_masters_and_serving_stores_compute_dtype():
    train = _build(dtype="bfloat16")
    serve = tbi.DRModelForInference.build(
        ModelArguments(dtype="bfloat16"), bert_config=tbert.BertConfig(**CFG), seed=5,
        device="cpu")
    layer_t, layer_s = train.lm_q.layers[0], serve.lm_q.layers[0]
    assert layer_t.qkv_kernel.dtype == torch.float32 and layer_t.qkv_kernel.requires_grad
    assert layer_s.qkv_kernel.dtype == torch.bfloat16
    assert layer_t.attn_ln_scale.dtype == layer_s.attn_ln_scale.dtype == torch.float32
    # the cast at use reproduces the serving weights: identical bf16 reps
    q = _batch(3, 8, 4)
    torch.testing.assert_close(train.encode_query(q), serve.encode_query(q), rtol=0, atol=0)


def test_convert_roundtrip_and_npz(tmp_path):
    tree = init_params_numpy(tbert.BertConfig(**CFG), 2)
    assert _flat(params_to_jax(params_from_jax(tree))).keys() == _flat(tree).keys()
    for k, v in _flat(params_to_jax(params_from_jax(tree))).items():
        np.testing.assert_array_equal(v, _flat(tree)[k])
    save_jax_params(tree, str(tmp_path))
    back = _flat(jbert.load_params(str(tmp_path)))
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(back[k], v)


# --- the Trainer --------------------------------------------------------------------------------

class _Rows:
    """Synthetic (query, passages) rows: queries are prefixes of their first passage."""

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


def _args(tmp, **kw):
    base = dict(output_dir=str(tmp / "out"), cache_train_dir=str(tmp / "cache"),
                train_batch_size=4, max_epochs=2, learning_rate=3e-3, optimizer="adamw",
                scheduler="linear", warmup_ratio=0.34, log_every=1, save_per_train=1)
    base.update(kw)
    return TrainingArguments(**base)


def _loader():
    return DataLoader(_Rows(12, seed=9), 4, _collate, shuffle=True, seed=3)


def _logged_losses(args):
    with open(os.path.join(args.output_dir, "train_log.jsonl")) as fh:
        return [r["loss"] for r in map(json.loads, fh) if "loss" in r]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's and the JAX Trainer from the same weights over the same 6
    batches (2 epochs of 3, shuffled per epoch): adamw, linear warmup from
    warmup_ratio, a log line per step, a save per epoch."""
    tmp = tmp_path_factory.mktemp("train")
    port = _build(seed=7)
    jmodel, jparams = _jax_model(port), _jax_params(port)
    trainer = Trainer(_args(tmp / "port"), port, train_loader=_loader())
    trainer.train()
    jargs = _args(tmp / "jax", save_per_train=10)
    jtrainer = JaxTrainer(jargs, jmodel, jparams, train_loader=_loader())
    jtrainer.train()
    return tmp, trainer, jtrainer


def test_trainer_trajectory_matches_jax(trained):
    """Per-step losses within 1e-5 relative plus 2e-6 absolute (a loss near 0
    is lse - tgt of scores ~10, where fp32 sums in another order leave ~1e-6;
    reading 5e-7). Final params within atol 5e-5, 1.7% of one lr=3e-3 step:
    Adam divides each grad by its running RMS, so where a grad is near fp32
    noise the two frameworks' steps differ by a share of lr (reading 1.1e-5
    on 9 of 1952 word-embedding entries, the rest below 1e-6)."""
    tmp, trainer, jtrainer = trained
    assert trainer.training_args.scheduler_kwargs == {"n_warmup_steps": 2, "max_steps": 6}
    ours, ref = _logged_losses(trainer.training_args), _logged_losses(jtrainer.training_args)
    assert len(ours) == len(ref) == 6 and trainer.step == 6
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=2e-6)
    want = _flat({"lm_q": jtrainer.state["params"]["lm_q"]})
    got = _flat({"lm_q": params_to_jax(trainer.model.lm_q.state_dict())})
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=5e-5, err_msg=k)


def test_jax_loads_the_deploy_format(trained):
    """The port-trained model saved in the deploy format: the JAX package's
    DRModel.build loads it and encodes the same reps within 1e-5."""
    tmp, trainer, _ = trained
    result = os.path.join(trainer.training_args.cache_train_dir, "result2")
    assert sorted(os.listdir(result)) == ["bert_config.json", "openmatch_config.json",
                                          "weights.npz"]
    jmodel, jparams = jbi.DRModel.build(ModelArguments(model_name_or_path=result))
    q = _batch(5, 8, 11)
    ref = np.asarray(jmodel.encode_query(jparams, jax.tree.map(jnp.asarray, q)))
    np.testing.assert_allclose(trainer.model.encode_query(q).numpy(), ref, atol=1e-5)
    served = tbi.DRModelForInference.build(ModelArguments(model_name_or_path=result),
                                           device="cpu")
    torch.testing.assert_close(served.encode_query(q), trainer.model.encode_query(q),
                               rtol=0, atol=0)


def test_untied_save_with_heads_loads_in_jax(tmp_path):
    port = _build(seed=3, untie_encoder=True, add_linear_head=True)
    with torch.no_grad():
        port.lm_p.layers[0].wi_bias.add_(0.5)  # make the towers differ
    port.save(str(tmp_path))
    for sub in ("query_model", "passage_model", "query_head", "passage_head"):
        assert os.path.isdir(tmp_path / sub)
    jmodel, jparams = jbi.DRModel.build(ModelArguments(model_name_or_path=str(tmp_path)))
    assert not jmodel.spec.tied and jmodel.spec.linear_head
    p = _batch(4, 12, 12)
    ref = np.asarray(jmodel.encode_passage(jparams, jax.tree.map(jnp.asarray, p)))
    out = port.encode_passage(p).numpy()
    assert out.shape == (4, 24)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_resume_repeats_the_next_epoch_exactly(trained, tmp_path):
    """From the epoch-1 checkpoint a fresh Trainer starts at epoch 2 (not 3, as
    the reference's off-by-one would) and logs the uninterrupted run's epoch-2
    losses bit for bit."""
    tmp, trainer, _ = trained
    ckpts = sorted(glob.glob(os.path.join(trainer.training_args.output_dir, "checkpoint", "ep*")))
    assert [os.path.basename(c) for c in ckpts] == ["ep1", "ep2"]
    resumed = Trainer(_args(tmp_path), _build(seed=99), train_loader=_loader())
    resumed.load(ckpts[0])
    assert resumed.start_epoch == 1 and resumed.step == 3 and resumed.optimizer.count == 3
    resumed.train()
    np.testing.assert_array_equal(_logged_losses(resumed.training_args),
                                  _logged_losses(trainer.training_args)[3:])
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v, rtol=0, atol=0)


def test_non_finite_loss_stops(tmp_path):
    port = _build(seed=1)
    trainer = Trainer(_args(tmp_path, max_epochs=1), port, train_loader=_loader())
    with torch.no_grad():
        for prm in port.parameters():
            prm.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="resume from the last checkpoint"):
        trainer.train()


def test_non_finite_loss_message_advises_no_unported_flag(tmp_path):
    """The message advises what the reference's does (trainer.py:226-230):
    a lower learning rate or --remat full, which the port now takes."""
    port = _build(seed=1)
    trainer = Trainer(_args(tmp_path, max_epochs=1), port, train_loader=_loader())
    with torch.no_grad():
        for prm in port.parameters():
            prm.fill_(float("nan"))
    with pytest.raises(FloatingPointError) as err:
        trainer.train()
    assert "(consider a lower learning_rate or --remat full)" in str(err.value)
    assert _build(seed=1, remat="full").lm_q.remat == "full"


def test_profile_trace_and_unported_arguments(tmp_path):
    """The profiler trace of step 2; evaluation loaders are taken (the
    evaluation itself is held to the JAX Trainer in tests/test_torch_eval.py) and so are
    a miner and a mesh (tests/test_torch_parallel.py runs one), while a model axis the
    world does not hold (tp_size 2 in one process) raises when the mesh is made
    (tests/test_torch_tensor_parallel.py runs two ranks)."""
    args = _args(tmp_path, max_epochs=1, profile_dir=str(tmp_path / "prof"))
    trainer = Trainer(args, _build(seed=2), train_loader=_loader())
    trainer.train()
    with open(tmp_path / "prof" / "train_step.json") as fh:
        assert "traceEvents" in json.load(fh)
    evaluating = Trainer(dataclasses.replace(args), _build(seed=2), corpus_dataloader=[],
                         eval_loader=[], test_loader=[], label_kind="docids")
    assert evaluating.eval_loader == evaluating.test_loader == evaluating.corpus_dataloader == []
    assert evaluating.label_kind == "docids" and evaluating.index is None
    miner = object()  # a miner is taken (tests/test_torch_mining.py runs one)
    assert Trainer(dataclasses.replace(args), _build(seed=2), miner=miner).miner is miner
    mesh = make_mesh()  # no process group: one rank
    assert Trainer(dataclasses.replace(args), _build(seed=2), mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="tp_size 2 must divide the world size 1"):
        make_mesh(tp_size=2)
