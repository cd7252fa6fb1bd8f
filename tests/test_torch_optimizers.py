"""The port's adagrad, rmsprop and adafactor against optax 0.2.6, on the CPU.

``train/optimizers.py`` writes the three to optax's formulas. Each runs 5
updates under a linear warmup schedule from the same parameters and
gradients as optax; a 3-step ``Trainer`` trajectory with adafactor is held to
the JAX Trainer's; a LoRA model's base stays bit-unchanged under each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from denseretrievaltoolkits_tpu.config import TrainingArguments
from denseretrievaltoolkits_tpu.train import schedulers as jsched
from denseretrievaltoolkits_tpu.train.trainer import Trainer as JaxTrainer
from denseretrievaltoolkits_torch.models.convert import params_to_jax
from denseretrievaltoolkits_torch.models.lora import lora_trainable
from denseretrievaltoolkits_torch.train import optimizers as topt
from denseretrievaltoolkits_torch.train.trainer import Trainer

from test_torch_train import _args, _build, _flat, _jax_model, _jax_params, _loader, \
    _logged_losses

SCHED = dict(n_warmup_steps=2, max_steps=6)
CASES = [
    ("adagrad", {}),
    ("adagrad", {"initial_accumulator_value": 0.0, "eps": 1e-5}),
    ("rmsprop", {}),
    ("rmsprop", {"centered": True, "momentum": 0.9, "nesterov": True, "eps": 1e-4,
                 "initial_scale": 1.0}),
    ("rmsprop", {"bias_correction": True, "eps_in_sqrt": False, "decay": 0.95,
                 "momentum": 0.5}),
    ("adafactor", {}),
    ("adafactor", {"momentum": 0.9, "weight_decay_rate": 0.01, "decay_offset": 1,
                   "decay_rate": 0.7, "min_dim_size_to_factor": 4}),
    ("adafactor", {"clipping_threshold": None, "multiply_by_parameter_scale": False,
                   "factored": False, "eps": 1e-20}),
]


def _params(rng):
    """A matrix factored at the default 128 (both dims >= 128), a small matrix,
    a vector, and a vector whose gradient is partly 0 (adagrad's where)."""
    return {"factored": rng.normal(size=(300, 130)).astype(np.float32),
            "small": rng.normal(size=(5, 3)).astype(np.float32),
            "vector": rng.normal(size=(7,)).astype(np.float32),
            "sparse": np.zeros((4,), np.float32)}


def _targs(tmp_path, name, kwargs, **kw):
    return TrainingArguments(optimizer=name, optimizer_kwargs=kwargs, learning_rate=0.1,
                             scheduler="linear", scheduler_kwargs=dict(SCHED),
                             output_dir=str(tmp_path), cache_train_dir=str(tmp_path / "c"), **kw)


@pytest.mark.parametrize("name,kwargs", CASES, ids=[f"{n}-{sorted(k)}" for n, k in CASES])
def test_updates_match_optax(name, kwargs, tmp_path):
    """5 updates: the parameters after each within 1e-6 relative (adafactor 1e-5:
    it clips and scales by RMS means, fp32 sums in another order) plus 1e-6
    absolute (an fp32 ulp at |p| ~ 4 is 4.8e-7; reading <= 7.2e-7)."""
    rng = np.random.default_rng(0)
    params = _params(rng)
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    for g in grads:
        g["sparse"][:2] = 0.0
    ref = getattr(optax, name)(jsched.get_schedule("linear", 0.1, SCHED), **kwargs)
    jp = jax.tree.map(jnp.asarray, params)
    state = ref.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = topt.get_optimizer(_targs(tmp_path, name, kwargs), tp.values())
    rtol = 1e-5 if name == "adafactor" else 1e-6
    for g in grads:
        updates, state = ref.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=rtol,
                                       atol=1e-6, err_msg=k)


def test_adafactor_kwargs_merge_over_optimizer_kwargs(tmp_path):
    """``adafactor_kwargs`` override ``optimizer_kwargs`` (optimizers.py:41-43 there);
    an optax kwarg with no translation still raises."""
    args = _targs(tmp_path, "adafactor", {"decay_rate": 0.5, "momentum": 0.9},
                  adafactor_kwargs={"decay_rate": 0.7})
    opt = topt.get_optimizer(args, [torch.nn.Parameter(torch.zeros(3))])
    assert isinstance(opt.optimizer, topt.Adafactor)
    assert opt.optimizer.defaults["decay_rate"] == 0.7
    assert opt.optimizer.defaults["momentum"] == 0.9
    for name, kw in (("adafactor", {"weight_decay_mask": None}), ("adagrad", {"b1": 0.9}),
                     ("rmsprop", {"weight_decay": 0.1})):
        with pytest.raises(NotImplementedError, match=sorted(kw)[0]):
            topt.get_optimizer(_targs(tmp_path, name, kw), [torch.nn.Parameter(torch.zeros(3))])


def test_adafactor_trainer_trajectory_matches_jax(tmp_path):
    """3 steps of the port's and the JAX Trainer from the same weights with
    adafactor and its defaults (the word embeddings, 61 x 32, stay unfactored at
    min_dim_size_to_factor 128; the test above covers the factored form): losses
    within the trajectory test's 1e-5 relative + 2e-6, parameters within 1e-5
    relative + 5e-5 (adafactor divides each gradient by its running RMS, as Adam
    does, so near-zero gradients move by a share of lr in either framework)."""
    port = _build(seed=7)
    jmodel, jparams = _jax_model(port), _jax_params(port)
    kw = dict(optimizer="adafactor", max_epochs=1, learning_rate=1e-2)
    trainer = Trainer(_args(tmp_path / "port", **kw), port, train_loader=_loader())
    trainer.train()
    jtrainer = JaxTrainer(_args(tmp_path / "jax", save_per_train=10, **kw), jmodel, jparams,
                          train_loader=_loader())
    jtrainer.train()
    ours, ref = _logged_losses(trainer.training_args), _logged_losses(jtrainer.training_args)
    assert len(ours) == len(ref) == 3
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=2e-6)
    want = _flat({"lm_q": jtrainer.state["params"]["lm_q"]})
    got = _flat({"lm_q": params_to_jax(trainer.model.lm_q.state_dict())})
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=5e-5, err_msg=k)


@pytest.mark.parametrize("name", ["adagrad", "rmsprop", "adafactor"])
def test_lora_base_bit_unchanged(name, tmp_path):
    """With adapters only they and the heads train: after 2 updates with a
    gradient on every parameter the base is bit for bit what it was, the
    adapters moved."""
    model = _build(seed=3, param_efficient_method="lora", lora_rank=4)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = topt.get_optimizer(_targs(tmp_path, name, {}), model)
    trainable = {id(p) for p in lora_trainable(model)}
    for step in range(2):
        for p in model.parameters():  # a gradient on every parameter, the base's too
            p.grad = torch.full_like(p, 0.5 + step)
        opt.step()
    moved = 0
    for k, v in model.named_parameters():
        if id(v) in trainable:
            moved += int(not torch.equal(v.detach(), before[k]))
        else:
            assert torch.equal(v.detach(), before[k]), k
    assert moved > 0
