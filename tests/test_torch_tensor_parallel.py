"""The port's tensor parallelism (``tp_size`` > 1) against the JAX package's mesh, on the CPU.

Worlds of dp x tp ``gloo`` ranks (``tests/torch_dist_worker.py``, case
``tp<dp>x<tp>``) run the steps of ``torch_dist_worker.TP_STEPS`` on a
``make_mesh(dp, tp)`` mesh: the BERT layers cut over the model axis
(``parallel/mesh.py:shard_module``), the batch over the data axis. The JAX side
runs the same global batch through its Trainer on ``make_mesh(dp, tp)`` over
``tests/conftest.py``'s 8 CPU devices, whose GSPMD step shards the same leaves.
The port's 'fused' and 'flash' steps run their kernels' plain versions here;
the JAX reference of all three is its 'xla' block (its 'flash' runs 'xla' off
the TPU, and its 'fused' Pallas kernels under GSPMD would run replicated, the
same function). Tolerances are ``test_dp_step_matches_jax_mesh``'s: losses 1e-5
relative + 2e-6, parameters 1e-5 relative + 5e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseretrievaltoolkits_tpu.config import ModelArguments as JModelArgs
from denseretrievaltoolkits_tpu.config import RRTrainingArguments as JRRArgs
from denseretrievaltoolkits_tpu.models import bert as jbert
from denseretrievaltoolkits_tpu.models import biencoder as jbi
from denseretrievaltoolkits_tpu.models import reranker as jrr
from denseretrievaltoolkits_tpu.parallel.mesh import make_mesh as jmake_mesh
from denseretrievaltoolkits_tpu.train.trainer import RRTrainer as JRRTrainer
from denseretrievaltoolkits_tpu.train.trainer import Trainer as JTrainer
from denseretrievaltoolkits_torch.config import ModelArguments, RRTrainingArguments
from denseretrievaltoolkits_torch.models import bert as tbert
from denseretrievaltoolkits_torch.models.biencoder import DRModel
from denseretrievaltoolkits_torch.models.convert import params_to_jax
from denseretrievaltoolkits_torch.parallel.mesh import LAYER_RULES, Shard
from denseretrievaltoolkits_torch.train.trainer import Trainer

import torch_dist_worker as W
from test_torch_parallel import _global_batch, _jargs, _jax_flat, _port_params, run_world

LOSS_TOL = dict(rtol=1e-5, atol=2e-6)
PARAM_TOL = dict(rtol=1e-5, atol=5e-5)
WORLDS = [(1, 2), (2, 2)]
STEPS = {label: (attention, optimizer, lr, kw, steps)
         for label, attention, optimizer, lr, kw, steps in W.TP_STEPS}


@pytest.fixture(scope="module", params=WORLDS, ids=[f"dp{d}-tp{t}" for d, t in WORLDS])
def tp_world(request, tmp_path_factory):
    dp, tp = request.param
    work = tmp_path_factory.mktemp(f"tp{dp}x{tp}")
    tbert.save_config(tbert.BertConfig(**dict(W.CFG, vocab_size=96)), str(work / "rr_arch"))
    return dp, tp, work, run_world(f"tp{dp}x{tp}", dp * tp, work), {}


def _jmesh(dp, tp):
    return jmake_mesh(dp, tp, devices=jax.devices()[:dp * tp])


def _jax_side(port):
    """The JAX dual encoder (its 'xla' block) and params of a port model."""
    s = port.spec
    jmodel = jbi.DRModel(jbi.DRModelSpec(bert_config=jbert.BertConfig(**W.CFG), tied=s.tied,
                                         pooling=s.pooling, fused_loss=s.fused_loss))
    return jmodel, jax.tree.map(jnp.asarray, {"lm_q": params_to_jax(port.lm_q.state_dict())})


def _jax_run(world, tmp_path, optimizer, lr, kw, steps):
    """The JAX Trainer's losses and lm_q on the world's mesh, memoized per world."""
    dp, tp, _, _, memo = world
    key = (optimizer, lr, tuple(sorted(kw.items())), steps)
    if key not in memo:
        jmodel, jparams = _jax_side(W.build_model())
        jt = JTrainer(_jargs(tmp_path, optimizer=optimizer, learning_rate=lr,
                             optimizer_kwargs=dict(kw)), jmodel, jparams, mesh=_jmesh(dp, tp))
        losses = [float(jt.train_step(_global_batch())) for _ in range(steps)]
        memo[key] = losses, _jax_flat(jt.state["params"]["lm_q"])
    return memo[key]


def _same_on_every_rank(outs, prefix):
    """Every rank's gathered parameters (cut and replicated leaves) bit for bit rank 0's."""
    for out in outs[1:]:
        for k in outs[0]:
            if k.startswith(prefix + "/"):
                np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)


def test_mesh_layout(tp_world):
    """Rank r sits at data index r // tp and model index r % tp (the JAX mesh's
    reshape(dp, tp)); ``Mesh.shape`` reports both axes."""
    dp, tp, _, outs, _ = tp_world
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["mesh"], [dp, tp, r // tp, r % tp])


@pytest.mark.parametrize("label", [s[0] for s in W.TP_STEPS if "factored" not in s[0]])
def test_tp_step_matches_jax_mesh(tp_world, tmp_path, label):
    """Each attention and optimizer of TP_STEPS on the dp x tp mesh against the JAX
    Trainer on ``make_mesh(dp, tp)`` over the same global 8 x 16 batch and weights:
    losses and parameters within the stated tolerances, and every rank's gathered
    parameters bit-equal (the replicated leaves' copies on the model ranks too)."""
    attention, optimizer, lr, kw, steps = STEPS[label]
    outs = tp_world[3]
    ref_losses, want = _jax_run(tp_world, tmp_path, optimizer, lr, kw, steps)
    for out in outs:
        np.testing.assert_allclose(out[f"{label}/losses"], ref_losses, **LOSS_TOL)
    _same_on_every_rank(outs, label)
    got = _port_params(outs[0], label, W.build_model().lm_q)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **PARAM_TOL, err_msg=k)


def _one_process(tmp_path, label, steps, attention="xla", optimizer="sgd", lr=0.1, kw=None,
                 **model_kw):
    """The port's own one-process steps at the global batch: (losses, lm_q's state)."""
    trainer = Trainer(W.train_args(str(tmp_path), label, optimizer=optimizer, learning_rate=lr,
                                   optimizer_kwargs=dict(kw or {})),
                      W.build_model(attention=attention, **model_kw))
    losses = [float(trainer.train_step(_global_batch())) for _ in range(steps)]
    return np.array(losses), W.state_of(trainer.model.lm_q, label)


def test_tp_adafactor_equals_one_process(tp_world, tmp_path):
    """Adafactor with every matrix factored (``min_dim_size_to_factor`` 16): its row
    and column moments, update clip and parameter RMS reduced over the model group
    give the one-process update: 2 steps on 'fused' within 1e-6 relative + 1e-7.
    The k third of the qkv bias is held to 5e-5: its gradient is 0 in exact
    arithmetic (softmax ignores a shift shared by every key), and adafactor turns
    its fp32 noise into +-lr x 1e-3 a step in either run."""
    label = "fused_adafactor_factored"
    attention, optimizer, lr, kw, steps = STEPS[label]
    losses, want = _one_process(tmp_path, label, steps, attention, optimizer, lr, kw)
    outs = tp_world[3]
    _same_on_every_rank(outs, label)
    np.testing.assert_allclose(outs[0][f"{label}/losses"], losses, rtol=1e-6, atol=1e-7)
    H = W.CFG["hidden_size"]
    for k, v in want.items():
        got = outs[0][k]
        if k.endswith("qkv_bias"):
            np.testing.assert_allclose(got[H:2 * H], v[H:2 * H], rtol=1e-6, atol=5e-5,
                                       err_msg=k)
            got, v = np.concatenate([got[:H], got[2 * H:]]), np.concatenate([v[:H], v[2 * H:]])
        np.testing.assert_allclose(got, v, rtol=1e-6, atol=1e-7, err_msg=k)


def test_tp_lora_step_equals_one_process(tp_world, tmp_path):
    """LoRA (rank 4) on the mesh: the adapters replicated, each rank adding its heads'
    columns of (x A) B with their gradients summed over the model group; 2 sgd steps
    (the second moves A, whose first gradient is 0 through B = 0) against the port's
    one-process steps, which tests/test_torch_lora.py holds to the JAX package:
    losses within 1e-5 + 2e-6, parameters within 1e-5 + 5e-5, the frozen base
    unchanged."""
    losses, want = _one_process(tmp_path, "lora", 2, lr=0.5, param_efficient_method="lora",
                                lora_rank=4)
    outs = tp_world[3]
    _same_on_every_rank(outs, "lora")
    np.testing.assert_allclose(outs[0]["lora/losses"], losses, **LOSS_TOL)
    base = W.state_of(W.build_model(param_efficient_method="lora", lora_rank=4).lm_q, "lora")
    moved = 0
    for k, v in want.items():
        np.testing.assert_allclose(outs[0][k], v, **PARAM_TOL, err_msg=k)
        if "lora_" in k:
            moved += int(not np.array_equal(outs[0][k], base[k]))
        else:
            np.testing.assert_array_equal(outs[0][k], base[k], err_msg=k)
    assert moved == 4 * W.CFG["num_hidden_layers"]


def test_tp_rrtrainer_matches_jax_mesh(tp_world, tmp_path):
    """RRTrainer on the mesh (the reranker's BERT cut over the model axis) against the
    JAX RRTrainer on ``make_mesh(dp, tp)`` over the same 8 pairs a step: 2 sgd steps'
    losses and the parameters within the stated tolerances."""
    dp, tp, work, outs, _ = tp_world
    margs = ModelArguments(model_name_or_path=str(work / "rr_arch"), pooling="first",
                           pos_token="yes", neg_token="no")
    targs = RRTrainingArguments(output_dir=str(tmp_path / "o"), cache_train_dir=str(tmp_path),
                                loss_fn="mr", margin=0.7)
    from denseretrievaltoolkits_torch.models.reranker import RRModel

    port = RRModel.build(margs, train_args=targs, tokenizer=W.RRTok(), device="cpu", seed=3)
    jmodel = jrr.RRModel(jrr.RRModelSpec(
        bert_config=jbert.BertConfig(**dict(W.CFG, vocab_size=96)), pooling="first",
        loss_fn="mr", margin=0.7))
    jparams = {"lm": params_to_jax(port.lm.state_dict())}
    if port.head is not None:
        jparams["head"] = {"kernel": port.head.kernel.detach().numpy().copy()}
    jt = JRRTrainer(JRRArgs(output_dir=str(tmp_path / "j"), cache_train_dir=str(tmp_path / "jc"),
                            loss_fn="mr", margin=0.7, optimizer="sgd", learning_rate=1e-2,
                            log_every=0, save_per_train=10),
                    jmodel, jax.tree.map(jnp.asarray, jparams), mesh=_jmesh(dp, tp))
    ref = [float(jt.train_step((W.token_batch(8, 12, 10 + i), W.token_batch(8, 12, 20 + i))))
           for i in range(2)]
    for out in outs:
        np.testing.assert_allclose(out["rr_losses"], ref, **LOSS_TOL)
    _same_on_every_rank(outs, "rr")
    got = _port_params(outs[0], "rr", port.lm)
    want = _jax_flat(jt.state["params"]["lm"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **PARAM_TOL, err_msg=k)


def test_tp_save_loads_in_one_process_and_in_jax(tp_world):
    """``Trainer.save`` on the mesh gathers the parts: the deploy format rank 0 wrote
    loads in one process (``DRModel.build``) and in the JAX package
    (``DRModel.build`` there) to the gathered parameters, bit for bit; each rank
    kept its part (its heads' columns of q, k and v) and wrote its resume
    checkpoint's parts."""
    dp, tp, work, outs, _ = tp_world
    saved = str(work / "xla_sgd0.0" / "cache" / "result1")
    port = DRModel.build(ModelArguments(model_name_or_path=saved), device="cpu")
    for k, v in port.lm_q.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), outs[0][f"xla_sgd/{k}"], err_msg=k)
    _, jparams = jbi.DRModel.build(JModelArgs(model_name_or_path=saved))
    want = _port_params(outs[0], "xla_sgd", port.lm_q)
    got = _jax_flat(jparams["lm_q"] if "lm_q" in jparams else jparams)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    full = torch.from_numpy(outs[0]["xla_sgd/layers.0.qkv_kernel"])
    for r, out in enumerate(outs):
        spec = Shard(*LAYER_RULES["qkv_kernel"], tp, r % tp)
        np.testing.assert_array_equal(out["shard_qkv"], spec.cut(full).numpy())
        ckpt = work / f"xla_sgd{r // tp}.{r % tp}" / "out" / "checkpoint" / "ep1"
        written = sorted(os.listdir(ckpt)) if ckpt.exists() else []
        assert written == ([f"state.tp{r % tp}.pt"] if r // tp == 0 else [])
