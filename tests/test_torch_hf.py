"""HF import and export of the port against the JAX package and ``transformers``, on the CPU.

The port reads and writes local HF directories by hand (``models/hf_import.py``:
``config.json``, ``model.safetensors`` parsed with numpy, ``pytorch_model.bin``
by ``torch.load``). Here, where ``transformers`` exists, its ``BertModel``
loads the port's export (forward within 1e-3, as ``tests/test_hf_export.py``),
and the port reads what ``save_pretrained`` writes into the same tree as the
JAX package's ``params_from_torch_state_dict`` (bit-equal), for BERT and for T5
(``T5EncoderModel`` and ``T5ForConditionalGeneration`` directories). Tiny local
models, no network.
"""

import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from denseretrievaltoolkits_tpu.config import ModelArguments
from denseretrievaltoolkits_tpu.models import bert as jbert
from denseretrievaltoolkits_tpu.models import biencoder as jbi
from denseretrievaltoolkits_tpu.models import hf_import as jhf
from denseretrievaltoolkits_tpu.models import lora as jlora
from denseretrievaltoolkits_tpu.models import t5 as jt5
from denseretrievaltoolkits_torch.models import bert as tbert
from denseretrievaltoolkits_torch.models import biencoder as tbi
from denseretrievaltoolkits_torch.models import hf_import as thf
from denseretrievaltoolkits_torch.models import lora as tlora
from denseretrievaltoolkits_torch.models import t5 as tt5
from denseretrievaltoolkits_torch.models.convert import params_to_jax

TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=64)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ids(seed=0, B=3, S=10):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(1, TINY["vocab_size"], (B, S)).astype(np.int32),
            "attention_mask": np.ones((B, S), np.int32)}


def _hf_model(seed=0, **kw):
    from transformers import BertConfig, BertModel

    torch.manual_seed(seed)
    return BertModel(BertConfig(**TINY), **kw).eval()


def _hf_hidden(hf, batch):
    with torch.no_grad():
        return hf(input_ids=torch.from_numpy(batch["input_ids"]).long(),
                  attention_mask=torch.from_numpy(batch["attention_mask"]).long()
                  ).last_hidden_state.numpy()


def _port_hidden(model, batch, tower="lm_q"):
    b = model._batch(batch)
    with torch.inference_mode():
        return getattr(model, tower)(b["input_ids"], b["attention_mask"]).numpy()


def _port(path=None, **kw):
    return tbi.DRModel.build(ModelArguments(model_name_or_path=path, **kw),
                             bert_config=tbert.BertConfig(**TINY), seed=3, device="cpu")


def test_export_loads_in_transformers(tmp_path):
    """The port's export_hf: ``transformers.BertModel.from_pretrained`` loads it with
    nothing missing, and its forward matches the port's within 1e-3."""
    from transformers import BertModel

    port = _port()
    port.export_hf(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["config.json", "model.safetensors"]
    hf, info = BertModel.from_pretrained(str(tmp_path), output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"]
    batch = _ids(1)
    np.testing.assert_allclose(_port_hidden(port, batch), _hf_hidden(hf.eval(), batch),
                               rtol=1e-3, atol=1e-3)


def test_export_is_bit_equal_to_jax(tmp_path):
    """Same weights, both packages' export_hf: the same tensor names, bit-equal values,
    and configs that ``transformers`` reads to the same fields."""
    from safetensors.numpy import load_file
    from transformers import BertConfig

    jmodel = jbi.DRModel(jbi.DRModelSpec(bert_config=jbert.BertConfig(**TINY)))
    jparams = jmodel.init_params(jax.random.key(0))
    jmodel.export_hf(jparams, str(tmp_path / "jax"))
    port = _port()
    port.load_tower_tree("lm_q", jax.tree.map(np.asarray, jparams["lm_q"]))
    port.export_hf(str(tmp_path / "port"))
    want = load_file(str(tmp_path / "jax" / "model.safetensors"))
    got = load_file(str(tmp_path / "port" / "model.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    a, b = (BertConfig.from_pretrained(str(tmp_path / d)).to_dict() for d in ("jax", "port"))
    for key in list(thf.HF_DEFAULTS) + ["hidden_act", "model_type", "initializer_range"]:
        assert a[key] == b[key], key


def test_untied_export(tmp_path):
    """Untied towers go to ``query_model/`` and ``passage_model/``, each loadable and
    each its own tower's forward."""
    from transformers import BertModel

    port = _port(untie_encoder=True)
    with torch.no_grad():
        port.lm_p.layers[0].wi_bias.add_(0.5)  # make the towers differ
    port.export_hf(str(tmp_path))
    batch = _ids(2)
    for sub, tower in (("query_model", "lm_q"), ("passage_model", "lm_p")):
        hf = BertModel.from_pretrained(str(tmp_path / sub)).eval()
        np.testing.assert_allclose(_port_hidden(port, batch, tower), _hf_hidden(hf, batch),
                                   rtol=1e-3, atol=1e-3)
    assert np.abs(_port_hidden(port, batch, "lm_q") - _port_hidden(port, batch, "lm_p")).max() > 0.1


def _save(kind, path):
    """A local HF directory as each kind of checkpoint writes it; returns its raw
    state dict (what the JAX package's converter reads)."""
    from transformers import BertForPreTraining

    if kind == "bert-prefix":  # a BertForPreTraining: "bert." keys beside its heads
        from transformers import BertConfig

        torch.manual_seed(4)
        model = BertForPreTraining(BertConfig(**TINY)).eval()
        model.save_pretrained(path, safe_serialization=False)
        return model.state_dict()
    hf = _hf_model(4, add_pooling_layer=kind != "no-pooler")
    if kind == "gamma-beta":  # an old checkpoint's LayerNorm names
        hf.save_pretrained(path)
        os.remove(os.path.join(path, "model.safetensors"))
        sd = {k.replace("LayerNorm.weight", "LayerNorm.gamma").replace("LayerNorm.bias",
                                                                        "LayerNorm.beta"): v
              for k, v in hf.state_dict().items()}
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))
        return hf.state_dict()
    hf.save_pretrained(path, safe_serialization=kind != "bin")
    return hf.state_dict()


@pytest.mark.parametrize("kind", ["safetensors", "bin", "bert-prefix", "gamma-beta",
                                  "no-pooler"])
def test_reads_hf_directories(kind, tmp_path):
    """``params_from_pretrained`` reads each directory into the tree the JAX package's
    ``params_from_torch_state_dict`` makes of its state dict, bit-equal (a zero pooler
    where there is none), with the same config; ``DRModel.build`` from the directory
    encodes as the JAX package's build does (2e-5)."""
    path = str(tmp_path / kind)
    sd = _save(kind, path)
    tree, config = thf.params_from_pretrained(path)
    assert config == tbert.BertConfig(**TINY)
    want = _flat(jax.tree.map(np.asarray, jhf.params_from_torch_state_dict(
        sd, jbert.BertConfig(**TINY))))
    got = _flat(tree)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if kind == "no-pooler":  # transformers would give the JAX build a random pooler
        assert not got["['pooler']['kernel']"].any()
        return
    port = tbi.DRModel.build(ModelArguments(model_name_or_path=path), device="cpu")
    jmodel, jparams = jbi.DRModel.build(ModelArguments(model_name_or_path=path))
    q = _ids(5)
    np.testing.assert_allclose(
        port.encode_query(q).numpy(),
        np.asarray(jmodel.encode_query(jparams, jax.tree.map(jnp.asarray, q))),
        rtol=2e-5, atol=2e-5)


def test_without_transformers_and_safetensors(tmp_path, monkeypatch):
    """With ``transformers`` and ``safetensors`` unimportable (as on the card's
    machine), the port builds from an HF directory and exports one; the export
    equals the directory it read."""
    src = str(tmp_path / "src")
    _hf_model(6).save_pretrained(src)
    want = thf.read_safetensors(os.path.join(src, "model.safetensors"))
    for name in [m for m in sys.modules if m.split(".")[0] in ("transformers", "safetensors")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    with pytest.raises(ImportError):
        import transformers  # noqa: F401
    port = tbi.DRModel.build(ModelArguments(model_name_or_path=src, dtype="bfloat16",
                                            attention="fused"), device="cpu")
    port.export_hf(str(tmp_path / "out"))
    got = thf.read_safetensors(str(tmp_path / "out" / "model.safetensors"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(tmp_path / "out" / "config.json") as fh:
        assert json.load(fh)["hidden_size"] == TINY["hidden_size"]


def test_lora_export_is_the_merged_tower(tmp_path):
    """Finding (a): the reference's export_hf drops the adapters; the port exports the
    merged tower. Held to the JAX package's export of ``merge_lora(params)`` (fp32,
    the rank-4 sum: within 1e-6), and loaded by transformers it encodes as the adapted
    tower (1e-3)."""
    from safetensors.numpy import load_file
    from transformers import BertModel

    port = _port(param_efficient_method="lora", lora_rank=4)
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for name, prm in port.named_parameters():
            if name.endswith("_B"):
                prm.copy_(torch.from_numpy((0.3 * rng.standard_normal(prm.shape)
                                            ).astype(np.float32)))
    port.export_hf(str(tmp_path / "port"))
    assert tlora.has_lora(port)  # the model keeps its adapters
    tree = jax.tree.map(jnp.asarray, params_to_jax(port.lm_q.state_dict()))
    jmodel = jbi.DRModel(jbi.DRModelSpec(bert_config=jbert.BertConfig(**TINY)))
    jmodel.export_hf({"lm_q": jlora.merge_lora(tree)}, str(tmp_path / "jax"))
    jmodel.export_hf({"lm_q": tree}, str(tmp_path / "jax-dropped"))
    want = load_file(str(tmp_path / "jax" / "model.safetensors"))
    got = load_file(str(tmp_path / "port" / "model.safetensors"))
    dropped = load_file(str(tmp_path / "jax-dropped" / "model.safetensors"))
    key = "encoder.layer.1.attention.self.query.weight"
    assert np.abs(dropped[key] - want[key]).max() > 1e-2  # the reference's export lost them
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    batch = _ids(8)
    hf = BertModel.from_pretrained(str(tmp_path / "port")).eval()
    np.testing.assert_allclose(_hf_hidden(hf, batch), _port_hidden(port, batch), rtol=1e-3,
                               atol=1e-3)


def test_hub_ids_and_sharded_checkpoints_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="needs a download"):
        thf.params_from_pretrained("bert-base-uncased")
    with pytest.raises(NotImplementedError, match="needs a download"):
        tbi.DRModel.build(ModelArguments(model_name_or_path="org/some-bert"), device="cpu")
    _hf_model(9).save_pretrained(str(tmp_path))
    os.replace(tmp_path / "model.safetensors", tmp_path / "model-00001-of-00001.safetensors")
    (tmp_path / "model.safetensors.index.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="sharded"):
        thf.params_from_pretrained(str(tmp_path))
    # a T5 config.json maps onto T5Config (the reference's from_hf_config): is_gated_act
    # from feed_forward_proj, relative_attention_max_distance 128 where absent, HF's
    # defaults for the rest; other model types raise
    cfg = thf.config_from_hf({"model_type": "t5", "d_model": 48, "num_layers": 3,
                              "feed_forward_proj": "gated-gelu", "tie_word_embeddings": False})
    assert cfg == tt5.T5Config(d_model=48, num_layers=3, is_gated_act=True,
                               tie_word_embeddings=False, relative_attention_max_distance=128)
    assert not thf.config_from_hf({"model_type": "t5"}).is_gated_act
    with pytest.raises(ValueError, match="roberta"):
        thf.config_from_hf({"model_type": "roberta"})


# --- T5 directories ---------------------------------------------------------------------------

T5_HF = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4,
             relative_attention_num_buckets=8, relative_attention_max_distance=20,
             decoder_start_token_id=0)
# (model class, tie_word_embeddings, feed_forward_proj, num_decoder_layers, serialization)
T5_CASES = {
    "encoder-safetensors": ("T5EncoderModel", True, "relu", None, True),
    "encoder-bin": ("T5EncoderModel", True, "relu", None, False),
    "full-tied-safetensors": ("T5ForConditionalGeneration", True, "relu", None, True),
    "full-untied-gated-bin": ("T5ForConditionalGeneration", False, "gated-gelu", 3, False),
    "full-untied-gated-safetensors": ("T5ForConditionalGeneration", False, "gated-gelu", 3,
                                      True),
}


def _t5_hf_dir(kind, path):
    import transformers

    cls_name, tied, proj, n_dec, safe = T5_CASES[kind]
    torch.manual_seed(len(kind))
    config = transformers.T5Config(**T5_HF, tie_word_embeddings=tied, feed_forward_proj=proj,
                                   num_decoder_layers=n_dec)
    hf = getattr(transformers, cls_name)(config).eval()
    hf.save_pretrained(path, safe_serialization=safe)
    return hf


@pytest.mark.parametrize("kind", sorted(T5_CASES))
def test_reads_t5_hf_directories(kind, tmp_path):
    """A T5 directory written by ``save_pretrained`` (safetensors or ``.bin``; tied, or
    untied and gated with ``lm_head``; a ``num_decoder_layers`` the reference does not
    read: it stacks ``num_layers`` decoder blocks) reads into the tree JAX's
    ``params_from_torch_state_dict`` makes of the model's state dict, bit-equal: the
    encoder alone from either kind, and the decoder from a full checkpoint. The config is
    JAX's ``from_hf_config``'s. ``DRModel.build`` from the directory encodes as the JAX
    package's build does (2e-5): ``encoder_only`` the pooled encoder, else the decoder's
    step-0 state."""
    path = str(tmp_path / f"t5-{kind}")
    hf = _t5_hf_dir(kind, path)
    jcfg = jt5.T5Config.from_hf_config(hf.config)
    full = T5_CASES[kind][0] == "T5ForConditionalGeneration"
    for with_decoder in (False, True) if full else (False,):
        tree, config = thf.params_from_pretrained(path, with_decoder=with_decoder)
        assert config == tt5.T5Config(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
        want = _flat(jax.tree.map(np.asarray, jt5.params_from_torch_state_dict(
            hf.state_dict(), jcfg, with_decoder=with_decoder)))
        got = _flat(tree)
        assert got.keys() == want.keys()
        assert ("['lm_head']" in got) == (with_decoder and not T5_CASES[kind][1])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    q = _ids(5)
    for encoder_only in (True, False) if full else (True,):
        margs = ModelArguments(model_name_or_path=path, encoder_only=encoder_only,
                               pooling="mean")
        port = tbi.DRModel.build(margs, device="cpu")
        jmodel, jparams = jbi.DRModel.build(margs)
        assert port.spec.backbone == jmodel.spec.backbone == ("t5" if encoder_only
                                                              else "t5_full")
        np.testing.assert_allclose(
            port.encode_query(q).numpy(),
            np.asarray(jmodel.encode_query(jparams, jax.tree.map(jnp.asarray, q))),
            rtol=2e-5, atol=2e-5)


def test_t5_checkpoint_with_only_embed_tokens(tmp_path):
    """A T5 file may keep only ``encoder.embed_tokens.weight`` of the tied pair: the port
    reads it as ``shared``, equal to JAX's tree of the full state dict."""
    hf = _t5_hf_dir("encoder-bin", str(tmp_path / "src"))
    sd = {k: v for k, v in hf.state_dict().items() if k != "shared.weight"}
    assert "encoder.embed_tokens.weight" in sd
    os.makedirs(tmp_path / "t5")
    torch.save(sd, tmp_path / "t5" / "pytorch_model.bin")
    os.replace(tmp_path / "src" / "config.json", tmp_path / "t5" / "config.json")
    tree, _ = thf.params_from_pretrained(str(tmp_path / "t5"))
    want = jt5.params_from_torch_state_dict(hf.state_dict(), jt5.T5Config.from_hf_config(
        hf.config))
    np.testing.assert_array_equal(tree["shared"], np.asarray(want["shared"]))
