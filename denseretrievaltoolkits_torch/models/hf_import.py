"""HF BERT and T5 checkpoints in and out of the port, without ``transformers``.

Counterpart of ``denseretrievaltoolkits_tpu/models/hf_import.py`` (:22-155):
a torch ``BertModel`` state dict becomes the reference's stacked-layer tree
(numpy, ``[in, out]`` kernels; ``models/convert.py`` maps it onto a
``BertEncoder``) and back. The card's machine has neither ``transformers`` nor
``safetensors``, so a local HF directory is read by hand:

- ``config.json`` maps onto ``BertConfig`` as the reference's
  ``BertConfig.from_hf_config`` maps it (bert.py:62-73); an absent key takes
  HF ``BertConfig``'s default;
- the weights come from ``model.safetensors``, parsed with numpy (an 8-byte
  little-endian header length, a JSON header of dtypes, shapes and offsets,
  then the raw bytes), or from ``pytorch_model.bin`` by
  ``torch.load(weights_only=True)``;
- old checkpoints' LayerNorm ``gamma`` / ``beta`` are renamed ``weight`` /
  ``bias``, as ``transformers`` renames them on load;
- a ``config.json`` with ``model_type: t5`` maps onto ``T5Config`` by its
  ``from_hf_config`` (``models/t5.py``), and its weights onto the T5 tree by
  ``t5.params_from_torch_state_dict``: the encoder alone (what
  ``T5EncoderModel.from_pretrained`` takes, from either checkpoint kind) or with
  the decoder.

Export writes ``config.json`` and a ``model.safetensors`` by the same format
by hand; ``transformers.BertModel.from_pretrained`` loads the directory. A
path that is no local directory (a hub id) needs a download and raises, and so
does a sharded checkpoint (``*.index.json``): ``save_pretrained`` never shards
a BERT under its 5 GB default.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from . import t5
from .bert import BertConfig

SAFETENSORS = "model.safetensors"
TORCH_BIN = "pytorch_model.bin"
HF_CONFIG = "config.json"

# HF BertConfig's defaults, for keys a config.json leaves out
HF_DEFAULTS = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                   num_attention_heads=12, intermediate_size=3072, max_position_embeddings=512,
                   type_vocab_size=2, layer_norm_eps=1e-12, pad_token_id=0)

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
              "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "BOOL": np.bool_}

_LAYER_MAP = (
    ("q_kernel", "attention.self.query.weight", True),
    ("q_bias", "attention.self.query.bias", False),
    ("k_kernel", "attention.self.key.weight", True),
    ("k_bias", "attention.self.key.bias", False),
    ("v_kernel", "attention.self.value.weight", True),
    ("v_bias", "attention.self.value.bias", False),
    ("o_kernel", "attention.output.dense.weight", True),
    ("o_bias", "attention.output.dense.bias", False),
    ("attn_ln_scale", "attention.output.LayerNorm.weight", False),
    ("attn_ln_bias", "attention.output.LayerNorm.bias", False),
    ("wi_kernel", "intermediate.dense.weight", True),
    ("wi_bias", "intermediate.dense.bias", False),
    ("wo_kernel", "output.dense.weight", True),
    ("wo_bias", "output.dense.bias", False),
    ("mlp_ln_scale", "output.LayerNorm.weight", False),
    ("mlp_ln_bias", "output.LayerNorm.bias", False),
)
_EMB_MAP = (("word", "word_embeddings.weight"), ("position", "position_embeddings.weight"),
            ("token_type", "token_type_embeddings.weight"), ("ln_scale", "LayerNorm.weight"),
            ("ln_bias", "LayerNorm.bias"))


# -- safetensors, by hand ---------------------------------------------------------------------

def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as a numpy array (BF16 widened to fp32)."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
        data = fh.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = data[begin:end]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
        elif info["dtype"] in _ST_DTYPES:
            out[name] = np.frombuffer(raw, dtype=np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder(
                "<")).reshape(shape).copy()
        else:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which the "
                             f"reader does not take")
    return out


def write_safetensors(tensors: Dict[str, np.ndarray], path: str) -> None:
    """Write fp32 / int tensors in the ``.safetensors`` format, names sorted, the header
    padded with spaces to a multiple of 8 bytes, ``{"format": "pt"}`` as metadata."""
    names = {np.dtype(v).type: k for k, v in _ST_DTYPES.items()}
    header: Dict[str, Any] = {"__metadata__": {"format": "pt"}}
    blobs, offset = [], 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        blob = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": names[arr.dtype.type], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(struct.pack("<Q", len(head)))
        fh.write(head)
        for blob in blobs:
            fh.write(blob)
    os.replace(tmp, path)


# -- state dicts --------------------------------------------------------------------------------

def _numpy(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
    return np.asarray(v)


def rename_legacy_keys(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """LayerNorm ``gamma`` / ``beta`` -> ``weight`` / ``bias``, as ``transformers``
    renames them when it loads an old checkpoint."""
    out = {}
    for k, v in state_dict.items():
        if k.endswith("LayerNorm.gamma"):
            k = k[:-len("gamma")] + "weight"
        elif k.endswith("LayerNorm.beta"):
            k = k[:-len("beta")] + "bias"
        out[k] = v
    return out


def params_from_torch_state_dict(state_dict: Dict[str, Any], config: BertConfig) -> Dict:
    """A torch ``BertModel`` state dict (tensors or numpy arrays; the ``bert.`` prefix of
    a ``BertFor*`` model taken) -> the reference-layout numpy tree, fp32. Without a pooler
    the tree gets a zero one (hf_import.py:69-74 there)."""
    state_dict = rename_legacy_keys(state_dict)
    prefix = "" if any(k.startswith("embeddings.") for k in state_dict) else "bert."

    def a(name):
        return np.asarray(_numpy(state_dict[prefix + name]), np.float32)

    def t(name):  # torch Linear stores [out, in]; the tree [in, out]
        return np.ascontiguousarray(a(name).T)

    L = config.num_hidden_layers
    layers = {ours: np.stack([(t if tr else a)(f"encoder.layer.{i}.{theirs}") for i in range(L)])
              for ours, theirs, tr in _LAYER_MAP}
    tree = {"embeddings": {ours: a(f"embeddings.{theirs}") for ours, theirs in _EMB_MAP},
            "layers": layers}
    if prefix + "pooler.dense.weight" in state_dict:
        tree["pooler"] = {"kernel": t("pooler.dense.weight"), "bias": a("pooler.dense.bias")}
    else:
        H = config.hidden_size
        tree["pooler"] = {"kernel": np.zeros((H, H), np.float32),
                          "bias": np.zeros((H,), np.float32)}
    return tree


def params_to_torch_state_dict(tree: Dict, config: BertConfig) -> Dict[str, torch.Tensor]:
    """The reference-layout tree -> a torch ``BertModel`` state dict of fp32 CPU
    tensors (hf_import.py:109-134 there). A tree with LoRA adapters must be merged
    first (``models/lora.py:merge_lora_tree``): ``BertModel`` has no place for them."""
    if "lora_q_A" in tree["layers"]:
        raise ValueError("LoRA adapters have no HF BertModel key: merge them first")

    def ta(x):
        return torch.from_numpy(np.array(x, np.float32))

    def tt(x):  # [in, out] -> torch [out, in]
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).T))

    emb, layers = tree["embeddings"], tree["layers"]
    sd = {f"embeddings.{theirs}": ta(emb[ours]) for ours, theirs in _EMB_MAP}
    sd["pooler.dense.weight"] = tt(tree["pooler"]["kernel"])
    sd["pooler.dense.bias"] = ta(tree["pooler"]["bias"])
    for i in range(config.num_hidden_layers):
        for ours, theirs, transpose in _LAYER_MAP:
            x = np.asarray(layers[ours][i])
            sd[f"encoder.layer.{i}.{theirs}"] = tt(x) if transpose else ta(x)
    return sd


# -- directories --------------------------------------------------------------------------------

def config_from_hf(hf: Dict):
    """An HF ``config.json`` (a dict) -> ``BertConfig``, the fields the reference's
    ``from_hf_config`` maps, or for ``model_type: t5`` a ``T5Config``; absent keys take
    HF's defaults. Other model types raise."""
    model_type = hf.get("model_type", "bert")
    if model_type == "t5":
        return t5.T5Config.from_hf_config(hf)
    if model_type != "bert":
        raise ValueError(f"model_type {model_type!r}: the port reads BERT and T5 towers only, "
                         f"as the reference does")
    return BertConfig(**{k: hf.get(k, v) for k, v in HF_DEFAULTS.items()})


def hf_config_dict(config: BertConfig) -> Dict:
    """The ``config.json`` ``BertModel.save_pretrained`` writes for ``config``."""
    return {"architectures": ["BertModel"], "model_type": "bert",
            "attention_probs_dropout_prob": 0.1, "hidden_act": "gelu",
            "hidden_dropout_prob": 0.1, "hidden_size": config.hidden_size,
            "initializer_range": config.initializer_range,
            "intermediate_size": config.intermediate_size,
            "layer_norm_eps": config.layer_norm_eps,
            "max_position_embeddings": config.max_position_embeddings,
            "num_attention_heads": config.num_attention_heads,
            "num_hidden_layers": config.num_hidden_layers, "pad_token_id": config.pad_token_id,
            "position_embedding_type": "absolute", "torch_dtype": "float32",
            "type_vocab_size": config.type_vocab_size, "use_cache": True,
            "vocab_size": config.vocab_size}


def read_state_dict(path: str) -> Dict[str, Any]:
    """The weights of a local HF directory: ``model.safetensors``, else
    ``pytorch_model.bin``. Sharded checkpoints raise."""
    st, pt = os.path.join(path, SAFETENSORS), os.path.join(path, TORCH_BIN)
    if os.path.isfile(st):
        return read_safetensors(st)
    if os.path.isfile(pt):
        return torch.load(pt, map_location="cpu", weights_only=True)
    for index in (SAFETENSORS + ".index.json", TORCH_BIN + ".index.json"):
        if os.path.isfile(os.path.join(path, index)):
            raise NotImplementedError(
                f"{path}: a sharded checkpoint ({index}) is not read by the port; BERT and "
                f"T5-base sizes never shard under save_pretrained's 5 GB default")
    raise FileNotFoundError(f"{path}: no {SAFETENSORS} or {TORCH_BIN}")


def read_config(local_dir: str):
    """The ``BertConfig`` or ``T5Config`` of a local HF directory's ``config.json``."""
    with open(os.path.join(local_dir, HF_CONFIG)) as fh:
        return config_from_hf(json.load(fh))


def params_from_pretrained(local_dir: str, with_decoder: bool = False) -> Tuple[Dict, Any]:
    """A local HF BERT or T5 directory -> (reference-layout tree, ``BertConfig`` or
    ``T5Config``); a T5 tree holds the decoder with ``with_decoder``, else the encoder
    only. A path that is no local directory (a hub id) raises: it needs a download."""
    if not os.path.isdir(local_dir):
        raise NotImplementedError(
            f"{local_dir!r} is not a local directory: a hub id needs a download, which the "
            f"port does not do (ROADMAP queue 1, item 'LoRA and HF import/export' reads local "
            f"HF directories only)")
    config = read_config(local_dir)
    if isinstance(config, t5.T5Config):
        return t5.params_from_torch_state_dict(read_state_dict(local_dir), config,
                                               with_decoder=with_decoder), config
    return params_from_torch_state_dict(read_state_dict(local_dir), config), config


def save_pretrained_hf(tree: Dict, config: BertConfig, output_dir: str) -> None:
    """Write ``output_dir/config.json`` and ``output_dir/model.safetensors`` (fp32), the
    HF deploy format ``BertModel.from_pretrained`` loads."""
    os.makedirs(output_dir, exist_ok=True)
    sd = params_to_torch_state_dict(tree, config)
    write_safetensors({k: v.numpy() for k, v in sd.items()},
                      os.path.join(output_dir, SAFETENSORS))
    with open(os.path.join(output_dir, HF_CONFIG), "w") as fh:
        json.dump(hf_config_dict(config), fh, indent=2, sort_keys=True)
