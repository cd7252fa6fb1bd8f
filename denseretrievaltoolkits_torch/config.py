"""Configuration layer (L1): the Model/Data/Training dataclass triple.

Mirrors the public flag surface of the reference's ``DRT/arguments.py:6-226``
(ModelArguments / DataArguments / TrainingArguments / RRTrainingArguments) —
same flag names, same defaults, same ``__post_init__`` normalization — plus
the JAX package's additions (mesh shape, index dtype, kernel toggle, seed).

The port's own copy of ``denseretrievaltoolkits_tpu/config.py``: the same
fields, defaults and parsing, so the flags of both packages parse alike. Only
help texts that named a TPU mechanism describe what the port does on CUDA.

Parsing supports the reference's dual mode (``run_random_sampling.py:21-24``):
either CLI flags or a single JSON-file argument.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import typing
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class ModelArguments:
    """Model selection and shape flags (reference ``DRT/arguments.py:6-77``)."""

    model_name_or_path: str = field(
        default=None,
        metadata={"help": "Path to pretrained model or HF model identifier"},
    )
    target_model_path: Optional[str] = field(
        default=None, metadata={"help": "Path to pretrained reranker target model"}
    )
    config_name: Optional[str] = field(
        default=None, metadata={"help": "Pretrained config name or path"}
    )
    num_labels: int = field(default=1, metadata={"help": "number of labels"})
    tokenizer_name: Optional[str] = field(
        default=None, metadata={"help": "Pretrained tokenizer name or path"}
    )
    cache_dir: Optional[str] = field(
        default=None, metadata={"help": "Where to store downloaded pretrained models"}
    )

    # modeling
    untie_encoder: bool = field(
        default=False,
        metadata={"help": "no weight sharing between query/passage encoders"},
    )
    feature: str = field(
        default="last_hidden_state",
        metadata={"help": "Which encoder output feature to pool"},
    )
    pooling: str = field(
        default="first", metadata={"help": "Pooling: first | mean | max"}
    )

    # out projection
    add_linear_head: bool = field(default=False)
    projection_in_dim: int = field(default=768)
    projection_out_dim: int = field(default=768)

    dtype: str = field(
        default="float32",
        metadata={"help": "Compute dtype: float32 | float16 | bfloat16"},
    )

    encoder_only: bool = field(
        default=False, metadata={"help": "Use only the encoder of T5"}
    )
    pos_token: Optional[str] = field(
        default=None, metadata={"help": "Token indicating a relevant document (T5 reranker)"}
    )
    neg_token: Optional[str] = field(
        default=None, metadata={"help": "Token indicating an irrelevant document (T5 reranker)"}
    )

    normalize: bool = field(
        default=False, metadata={"help": "L2-normalize the embeddings"}
    )
    param_efficient_method: Optional[str] = field(
        default=None,
        metadata={"help": "Param-efficient method: 'lora' adds rank-r adapters "
                  "on the attention q/v projections and freezes the base"},
    )
    lora_rank: int = field(default=8, metadata={"help": "LoRA adapter rank"})

    # --- additions of the JAX package ---
    remat: str = field(
        default="",
        metadata={"help": "Rematerialization: '' (off) | 'full' (checkpoint "
                  "whole encoder blocks) | 'attn' (recompute only attention "
                  "tensors). Not ported yet: the port raises for both"},
    )
    fused_loss: bool = field(
        default=False,
        metadata={"help": "Compute the in-batch contrastive loss with the fused "
                  "similarity+CE CUDA kernels (K3/K4; never materializes the "
                  "score matrix in device memory)"},
    )
    attention: str = field(
        default="xla",
        metadata={"help": "Attention implementation: 'xla' (plain PyTorch "
                  "einsum+softmax) | 'flash' (not ported yet: raises) | "
                  "'fused' (the CUDA encoder-block kernels K1/K2 for short "
                  "sequences: attention+o-proj+LN and MLP+gelu+LN — scores "
                  "and the [B,S,F] gelu intermediate never reach device "
                  "memory)"},
    )


@dataclass
class DataArguments:
    """Dataset ids and tokenization lengths (reference ``DRT/arguments.py:80-165``)."""

    dataset: Optional[str] = field(
        default=None, metadata={"help": "dataset name: nq, wq, tq, squad, msmarco"}
    )
    data_dir: Optional[str] = field(default=None, metadata={"help": "Path to train directory"})
    dataset_name: Optional[str] = field(default=None, metadata={"help": "HF dataset name"})
    corpus_name: Optional[str] = field(default=None, metadata={"help": "HF corpus dataset name"})
    corpus_path: Optional[str] = field(default=None, metadata={"help": "corpus dataset path"})
    passage_field_separator: str = field(default=" ")
    dataset_proc_num: int = field(
        default=12, metadata={"help": "processes used in dataset preprocessing"}
    )
    train_n_passages: int = field(default=8)
    positive_passage_no_shuffle: bool = field(
        default=False, metadata={"help": "always use the first positive passage"}
    )
    negative_passage_no_shuffle: bool = field(
        default=False, metadata={"help": "always use the first negative passages"}
    )

    encode_in_path: Optional[List[str]] = field(
        default=None, metadata={"help": "Path to data to encode"}
    )
    encodedq_save_path: Optional[str] = field(default=None)
    encodedp_save_path: Optional[str] = field(default=None)
    encode_is_qry: bool = field(default=False)
    encode_num_shard: int = field(default=1)
    encode_shard_index: int = field(default=0)

    q_max_len: int = field(
        default=32, metadata={"help": "Max query length (pad/truncate to static shape)"}
    )
    p_max_len: int = field(
        default=128, metadata={"help": "Max passage length (pad/truncate to static shape)"}
    )
    bucketed_encode: bool = field(
        default=False,
        metadata={"help": "Corpus encode pads each batch to its length "
                  "bucket (multiples of bucket_step up to p_max_len) over a "
                  "length-sorted iteration, instead of always padding to "
                  "p_max_len, so padded tokens cost no compute. At most "
                  "ceil(p_max_len/bucket_step) batch shapes. Single-host "
                  "corpus encode only"},
    )
    bucket_step: int = field(
        default=32,
        metadata={"help": "Length-bucket granularity for bucketed_encode"},
    )
    data_cache_dir: Optional[str] = field(
        default=None, metadata={"help": "Where to cache HF datasets downloads"}
    )

    def __post_init__(self):
        # `name/split`, `name:language` parsing (reference arguments.py:132-143).
        if self.dataset_name is not None:
            info = self.dataset_name.split("/")
            self.dataset_split = info[-1] if len(info) == 3 else "train"
            self.dataset_name = (
                "/".join(info[:-1]) if len(info) == 3 else "/".join(info)
            )
            self.dataset_language = "default"
            if ":" in self.dataset_name:
                self.dataset_name, self.dataset_language = self.dataset_name.split(":")
        else:
            self.dataset_name = "json"
            self.dataset_split = "train"
            self.dataset_language = "default"
        # data_dir scan for {train,dev,test}.json(l) (reference arguments.py:144-164).
        if self.data_dir is not None:
            if os.path.isdir(self.data_dir):
                self.data_dir = os.path.abspath(self.data_dir)
                files = os.listdir(self.data_dir)
                paths: Dict[str, str] = {}
                for f in files:
                    for split in ("train", "test", "dev"):
                        if f.endswith(f"{split}.jsonl") or f.endswith(f"{split}.json"):
                            paths[split] = os.path.join(self.data_dir, f)
                missing = {"train", "test", "dev"} - set(paths)
                if missing:
                    raise FileNotFoundError(
                        f"data_dir {self.data_dir} is missing splits: {sorted(missing)}"
                    )
                self.data_path = paths
            else:
                self.data_path = [self.data_dir]
        else:
            self.data_path = None
        self.corpus_name = "json" if self.corpus_name is None else self.corpus_name


@dataclass
class TrainingArguments:
    """Training-loop and retrieval-eval flags (reference ``DRT/arguments.py:168-220``)."""

    output_dir: str = field(default="./drt_output")
    local_rank: int = field(default=0)
    warmup_ratio: float = field(
        default=0.1,
        metadata={"help": "Warmup fraction of total steps when a scheduler is "
                  "set without explicit n_warmup_steps (declared-only in the "
                  "reference, arguments.py:174; honored here)"},
    )
    negatives_x_device: bool = field(
        default=True,
        metadata={
            "help": "Share in-batch negatives globally across data-parallel "
            "replicas; False restricts the contrastive loss to each replica's "
            "local block (reference semantics with the flag off). The port has "
            "one device per process so far (multi-GPU: ROADMAP queue 1)."
        },
    )
    do_encode: bool = field(default=False, metadata={"help": "run the encoding loop"})

    grad_cache: bool = field(
        default=False, metadata={"help": "Use gradient-cache (micro-chunked) update"}
    )
    gc_q_chunk_size: int = field(default=4)
    gc_p_chunk_size: int = field(default=32)
    eval_method: str = field(default="metrics")
    optimizer: str = field(default="adam")
    scheduler: Optional[str] = field(default=None)
    learning_rate: float = field(default=1e-5)
    optimizer_kwargs: dict = field(default_factory=dict)
    adafactor_kwargs: dict = field(default_factory=dict)
    scheduler_kwargs: dict = field(default_factory=dict)
    train_batch_size: int = field(default=128)
    eval_batch_size: int = field(default=128)
    test_batch_size: int = field(default=128)
    corpus_batch_size: int = field(default=128)
    max_epochs: int = field(default=5)
    decimal_place: int = field(
        default=4,
        metadata={"help": "Decimal places for logged metrics (reference "
                  "arguments.py:193 declared it unused; metric JSON dumps stay "
                  "full precision)"},
    )
    topk: str = field(default="5,10,20")
    retrieve_num: int = field(default=100)
    retrieve_dir: str = field(default="")
    eval_per_train: int = field(default=5)
    index_order_dir: str = field(default="")
    rr_result_dir: str = field(default="")
    encode_corpus_dir: str = field(default="")
    loss_fn: str = field(default="SimpleContrastiveLoss")
    index_file: str = field(default="")
    cache_train_dir: str = field(default="./drt_cache/")
    save_per_train: int = field(
        default=10, metadata={"help": "Save checkpoint every X epochs"}
    )

    # --- additions of the JAX package ---
    seed: int = field(default=42, metadata={"help": "PRNG seed"})
    dp_size: int = field(
        default=-1, metadata={"help": "Data-parallel mesh size (-1: all devices / tp_size)"}
    )
    tp_size: int = field(default=1, metadata={"help": "Tensor-parallel mesh size"})
    index_dtype: str = field(
        default="float32",
        metadata={"help": "Device index dtype: float32 | bfloat16 | int8 "
                  "(per-row scales, quantized on the card by K7) | int4 "
                  "(nibble-packed, per-row scales, quantized on the card by K9)"},
    )
    use_pallas: bool = field(
        default=True,
        metadata={"help": "Kept for the flags to parse alike: the port's "
                  "index runs its CUDA top-k kernels on the card and the exact "
                  "scan on the CPU"},
    )
    index_factory: str = field(
        default="",
        metadata={"help": "FAISS-style factory string for the evaluation index "
                  "(overrides index_dtype): Flat | BF16 | SQ8 | SQ4 | "
                  "IVF{n},Flat|BF16|SQ8 | PCAR{d},... — trained indexes "
                  "(IVF/PCAR) train on the encoded corpus during evaluation "
                  "(reference faiss.index_factory + train(), index.py:47-54). "
                  "Single-device; empty = flat index at index_dtype"},
    )
    nprobe: int = field(
        default=32,
        metadata={"help": "IVF cells probed per query when index_factory "
                  "builds an IVF index"},
    )
    index_train_rows: int = field(
        default=262144,
        metadata={"help": "Max corpus rows sampled to train a trained "
                  "(IVF/PCAR) factory index"},
    )
    resume_from: Optional[str] = field(
        default=None, metadata={"help": "Checkpoint dir to resume from"}
    )
    mine_per_train: int = field(
        default=0,
        metadata={"help": "Every X epochs, refresh train negatives by mining the "
                  "current model's hardest negatives from the device index "
                  "(ANCE-style; 0 = off)"},
    )
    log_every: int = field(default=10, metadata={"help": "Steps between metric log lines"})
    save_corpus_artifacts: bool = field(
        default=True,
        metadata={"help": "Write encoded-corpus npy/docid dumps and index files "
                  "during evaluation (disable for multi-GB corpora; the index "
                  "stays device-resident either way)"},
    )
    search_mode: str = field(
        default="exact",
        metadata={"help": "Retrieval search mode: exact (certified, K5/K6/K10) | "
                  "serve (K8/K11 candidates, Poisson J, no certificate) | partial "
                  "(K5 candidates without the certificate, fp32/bf16 only) | "
                  "i8q (K7-quantized queries on the s8 tensor-core kernel "
                  "K12, int8/int4 only) | approx (per-dtype alias: fp32/bf16->"
                  "partial, int8/int4->i8q). IVF factory indexes: bulk (K13 / "
                  "K14 cell-major search) | probe (per-query gathered cells) | "
                  "i8q (bulk with int8 queries, int8 cells) | approx | exact. "
                  "Contract table: index/modes.py"},
    )
    profile_dir: Optional[str] = field(
        default=None, metadata={"help": "If set, write a torch.profiler trace of a train step here"}
    )
    index_slab_rows: int = field(
        default=262144,
        metadata={"help": "Corpus-encode rows accumulated on device before they "
                  "are flushed into the index as one slab (device-native add "
                  "path; bounds transient device memory at slab_rows x dim x "
                  "4 bytes)"},
    )

    def __post_init__(self):
        # Derived artifact dirs (reference arguments.py:206-220).
        if self.index_file == "":
            self.index_file = os.path.join(self.cache_train_dir, "index_1phrase")
        if self.retrieve_dir == "":
            self.retrieve_dir = os.path.join(self.cache_train_dir, "retrieve")
        if self.index_order_dir == "":
            self.index_order_dir = os.path.join(self.cache_train_dir, "idx")
        if self.rr_result_dir == "":
            self.rr_result_dir = os.path.join(self.cache_train_dir, "rr")
        if self.encode_corpus_dir == "":
            self.encode_corpus_dir = os.path.join(self.cache_train_dir, "encoded_p")
        for d in (
            self.retrieve_dir,
            self.encode_corpus_dir,
            self.rr_result_dir,
            self.index_order_dir,
        ):
            os.makedirs(d, exist_ok=True)
        if self.save_per_train > self.max_epochs:
            self.save_per_train = self.max_epochs

    @property
    def topk_list(self) -> List[int]:
        if isinstance(self.topk, (list, tuple)):
            return [int(k) for k in self.topk]
        return [int(k) for k in str(self.topk).split(",")]


@dataclass
class RRTrainingArguments(TrainingArguments):
    """Reranker training flags (reference ``DRT/arguments.py:223-226``)."""

    loss_fn: str = field(default="mr")
    margin: float = field(default=1.0)


# ---------------------------------------------------------------------------
# Parsing: CLI flags or a single JSON-file argv, like HfArgumentParser usage
# at reference run_random_sampling.py:21-24.
# ---------------------------------------------------------------------------


def _add_dataclass_args(parser: argparse.ArgumentParser, dc: type, seen: set) -> None:
    hints = typing.get_type_hints(dc)
    for f in dataclasses.fields(dc):
        if f.name in seen:
            continue
        seen.add(f.name)
        ftype = hints[f.name]
        origin = typing.get_origin(ftype)
        if origin is typing.Union:  # Optional[...]
            args = [a for a in typing.get_args(ftype) if a is not type(None)]
            ftype = args[0]
            origin = typing.get_origin(ftype)
        default = (
            f.default
            if f.default is not dataclasses.MISSING
            else (f.default_factory() if f.default_factory is not dataclasses.MISSING else None)
        )
        name = "--" + f.name
        helptext = f.metadata.get("help", "")
        if ftype is bool:
            grp = parser.add_mutually_exclusive_group()
            grp.add_argument(name, dest=f.name, action="store_true", default=default, help=helptext)
            grp.add_argument("--no_" + f.name, dest=f.name, action="store_false")
        elif origin in (list, List):
            elem = typing.get_args(ftype)[0] if typing.get_args(ftype) else str
            parser.add_argument(name, type=elem, nargs="+", default=default, help=helptext)
        elif ftype is dict or origin in (dict, Dict):
            parser.add_argument(name, type=json.loads, default=default, help=helptext)
        else:
            parser.add_argument(name, type=ftype, default=default, help=helptext)


def parse_args(
    dataclass_types=(ModelArguments, DataArguments, TrainingArguments),
    args: Optional[List[str]] = None,
):
    """Parse CLI flags, or a single ``config.json`` path, into the dataclass triple."""
    argv = list(sys.argv[1:]) if args is None else list(args)

    if len(argv) == 1 and argv[0].endswith(".json"):
        with open(argv[0]) as fh:
            blob = json.load(fh)
        out = []
        for dc in dataclass_types:
            names = {f.name for f in dataclasses.fields(dc)}
            out.append(dc(**{k: v for k, v in blob.items() if k in names}))
        return tuple(out)

    parser = argparse.ArgumentParser()
    seen: set = set()
    for dc in dataclass_types:
        _add_dataclass_args(parser, dc, seen)
    ns = parser.parse_args(argv)
    out = []
    for dc in dataclass_types:
        names = {f.name for f in dataclasses.fields(dc)}
        out.append(dc(**{k: v for k, v in vars(ns).items() if k in names}))
    return tuple(out)
