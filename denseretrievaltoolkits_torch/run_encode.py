"""Offline encoding CLI: corpus/query shards -> pickled (reps, lookup) files.

Counterpart of the JAX package's ``run_encode.py``, with the same flags and
the same pickle output, consumable by ``evaluator/retrieval.py``:

    python -m denseretrievaltoolkits_torch.run_encode \\
        --model_name_or_path <dir saved by the JAX package> --dtype bfloat16 \\
        --attention fused --encode_in_path corpus.jsonl --p_max_len 156 \\
        --encodedp_save_path corpus.pkl --corpus_batch_size 64

:func:`main` reads a BERT tokenizer directory and local JSON-Lines inputs with
the port's own tokenizer and reader, so it runs without ``transformers`` and
``datasets`` (a T5 tokenizer or a hub dataset needs them);
:func:`encode_batches`, the batch loop, also drives pre-tokenised ids.
"""

from __future__ import annotations

import logging
import pickle
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from .config import DataArguments, ModelArguments, TrainingArguments, parse_args
from .data.loaders import pad_to_batch

logger = logging.getLogger(__name__)


def encode_batches(model, batches: Iterable[Tuple[List, dict]], side: str,
                   batch_size: Optional[int] = None) -> Tuple[np.ndarray, List]:
    """Encode ``(ids, batch)`` pairs through the query or passage tower.

    Each batch is padded to ``batch_size`` rows with all-pad rows
    (``pad_to_batch``, as the reference does for one compiled shape) and the
    pad rows' reps are dropped. Returns (reps [n, D] fp32, lookup)."""
    if side not in ("query", "passage"):
        raise ValueError(f"side must be 'query' or 'passage', got {side!r}")
    encode = model.encode_query if side == "query" else model.encode_passage
    reps, lookup = [], []
    for ids, batch in batches:
        padded, valid = pad_to_batch(batch, batch_size or len(ids))
        reps.append(encode(padded)[:valid])
        lookup.extend(ids)
    if not reps:
        return np.zeros((0, 0), np.float32), lookup
    return torch.cat(reps).cpu().numpy(), lookup


def main(argv=None, device=None):
    """Encode ``--encode_in_path`` on ``device`` (the card unless the caller names
    another) into the pickle at ``--encodedq_save_path`` / ``--encodedp_save_path``."""
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        level=logging.INFO,
    )
    model_args, data_args, training_args = parse_args(
        (ModelArguments, DataArguments, TrainingArguments), args=argv)
    if not data_args.encode_in_path:
        raise SystemExit("--encode_in_path is required")
    save_path = data_args.encodedq_save_path if data_args.encode_is_qry \
        else data_args.encodedp_save_path
    if not save_path:
        raise SystemExit("--encodedq_save_path / --encodedp_save_path is required")

    from .data.collators import EncodeCollator
    from .data.datasets import load_dataset
    from .data.loaders import DataLoader
    from .models.biencoder import DRModelForInference
    from .utils.tokenization import load_tokenizer

    tokenizer = load_tokenizer(model_args)
    model = DRModelForInference.build(model_args, seed=training_args.seed, device=device)

    ds = load_dataset("json", data_files=list(data_args.encode_in_path),
                      cache_dir=data_args.data_cache_dir)["train"].shard(
        data_args.encode_num_shard, data_args.encode_shard_index)

    def tok(text, max_len):
        return tokenizer.encode(text, add_special_tokens=False, max_length=max_len,
                                truncation=True)

    if data_args.encode_is_qry:
        rows = [{"query_id": ex["query_id"], "query": tok(ex["query"], data_args.q_max_len)}
                for ex in ds]
        collator = EncodeCollator(tokenizer, q_max_len=data_args.q_max_len)
        sort = None
    else:
        sep = data_args.passage_field_separator
        rows = [{"doc_id": ex["docid"],
                 "text": tok(ex["title"] + sep + ex["text"] if "title" in ex else ex["text"],
                             data_args.p_max_len)} for ex in ds]
        bucketed = getattr(data_args, "bucketed_encode", False)
        collator = EncodeCollator(tokenizer, p_max_len=data_args.p_max_len,
                                  bucket_step=data_args.bucket_step if bucketed else 0)
        sort = (lambda ex: len(ex["text"]) + 2) if bucketed else None
    loader = DataLoader(rows, training_args.corpus_batch_size, collator, shuffle=False,
                        sort_by_length=sort)
    side = "query" if data_args.encode_is_qry else "passage"
    reps, lookup = encode_batches(model, loader, side, loader.batch_size)
    with open(save_path, "wb") as fh:
        pickle.dump((reps, lookup), fh)
    logger.info("encoded %d items (dim %d) -> %s", reps.shape[0], reps.shape[1], save_path)


if __name__ == "__main__":
    main()
