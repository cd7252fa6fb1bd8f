"""Tokenizer loading helper (host-side HF tokenizers).

The port's own copy of ``denseretrievaltoolkits_tpu/utils/tokenization.py``.
``transformers`` is imported where it is used: the package imports without it.
"""

from __future__ import annotations


def load_tokenizer(model_args):
    """AutoTokenizer from tokenizer_name or model_name_or_path
    (reference run_random_sampling.py:31-34)."""
    from transformers import AutoTokenizer

    name = model_args.tokenizer_name or model_args.model_name_or_path
    return AutoTokenizer.from_pretrained(name, cache_dir=model_args.cache_dir)
