"""Tokenizers: a BERT WordPiece tokenizer of the port's own, and HF's for the rest.

The port's counterpart of ``denseretrievaltoolkits_tpu/utils/tokenization.py``.
:func:`load_tokenizer` reads a local BERT tokenizer directory (``vocab.txt``,
with or without the ``tokenizer.json`` that ``BertTokenizerFast.save_pretrained``
writes) into :class:`WordPieceTokenizer`, which gives the ids
``BertTokenizerFast`` gives, without ``transformers`` or ``tokenizers``: the
card's machine has neither. A T5 directory (``spiece.model``), another
tokenizer class or a hub id still goes through ``transformers.AutoTokenizer``,
imported there; without it, that raises and names what is missing.

The pipeline, in ``BertTokenizerFast``'s order (``tokenizers``' ``BertNormalizer``,
``BertPreTokenizer`` and ``WordPiece``):

1. special tokens (``[SEP]``, ...) found in the raw text, leftmost and longest
   first, are kept whole;
2. clean text: NUL, U+FFFD and every other-category (Cc, Cf, Co) character but
   tab, newline and carriage return dropped, whitespace made a space; CJK
   ideographs spaced apart; accents stripped (NFD, nonspacing marks dropped)
   where ``strip_accents`` (default: ``do_lower_case``); then lower-cased
   character by character;
3. words split on whitespace, punctuation (P*, and every ASCII punctuation
   character) split off one character a word;
4. greedy longest-match WordPiece with ``##`` continuations; a word of more
   than 100 characters, or one with no match, is ``[UNK]``.

Whitespace is Unicode's White_Space property (Rust's ``char::is_whitespace``),
not Python's ``str.isspace``; the other character classes are ``tokenizers``'
own, older than ``unicodedata``'s (``bert_chars.py``). Each word's ids are
memoised.
"""

from __future__ import annotations

import bisect
import json
import logging
import os
import re
import unicodedata
from typing import Dict, List, Optional

from . import bert_chars

logger = logging.getLogger(__name__)

# Unicode's White_Space characters (Rust's char::is_whitespace); tokenizers
# counts tab, newline and carriage return as whitespace too
_WHITESPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004"
                        "\u2005\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
# CJK ideograph blocks that BertNormalizer spaces apart
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
# ASCII text with no control character: str.lower() and a split on spaces suffice
_ASCII_PLAIN = re.compile(r"[ -~]*")

BERT_CLASSES = ("BertTokenizer", "BertTokenizerFast")


def _in(table, cp: int) -> bool:
    """``cp`` inside one of ``table``'s flat (first, last) pairs."""
    i = bisect.bisect_right(table, cp)
    return i % 2 == 1 or (i > 0 and table[i - 1] == cp)


def _is_dropped(ch: str) -> bool:
    return _in(bert_chars.DROPPED, ord(ch))


def _is_punctuation(ch: str) -> bool:
    return _in(bert_chars.PUNCTUATION, ord(ch))


def _is_mark(ch: str) -> bool:
    return _in(bert_chars.NONSPACING_MARKS, ord(ch))


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK)


class WordPieceTokenizer:
    """``BertTokenizerFast``'s ids and the part of its surface the port uses:
    ``encode``, ``tokenize``, ``prepare_for_model`` (one sequence or a pair),
    ``convert_tokens_to_ids``, ``vocab_size``, the special tokens and their ids."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 strip_accents: Optional[bool] = None, tokenize_chinese_chars: bool = True,
                 clean_text: bool = True, unk_token: str = "[UNK]", sep_token: str = "[SEP]",
                 pad_token: str = "[PAD]", cls_token: str = "[CLS]", mask_token: str = "[MASK]",
                 added_tokens: Optional[Dict[str, int]] = None,
                 max_input_chars_per_word: int = 100, continuing_subword_prefix: str = "##",
                 model_max_length: Optional[int] = None):
        self.vocab = dict(vocab)
        self.do_lower_case = do_lower_case
        self.strip_accents = do_lower_case if strip_accents is None else strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.clean_text = clean_text
        self.unk_token, self.sep_token, self.pad_token = unk_token, sep_token, pad_token
        self.cls_token, self.mask_token = cls_token, mask_token
        self.max_input_chars_per_word = max_input_chars_per_word
        self.prefix = continuing_subword_prefix
        self.model_max_length = model_max_length
        added = {t: self.vocab[t] for t in (pad_token, unk_token, cls_token, sep_token, mask_token)
                 if t is not None and t in self.vocab}
        added.update(added_tokens or {})
        self.added_tokens = added
        # leftmost, then longest: an alternation tried longest first
        self._added_re = re.compile("|".join(
            re.escape(t) for t in sorted(added, key=len, reverse=True))) if added else None
        self._added_first = frozenset(t[:1] for t in added)
        self._ids_to_tokens = {i: t for t, i in {**self.vocab, **added}.items()}
        self._char_cache: Dict[str, str] = {}
        self._word_cache: Dict[str, List[int]] = {}

    # -- the special tokens ------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def __len__(self) -> int:
        return len(set(self.vocab) | set(self.added_tokens))

    def _id(self, token):
        return None if token is None else self.convert_tokens_to_ids(token)

    @property
    def pad_token_id(self):
        return self._id(self.pad_token)

    @property
    def unk_token_id(self):
        return self._id(self.unk_token)

    @property
    def cls_token_id(self):
        return self._id(self.cls_token)

    @property
    def sep_token_id(self):
        return self._id(self.sep_token)

    @property
    def mask_token_id(self):
        return self._id(self.mask_token)

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            tid = self.added_tokens.get(tokens, self.vocab.get(tokens))
            return self.vocab.get(self.unk_token) if tid is None else tid
        return [self.convert_tokens_to_ids(t) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, int):
            return self._ids_to_tokens.get(ids)
        return [self._ids_to_tokens.get(i) for i in ids]

    # -- normalization and words -------------------------------------------
    def _normalize_char(self, ch: str) -> str:
        out = self._char_cache.get(ch)
        if out is not None:
            return out
        out = ch
        if self.clean_text and _is_dropped(ch):
            out = ""
        elif self.clean_text and ch in _WHITESPACE:
            out = " "
        elif self.tokenize_chinese_chars and _is_cjk(ord(ch)):
            out = f" {ch} "
        if self.strip_accents:  # NFD of the compatibility ideographs too
            out = "".join(c for c in (out if ord(ch) in bert_chars.NFD_WHOLE
                                      else unicodedata.normalize("NFD", out)) if not _is_mark(c))
        if self.do_lower_case:  # char by char: no final-sigma rule
            out = "".join(chr(bert_chars.LOWER[ord(c)]) if ord(c) in bert_chars.LOWER
                          else c.lower() for c in out)
        self._char_cache[ch] = out
        return out

    def _words(self, text: str) -> List[str]:
        """The whitespace-separated pieces of the normalized text."""
        if _ASCII_PLAIN.fullmatch(text):
            return (text.lower() if self.do_lower_case else text).split()
        norm = "".join(map(self._normalize_char, text))
        # whitespace the normalizer left (clean_text off) still splits words
        return "".join(" " if c in _WHITESPACE else c for c in norm).split(" ")

    def _word_ids(self, word: str) -> List[int]:
        ids = self._word_cache.get(word)
        if ids is not None:
            return ids
        ids = []
        piece = []
        for ch in word:  # punctuation splits off, one character a word
            if _is_punctuation(ch):
                if piece:
                    ids.extend(self._wordpiece("".join(piece)))
                    piece = []
                ids.extend(self._wordpiece(ch))
            else:
                piece.append(ch)
        if piece:
            ids.extend(self._wordpiece("".join(piece)))
        self._word_cache[word] = ids
        return ids

    def _wordpiece(self, word: str) -> List[int]:
        unk = [self.vocab[self.unk_token]]
        if len(word) > self.max_input_chars_per_word:
            return unk
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            tid = None
            while start < end:
                sub = word[start:end] if start == 0 else self.prefix + word[start:end]
                tid = self.vocab.get(sub)
                if tid is not None:
                    break
                end -= 1
            if tid is None:
                return unk
            ids.append(tid)
            start = end
        return ids

    def _text_ids(self, text: str) -> List[int]:
        ids = []
        for word in self._words(text):
            if word:
                ids.extend(self._word_ids(word))
        return ids

    def _encode_text(self, text: str) -> List[int]:
        if self._added_re is None or not any(c in text for c in self._added_first):
            return self._text_ids(text)
        ids, pos = [], 0
        for m in self._added_re.finditer(text):
            ids.extend(self._text_ids(text[pos:m.start()]))
            ids.append(self.added_tokens[m.group()])
            pos = m.end()
        ids.extend(self._text_ids(text[pos:]))
        return ids

    def tokenize(self, text: str) -> List[str]:
        return self.convert_ids_to_tokens(self._encode_text(text))

    # -- the surface the port calls ----------------------------------------
    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: Optional[int] = None, truncation=False, **kwargs) -> List[int]:
        """Ids of ``text``; with ``truncation`` and ``max_length`` cut to it."""
        return self.prepare_for_model(self._encode_text(text),
                                      add_special_tokens=add_special_tokens,
                                      truncation=truncation, max_length=max_length,
                                      return_attention_mask=False,
                                      return_token_type_ids=False)["input_ids"]

    def num_special_tokens_to_add(self, pair: bool = False) -> int:
        return 3 if pair else 2

    def build_inputs_with_special_tokens(self, ids, pair_ids=None):
        cls, sep = [self.cls_token_id], [self.sep_token_id]
        if pair_ids is None:
            return cls + list(ids) + sep
        return cls + list(ids) + sep + list(pair_ids) + sep

    def prepare_for_model(self, ids, pair_ids=None, add_special_tokens: bool = True,
                          padding=False, truncation=False, max_length: Optional[int] = None,
                          return_attention_mask=None, return_token_type_ids=None, **kwargs):
        """``PreTrainedTokenizerBase.prepare_for_model`` without padding: special
        tokens added, then cut to ``max_length`` by ``only_first`` or
        ``longest_first`` (``truncation=True``). Where ``only_first`` cannot cut the
        first sequence far enough, the pair is returned uncut and an error logged,
        as ``transformers`` does."""
        if padding not in (False, "do_not_pad"):
            raise NotImplementedError("prepare_for_model pads nothing here: pad in numpy")
        ids, pair = list(ids), None if pair_ids is None else list(pair_ids)
        if truncation is True:
            truncation = "longest_first"
        if truncation and truncation != "do_not_truncate" and max_length is not None:
            total = len(ids) + (len(pair) if pair is not None else 0) + (
                self.num_special_tokens_to_add(pair is not None) if add_special_tokens else 0)
            ids, pair = self._truncate(ids, pair, total - max_length, truncation)
        if add_special_tokens:
            input_ids = self.build_inputs_with_special_tokens(ids, pair)
            types = [0] * (len(ids) + 2) + ([1] * (len(pair) + 1) if pair is not None else [])
        else:
            input_ids = ids + (pair or [])
            types = [0] * len(ids) + [1] * len(pair or [])
        out = {"input_ids": input_ids}
        if return_token_type_ids is not False:
            out["token_type_ids"] = types
        if return_attention_mask is not False:
            out["attention_mask"] = [1] * len(input_ids)
        return out

    @staticmethod
    def _truncate(ids, pair, n_remove, strategy):
        if n_remove <= 0:
            return ids, pair
        if strategy == "longest_first":
            for _ in range(n_remove):  # one token at a time from the longer (ties: the pair)
                if pair is None or len(ids) > len(pair):
                    ids = ids[:-1]
                else:
                    pair = pair[:-1]
            return ids, pair
        if strategy != "only_first":
            raise ValueError(f"unknown truncation strategy {strategy!r}")
        if len(ids) > n_remove:
            return ids[:-n_remove], pair
        logger.error("We need to remove %d to truncate the input but the first sequence has a "
                     "length %d.", n_remove, len(ids))
        return ids, pair


def _read_vocab(path: str) -> Dict[str, int]:
    """``vocab.txt``: one token a line, ids by line (a later duplicate wins)."""
    vocab = {}
    with open(path, encoding="utf-8") as fh:
        for index, line in enumerate(fh.readlines()):
            vocab[line.rstrip("\n")] = index
    return vocab


def _json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def is_bert_directory(path: str) -> bool:
    """A local directory this module reads itself: a WordPiece vocabulary
    (``vocab.txt`` or a ``tokenizer.json`` WordPiece model), no ``spiece.model``,
    and a ``tokenizer_config.json`` naming a BERT class or none."""
    if not path or not os.path.isdir(path) or os.path.exists(os.path.join(path, "spiece.model")):
        return False
    config = _json(os.path.join(path, "tokenizer_config.json"))
    if config.get("tokenizer_class") not in (None, "") + BERT_CLASSES:
        return False
    model = _json(os.path.join(path, "tokenizer.json")).get("model", {})
    return model.get("type") == "WordPiece" or (
        not model and os.path.exists(os.path.join(path, "vocab.txt")))


def load_bert_tokenizer(path: str) -> WordPieceTokenizer:
    """A BERT tokenizer directory as ``BertTokenizerFast.from_pretrained`` reads it:
    ``tokenizer_config.json``'s ``do_lower_case`` (default True), ``strip_accents``
    (default None) and ``tokenize_chinese_chars`` (default True) over the
    ``tokenizer.json`` normalizer's; the vocabulary and added tokens from
    ``tokenizer.json`` where there is one, else ``vocab.txt``."""
    config = _json(os.path.join(path, "tokenizer_config.json"))
    tok_json = _json(os.path.join(path, "tokenizer.json"))
    model = tok_json.get("model") or {}
    vocab = model.get("vocab") or _read_vocab(os.path.join(path, "vocab.txt"))
    normalizer = tok_json.get("normalizer") or {}
    if normalizer and normalizer.get("type") != "BertNormalizer":
        raise NotImplementedError(f"{path}: normalizer {normalizer.get('type')!r} is not "
                                  "BERT's; load it with transformers")
    added = {}
    for tok in tok_json.get("added_tokens", []):
        if tok.get("normalized") or tok.get("lstrip") or tok.get("rstrip") \
                or tok.get("single_word"):
            raise NotImplementedError(f"{path}: added token {tok['content']!r} has options "
                                      "this tokenizer does not read; load it with transformers")
        added[tok["content"]] = tok["id"]
    return WordPieceTokenizer(
        vocab, do_lower_case=config.get("do_lower_case", True),
        strip_accents=config.get("strip_accents"),
        tokenize_chinese_chars=config.get("tokenize_chinese_chars", True),
        clean_text=normalizer.get("clean_text", True),
        unk_token=config.get("unk_token", model.get("unk_token", "[UNK]")),
        sep_token=config.get("sep_token", "[SEP]"), pad_token=config.get("pad_token", "[PAD]"),
        cls_token=config.get("cls_token", "[CLS]"), mask_token=config.get("mask_token", "[MASK]"),
        added_tokens=added,
        max_input_chars_per_word=model.get("max_input_chars_per_word", 100),
        continuing_subword_prefix=model.get("continuing_subword_prefix", "##"),
        model_max_length=config.get("model_max_length"))


def load_tokenizer(model_args):
    """The tokenizer of ``tokenizer_name`` or ``model_name_or_path`` (reference
    run_random_sampling.py:31-34): the port's own for a local BERT directory,
    else ``transformers.AutoTokenizer``."""
    name = model_args.tokenizer_name or model_args.model_name_or_path
    if is_bert_directory(name):
        return load_bert_tokenizer(name)
    try:
        from transformers import AutoTokenizer
    except ImportError as exc:
        raise ImportError(
            f"tokenizer {name!r} is no local BERT tokenizer directory (vocab.txt): a T5 "
            "directory (spiece.model), another tokenizer class or a hub id needs "
            "`transformers`, which is not installed") from exc
    return AutoTokenizer.from_pretrained(name, cache_dir=model_args.cache_dir)
