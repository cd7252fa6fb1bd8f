"""The port's WordPiece tokenizer against ``BertTokenizerFast``.

``utils/tokenization.py`` reads a BERT tokenizer directory without
``transformers``; on the same directory it must give the ids
``BertTokenizerFast`` gives: for ``encode`` (with and without special tokens,
cut by ``max_length``) and ``prepare_for_model`` (one sequence, and pairs by
``only_first``, also where that cannot cut far enough), over Unicode text,
accents, CJK, punctuation, control characters, over-long words, empty strings
and special tokens inside the text, for both ``do_lower_case`` values and both
kinds of directory (``vocab.txt`` + ``tokenizer_config.json`` as the
``quality_trend`` recipe writes it, and what ``save_pretrained`` writes). The
character tables of ``utils/bert_chars.py`` are held to ``tokenizers`` at every
boundary of their ranges.
"""

import json
import logging
import os
import sys

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers.normalizers import BertNormalizer
from tokenizers.pre_tokenizers import BertPreTokenizer
from transformers import AutoTokenizer, BertTokenizerFast

from denseretrievaltoolkits_torch.config import ModelArguments
from denseretrievaltoolkits_torch.utils import bert_chars
from denseretrievaltoolkits_torch.utils import tokenization as ttok

PIECES = ["a", "b", "c", "ab", "abc", "the", "capital", "paris", "é", "e", "ü", "ß", "σ", "ς",
          "中", "文", "日", "x", "café", "naïve", "i̇", "tok0001", "tok", "0001", "un", "able",
          "!", "?", ".", ",", "-", "[", "]", "'", "$", "^", "`", "|", "~", "¿", "«", "»", "—"]
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + PIECES
         + ["##" + p for p in PIECES if p.isalnum()] + ["Paris", "The", "É", "Σ"])
SPECIAL_BITS = ["[SEP]", "[sep]", "[CLS]", "[MASK]", "[PAD]", "[UNK]", "[SE", "P]", "x" * 101,
                "\x00", "\t", "\n", "\r", "\x0b", "\x85", "​", "﻿", "　", "\xa0",
                "́", "͸", "؝", "�", "İ", "ΑΣ", "\U0001f600", "豈"]
TEXT = st.lists(st.one_of(st.sampled_from(PIECES), st.sampled_from(SPECIAL_BITS),
                          st.sampled_from([" ", "  ", "\t"]),
                          st.text(st.characters(exclude_categories=("Cs",)), max_size=4)),
                max_size=14).map("".join)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{(kind, lower): (port tokenizer, BertTokenizerFast)} over the same directory."""
    tmp = tmp_path_factory.mktemp("tok")
    out = {}
    for lower in (True, False):
        plain = tmp / f"plain-{lower}"  # vocab.txt + tokenizer_config.json, as quality_trend
        plain.mkdir()
        (plain / "vocab.txt").write_text("\n".join(VOCAB))
        (plain / "tokenizer_config.json").write_text(json.dumps(
            {"tokenizer_class": "BertTokenizerFast", "do_lower_case": lower}))
        saved = tmp / f"saved-{lower}"
        BertTokenizerFast(vocab_file=str(plain / "vocab.txt"),
                          do_lower_case=lower).save_pretrained(str(saved))
        for kind, path in (("plain", plain), ("saved", saved)):
            args = ModelArguments(tokenizer_name=str(path))
            out[(kind, lower)] = (ttok.load_tokenizer(args), AutoTokenizer.from_pretrained(
                str(path)))
    return out


@pytest.fixture(autouse=True)
def _quiet():
    # transformers logs an error where only_first cannot cut; the port logs the same
    logging.disable(logging.ERROR)
    yield
    logging.disable(logging.NOTSET)


KINDS = [(k, lower) for k in ("plain", "saved") for lower in (True, False)]


@pytest.mark.parametrize("kind,lower", KINDS)
def test_loader_picks_the_port_tokenizer(dirs, kind, lower):
    port, ref = dirs[(kind, lower)]
    assert isinstance(port, ttok.WordPieceTokenizer)
    assert port.vocab_size == ref.vocab_size and len(port) == len(ref)
    for name in ("pad", "unk", "cls", "sep", "mask"):
        assert getattr(port, f"{name}_token") == getattr(ref, f"{name}_token")
        assert getattr(port, f"{name}_token_id") == getattr(ref, f"{name}_token_id")


@pytest.mark.parametrize("kind,lower", KINDS)
@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(text=TEXT, pair=TEXT, max_length=st.integers(1, 12))
def test_ids_equal_bert_tokenizer_fast(dirs, kind, lower, text, pair, max_length):
    port, ref = dirs[(kind, lower)]
    a = ref.encode(text, add_special_tokens=False)
    assert port.encode(text, add_special_tokens=False) == a, text
    assert port.encode(text) == ref.encode(text)
    assert port.tokenize(text) == ref.tokenize(text)
    kw = dict(add_special_tokens=False, max_length=max_length, truncation=True)
    assert port.encode(text, **kw) == ref.encode(text, **kw)
    b = ref.encode(pair, add_special_tokens=False)
    pfm = dict(truncation="only_first", max_length=max_length, padding=False,
               return_attention_mask=False, return_token_type_ids=False)
    assert port.prepare_for_model(a, **pfm) == ref.prepare_for_model(a, **pfm)
    assert port.prepare_for_model(a, b, **pfm) == ref.prepare_for_model(a, b, **pfm)


def test_pairs_only_first_cannot_cut(dirs):
    """The first sequence no longer than the overflow: returned uncut, as transformers."""
    port, ref = dirs[("plain", True)]
    pfm = dict(truncation="only_first", padding=False, return_attention_mask=False,
               return_token_type_ids=False)
    for a, b, n in (([5, 6], [7, 8, 9], 5), ([5, 6, 7], None, 2), ([], [7], 1), ([5], [6], 4)):
        args = (a,) if b is None else (a, b)
        want = ref.prepare_for_model(*args, max_length=n, **pfm)
        assert port.prepare_for_model(*args, max_length=n, **pfm) == want


def _edges(table):
    for lo, hi in zip(table[::2], table[1::2]):
        yield from (lo - 1, lo, hi, hi + 1)


def test_character_tables_equal_tokenizers():
    """Every boundary of ``bert_chars``' ranges (and the lower-case table) against
    ``tokenizers``' normalizer and pre-tokenizer, one code point at a time."""
    clean = BertNormalizer(clean_text=True, handle_chinese_chars=False, strip_accents=False,
                           lowercase=False)
    strip = BertNormalizer(clean_text=False, handle_chinese_chars=False, strip_accents=True,
                           lowercase=False)
    lower = BertNormalizer(clean_text=False, handle_chinese_chars=False, strip_accents=False,
                           lowercase=True)
    pre = BertPreTokenizer()
    points = {cp for t in (bert_chars.DROPPED, bert_chars.PUNCTUATION,
                           bert_chars.NONSPACING_MARKS) for cp in _edges(t)}
    points |= set(bert_chars.LOWER) | set(bert_chars.NFD_WHOLE) | set(range(0x300))
    points = sorted(cp for cp in points if 0 <= cp < 0x110000 and not 0xD800 <= cp < 0xE000)
    for lc in (True, False):
        port = ttok.WordPieceTokenizer({"[UNK]": 0}, do_lower_case=lc)
        ref = BertNormalizer(clean_text=True, handle_chinese_chars=True, strip_accents=None,
                             lowercase=lc)
        for cp in points:
            assert port._normalize_char(chr(cp)) == ref.normalize_str(chr(cp)), hex(cp)
    for cp in points:
        ch = chr(cp)
        assert ttok._is_dropped(ch) == (clean.normalize_str(ch) == ""), hex(cp)
        split = [w for w, _ in pre.pre_tokenize_str("a" + ch + "b")]
        assert ttok._is_punctuation(ch) == (split == ["a", ch, "b"]), hex(cp)
        if cp in bert_chars.LOWER:
            assert chr(bert_chars.LOWER[cp]) == lower.normalize_str(ch), hex(cp)
        if ttok._is_mark(ch):
            assert strip.normalize_str(ch) == "", hex(cp)


def test_words_are_memoised(dirs, monkeypatch):
    port, _ = dirs[("plain", True)]
    text = "the capital of paris naïve café"
    first = port.encode(text, add_special_tokens=False)
    calls = []
    monkeypatch.setattr(port, "_wordpiece", lambda w: calls.append(w) or [0])
    assert port.encode(text, add_special_tokens=False) == first and not calls


def test_other_directories_need_transformers(tmp_path, monkeypatch):
    """A T5 directory (spiece.model), another tokenizer class or a hub id goes through
    ``transformers``; without it that raises, naming what is missing."""
    t5 = tmp_path / "t5"
    t5.mkdir()
    (t5 / "spiece.model").write_bytes(b"")
    (t5 / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "T5Tokenizer"}))
    other = tmp_path / "roberta"
    other.mkdir()
    (other / "vocab.txt").write_text("a\n")
    (other / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "RobertaTokenizer"}))
    assert not ttok.is_bert_directory(str(t5)) and not ttok.is_bert_directory(str(other))
    monkeypatch.setitem(sys.modules, "transformers", None)
    for name in (str(t5), str(other), "bert-base-uncased"):
        with pytest.raises(ImportError, match="needs `transformers`"):
            ttok.load_tokenizer(ModelArguments(tokenizer_name=name))
    # a BERT directory needs nothing
    bert_dir = tmp_path / "bert"
    bert_dir.mkdir()
    (bert_dir / "vocab.txt").write_text("\n".join(VOCAB))
    (bert_dir / "tokenizer_config.json").write_text("{}")
    tok = ttok.load_tokenizer(ModelArguments(tokenizer_name=str(bert_dir)))
    assert tok.encode("The capital!", add_special_tokens=False) == [
        VOCAB.index("the"), VOCAB.index("capital"), VOCAB.index("!")]
    assert os.path.isdir(str(bert_dir))
