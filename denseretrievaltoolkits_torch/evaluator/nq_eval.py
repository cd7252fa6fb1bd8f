"""DPR-style answer-string matching + top-k accuracy CLI.

The port's own copy of ``denseretrievaltoolkits_tpu/evaluator/nq_eval.py``,
with the same names and behaviour: NFD-normalize, word-tokenize (runs of
unicode letters / digits / marks, else any single character that is neither a
separator nor an "other" character), then slide the answer token sequence
over the passage tokens. It is the relevance criterion of the trainer's
retrieval evaluation (``train/trainer.py:_label_hit``).

The reference tokenizes with the third-party ``regex`` package
(``[\\p{L}\\p{N}\\p{M}]+|[^\\p{Z}\\p{C}]``), which the card's machine does not
have. The same classes are the Unicode general categories L*, N*, M* and Z*,
C*, so :class:`SimpleTokenizer` reads them from ``unicodedata.category``.
``tests/test_torch_eval.py`` holds it to the reference's tokens.
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import unicodedata
from typing import List, Sequence

_WORD, _SINGLE, _SKIP = 2, 1, 0


def _char_class(ch: str) -> int:
    """_WORD for letters, numbers and marks (``[\\p{L}\\p{N}\\p{M}]``), _SKIP
    for separators and other characters (``[\\p{Z}\\p{C}]``), else _SINGLE."""
    major = unicodedata.category(ch)[0]
    if major in "LNM":
        return _WORD
    return _SKIP if major in "ZC" else _SINGLE


class SimpleTokenizer:
    """Word tokenizer matching the DPR evaluation convention (reference
    nq_eval.py:24-38): maximal runs of word characters, and every other
    visible character as a token of its own."""

    def tokenize(self, text: str) -> "Tokens":
        words = []
        for cls, run in itertools.groupby(text, key=_char_class):
            if cls == _WORD:
                words.append("".join(run))
            elif cls == _SINGLE:
                words.extend(run)
        return Tokens(words)


class Tokens:
    """Minimal token-list wrapper (reference nq_eval.py:41-54 surface)."""

    def __init__(self, words: List[str]):
        self._words = words

    def __len__(self):
        return len(self._words)

    def words(self, uncased: bool = False) -> List[str]:
        return [w.lower() for w in self._words] if uncased else list(self._words)

    def slice(self, i=None, j=None) -> "Tokens":
        return Tokens(self._words[i:j])


_DEFAULT_TOKENIZER = SimpleTokenizer()


def _normalize(text: str) -> str:
    return unicodedata.normalize("NFD", text)


def regex_match(text: str, pattern: str) -> bool:
    """True iff the regex pattern occurs in the text (reference :64-70)."""
    try:
        compiled = re.compile(pattern, flags=re.IGNORECASE + re.UNICODE + re.MULTILINE)
    except re.error:
        return False
    return compiled.search(text) is not None


def _words_of(text: str, tokenizer: SimpleTokenizer) -> List[str]:
    return tokenizer.tokenize(_normalize(text)).words(uncased=True)


def _contains_seq(words: List[str], ans_words: List[str]) -> bool:
    if not ans_words:
        return False
    first = ans_words[0]
    n = len(ans_words)
    for i in range(0, len(words) - n + 1):
        if words[i] == first and ans_words == words[i : i + n]:
            return True
    return False


def has_answers(
    text: str,
    answers: Sequence[str],
    tokenizer: SimpleTokenizer = None,
    regex: bool = False,
) -> bool:
    """True iff any answer occurs in the passage (token-sequence or regex match,
    reference nq_eval.py:88-101)."""
    tokenizer = tokenizer or _DEFAULT_TOKENIZER
    if regex:
        text = _normalize(text)
        return any(regex_match(text, _normalize(ans)) for ans in answers)
    words = _words_of(text, tokenizer)
    return any(_contains_seq(words, _words_of(ans, tokenizer)) for ans in answers)


class AnswerMatcher:
    """Memoizing batch matcher for the evaluation hot loop.

    ``trainer.evaluate`` calls has_answers O(n_queries × retrieve_num) times;
    retrieved docs repeat heavily across queries and answer lists repeat
    across hits, so tokenize each unique doc and answer exactly once."""

    def __init__(self, tokenizer: SimpleTokenizer = None):
        self._tokenizer = tokenizer or _DEFAULT_TOKENIZER
        self._doc_words: dict = {}
        self._ans_words: dict = {}

    def doc_words(self, key, text: str) -> List[str]:
        words = self._doc_words.get(key)
        if words is None:
            words = _words_of(text, self._tokenizer)
            self._doc_words[key] = words
        return words

    def answer_words(self, ans: str) -> List[str]:
        words = self._ans_words.get(ans)
        if words is None:
            words = _words_of(ans, self._tokenizer)
            self._ans_words[ans] = words
        return words

    def match(self, doc_key, doc_text: str, answers: Sequence[str]) -> bool:
        words = self.doc_words(doc_key, doc_text)
        return any(_contains_seq(words, self.answer_words(a)) for a in answers)


def evaluate_retrieval(retrieval_file: str, topk: Sequence[int], regex: bool = False) -> dict:
    """Top-k answer accuracy over a retrieval JSON
    {qid: {answers: [...], contexts: [{text | has_answer}]}}
    (reference nq_eval.py:135-167). Returns {k: accuracy}."""
    tokenizer = SimpleTokenizer()
    with open(retrieval_file) as fh:
        retrieval = json.load(fh)
    max_k = max(topk)
    accuracy = {k: [] for k in topk}

    for qid in retrieval:
        answers = retrieval[qid]["answers"]
        contexts = retrieval[qid]["contexts"]
        has_ans_idx = max_k
        for idx, ctx in enumerate(contexts[:max_k]):
            if "has_answer" in ctx:
                if ctx["has_answer"]:
                    has_ans_idx = idx
                    break
            else:
                # contexts store "title\ntext"
                parts = ctx["text"].split("\n")
                text = parts[1] if len(parts) > 1 else parts[0]
                if has_answers(text, answers, tokenizer, regex):
                    has_ans_idx = idx
                    break
        for k in topk:
            accuracy[k].append(0 if has_ans_idx >= k else 1)

    result = {k: (sum(v) / len(v) if v else 0.0) for k, v in accuracy.items()}
    for k in topk:
        print(f"Top{k}\taccuracy: {result[k]:.4f}")
    return result


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--retrieval", type=str, metavar="path",
                        help="Path to retrieval output file.")
    parser.add_argument("--topk", type=int, nargs="+", help="topk to evaluate")
    parser.add_argument("--regex", action="store_true", default=False, help="regex match")
    args = parser.parse_args(argv)
    return evaluate_retrieval(args.retrieval, args.topk, args.regex)


if __name__ == "__main__":
    main()
