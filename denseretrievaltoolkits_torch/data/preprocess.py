"""Tokenize-time preprocessors, applied via parallel ``datasets.map``.

Host-side, stateless per-example tokenizers — the same eight roles as the
reference (``DRT/dataset/preprocess.py:1-150``), producing un-padded token-id
lists; padding to static shapes happens in the collators.

The port's own copy of ``denseretrievaltoolkits_tpu/data/preprocess.py``, with
the same names and behaviour.
"""

from __future__ import annotations


def _passage_text(passage: dict, separator: str) -> str:
    if "title" in passage:
        return passage["title"] + separator + passage["text"]
    return passage["text"]


def _encode(tokenizer, text, max_length):
    return tokenizer.encode(
        text, add_special_tokens=False, max_length=max_length, truncation=True
    )


class TrainPreProcessor:
    """{query, positive_passages, negative_passages} → token-id lists
    (reference preprocess.py:1-28)."""

    def __init__(self, tokenizer, query_max_length=32, text_max_length=256, separator=" "):
        self.tokenizer = tokenizer
        self.query_max_length = query_max_length
        self.text_max_length = text_max_length
        self.separator = separator

    def __call__(self, example):
        query = _encode(self.tokenizer, example["query"], self.query_max_length)
        positives = [
            _encode(self.tokenizer, _passage_text(p, self.separator), self.text_max_length)
            for p in example["positive_passages"]
        ]
        negatives = [
            _encode(self.tokenizer, _passage_text(n, self.separator), self.text_max_length)
            for n in example["negative_passages"]
        ]
        return {"query": query, "positives": positives, "negatives": negatives}


class EvalPreProcessor:
    """{query, positive docids} for relevancy-judged eval (preprocess.py:31-47)."""

    def __init__(self, tokenizer, query_max_length=32, text_max_length=256, separator=" "):
        self.tokenizer = tokenizer
        self.query_max_length = query_max_length

    def __call__(self, example):
        query = _encode(self.tokenizer, example["query"], self.query_max_length)
        positives = [p["docid"] for p in example["positive_passages"]]
        # intended semantics: keep the query id + raw text so the eval
        # collator/trainer can group and dump results (the reference's
        # EvalPreProcessor drops them, preprocess.py:38-47)
        return {
            "query_id": example.get("query_id"),
            "query": query,
            "positives_ids": positives,
            "original": example["query"],
        }


class DocPreProcessor:
    """Corpus doc → {id, token ids, original text} (preprocess.py:50-61)."""

    def __init__(self, tokenizer, text_max_length=256):
        self.tokenizer = tokenizer
        self.text_max_length = text_max_length

    def __call__(self, example):
        text = _encode(self.tokenizer, example["text"], self.text_max_length)
        return {"id": example["id"], "text": text, "original": example["text"]}


class RREVPreProcessor:
    """Reranker-eval row over the retriever's dump (preprocess.py:64-84)."""

    def __init__(self, tokenizer, query_max_length=32, text_max_length=256):
        self.tokenizer = tokenizer
        self.query_max_length = query_max_length
        self.text_max_length = text_max_length

    def __call__(self, example):
        query = _encode(self.tokenizer, example["query"], self.query_max_length)
        document = _encode(self.tokenizer, example["document"], self.text_max_length)
        return {
            "query_id": example["query_id"],
            "query": query,
            # intended semantics: carry the doc id (the reference stores the
            # raw document text in doc_id, preprocess.py:81)
            "doc_id": example.get("doc_id", example["document"]),
            "document": document,
            "original": example["document"],
            "answers": example["answers"],
        }


class RelevancyPreProcessor:
    """{query_id, query ids, pos_doc_ids} (preprocess.py:87-99)."""

    def __init__(self, tokenizer, query_max_length=32, *args):
        self.tokenizer = tokenizer
        self.query_max_length = query_max_length

    def __call__(self, example):
        query = _encode(self.tokenizer, example["query"], self.query_max_length)
        return {
            "query_id": example["query_id"],
            "query": query,
            "pos_doc_ids": example["pos_doc_ids"],
        }


class ExactMatchPreProcessor:
    """{query_id, query ids, answers, original query text} (preprocess.py:102-118)."""

    def __init__(self, tokenizer, query_max_length=32, *args):
        self.tokenizer = tokenizer
        self.query_max_length = query_max_length

    def __call__(self, example):
        query = _encode(self.tokenizer, example["query"], self.query_max_length)
        return {
            "query_id": example["query_id"],
            "query": query,
            "answers": example["answers"],
            "original": example["query"],
        }


class QueryPreProcessor:
    """{query_id, query ids} (preprocess.py:121-132)."""

    def __init__(self, tokenizer, query_max_length=32):
        self.tokenizer = tokenizer
        self.query_max_length = query_max_length

    def __call__(self, example):
        query = _encode(self.tokenizer, example["query"], self.query_max_length)
        return {"query_id": example["query_id"], "query": query}


class CorpusPreProcessor:
    """Corpus doc with optional title → {id, token ids, original}
    (preprocess.py:135-150, minus its stray print)."""

    def __init__(self, tokenizer, text_max_length=256, separator=" "):
        self.tokenizer = tokenizer
        self.text_max_length = text_max_length
        self.separator = separator

    def __call__(self, example):
        docid = example["docid"]
        text = (
            example["title"] + self.separator + example["text"]
            if "title" in example
            else example["text"]
        )
        ids = _encode(self.tokenizer, text, self.text_max_length)
        return {"id": docid, "text": ids, "original": text}
