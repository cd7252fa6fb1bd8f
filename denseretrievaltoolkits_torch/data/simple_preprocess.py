"""Offline MS MARCO-style tsv → training-jsonl preprocessors + templates.

Mirrors ``DRT/model/utils.py:14-123`` (SimpleTrainPreProcessor /
SimpleCollectionPreProcessor) and the ``<field>`` template helpers
(``utils.py:172-212``).  Host-side one-time data preparation.

The port's own copy of ``denseretrievaltoolkits_tpu/data/simple_preprocess.py``,
with the same names and behaviour. The tsv collection is read with ``csv``
(``datasets``' csv loader in the original, which the card's machine lacks): a
row a line, ``columns`` as keys, empty fields ``None`` as pandas reads them.
"""

from __future__ import annotations

import csv
import json
import warnings
from dataclasses import dataclass
from typing import Dict, List


def find_all_markers(template: str) -> List[str]:
    """All ``<name>`` markers in a template (reference utils.py:172-187)."""
    markers = []
    start = 0
    while True:
        start = template.find("<", start)
        if start == -1:
            break
        end = template.find(">", start)
        if end == -1:
            break
        markers.append(template[start + 1 : end])
        start = end + 1
    return markers


def fill_template(template: str, data: Dict, markers: List[str] = None,
                  allow_not_found: bool = False) -> str:
    """Fill ``<a.b>`` markers from (nested) data (reference utils.py:190-212)."""
    if markers is None:
        markers = find_all_markers(template)
    for marker in markers:
        found = True
        content = data
        for level in marker.split("."):
            content = content.get(level, None) if isinstance(content, dict) else None
            if content is None:
                found = False
                break
        if not found:
            if allow_not_found:
                warnings.warn(
                    f"Marker '{marker}' not found in data. Replacing with ''.",
                    RuntimeWarning,
                )
                content = ""
            else:
                raise ValueError(f"Cannot find the marker '{marker}' in the data")
        template = template.replace(f"<{marker}>", str(content))
    return template


@dataclass
class SimpleTrainPreProcessor:
    """(qid, pos docids, neg docids) triples + tsv collection → train rows
    (reference utils.py:14-101)."""

    query_file: str
    collection_file: str
    tokenizer: object

    doc_max_len: int = 128
    query_max_len: int = 32
    columns = ["text_id", "title", "text"]
    title_field = "title"
    text_field = "text"
    query_field = "text"
    doc_template: str = None
    query_template: str = None
    allow_not_found: bool = False

    def __post_init__(self):
        self.queries = self.read_queries(self.query_file)
        self.collection = self.read_collection(self.collection_file, self.columns)

    @staticmethod
    def read_collection(path: str, columns: List[str]) -> List[Dict[str, str]]:
        with open(path, encoding="utf8", newline="") as fh:
            return [dict(zip(columns, (v if v != "" else None for v in row)))
                    for row in csv.reader(fh, delimiter="\t")]

    @staticmethod
    def read_queries(queries: str) -> Dict[str, str]:
        qmap = {}
        with open(queries) as fh:
            for line in fh:
                qid, qry = line.strip().split("\t")
                qmap[qid] = qry
        return qmap

    @staticmethod
    def read_qrel(relevance_file: str) -> Dict[str, List[str]]:
        qrel: Dict[str, List[str]] = {}
        with open(relevance_file, encoding="utf8") as fh:
            for topicid, _, docid, rel in csv.reader(fh, delimiter="\t"):
                assert rel == "1"
                qrel.setdefault(topicid, []).append(docid)
        return qrel

    def get_query(self, q: str) -> List[int]:
        if self.query_template is None:
            query = self.queries[q]
        else:
            query = fill_template(
                self.query_template,
                data={self.query_field: self.queries[q]},
                allow_not_found=self.allow_not_found,
            )
        return self.tokenizer.encode(
            query, add_special_tokens=False, max_length=self.query_max_len, truncation=True
        )

    def get_passage(self, p: str) -> List[int]:
        entry = self.collection[int(p)]
        title = entry[self.title_field] or ""
        body = entry[self.text_field]
        if self.doc_template is None:
            content = title + self.tokenizer.sep_token + body
        else:
            content = fill_template(
                self.doc_template, data=entry, allow_not_found=self.allow_not_found
            )
        return self.tokenizer.encode(
            content, add_special_tokens=False, max_length=self.doc_max_len, truncation=True
        )

    def process_one(self, train) -> str:
        q, pp, nn = train
        return json.dumps(
            {
                "query": self.get_query(q),
                "positives": [self.get_passage(p) for p in pp],
                "negatives": [self.get_passage(n) for n in nn],
            }
        )


@dataclass
class SimpleCollectionPreProcessor:
    """tsv collection line → {text_id, token ids} json (reference utils.py:104-123)."""

    tokenizer: object
    separator: str = "\t"
    max_length: int = 128

    def process_line(self, line: str) -> str:
        xx = line.strip().split(self.separator)
        text_id, text = xx[0], xx[1:]
        text_encoded = self.tokenizer.encode(
            self.tokenizer.sep_token.join(text),
            add_special_tokens=False,
            max_length=self.max_length,
            truncation=True,
        )
        return json.dumps({"text_id": text_id, "text": text_encoded})
