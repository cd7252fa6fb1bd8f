"""The port's JSON / JSON-Lines reader against ``datasets.load_dataset("json")``.

``data/json_reader.py`` must give ``datasets``' (5.0.0) rows, in its order, for
``.json`` (JSON lines, or one array) and ``.jsonl`` files, a path, a list or a
dict of splits: keys missing in some rows are ``None``, structs whose keys
differ from row to row come back as they were written (``datasets`` stores
them as JSON), ints and floats in one column are floats; ``shard(n, i)`` for
every i, ``map``, ``column_names``, indexing. The published-schema rows of
``tests/test_realdata_playbook.py`` carry extra fields in some rows only. A hub
name goes through ``datasets``, and raises without it.
"""

import json
import random
import sys

import datasets
import pytest
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

from denseretrievaltoolkits_torch.data import datasets as tds
from denseretrievaltoolkits_torch.data.json_reader import JsonDataset, load_json

from test_realdata_playbook import _make_published_fixture, _wiki_nq_row

datasets.disable_progress_bars()


def _hf(files, tmp_path):
    return datasets.load_dataset("json", data_files=files, cache_dir=str(tmp_path / "hf"))


def _same(ref, mine):
    assert list(ref) == list(mine)
    for name in ref:
        assert len(ref[name]) == len(mine[name])
        assert list(ref[name]) == list(mine[name]), name
        assert set(ref[name].column_names) == set(mine[name].column_names)


def _write(path, rows, as_array=False):
    with open(path, "w") as fh:
        if as_array:
            json.dump(rows, fh)
        else:
            fh.write("\n".join(json.dumps(r) for r in rows) + "\n")
    return str(path)


def test_published_schema_rows(tmp_path):
    """The Tevatron-layout fixture, with ``extra`` fields in some rows only."""
    data_dir, corpus_path, corpus = _make_published_fixture(tmp_path)
    rng = random.Random(3)
    rows = []
    for i in range(14):
        row = _wiki_nq_row(rng, i % len(corpus), "paris", corpus, extra=i % 3 == 0)
        if i % 4 == 1:
            row["positive_passages"][0]["score"] = 1.5 if i % 8 == 1 else 2
        if i % 5 == 2:
            row["negative_passages"] = []
        rows.append(row)
    mixed = _write(tmp_path / "mixed.jsonl", rows)
    files = {"train": mixed, "dev": f"{data_dir}/dev.jsonl", "test": f"{data_dir}/test.jsonl"}
    _same(_hf(files, tmp_path), load_json(files))
    _same(_hf(corpus_path, tmp_path), load_json(corpus_path))


@pytest.mark.parametrize("as_array", [False, True], ids=["json-lines", "json-array"])
def test_json_files_lists_and_shards(tmp_path, as_array):
    rows = [{"query_id": str(i), "query": f"q {i}", "n": i, "w": 0.5 * i if i % 2 else i,
             "tags": ["a"] * (i % 3), "when": "2020-01-0%d" % (1 + i % 9)}
            for i in range(23)]
    a = _write(tmp_path / "a.json", rows[:15], as_array)
    b = _write(tmp_path / "b.jsonl", rows[15:])
    ref, mine = _hf([a, b], tmp_path), load_json([a, b])
    _same(ref, mine)
    r, m = ref["train"], mine["train"]
    for n in (1, 2, 3, 4, 7):
        for i in range(n):
            assert list(r.shard(n, i)) == list(m.shard(n, i)), (n, i)
    assert r[[0, 5, 9]] == m[[0, 5, 9]] and r["query"] == m["query"] and r[3] == m[3]

    def fn(row):
        return {"q": row["query"], "k": len(row["tags"]), "doc": {"id": row["query_id"]}}

    assert list(r.map(fn, remove_columns=r.column_names)) == \
        list(m.map(fn, remove_columns=m.column_names))
    assert list(r.map(fn)) == list(m.map(fn))


ROW = st.fixed_dictionaries(
    {"id": st.text(max_size=5)},
    optional={"n": st.integers(-5, 5), "x": st.one_of(st.integers(-3, 3), st.floats(-2, 2)),
              "answers": st.lists(st.text(max_size=3), max_size=3),
              "p": st.lists(st.fixed_dictionaries({"docid": st.text(max_size=3)},
                                                  optional={"s": st.integers(0, 3)}),
                            max_size=3),
              "meta": st.fixed_dictionaries({"k": st.booleans()}, optional={"v": st.none()})})


@settings(max_examples=12, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(train=st.lists(ROW, min_size=1, max_size=8), test=st.lists(ROW, max_size=5))
@example(train=[{"id": "", "meta": {"k": False}},  # a JSON path: ujson reads 5e-324 as 0
                {"id": "", "meta": {"k": False, "v": None}, "x": 5e-324}], test=[])
def test_random_rows_equal_datasets(tmp_path_factory, train, test):
    tmp = tmp_path_factory.mktemp("rows")
    files = {"train": _write(tmp / "train.jsonl", train)}
    if test:
        files["test"] = _write(tmp / "test.jsonl", test)
    try:
        ref = _hf(files, tmp)
    except Exception:  # datasets refuses the rows (a key only the test split has)
        with pytest.raises(ValueError):
            load_json(files)
        return
    _same(ref, load_json(files))


def test_datasets_classes_read_with_the_port(tmp_path, monkeypatch):
    """The split datasets and the corpus read local files without ``datasets``; a hub
    name needs it."""
    from denseretrievaltoolkits_torch.config import DataArguments

    data_dir, corpus_path, corpus = _make_published_fixture(tmp_path)
    monkeypatch.setitem(sys.modules, "datasets", None)
    args = DataArguments(dataset="nq", data_dir=data_dir, corpus_path=corpus_path)
    got = tds.load_dataset("json", data_files=args.data_path)
    assert sorted(got) == ["dev", "test", "train"] and isinstance(got["train"], JsonDataset)
    assert len(tds.load_dataset("json", data_files=corpus_path)["train"]) == len(corpus)
    with pytest.raises(ImportError, match="needs `datasets`"):
        tds.load_dataset("Tevatron/wikipedia-nq")
