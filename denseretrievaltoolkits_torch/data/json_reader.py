"""Local JSON / JSON-Lines splits read as ``datasets.load_dataset("json", ...)`` reads them.

The port's own reader, for the machine with the card, which has no ``datasets``.
:func:`load_json` takes ``data_files`` as ``datasets`` does (a path, a list of
paths or a dict of splits, glob patterns allowed) and returns a dict of
:class:`JsonDataset`, one a split, whose rows equal ``datasets``' (5.0.0):

- a file holds JSON lines, or one JSON array of objects (of strings: a
  ``text`` column);
- the columns are inferred as ``pyarrow``'s JSON reader infers them, from the
  first split's first file, and every split is cast to them: keys missing in a
  row, or in a struct inside a list, are ``None``; a column of ints and floats
  is floats; a column of strings that are all ISO-8601 dates or times
  (``YYYY-MM-DD[ hh:mm:ss]``) is ``datetime``; a key outside these columns, or a
  column of two kinds (a string and a number), raises;
- ``shard(n, i)`` takes the contiguous i-th of n parts (``datasets``' default);
- ``map(fn, remove_columns=...)`` runs ``fn`` row by row and infers the new
  columns the same way.

``datasets``' other loaders and hub names are not read here
(``data/datasets.py:load_dataset`` sends them to ``datasets``).
"""

from __future__ import annotations

import datetime
import glob
import json
import math
import operator
import os
import re
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

_TIMESTAMP = re.compile(r"\d{4}-\d{2}-\d{2}(?:[ T]\d{2}:\d{2}:\d{2})?")


class _Mixed(ValueError):
    """Two kinds of value at one path: ``datasets`` stores that path as JSON."""

    def __init__(self, path):
        super().__init__(f"column {'/'.join(map(str, path))} mixes kinds")
        self.path = path


def json_paths(rows: Sequence[dict]) -> List[tuple]:
    """The paths ``datasets`` stores as JSON (``find_mixed_struct_types_field_paths``):
    structs under the root whose key sets differ (or that are empty), and values
    mixing objects or lists with other kinds. A path is a tuple of keys, 0 for a
    list's items."""
    out, todo = [], [((), [r for r in rows if r is not None])]
    while todo:
        path, content = todo.pop(0)
        if all(isinstance(x, dict) for x in content):
            if path and (any(set(x) != set(content[0]) for x in content) or not content[0]):
                out.append(path)
                continue
            for key in {k for x in content for k in x}:
                values = [x[key] for x in content if x.get(key) is not None]
                if values:
                    todo.append((path + (key,), values))
        elif all(isinstance(x, list) for x in content):
            values = [v for x in content for v in x if v is not None]
            if values:
                todo.append((path + (0,), values))
        elif any(isinstance(x, (dict, list)) for x in content):
            out.append(path)
    return out


def _kind(value, path=(), as_json=()):
    """The inferred type of one JSON value: a tuple whose first item is its kind."""
    if path in as_json:
        return ("json",)
    if value is None:
        return ("null",)
    if isinstance(value, bool):
        return ("bool",)
    if isinstance(value, int):
        return ("int",)
    if isinstance(value, float):
        return ("float",)
    if isinstance(value, str):
        return ("timestamp",) if _TIMESTAMP.fullmatch(value) else ("str",)
    if isinstance(value, datetime.datetime):
        return ("timestamp",)
    if isinstance(value, list):
        elem = ("null",)
        for v in value:
            elem = _merge(elem, _kind(v, path + (0,), as_json), path + (0,))
        return ("list", elem)
    if isinstance(value, dict):
        return ("struct", {k: _kind(v, path + (k,), as_json) for k, v in value.items()})
    raise ValueError(f"unsupported JSON value {value!r}")


def _merge(a, b, path):
    """The type of a column holding values of types ``a`` and ``b`` (pyarrow's)."""
    if a[0] == "null":
        return b
    if b[0] == "null" or a == b:
        return a
    kinds = {a[0], b[0]}
    if kinds == {"int", "float"}:
        return ("float",)
    if kinds == {"str", "timestamp"}:
        return ("str",)
    if a[0] == b[0] == "list":
        return ("list", _merge(a[1], b[1], path + (0,)))
    if a[0] == b[0] == "struct":
        fields = dict(a[1])  # first-seen order, new fields after
        for k, t in b[1].items():
            fields[k] = _merge(fields[k], t, path + (k,)) if k in fields else t
        return ("struct", fields)
    raise _Mixed(path)


def infer_schema(rows: Sequence[dict]):
    """(the columns of ``rows``, the paths stored as JSON): a struct type over the
    union of their keys, with the paths of :func:`json_paths` and of mixed kinds
    as JSON (``datasets`` re-reads a batch with each path pyarrow refuses
    JSON-encoded)."""
    as_json = json_paths(rows)
    while True:
        schema = ("struct", {})
        try:
            for row in rows:
                if not isinstance(row, dict):
                    raise ValueError(f"a row must be a JSON object, got {row!r}")
                schema = _merge(schema, _kind(row, (), as_json), ())
            return schema, as_json
        except _Mixed as mixed:
            if not mixed.path:
                raise ValueError("rows must be JSON objects") from None
            for i, p in enumerate(as_json):  # a shorter path replaces those under it
                if p[:len(mixed.path)] == mixed.path:
                    as_json[i] = mixed.path
                    break
            else:
                as_json.append(mixed.path)


def _json_value(value):
    """A value through ``datasets``' JSON column: a string that parses as JSON comes
    back parsed, floats as pandas' ujson writes them, the rest as it was."""
    if isinstance(value, str):
        try:
            return json.loads(value)
        except ValueError:
            return value
    return _rounded(value)


def _ujson_float(x: float) -> float:
    """``x`` read by pandas' ujson, written by it (10 decimals; 10 significant
    digits in the exponent form it takes above 1e16 and below 1e-15) and read back.
    ujson reads a number whose power of ten underflows (5e-324) as 0."""
    a = abs(x)
    if a != a or a in (0.0, float("inf")):
        return x
    exp = repr(a).partition("e")[2]
    if exp and 10.0 ** int(exp) == 0.0:
        return math.copysign(0.0, x)
    if a > 1e16 or a < 1e-15:
        return float(f"{x:.9e}")
    return round(x, 10)


def _rounded(value):
    if isinstance(value, float):
        return _ujson_float(value)
    if isinstance(value, list):
        return [_rounded(v) for v in value]
    if isinstance(value, dict):
        return {k: _rounded(v) for k, v in value.items()}
    return value


def _cast(value, kind, path):
    if value is None:
        return None
    if kind[0] == "json":
        return _json_value(value)
    if kind[0] == "float":
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"column {path}: {value!r} is no number")
        return float(value)
    if kind[0] == "int":
        if isinstance(value, bool) or not isinstance(value, int):
            raise ValueError(f"column {path}: {value!r} is no int")
        return value
    if kind[0] == "timestamp" and isinstance(value, str):
        return datetime.datetime.fromisoformat(value)
    if kind[0] == "list" and isinstance(value, list):
        return [_cast(v, kind[1], path + "[]") for v in value]
    if kind[0] == "struct" and isinstance(value, dict):
        extra = set(value) - set(kind[1])
        if extra:
            raise ValueError(f"{path or 'row'}: keys {sorted(extra)} are not in the columns "
                             "inferred from the first file")
        return {k: _cast(value.get(k), t, f"{path}.{k}".lstrip(".")) for k, t in kind[1].items()}
    try:
        fits = _merge(kind, _kind(value), ()) == kind
    except _Mixed:
        fits = False
    if not fits:
        raise ValueError(f"column {path}: {value!r} does not fit {kind[0]}")
    return value


class JsonDataset:
    """Rows as dicts: ``len``, indexing by row, rows or column, iteration,
    ``column_names``, ``shard``, ``select`` and ``map``."""

    def __init__(self, rows: List[dict], schema=None):
        self._schema = infer_schema(rows)[0] if schema is None else schema
        self._rows = [_cast(r, self._schema, "") for r in rows]

    @classmethod
    def _of_cast_rows(cls, rows: List[dict], schema) -> "JsonDataset":
        ds = cls.__new__(cls)
        ds._schema, ds._rows = schema, rows
        return ds

    @property
    def column_names(self) -> List[str]:
        return list(self._schema[1])

    def __len__(self) -> int:
        return len(self._rows)

    def __iter__(self) -> Iterator[dict]:
        return (dict(r) for r in self._rows)

    def __getitem__(self, key):
        if isinstance(key, str):
            if key not in self._schema[1]:
                raise KeyError(key)
            return [r[key] for r in self._rows]
        if isinstance(key, slice):
            key = range(*key.indices(len(self._rows)))
        try:
            return dict(self._rows[operator.index(key)])
        except TypeError:  # rows: a dict of columns
            pass
        picked = [self._rows[int(i)] for i in key]
        return {c: [r[c] for r in picked] for c in self.column_names}

    def select(self, indices) -> "JsonDataset":
        return JsonDataset._of_cast_rows([self._rows[int(i)] for i in indices], self._schema)

    def shard(self, num_shards: int, index: int, contiguous: bool = True) -> "JsonDataset":
        if not 0 <= index < num_shards:
            raise ValueError("index should be in [0, num_shards-1]")
        if not contiguous:
            return self.select(range(index, len(self), num_shards))
        div, mod = divmod(len(self), num_shards)
        start = div * index + min(index, mod)
        return self.select(range(start, start + div + (1 if index < mod else 0)))

    def map(self, function: Callable[[dict], dict], batched: bool = False,
            remove_columns: Optional[Sequence[str]] = None, **kwargs) -> "JsonDataset":
        """``function`` on every row; its dict updates the row less
        ``remove_columns``. ``num_proc``, ``desc`` and the like are accepted and
        ignored: the rows are mapped in this process."""
        if batched:
            raise NotImplementedError("JsonDataset.map maps row by row")
        drop = set(remove_columns or ())
        out = []
        for row in self._rows:
            new = {k: v for k, v in row.items() if k not in drop}
            new.update(function(dict(row)))
            out.append(new)
        return JsonDataset(out)


def _files(spec) -> List[str]:
    paths = [spec] if isinstance(spec, (str, os.PathLike)) else list(spec)
    out = []
    for p in map(os.fspath, paths):
        if os.path.exists(p):
            out.append(p)
            continue
        hits = sorted(glob.glob(p))
        if not hits:
            raise FileNotFoundError(f"no data file matches {p!r}")
        out.extend(hits)
    return out


def read_rows(path: str) -> Tuple[List[dict], bool]:
    """One file's rows: JSON lines, or a JSON array (of objects, or of strings as
    ``{"text": ...}``); and whether it was an array."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    if text.lstrip().startswith("["):
        data = json.loads(text)
        return [x if isinstance(x, dict) else {"text": x} for x in data], True
    return [json.loads(line) for line in text.splitlines() if line.strip()], False


def is_local(data_files) -> bool:
    """``data_files`` names local files (or glob patterns over local directories)."""
    if data_files is None:
        return False
    specs = data_files.values() if isinstance(data_files, dict) else [data_files]
    try:
        return all(os.path.exists(p) or glob.glob(p) for s in specs for p in _files(s))
    except FileNotFoundError:
        return False


def load_json(data_files: Union[str, Sequence[str], Dict[str, Union[str, Sequence[str]]]]
              ) -> Dict[str, JsonDataset]:
    """``{split: JsonDataset}`` (a path or list of paths is the ``train`` split).

    The columns come from the first split's first file, as ``datasets`` infers
    its features from that file's first block; where that file is a JSON array,
    ``datasets`` reads no features ahead, and each split's first file sets its
    own. Where a path is stored as JSON, ``datasets`` re-writes every row with
    pandas' ujson, which keeps 10 decimals of a float: so are the floats here."""
    splits = data_files if isinstance(data_files, dict) else {"train": data_files}
    files = {name: _files(spec) for name, spec in splits.items()}
    shared = None
    out = {}
    for name, paths in files.items():
        read = [read_rows(p) for p in paths]
        if shared is None or read[0][1]:
            columns = infer_schema(read[0][0])
            if shared is None and not read[0][1]:
                shared = columns
        else:
            columns = shared
        schema, as_json = columns
        rows = [r for rows, _ in read for r in rows]
        out[name] = JsonDataset(_rounded(rows) if as_json else rows, schema)
    return out
