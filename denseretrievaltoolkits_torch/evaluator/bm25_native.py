"""ctypes binding for the port's native C++ BM25 engine (``native/bm25.cpp``).

Counterpart of ``denseretrievaltoolkits_tpu/evaluator/bm25_native.py``: the
same model and parameters as the Python ``BM25Retriever``
(``evaluator/bm25.py``), with postings and dense epoch-stamped scoring in
place of Python dicts, for the hard-negative mining path. The source is the
port's own copy, ``denseretrievaltoolkits_torch/native/bm25.cpp``
(``tests/test_torch_shared.py`` holds it to the original). At first use it is
compiled by ``g++ -O3 -shared -fPIC -std=c++17`` into the git-ignored
``_build/libbm25_<hash>.so``, named by a hash of the source and the flags, as
``ops/_native.py`` names the CUDA library; there is no ``-march=native``, so
the library runs on any x86-64 host. A failed build raises with the
compiler's output: unlike the reference's ``native_available``, nothing falls
back to Python (``BM25Negatives(use_native=False)`` asks for it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import random
import shutil
import subprocess
import tempfile
from typing import List, Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "bm25.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_I32P = ctypes.POINTER(ctypes.c_int32)


def library_path() -> str:
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(" ".join(FLAGS).encode() + b"|" + fh.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libbm25_{digest}.so")


def build() -> str:
    """Compile ``native/bm25.cpp`` unless its library exists; returns the path. Raises
    with g++'s output when the compiler is missing or fails."""
    target = library_path()
    if os.path.exists(target):
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native BM25 engine is compiled at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        tmp = os.path.join(work, "libbm25.so")
        cmd = [cxx, *FLAGS, SOURCE, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, target)  # atomic: a concurrent build never sees a partial .so
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return target


@functools.lru_cache(maxsize=None)
def load_lib() -> ctypes.CDLL:
    """The loaded engine, built on first call (the reference's signatures,
    bm25_native.py:39-67 there)."""
    lib = ctypes.CDLL(build())
    lib.bm25_create.restype = ctypes.c_void_p
    lib.bm25_create.argtypes = [ctypes.c_double, ctypes.c_double, ctypes.c_double]
    lib.bm25_destroy.argtypes = [ctypes.c_void_p]
    lib.bm25_num_docs.restype = ctypes.c_int64
    lib.bm25_num_docs.argtypes = [ctypes.c_void_p]
    lib.bm25_add_doc.restype = ctypes.c_int32
    lib.bm25_add_doc.argtypes = [ctypes.c_void_p, _I32P, ctypes.c_int32]
    lib.bm25_finalize.argtypes = [ctypes.c_void_p]
    lib.bm25_search.restype = ctypes.c_int32
    lib.bm25_search.argtypes = [ctypes.c_void_p, _I32P, ctypes.c_int32, ctypes.c_int32,
                                ctypes.c_int32, ctypes.c_int32, _I32P,
                                ctypes.POINTER(ctypes.c_float)]
    lib.bm25_search_batch.argtypes = [ctypes.c_void_p, _I32P, ctypes.POINTER(ctypes.c_int64),
                                      ctypes.c_int32, ctypes.c_int32, _I32P, _I32P, _I32P,
                                      ctypes.POINTER(ctypes.c_float)]
    return lib


def _as_i32(seq) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(seq, dtype=np.int32))


def _ptr(arr: np.ndarray, ctype=ctypes.c_int32):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeBM25Retriever:
    """API mirror of ``evaluator.bm25.BM25Retriever`` backed by the C++ engine."""

    def __init__(self, topK: int = 10, vocab_size: int = None, seed: int = 0,
                 k1: float = 1.2, b: float = 0.75, eps: float = 0.25):
        self._lib = load_lib()
        self._h = self._lib.bm25_create(k1, b, eps)
        self.k1, self.b, self.eps = k1, b, eps  # read by the mining cache's key
        self.topK = topK
        self.passage: List[List[int]] = []
        self._rng = random.Random(seed)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bm25_destroy(self._h)
            self._h = None

    def load_passages(self, corpus: Sequence[dict]) -> Tuple[List[int], List[int]]:
        """Each sample's positives then negatives into the pool; returns the spans
        [bp, ep) of each sample's own positives."""
        bp, ep = [], []
        for sample in corpus:
            bp.append(len(self.passage))
            for p in sample["positives"]:
                self._add(p)
            ep.append(len(self.passage))
            for n in sample.get("negatives", []):
                self._add(n)
        self._lib.bm25_finalize(self._h)
        return bp, ep

    def _add(self, tokens) -> None:
        arr = _as_i32(tokens)
        self.passage.append(list(tokens))
        self._lib.bm25_add_doc(self._h, _ptr(arr), len(arr))

    def search(self, query_tokens: Sequence[int], k: int = 1000,
               exclude: Tuple[int, int] = (0, 0)) -> List[int]:
        arr = _as_i32(query_tokens)
        out_ids = np.empty(k, np.int32)
        out_scores = np.empty(k, np.float32)
        n = self._lib.bm25_search(self._h, _ptr(arr), len(arr), k, exclude[0], exclude[1],
                                  _ptr(out_ids), _ptr(out_scores, ctypes.c_float))
        out = out_ids[:n].tolist()
        # pad with seeded random unseen docs, as the Python retriever does
        if len(out) < k and len(self.passage) > len(out):
            chosen = set(out)
            pool = [i for i in range(len(self.passage)) if i not in chosen]
            self._rng.shuffle(pool)
            out.extend(pool[: k - len(out)])
        return out

    def search_batch(self, queries: Sequence[Sequence[int]], k: int,
                     excl_begin=None, excl_end=None) -> np.ndarray:
        """Every query in one call: [n_queries, k] doc ids, -1 padded."""
        flat = _as_i32([t for q in queries for t in q])
        offsets = np.zeros(len(queries) + 1, np.int64)
        np.cumsum([len(q) for q in queries], out=offsets[1:])
        out_ids = np.empty((len(queries), k), np.int32)
        out_scores = np.empty((len(queries), k), np.float32)
        eb = _as_i32(excl_begin) if excl_begin is not None else None
        ee = _as_i32(excl_end) if excl_end is not None else None
        null = _I32P()
        self._lib.bm25_search_batch(
            self._h, _ptr(flat), _ptr(offsets, ctypes.c_int64), len(queries), k,
            _ptr(eb) if eb is not None else null, _ptr(ee) if ee is not None else null,
            _ptr(out_ids), _ptr(out_scores, ctypes.c_float))
        return out_ids
