"""Device-resident flat inner-product index with exact top-k search.

Counterpart of ``denseretrievaltoolkits_tpu/index/flat.py`` for fp32 and bf16
rows:

- :func:`blockwise_topk` is the exact scan, a running top-k merged block by
  block. It is the plain version of the whole search, the reference for the
  K5 path, and the last rung of the certified search.
- :class:`FlatIPIndex` stages rows on the host (``add``) or takes device
  tensors (``add_device``). On CUDA, ``search(mode="exact")`` runs the K5
  kernel through the certified search (``ops/topk.py:certified_topk``); on the
  CPU every mode runs the exact scan, as the reference does off TPU
  (index/modes.py:55-57). ``save``/``load`` use the reference's
  ``path.npz`` + ``path.meta.json`` format, so indexes interchange.

Modes resolve through the reference's ``index.modes.resolve_mode``. On CUDA
the approximate modes (``serve``/``partial``/``i8q``) and the int8/int4
dtypes raise ``NotImplementedError`` until their kernels are ported; they
never silently run ``exact``.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from denseretrievaltoolkits_tpu.index.modes import resolve_mode

from ..ops.topk import _scores, certified_topk

DEFAULT_BLOCK = 4096
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def blockwise_topk(q_reps: torch.Tensor, corpus: torch.Tensor, k: int,
                   block_size: int = DEFAULT_BLOCK,
                   valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner-product search, O(k + block) memory per query.

    q_reps [Q,H] float; corpus [N,H] fp32/bf16; ``valid`` counts the real rows
    (later rows are masked). Returns (scores [Q,k] fp32, ids [Q,k] int32) sorted
    descending; ties keep the smaller id, as ``lax.top_k`` does. fp32 rows
    score in true fp32, which on CUDA needs
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default)."""
    if corpus.is_cuda and corpus.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("blockwise_topk: fp32 scores must not use TF32; set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    Q = q_reps.shape[0]
    N = corpus.shape[0]
    n_valid = N if valid is None else int(valid)
    qf = q_reps.to(device=corpus.device, dtype=torch.float32)
    run_s = torch.full((Q, k), float("-inf"), dtype=torch.float32, device=corpus.device)
    run_i = torch.zeros((Q, k), dtype=torch.int32, device=corpus.device)
    for start in range(0, N, block_size):
        blk = corpus[start:start + block_size]
        s = _scores(qf, blk)
        ids = torch.arange(start, start + blk.shape[0], dtype=torch.int32, device=corpus.device)
        s = torch.where(ids[None, :] < n_valid, s, float("-inf"))
        cat_s = torch.cat([run_s, s], dim=1)
        cat_i = torch.cat([run_i, ids.expand(Q, -1)], dim=1)
        sv, pos = torch.sort(cat_s, dim=1, descending=True, stable=True)
        run_s = sv[:, :k].contiguous()
        run_i = torch.gather(cat_i, 1, pos[:, :k])
    return run_s, run_i


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to CUDA yet (ROADMAP queue 1, item 'Flat int8/int4 and the "
        f"serve/partial/i8q modes'); use mode='exact' on a float32/bfloat16 index")


class FlatIPIndex:
    """Device-resident flat IP index: add / add_device / search / batch_search /
    save / load. ``device`` defaults to CUDA when a card is present."""

    def __init__(self, dim_or_reps, dtype: str = "float32",
                 block_size: int = DEFAULT_BLOCK, device=None):
        if dtype in ("int8", "int4"):
            raise _not_ported(f"the {dtype} index")
        if dtype not in DTYPES:
            raise ValueError(f"unsupported index dtype {dtype!r}")
        reps = dim_or_reps if isinstance(dim_or_reps, np.ndarray) else None
        self.dim = int(reps.shape[1]) if reps is not None else int(dim_or_reps)
        self.dtype = dtype
        self.block_size = block_size
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self._chunks: List[np.ndarray] = []
        self._device_slabs: List[torch.Tensor] = []
        self._device_corpus: Optional[torch.Tensor] = None
        self._n = 0
        self.docid: List = []
        if reps is not None:
            self.add(reps)

    def __len__(self):
        return self._n

    def add(self, p_reps: np.ndarray) -> None:
        """Append corpus embeddings (host-side staging; device upload is lazy)."""
        if self._device_slabs:
            raise ValueError("mixing add() and add_device() is not supported")
        p_reps = np.asarray(p_reps, np.float32)
        if p_reps.ndim != 2 or p_reps.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}] reps, got {p_reps.shape}")
        self._chunks.append(p_reps)
        self._n += p_reps.shape[0]
        self._device_corpus = None

    def add_device(self, p_reps: torch.Tensor) -> None:
        """Append device-resident embeddings without a host round trip; each
        call becomes one slab, searched on its own and merged."""
        if self._chunks:
            raise ValueError("mixing add() and add_device() is not supported")
        if p_reps.ndim != 2 or p_reps.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}] reps, got {tuple(p_reps.shape)}")
        self._device_slabs.append(p_reps.to(self.device, DTYPES[self.dtype]).contiguous())
        self._n += int(p_reps.shape[0])

    def _materialize(self) -> torch.Tensor:
        if self._device_corpus is None:
            full = np.concatenate(self._chunks, axis=0) if len(self._chunks) != 1 \
                else self._chunks[0]
            self._device_corpus = torch.from_numpy(full).to(self.device, DTYPES[self.dtype])
        return self._device_corpus

    def _topk(self, q: torch.Tensor, corpus: torch.Tensor, k: int):
        block = min(self.block_size, max(256, 1 << (corpus.shape[0] - 1).bit_length()))
        if corpus.is_cuda:
            return certified_topk(q, corpus, k, block)
        return blockwise_topk(q, corpus, k, block)

    def search(self, q_reps, k: int = 1000,
               mode: str = "exact") -> Tuple[np.ndarray, np.ndarray]:
        """Top-k search. Returns (scores [Q,k], indices [Q,k]) sorted descending."""
        mode = resolve_mode(mode, self.dtype)
        if self.device.type == "cuda" and mode != "exact":
            raise _not_ported(f"mode={mode!r}")
        k = min(k, self._n)
        q = torch.as_tensor(q_reps, dtype=torch.float32, device=self.device)
        if self._device_slabs:
            parts_v, parts_i, offset = [], [], 0
            for slab in self._device_slabs:
                s, i = self._topk(q, slab, min(k, slab.shape[0]))
                parts_v.append(s)
                parts_i.append(i + offset)
                offset += slab.shape[0]
            cat_v = torch.cat(parts_v, dim=1)
            cat_i = torch.cat(parts_i, dim=1)
            sv, pos = torch.sort(cat_v, dim=1, descending=True, stable=True)
            scores, ids = sv[:, :k], torch.gather(cat_i, 1, pos[:, :k])
        else:
            scores, ids = self._topk(q, self._materialize(), k)
        return scores.cpu().numpy(), ids.cpu().numpy()

    def batch_search(self, q_reps, k: int, batch_size: int, quiet: bool = False,
                     mode: str = "exact") -> Tuple[np.ndarray, np.ndarray]:
        """Chunked search over many queries."""
        all_scores, all_indices = [], []
        for start in range(0, q_reps.shape[0], batch_size):
            s, i = self.search(q_reps[start:start + batch_size], k, mode=mode)
            all_scores.append(s)
            all_indices.append(i)
        return np.concatenate(all_scores), np.concatenate(all_indices)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if self._device_slabs:
            full = torch.cat([s.float() for s in self._device_slabs]).cpu().numpy()
        elif self._chunks:
            full = np.concatenate(self._chunks, axis=0)
        else:
            full = np.zeros((0, self.dim), np.float32)
        np.savez(path + ".npz", reps=full)
        with open(path + ".meta.json", "w") as fh:
            json.dump({"dim": self.dim, "dtype": self.dtype, "n": self._n,
                       "docid": self.docid}, fh)

    @classmethod
    def load(cls, path: str, device=None) -> "FlatIPIndex":
        with open(path + ".meta.json") as fh:
            meta = json.load(fh)
        idx = cls(meta["dim"], dtype=meta["dtype"], device=device)
        with np.load(path + ".npz") as z:
            reps = z["reps"]
        if reps.shape[0]:
            idx.add(reps)
        idx.docid = meta.get("docid", [])
        return idx
