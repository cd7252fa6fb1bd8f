"""Corpus-sharded product-quantized index.

Counterpart of ``denseretrievaltoolkits_tpu/parallel/sharded_pq.py``
(:30-387): the codebooks are fitted once on the gathered sample (rank 0
fits, every rank receives them: ``sharded_ivf.fit_on_rank0``), each rank
encodes and holds the codes of its contiguous rows in a
``index/pq.py:PQIndex`` on its card and searches them there (``serve``: K16
for 8-bit codes, K15 for 4-bit; ``exact``: the ADC scan), and the candidates
merge as ``ShardedFlatIndex``'s do.

``save`` gathers the codes to rank 0, which writes ``PQIndex``'s one-file
format (the JAX package's one-process load reads it); ``load`` reads that
or the JAX package's multi-host parts, each rank its own rows. Train, add,
search, save and load are collective.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..index.modes import resolve_pq_mode
from ..index.pq import PQIndex
from ..utils.distributed import host_corpus_bounds
from .mesh import Mesh
from .sharded_index import merge_candidates, pad_candidates, rank_window
from .sharded_ivf import _as_tensor, collective_sample, fit_on_rank0


class ShardedPQIndex:
    """PQ codes split over the mesh's ranks by contiguous rows; global ADC
    top-k. ``PQIndex``'s trained-index protocol (``is_trained`` / ``train`` /
    ``add_chunks``), on ``device`` (CUDA by default)."""

    def __init__(self, mesh: Mesh, dim: int, M: int = 96, block_size: Optional[int] = None,
                 nbits: int = 8, device=None):
        self.mesh = mesh
        self.local = PQIndex(dim, M=M, block_size=block_size, nbits=nbits, device=device)
        self.dim, self.M, self.nbits = dim, M, nbits
        self.device = self.local.device
        self.docid: List = []
        self.global_rows: Optional[int] = None

    def __len__(self):
        return len(self.local) if self.global_rows is None else int(self.global_rows)

    @property
    def is_trained(self) -> bool:
        return self.local.is_trained

    @property
    def codebooks(self):
        return self.local.codebooks

    def train(self, reps, iters: int = 12, seed: int = 0) -> None:
        """The codebooks, fitted on rank 0 on every rank's sample, on every rank."""
        local = self.local
        sample = collective_sample(reps, self.mesh, self.device)
        (codebooks,) = fit_on_rank0(self.mesh,
                                    lambda: local.train(sample, iters=iters, seed=seed),
                                    lambda: [local.codebooks], self.device)
        local.codebooks = codebooks
        local._set_codebooks()

    def add(self, reps) -> None:
        self.local.add(reps)

    def add_device(self, reps) -> None:
        self.local.add_device(reps)

    def add_chunks(self, chunk_fn, n_rows: int, chunk_rows: int = 500_000) -> None:
        """This rank's window, ``chunk_fn(start, rows)`` 0-based over it."""
        self.local.add_chunks(chunk_fn, n_rows, chunk_rows=chunk_rows)

    def _layout(self) -> Tuple[int, int, int]:
        return rank_window(self.mesh, self.global_rows, len(self.local), "ShardedPQIndex")

    def search(self, q_reps, k: int = 1000,
               mode: str = "exact") -> Tuple[np.ndarray, np.ndarray]:
        mode = resolve_pq_mode(mode)
        if not self.is_trained:
            raise RuntimeError("ShardedPQIndex.search on an untrained index")
        n, start, _ = self._layout()
        k = min(k, n)
        q = _as_tensor(q_reps, self.device)
        s = i = None
        if len(self.local):
            s, i = self.local.search(q, min(k, len(self.local)), mode=mode)
            s, i = torch.as_tensor(s), torch.as_tensor(i)
        s, i = pad_candidates(s, i, int(q.shape[0]), k, start, self.device)
        return merge_candidates(s, i, self.mesh, k)

    def batch_search(self, q_reps, k: int, batch_size: int, quiet: bool = True,
                     mode: str = "exact") -> Tuple[np.ndarray, np.ndarray]:
        all_s, all_i = [], []
        for start in range(0, q_reps.shape[0], batch_size):
            s, i = self.search(q_reps[start:start + batch_size], k, mode=mode)
            all_s.append(s)
            all_i.append(i)
        return np.concatenate(all_s), np.concatenate(all_i)

    # -- persistence ---------------------------------------------------------------------------

    def save(self, path: str) -> None:
        """Every rank's codes, gathered (padded to the first window's width),
        written by rank 0 as one ``path.npz`` (codes, codebooks) + meta; then a
        barrier."""
        n, start, stop = self._layout()
        m_storage = self.M // 2 if self.nbits == 4 else self.M
        width = host_corpus_bounds(n, self.mesh.size, 0)[1]
        codes = self.local._materialize()
        mine = torch.zeros((m_storage, width), dtype=torch.int8, device=self.device)
        if codes is not None:
            mine[:, :stop - start] = codes
        parts = self.mesh.all_gather(mine)
        if self.mesh.rank == 0:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            spans = [host_corpus_bounds(n, self.mesh.size, r) for r in range(self.mesh.size)]
            full = torch.cat([p[:, :b - a] for p, (a, b) in zip(parts, spans)], dim=1)
            np.savez(path + ".npz", codes=full.cpu().numpy(), codebooks=self.codebooks)
            with open(path + ".meta.json", "w") as fh:
                json.dump({"kind": "pq", "dim": self.dim, "M": self.M, "nbits": self.nbits,
                           "n": n, "docid": self.docid}, fh)
        self.mesh.barrier()

    @classmethod
    def load(cls, path: str, mesh: Mesh, device=None) -> "ShardedPQIndex":
        """Each rank's rows of a PQ index saved by either package: one
        ``path.npz``, or the multi-host parts (``path.cb.npz`` + ``path.part{p}.npz``)."""
        with open(path + ".meta.json") as fh:
            meta = json.load(fh)
        idx = cls(mesh, meta["dim"], M=meta["M"], nbits=meta.get("nbits", 8), device=device)
        n = int(meta["n"])
        lo, hi = host_corpus_bounds(n, mesh.size, mesh.rank)
        if "parts" in meta:
            with np.load(path + ".cb.npz") as z:
                codebooks = z["codebooks"]
            offs = np.concatenate([[0], np.cumsum(meta["parts"])]).astype(np.int64)
            cols = []
            for p in range(len(meta["parts"])):
                a, b = max(lo, int(offs[p])), min(hi, int(offs[p + 1]))
                if a < b:
                    with np.load(f"{path}.part{p}.npz") as z:
                        cols.append(z["codes"][:, a - offs[p]:b - offs[p]])
            codes = np.concatenate(cols, axis=1) if cols else None
        else:
            with np.load(path + ".npz") as z:
                codebooks, codes = z["codebooks"], z["codes"][:, lo:hi]
        local = idx.local
        local.codebooks = np.asarray(codebooks, np.float32)
        local._set_codebooks()
        if codes is not None and codes.shape[1]:
            local._code_slabs = [torch.from_numpy(np.ascontiguousarray(codes)).to(idx.device)]
            local._n = int(codes.shape[1])
        idx.global_rows = n
        idx.docid = meta.get("docid", [])
        return idx
