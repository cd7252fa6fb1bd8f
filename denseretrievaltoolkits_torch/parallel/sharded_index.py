"""Corpus-sharded flat index: each rank searches its rows, the candidates merge.

Counterpart of ``denseretrievaltoolkits_tpu/parallel/sharded_index.py``
(:29-693). The reference's evaluation had each rank encode its corpus
shard, dump it to disk and rank 0 rebuild one FAISS index
(``trainer.py:191-262`` there). Here rank r holds the contiguous rows
``[r per, (r + 1) per)``, ``per = ceil(n / world)``
(``utils/distributed.py:host_corpus_bounds``), on its own card, in a
:class:`~denseretrievaltoolkits_torch.index.flat.FlatIPIndex` of the index's
dtype; so a search runs that rank's flat kernels on its rows: exact K5 /
K6 / K10 under the certificate with its fallback, serve K8 / K11 (J from the
shard's own rows), i8q K12; ``add_device`` quantizes on the card (K7 / K9).
Each rank's top-k ids are offset by its first row, ``all_gather``ed and
merged by a stable sort, which keeps the earlier rank's candidate at a tie,
as ``lax.top_k`` over the gathered candidates does there. Every rank returns
the same result.

Each rank adds only its window; ``global_rows`` (the whole corpus) must be
set on every rank before a search when there are several. ``save`` writes
each rank's rows as ``path.part{r}.npz`` and rank 0 the meta, the JAX
package's multi-host format, which its single-process ``load`` also reads;
:meth:`ShardedFlatIndex.load` reads that and ``FlatIPIndex``'s one-file
format. Search, ``save`` and ``load`` are collective: every rank calls them.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..index.flat import DEFAULT_BLOCK, FlatIPIndex
from ..index.modes import resolve_mode
from ..utils.distributed import host_corpus_bounds
from .mesh import Mesh


def rank_window(mesh: Mesh, global_rows: Optional[int], local_rows: int,
                what: str) -> Tuple[int, int, int]:
    """(corpus rows, this rank's window start, stop), checked against the
    ``local_rows`` it holds. One rank: the corpus is its rows; several need
    ``global_rows``, since each rank adds only its window."""
    if global_rows is None:
        if mesh.size > 1:
            raise RuntimeError(f"a {what} over several ranks needs global_rows set to the "
                               f"corpus size on every rank; each rank adds only its "
                               f"host_corpus_bounds window")
        global_rows = local_rows
    n = int(global_rows)
    start, stop = host_corpus_bounds(n, mesh.size, mesh.rank)
    if local_rows != stop - start:
        raise RuntimeError(f"rank {mesh.rank} holds {local_rows} rows but its window is "
                           f"[{start},{stop}): feed the corpus loader with shard_hosts=True")
    return n, start, stop


def merge_candidates(scores: torch.Tensor, ids: torch.Tensor, mesh: Mesh,
                     k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The global top-k of every rank's [Q, k] candidates (ids -1: none), in
    rank order; a stable sort keeps the earlier rank's candidate at a tie."""
    scores = torch.where(ids >= 0, scores, torch.full_like(scores, float("-inf")))
    all_s = torch.cat(mesh.all_gather(scores.contiguous()), dim=1)
    all_i = torch.cat(mesh.all_gather(ids.contiguous()), dim=1)
    top, pos = torch.sort(all_s, dim=1, descending=True, stable=True)
    return top[:, :k].cpu().numpy(), torch.gather(all_i, 1, pos[:, :k]).cpu().numpy()


def pad_candidates(scores: Optional[torch.Tensor], ids: Optional[torch.Tensor], q_rows: int,
                   k: int, offset: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A rank's candidates as [Q, k] fp32 scores and int64 global ids, -inf /
    -1 past what it found (an empty shard finds nothing)."""
    out_s = torch.full((q_rows, k), float("-inf"), dtype=torch.float32, device=device)
    out_i = torch.full((q_rows, k), -1, dtype=torch.int64, device=device)
    if scores is not None and scores.shape[1]:
        kk = min(k, int(scores.shape[1]))
        ids = ids[:, :kk].to(device=device, dtype=torch.int64)
        out_s[:, :kk] = scores[:, :kk].to(device=device, dtype=torch.float32)
        out_i[:, :kk] = torch.where(ids >= 0, ids + offset, ids)
    return out_s, out_i


class ShardedFlatIndex:
    """The corpus split over the mesh's ranks by contiguous rows; exact global
    top-k (module docstring). Runs on ``device``, CUDA by default."""

    def __init__(self, mesh: Mesh, dim: int, dtype: str = "float32",
                 block_size: int = DEFAULT_BLOCK, device=None):
        self.mesh = mesh
        self.local = FlatIPIndex(dim, dtype=dtype, block_size=block_size, device=device)
        self.dim = dim
        self.dtype = dtype
        self.device = self.local.device
        self.docid: List = []
        # rows over every rank; each rank adds only its host_corpus_bounds window
        self.global_rows: Optional[int] = None

    def __len__(self):
        """The corpus rows over every rank (this rank's until ``global_rows``
        is set)."""
        return len(self.local) if self.global_rows is None else int(self.global_rows)

    def add(self, p_reps: np.ndarray) -> None:
        """Stage this rank's rows on the host."""
        self.local.add(p_reps)

    def add_device(self, p_reps: torch.Tensor) -> None:
        """Append this rank's device rows, quantized on the card for int8 /
        int4 (K7 / K9)."""
        self.local.add_device(p_reps)

    def _layout(self) -> Tuple[int, int, int]:
        return rank_window(self.mesh, self.global_rows, len(self.local), "ShardedFlatIndex")

    def search(self, q_reps, k: int = 1000,
               mode: str = "exact") -> Tuple[np.ndarray, np.ndarray]:
        """Global top-k (scores [Q,k], ids [Q,k]) in ``mode``
        (``index/modes.py``), the same on every rank."""
        n, start, _ = self._layout()
        mode = resolve_mode(mode, self.dtype)
        k = min(k, n)
        q = torch.as_tensor(np.asarray(q_reps, np.float32) if isinstance(q_reps, np.ndarray)
                            else q_reps).to(device=self.device, dtype=torch.float32)
        s = i = None
        if len(self.local):
            s, i = self.local.search_tensors(q, min(k, len(self.local)), mode)
        s, i = pad_candidates(s, i, int(q.shape[0]), k, start, self.device)
        return merge_candidates(s, i, self.mesh, k)

    def batch_search(self, q_reps, k: int, batch_size: int, quiet: bool = False,
                     mode: str = "exact") -> Tuple[np.ndarray, np.ndarray]:
        out_s, out_i = [], []
        for start in range(0, q_reps.shape[0], batch_size):
            s, i = self.search(q_reps[start:start + batch_size], k, mode=mode)
            out_s.append(s)
            out_i.append(i)
        return np.concatenate(out_s), np.concatenate(out_i)

    # -- persistence: the JAX package's formats ------------------------------------------------

    def save(self, path: str) -> None:
        """One rank: ``FlatIPIndex``'s ``path.npz`` + meta. Several: this rank's
        rows as ``path.part{rank}.npz`` (int8 / int4 values + scales as stored,
        else fp32 ``reps``) and rank 0's meta with every part's rows, then a
        barrier, so a load that follows reads whole files."""
        n, _, _ = self._layout()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        meta = {"dim": self.dim, "dtype": self.dtype, "n": n, "docid": self.docid}
        if self.mesh.size == 1:
            np.savez(path + ".npz", **self.local.payload())
        else:
            np.savez(f"{path}.part{self.mesh.rank}.npz", **self.local.payload())
            meta["parts"] = [b - a for a, b in (host_corpus_bounds(n, self.mesh.size, r)
                                                for r in range(self.mesh.size))]
        if self.mesh.rank == 0:
            with open(path + ".meta.json", "w") as fh:
                json.dump(meta, fh)
        self.mesh.barrier()

    @staticmethod
    def _read_rows(path: str, meta: dict, lo: int, hi: int):
        """Rows [lo, hi) of a saved flat index: (values, scales or None), from
        the one-file format or from the part files that overlap."""
        if "parts" not in meta:
            with np.load(path + ".npz") as z:
                if "values" in z:
                    return z["values"][lo:hi], z["scales"][lo:hi]
                return z["reps"][lo:hi], None
        offs = np.concatenate([[0], np.cumsum(meta["parts"])]).astype(np.int64)
        vs, ss = [], []
        for p in range(len(meta["parts"])):
            a, b = max(lo, int(offs[p])), min(hi, int(offs[p + 1]))
            if a >= b:
                continue
            with np.load(f"{path}.part{p}.npz") as z:
                key = "values" if "values" in z else "reps"
                vs.append(z[key][a - offs[p]:b - offs[p]])
                if "scales" in z:
                    ss.append(z["scales"][a - offs[p]:b - offs[p]])
        if not vs:
            return np.zeros((0, 0), np.float32), None
        return np.concatenate(vs), (np.concatenate(ss) if ss else None)

    @classmethod
    def load(cls, path: str, mesh: Mesh, device=None) -> "ShardedFlatIndex":
        """Each rank reads its window of a flat index saved by either package,
        in one file or in parts, onto ``device``."""
        with open(path + ".meta.json") as fh:
            meta = json.load(fh)
        idx = cls(mesh, meta["dim"], dtype=meta["dtype"], device=device)
        n = int(meta["n"])
        lo, hi = host_corpus_bounds(n, mesh.size, mesh.rank)
        values, scales = cls._read_rows(path, meta, lo, hi)
        if hi > lo:
            idx.local.add_native(np.asarray(values, np.float32) if scales is None else values,
                                 scales)
        idx.global_rows = n
        idx.docid = meta.get("docid", [])
        return idx
