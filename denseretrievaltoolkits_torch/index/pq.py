"""Product-quantized flat index: the ``PQ{M}`` / ``PQ{M}x4`` strings of the factory.

Counterpart of ``denseretrievaltoolkits_tpu/index/pq.py``. A row of H dims
takes M bytes (8-bit codes) or M / 2 bytes (4-bit): at H = 768, PQ96 and
PQ192x4 store 96 B per row where SQ4 needs 388. Scores are inner products
against the reconstructions (ADC), so recall is the codebooks' fit, not a
rounding bound.

- ``train`` fits the M subspace codebooks (``ops/pq.py:pq_train``) on
  sample rows; ``add`` / ``add_device`` / ``add_chunks`` encode rows on the
  device into code-major slabs ``[M, n]`` (4-bit: ``[M/2, n]``), so the float
  rows can be freed.
- ``search`` in the modes of ``index/modes.py:resolve_pq_mode``: ``exact``,
  exact ADC in true fp32 (``pq_blockwise_topk``); ``serve`` (alias
  ``approx``), the decode-and-scan kernels through
  ``ops/pq.py:pq_serve_topk``: K16 (the int8 codebook) for 8-bit codes, the
  reference's default (index/pq.py:111-118, 178-183), K15 for 4-bit. As in
  the reference the serve search takes the exact scan where the decode
  layout does not hold (d_sub | 128 and 128 | H, index/pq.py:64-67) or the
  corpus is tiny (ops/pq.py:576); both are counted in
  ``ops.pq.pq_serve_topk.exact_scans``.
- ``save`` / ``load``: the reference's ``path.npz`` (codes, codebooks) +
  ``path.meta.json`` (kind ``pq``), so indexes interchange with the JAX
  package.

Runs on ``device``, the CUDA card unless the caller names another; on the
CPU the serve kernels run their plain versions.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.pq import (bdcb_table, build_bdcb, build_bdcb_i8, pq_blockwise_topk, pq_decode,
                      pq_encode_device, pq_serve_topk, pq_train)
from .modes import resolve_pq_mode


class PQIndex:
    """Device-resident PQ index: train / add / search / save / load, the
    ``FlatIPIndex`` API with the trained-index protocol (``is_trained``,
    ``train``, ``add_chunks``) of the IVF indexes."""

    def __init__(self, dim: int, M: int = 96, block_size: Optional[int] = None, nbits: int = 8,
                 device=None):
        if M <= 0 or dim % M:
            raise ValueError(f"dim {dim} not divisible by M={M}")
        if nbits not in (4, 8):
            raise ValueError(f"PQ nbits must be 4 or 8, got {nbits}")
        if nbits == 4 and M % 2:
            raise ValueError("4-bit PQ packs code pairs: M must be even")
        d_sub = dim // M
        # the decode kernels' layout; other geometries serve by the exact scan
        self._pallas_geometry = (128 % d_sub == 0) and (dim % 128 == 0)
        self.dim = dim
        self.M = M
        self.nbits = nbits
        # the reference's blocks: 2048 rows for 4-bit codes, 1024 for 8-bit
        self.block_size = block_size or (2048 if nbits == 4 else 1024)
        self.device = resolve_device(device, "PQIndex")
        self.codebooks: Optional[np.ndarray] = None  # [M, k, d_sub] fp32
        self._cb_dev: Optional[torch.Tensor] = None
        self._table = None        # the serve kernel's table [M, k, d_sub] (K16: int8)
        self._table_scale = None  # K16: [dim] per-dim scale
        self._code_slabs: List[torch.Tensor] = []  # [M_storage, n] int8 device slabs
        self._codes: Optional[torch.Tensor] = None  # materialized [M_storage, N]
        self._n = 0
        self.docid: List = []

    def __len__(self):
        return self._n

    @property
    def is_trained(self) -> bool:
        return self.codebooks is not None

    def train(self, reps, iters: int = 12, seed: int = 0) -> None:
        """Fit the M subspace codebooks on sample rows (host or device) on
        the index's device (the faiss ``index.train`` role)."""
        if reps.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}] rows, got {tuple(reps.shape)}")
        self.codebooks = pq_train(reps, self.M, iters=iters, seed=seed,
                                  block_rows=min(2048, int(reps.shape[0])), k=1 << self.nbits,
                                  device=self.device)
        self._set_codebooks()

    def _set_codebooks(self) -> None:
        """The device codebooks and the serve kernel's table: from the int8
        block-diagonal operand for 8-bit codes (K16), the bf16 one for 4-bit
        (K15)."""
        self._cb_dev = torch.from_numpy(np.asarray(self.codebooks, np.float32)).to(self.device)
        self._table = self._table_scale = None
        if self._pallas_geometry:
            k = 1 << self.nbits
            if self.nbits == 8:
                bd8, sc = build_bdcb_i8(self.codebooks)
                table, scale = bdcb_table(bd8, sc, k=k)
            else:
                table, scale = bdcb_table(build_bdcb(self.codebooks), k=k)
            self._table = table.to(self.device)
            self._table_scale = None if scale is None else scale.to(self.device)

    def _check_trained(self, what: str) -> None:
        if not self.is_trained:
            raise RuntimeError(f"PQIndex.{what} before train()")

    def _add_codes(self, reps: torch.Tensor) -> None:
        if reps.ndim != 2 or reps.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}] rows, got {tuple(reps.shape)}")
        self._code_slabs.append(pq_encode_device(reps.to(self.device), self._cb_dev))
        self._n += int(reps.shape[0])
        self._codes = None

    def add(self, reps) -> None:
        """Encode host rows on the device."""
        self._check_trained("add")
        self._add_codes(torch.from_numpy(np.ascontiguousarray(reps, np.float32)))

    def add_device(self, reps) -> None:
        """Encode device rows straight to a code slab (the float rows can be
        freed: the slab is 4 x dim / M times smaller)."""
        self._check_trained("add_device")
        self._add_codes(torch.as_tensor(reps))

    def add_chunks(self, chunk_fn, n_rows: int, chunk_rows: int = 500_000) -> None:
        """Streamed build: ``chunk_fn(start, rows)`` gives rows [start, start +
        rows) (host or device); device memory holds one float chunk and the
        growing code store."""
        self._check_trained("add_chunks")
        for start in range(0, int(n_rows), chunk_rows):
            rows = min(chunk_rows, int(n_rows) - start)
            self._add_codes(torch.as_tensor(chunk_fn(start, rows)))

    def _materialize(self) -> Optional[torch.Tensor]:
        if self._codes is None and self._code_slabs:
            self._codes = (self._code_slabs[0] if len(self._code_slabs) == 1
                           else torch.cat(self._code_slabs, dim=1))
            self._code_slabs = [self._codes]
        return self._codes

    def search(self, q_reps, k: int = 1000, mode: str = "exact") -> Tuple[np.ndarray, np.ndarray]:
        """Top-k by ADC inner product: ``exact`` the fp32 scan over the
        reconstructions, ``serve`` (``approx``) the K16 (8-bit) or K15 (4-bit)
        search; ``partial`` / ``i8q`` raise (``index/modes.py``)."""
        mode = resolve_pq_mode(mode)
        if not (self.is_trained and self._n):
            raise RuntimeError("PQIndex.search on an empty or untrained index")
        codes = self._materialize()
        k = min(k, self._n)
        q = torch.as_tensor(np.asarray(q_reps, np.float32) if isinstance(q_reps, np.ndarray)
                            else q_reps).to(device=self.device, dtype=torch.float32)
        if mode == "serve":
            if self._table is not None:
                s, i = pq_serve_topk(q, codes, self._cb_dev, self._table, k,
                                     block_size=self.block_size, valid=self._n, nbits=self.nbits,
                                     scale=self._table_scale)
                return s.cpu().numpy(), i.cpu().numpy()
            pq_serve_topk.exact_scans += 1  # the geometry rule
        s, i = pq_blockwise_topk(q, codes, self._cb_dev, k,
                                 block_size=min(1024, max(256, self._n)), valid=self._n)
        return s.cpu().numpy(), i.cpu().numpy()

    def batch_search(self, q_reps, k: int, batch_size: int, quiet: bool = True,
                     mode: str = "exact") -> Tuple[np.ndarray, np.ndarray]:
        all_s, all_i = [], []
        for start in range(0, q_reps.shape[0], batch_size):
            s, i = self.search(q_reps[start:start + batch_size], k, mode=mode)
            all_s.append(s)
            all_i.append(i)
        return np.concatenate(all_s), np.concatenate(all_i)

    def reconstruct(self, rows) -> np.ndarray:
        """Decoded fp32 rows (FAISS ``reconstruct_n``)."""
        codes = self._materialize()
        at = torch.as_tensor(np.asarray(rows, np.int64)).to(self.device)
        return pq_decode(codes[:, at], self._cb_dev).cpu().numpy()

    # -- persistence ---------------------------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        codes = self._materialize()
        m_storage = self.M // 2 if self.nbits == 4 else self.M
        np.savez(path + ".npz",
                 codes=np.zeros((m_storage, 0), np.int8) if codes is None else codes.cpu().numpy(),
                 codebooks=self.codebooks)
        with open(path + ".meta.json", "w") as fh:
            json.dump({"kind": "pq", "dim": self.dim, "M": self.M, "nbits": self.nbits,
                       "n": self._n, "docid": self.docid}, fh)

    @classmethod
    def load(cls, path: str, device=None) -> "PQIndex":
        """Load ``path.npz`` + ``path.meta.json`` (kind ``pq``) onto ``device``."""
        with open(path + ".meta.json") as fh:
            meta = json.load(fh)
        idx = cls(meta["dim"], M=meta["M"], nbits=meta.get("nbits", 8), device=device)
        with np.load(path + ".npz") as z:
            idx.codebooks = np.asarray(z["codebooks"], np.float32)
            codes = z["codes"]
        idx._set_codebooks()
        if codes.shape[1]:
            idx._code_slabs = [torch.from_numpy(np.ascontiguousarray(codes)).to(idx.device)]
        idx._n = int(meta["n"])
        idx.docid = meta.get("docid", [])
        return idx
