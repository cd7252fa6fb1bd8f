"""IVF-PQ: the ragged IVF index over PQ codes of residuals (``IVF{n},PQ{M}[x4]``).

Counterpart of ``denseretrievaltoolkits_tpu/index/ivf_pq.py`` (FAISS
``IVF{n},PQ{M}`` with ``by_residual``): k-means cells prune a search to
``nprobe / nlist`` of the corpus while each row takes M bytes (M / 2 for
4-bit codes) plus its int32 row id. Rows store the PQ codes of ``x -
centroid(cell)``; a search adds the probe's ``q . centroid`` back per (cell,
slot), so scores are ADC against ``centroid + decode(code)``.

The layout is :class:`..index.ivf.IVFRaggedIndex`'s (rows sorted by cell,
each cell padded to a ``block`` multiple), but ``_values`` holds the
CODE-MAJOR store ``[M_storage, nb_total * block]`` int8 (column n: padded
position n's codes; M_storage = M, or M / 2 nibble-packed). Every method that
reads ``_values`` is overridden here; the bulk search (Qcap and hot-cell
tuning, ``search_bulk_async``) is the parent's, through :meth:`_bulk_call`.

- ``train``: the parent's k-means, then the M codebooks on the training
  residuals.
- ``add_chunks`` / ``add_device`` / ``add``: two passes (assign, then encode
  each chunk's residuals on the device and scatter the code columns).
- ``search`` in ``index/modes.py:resolve_ivfpq_mode``'s modes: ``bulk`` (
  alias ``serve`` / ``approx``) the cell search of ``ops/ivf_pq.py`` on K17,
  whose hot cells go to a dense side slab (their rows decoded once to
  reconstructions, quantized by K7, scored by K8); ``exact`` the fp32 scan of
  every reconstruction, which concatenates them all on the device (27 GB at
  8.8M x 768): an evaluation-size check.
- ``save`` / ``load``: the reference's ``path.npz`` + ``path.meta.json``
  (kind ``ivfpq``).

The decode kernel needs d_sub | 128 and 128 | dim; other geometries raise
``ValueError``, as in the reference.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.ivf_bulk import serve_j
from ..ops.ivf_pq import ivf_pq_search
from ..ops.pq import bdcb_table, build_bdcb, pq_decode, pq_encode_device, pq_train
from ..ops.quant import quantize_int8_device
from .ivf import IVFRaggedIndex, _assign_device, _chunk
from .modes import resolve_ivfpq_mode


class IVFPQIndex(IVFRaggedIndex):
    """Ragged IVF with PQ-coded residual cells: train / add_chunks / search /
    save / load, on ``device`` (CUDA by default)."""

    # the reference's Qcap x block budget for this kernel (half the dense
    # ragged one), kept so the learned Qcap is the reference's
    QCAP_ELEMS = 131072

    def __init__(self, dim: int, nlist: int = 1024, nprobe: int = 32, M: int = 96,
                 nbits: int = 8, block: int = 512, train_block: int = 8192,
                 qcap_factor: float = 2.0, device=None):
        if M <= 0 or dim % M:
            raise ValueError(f"dim {dim} not divisible by M={M}")
        if nbits not in (4, 8):
            raise ValueError(f"IVFPQ nbits must be 4 or 8, got {nbits}")
        if nbits == 4 and M % 2:
            raise ValueError("4-bit PQ packs code pairs: M must be even")
        d_sub = dim // M
        if 128 % d_sub or dim % 128:
            raise ValueError(
                f"IVFPQ needs d_sub={d_sub} dividing 128 and dim % 128 == 0 "
                f"(the ops/pq.py block-diagonal decode layout)")
        super().__init__(dim, nlist=nlist, nprobe=nprobe, dtype="int8", block=block,
                         train_block=train_block, qcap_factor=qcap_factor, device=device)
        self.dtype = "pq"  # the cells hold PQ codes
        self.M = M
        self.nbits = nbits
        self.codebooks: Optional[np.ndarray] = None  # [M, k, d_sub] fp32
        self._cb_dev: Optional[torch.Tensor] = None
        self._table: Optional[torch.Tensor] = None   # K17's bf16 table [M, k, d_sub]

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None and self.codebooks is not None

    # -- training --------------------------------------------------------------------------------

    def train(self, reps, iters: int = 10, seed: int = 0, pq_iters: int = 8) -> None:
        """k-means (the parent's), then the M subspace codebooks on the
        training residuals ``x - centroid(assign(x))`` (ivf_pq.py:110-126)."""
        super().train(reps, iters=iters, seed=seed)
        x = torch.as_tensor(np.asarray(reps, np.float32) if isinstance(reps, np.ndarray)
                            else reps).to(device=self.device, dtype=torch.float32)
        n = int(x.shape[0])
        assign = _assign_device(x, self.centroids, min(8192, max(8, n)))
        res = x - self.centroids[assign.long()]
        self.codebooks = pq_train(res, self.M, iters=pq_iters, seed=seed,
                                  block_rows=min(2048, n), k=1 << self.nbits)
        self._set_codebooks()

    def _set_codebooks(self) -> None:
        self._cb_dev = torch.from_numpy(np.asarray(self.codebooks, np.float32)).to(self.device)
        self._table = bdcb_table(build_bdcb(self.codebooks), k=1 << self.nbits)[0].to(self.device)

    # -- population ------------------------------------------------------------------------------

    def add_chunks(self, chunk_fn, n_rows: int, chunk_rows: int = 500_000, assign=None) -> None:
        """Two-pass ragged build (ivf_pq.py:136-180): pass 2 encodes each
        chunk's residuals and scatters its code columns into the store, so
        device memory holds one float chunk and the code store."""
        self._check_build()
        N = int(n_rows)
        if assign is not None:
            assign_all = np.ascontiguousarray(np.asarray(assign, np.int32))
            if assign_all.shape != (N,):
                raise ValueError(f"assign must be [{N}], got {assign_all.shape}")
        else:
            assign_all = self._assign_pass(chunk_fn, N, chunk_rows)
        self.last_assign = assign_all
        dest, row_ids_flat = self._ragged_layout(assign_all, N)
        m_storage = self.M // 2 if self.nbits == 4 else self.M
        codes = torch.zeros((m_storage, row_ids_flat.shape[0]), dtype=torch.int8,
                            device=self.device)
        for start in range(0, N, chunk_rows):
            rows = min(chunk_rows, N - start)
            chunk = _chunk(chunk_fn, start, rows, self.device).float()
            a = torch.from_numpy(assign_all[start:start + rows]).to(self.device).long()
            res = chunk - self.centroids[a]
            del chunk
            at = torch.from_numpy(dest[start:start + rows]).to(self.device)
            codes.index_copy_(1, at, pq_encode_device(res, self._cb_dev))
            del res
        self._values, self._scales = codes, None
        self._row_ids = torch.from_numpy(row_ids_flat).to(self.device)
        self._n = N
        self._bulk_state = None

    # -- search ----------------------------------------------------------------------------------

    def _reconstruct(self, r0: int, r1: int) -> torch.Tensor:
        """fp32 reconstructions ``centroid + decode(code)`` of padded
        positions r0..r1-1."""
        cells = torch.repeat_interleave(self._block_cell[r0 // self.block:-(-r1 // self.block)]
                                        .long(), self.block)[r0 % self.block:][:r1 - r0]
        return pq_decode(self._values[:, r0:r1], self._cb_dev) + self.centroids[cells]

    def _side_slab(self, hot_ids: np.ndarray):
        """The hot cells' rows decoded once to int8-quantized reconstructions
        (K7), so the side scan's absolute scores keep the cell path's ADC
        contract; real rows first (ivf_pq.py:184-218)."""
        bs = self._block_start.cpu().numpy()
        parts_v, parts_s, parts_i = [], [], []
        for c in hot_ids:
            r0, r1 = int(bs[c]) * self.block, int(bs[c + 1]) * self.block
            if r1 > r0:
                qv, qs = quantize_int8_device(self._reconstruct(r0, r1))
                parts_v.append(qv)
                parts_s.append(qs)
                parts_i.append(self._row_ids[r0:r1])
        return self._pack_side(parts_v, parts_s, parts_i)

    def _bulk_call(self, q, k: int, nprobe: int, i8_native: bool, state: dict, Qcap: int,
                   n_real: int):
        """One IVF-PQ search (``ops/ivf_pq.py:ivf_pq_search``) with an explicit
        tuning state; the parent's device-result contract. J comes from the
        mean cell rows (``bulk_j`` overrides it) and the selection plan of
        :meth:`_cell_plan`; the mode table keeps i8q away."""
        block, sel, J = self._cell_plan(Qcap, k)
        sv, ss, si, side_valid = state["side"]
        np_eff = min(nprobe, self.nlist - int(state["hot"].size))
        sb = self.SIDE_BLOCK
        side_J = serve_j(k, sb, max(sb, side_valid)) if side_valid else 4
        return ivf_pq_search(
            q, self.centroids, self._values, self._row_ids, self._block_cell, self._block_start,
            self._table, sv, ss, si, k=k, nprobe=np_eff, Qcap=Qcap, J=J, block=block, sel=sel,
            nlist=self.nlist, nb_max=self._nb_max, hot_penalty=state["hp"],
            side_valid=side_valid, side_J=side_J, side_block=sb, nbits=self.nbits, n_real=n_real)

    def search(self, q_reps, k: int = 100, mode: str = "bulk",
               nprobe: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """``bulk`` / ``serve`` / ``approx``: the cell search on K17;
        ``exact``: the exact-ADC scan over every reconstruction."""
        if self._values is None:
            raise RuntimeError("IVFPQIndex.search before add()")
        mode = resolve_ivfpq_mode(mode)
        k = min(k, self._n)
        if mode == "exact":
            return self._search_exact(self._queries(q_reps), k)
        return self.search_bulk(q_reps, k, nprobe=nprobe, i8_native=False)

    def _stored_rows(self):
        """(fp32 reconstructions, corpus ids) of every stored row, in
        position order, decoded 65,536 positions at a time (ivf_pq.py:266-286)."""
        mask = self._row_ids >= 0
        total = int(self._row_ids.shape[0])
        parts = [self._reconstruct(s, min(total, s + 65536))[mask[s:s + 65536]]
                 for s in range(0, total, 65536)]
        return torch.cat(parts), self._row_ids[mask]

    # -- persistence -----------------------------------------------------------------------------

    def _meta(self) -> dict:
        return {"kind": "ivfpq", "dim": self.dim, "nlist": self.nlist, "nprobe": self.nprobe,
                "M": self.M, "nbits": self.nbits, "block": self.block, "nb_max": self._nb_max,
                "n": self._n, "docid": self.docid}

    def _payload(self) -> dict:
        return {"centroids": self.centroids.float().cpu().numpy(),
                "codes": self._values.cpu().numpy(), "row_ids": self._row_ids.cpu().numpy(),
                "block_cell": self._block_cell.cpu().numpy(),
                "block_start": self._block_start.cpu().numpy(), "codebooks": self.codebooks}

    @classmethod
    def load(cls, path: str, device=None) -> "IVFPQIndex":
        """Load ``path.npz`` + ``path.meta.json`` (kind ``ivfpq``) onto ``device``."""
        with open(path + ".meta.json") as fh:
            meta = json.load(fh)
        idx = cls(meta["dim"], nlist=meta["nlist"], nprobe=meta["nprobe"], M=meta["M"],
                  nbits=meta.get("nbits", 8), block=meta["block"], device=device)
        with np.load(path + ".npz") as z:
            arrays = {name: torch.from_numpy(np.ascontiguousarray(z[name])).to(idx.device)
                      for name in ("centroids", "codes", "row_ids", "block_cell", "block_start")}
            idx.codebooks = np.asarray(z["codebooks"], np.float32)
        idx.centroids, idx._values = arrays["centroids"], arrays["codes"]
        idx._row_ids, idx._block_cell = arrays["row_ids"], arrays["block_cell"]
        idx._block_start = arrays["block_start"]
        idx._set_codebooks()
        idx._nb_max = meta["nb_max"]
        idx._n = meta["n"]
        idx.docid = meta.get("docid", [])
        return idx
