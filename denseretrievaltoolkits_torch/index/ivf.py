"""Trained inverted-file indexes: k-means, two cell layouts, bulk and probe search.

Counterpart of ``denseretrievaltoolkits_tpu/index/ivf.py``, the role of the
reference's trained FAISS factory indexes (``faiss.index_factory`` +
``train()``, DRT ``evaluator/index.py:47-54``): a search visits the
``nprobe`` best of ``nlist`` k-means cells instead of every row.

- **training** (:meth:`IVFFlatIndex.train`): Lloyd's k-means on the device
  (:func:`_kmeans_device`: assignment as the argmax of ``x.c - |c|^2 / 2``
  per corpus block, the centroid sums by ``index_add_``), from rows drawn by
  numpy from ``seed``, then :func:`_split_heavy_cells` moves the emptiest
  centroids next to the heaviest (perturbations drawn by numpy too). On CUDA
  ``index_add_`` sums with atomics in an order that changes from run to run,
  so centroids may differ by ulps between runs.
- :class:`IVFFlatIndex`: the fixed-capacity layout, values [nlist, C, dim]
  and row ids [nlist, C] (-1 = empty slot), C from :meth:`_capacity`; rows
  past a cell's capacity go to an overflow slab that every bulk search scans
  exactly. :class:`IVFRaggedIndex`: the ragged layout, rows sorted by cell
  and each cell padded to a ``block`` multiple, [nb_total * block, dim] with
  ``block_cell`` and ``block_start``; no overflow.
- **build**: ``add`` / ``add_device`` in one pass, or ``add_chunks`` in two
  passes over a chunk function (assign, then quantize and place), whose peak
  device memory is the cell buffer plus one chunk. int8 cells quantize on
  the card by K7. The cell buffer is filled in place.
- **search** in the modes of ``index/modes.py:resolve_ivf_mode``: ``bulk``
  (alias ``serve``), the cell-major search of ``ops/ivf_bulk.py`` on K13
  (fixed) or K14 (ragged), which tunes its hot-cell set and per-cell query
  capacity ``Qcap`` on the first batch and keeps them; ``i8q`` the same with
  int8 queries (int8 cells); ``probe``, per query tile the probed cells'
  rows gathered and scored in plain PyTorch (the reference's XLA einsum;
  the ragged layout serves it through bulk); ``exact``, the flat scan of
  every stored row. Where no row is left for a result slot its id is -1.
- ``save`` / ``load``: the reference's ``path.npz`` + ``path.meta.json``
  (kinds ``ivf`` and ``ivfr``), so indexes interchange with the JAX package.
  bf16 cells are stored as the reference's ``np.savez`` of an ml_dtypes
  array stores them, raw 2-byte records.

Every class runs on ``device``, the CUDA card unless the caller names
another; on the CPU the cell kernels run their plain versions.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.ivf_bulk import (_descending, _top, ivf_bulk_search, ivf_ragged_search,
                            selection_plan, serve_j)
from ..ops.quant import quantize_int8_device
from .flat import blockwise_topk
from .modes import resolve_ivf_mode

CELL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _kmeans_device(corpus: torch.Tensor, init: torch.Tensor, nlist: int, iters: int,
                   block: int) -> torch.Tensor:
    """Lloyd's k-means over corpus blocks (ivf.py:43-83); centroids [nlist, dim]
    fp32. An empty cell keeps its centroid."""
    N, H = corpus.shape
    centroids = init.float().clone()
    for _ in range(iters):
        half_norm = 0.5 * (centroids * centroids).sum(1)
        sums = torch.zeros((nlist, H), dtype=torch.float32, device=corpus.device)
        counts = torch.zeros(nlist, dtype=torch.float32, device=corpus.device)
        for start in range(0, N, block):
            x = corpus[start:start + block].float()
            assign = torch.argmax(torch.matmul(x, centroids.T) - half_norm, dim=1)
            sums.index_add_(0, assign, x)
            counts.index_add_(0, assign, torch.ones_like(assign, dtype=torch.float32))
        centroids = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None],
                                centroids)
    return centroids


def _assign_device(corpus: torch.Tensor, centroids: torch.Tensor, block: int) -> torch.Tensor:
    """Nearest-centroid (L2) cell of each row, [N] int32 (ivf.py:158-174)."""
    half_norm = 0.5 * (centroids * centroids).sum(1)
    out = [torch.argmax(torch.matmul(corpus[s:s + block].float(), centroids.T) - half_norm, dim=1)
           for s in range(0, corpus.shape[0], block)]
    return torch.cat(out).to(torch.int32) if out else torch.zeros(0, dtype=torch.int32,
                                                                  device=corpus.device)


def _split_heavy_cells(corpus, centroids, nlist: int, block: int, rounds: int = 2,
                       iters: int = 4, seed: int = 0) -> torch.Tensor:
    """Rebalance Lloyd's output (ivf.py:86-109): each round moves the
    emptiest centroids next to the heaviest (perturbed copies, drawn by numpy
    from ``seed``) and re-runs a few Lloyd's iterations."""
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        counts = np.bincount(_assign_device(corpus, centroids, block).cpu().numpy(),
                             minlength=nlist)
        mean = counts.mean()
        heavy = np.argsort(-counts)
        light = np.argsort(counts)
        n_move = int(min((counts[light] < mean / 4).sum(), (counts[heavy] > 2 * mean).sum()))
        if n_move == 0:
            break
        c_host = centroids.cpu().numpy().copy()
        eps = rng.standard_normal((n_move, c_host.shape[1])).astype(np.float32)
        c_host[light[:n_move]] = c_host[heavy[:n_move]] + 1e-3 * eps
        centroids = _kmeans_device(corpus, torch.from_numpy(c_host).to(corpus.device), nlist,
                                   iters, block)
    return centroids


def _bucket_device(reps, assign, starts, C: int, nlist: int, n_ovf: int, scales=None):
    """Rows into the fixed-capacity layout (ivf.py:112-155): reps [N, dim]
    (int8 rows stay int8), assign [N], starts [nlist] (each cell's first
    position in the stably sorted order). Rows ranked past a cell's C go to
    the overflow slab. Returns (values [nlist * C, dim], row_ids [nlist * C]
    int32, cell_scales or None, ovf_rows, ovf_ids int32, ovf_scales or None)."""
    N = reps.shape[0]
    dev = reps.device
    order = torch.argsort(assign, stable=True)
    sa = assign[order].long()
    pos = torch.arange(N, device=dev) - starts[sa]
    in_cell = pos < C
    # rows past their cell's capacity land on one spare row past the buffer
    dest = torch.where(in_cell, sa * C + pos, nlist * C)
    values = torch.zeros((nlist * C + 1, reps.shape[1]), dtype=reps.dtype, device=dev)
    values[dest] = reps[order]
    row_ids = torch.full((nlist * C + 1,), -1, dtype=torch.int32, device=dev)
    row_ids[dest] = order.to(torch.int32)
    cell_scales = None
    if scales is not None:
        cell_scales = torch.ones(nlist * C + 1, dtype=torch.float32, device=dev)
        cell_scales[dest] = scales[order]
        cell_scales = cell_scales[:-1]
    # stable partition: in-capacity rows first, the overflow last
    p2 = torch.argsort((~in_cell).to(torch.uint8), stable=True)
    ovf_ids = order[p2][N - n_ovf:].to(torch.int32)
    ovf_scales = None if scales is None else scales[ovf_ids.long()]
    return (values[:-1], row_ids[:-1], cell_scales, reps[ovf_ids.long()], ovf_ids, ovf_scales)


def _chunk(chunk_fn, start: int, rows: int, device) -> torch.Tensor:
    """Rows [start, start + rows) of a chunk function, as a tensor on device."""
    return torch.as_tensor(chunk_fn(start, rows)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A saved array: bf16 as raw 2-byte records, the bytes the reference's
    ``np.savez`` writes for an ml_dtypes bfloat16 array."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.dtype("V2"))
    return t.cpu().numpy()


def _from_numpy(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A loaded array on device; 2-byte records of a bfloat16 index are bf16."""
    if dtype == "bfloat16" and a.dtype.itemsize == 2 and a.dtype.kind not in "iuf":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class IVFFlatIndex:
    """Trained inverted-file index, inner-product metric, fp32 / bf16 / int8
    cells in the fixed-capacity layout: ``train`` -> ``add`` -> ``search``.
    Runs on ``device``, CUDA by default."""

    def __init__(self, dim: int, nlist: int = 1024, nprobe: int = 32, dtype: str = "float32",
                 capacity_factor: float = 2.0, query_tile: int = 16, train_block: int = 8192,
                 ovf_frac: float = 0.02, max_capacity_factor: float = 8.0,
                 qcap_factor: float = 2.0, device=None):
        if dtype not in CELL_DTYPES:
            raise ValueError(f"IVF cells store float32, bfloat16 or int8, not {dtype!r}")
        self.dim = dim
        self.nlist = nlist
        self.nprobe = min(nprobe, nlist)
        self.dtype = dtype
        self.capacity_factor = capacity_factor
        self.query_tile = query_tile
        self.train_block = train_block
        # bulk search: per-cell query capacity = qcap_factor x the mean probe
        # load; probes past a hot cell's capacity drop and count in last_dropped
        self.qcap_factor = qcap_factor
        self.last_dropped = 0
        # hot cells the bulk tuner may move to the side scan (None = nlist / 16)
        self.max_hot: Optional[int] = None
        # cells grow past capacity_factor x mean until the overflow slab holds at
        # most ovf_frac of the rows, up to max_capacity_factor x mean
        self.ovf_frac = ovf_frac
        self.max_capacity_factor = max_capacity_factor
        self.device = resolve_device(device, type(self).__name__)
        self.centroids: Optional[torch.Tensor] = None  # [nlist, dim] fp32
        self._values = None      # [nlist, C, dim] cell rows
        self._scales = None      # [nlist, C] for int8
        self._row_ids = None     # [nlist, C] int32, -1 = empty slot
        self._ovf_values = None  # [M, dim] overflow slab
        self._ovf_scales = None
        self._ovf_ids = None
        self._n = 0
        self.docid: List = []
        self._bulk_state = None

    def __len__(self):
        return self._n

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None

    def _cell_dtype(self) -> torch.dtype:
        return CELL_DTYPES[self.dtype]

    def _queries(self, q_reps) -> torch.Tensor:
        return torch.as_tensor(q_reps).to(device=self.device, dtype=torch.float32)

    # -- training --------------------------------------------------------------------------------

    def train(self, reps, iters: int = 10, seed: int = 0) -> None:
        """k-means on the device (the faiss ``index.train()`` role) over host
        or device rows; the initial rows are drawn by numpy from ``seed``."""
        n = int(reps.shape[0])
        if n < self.nlist:
            raise ValueError(f"need >= nlist={self.nlist} training rows, got {n}")
        rng = np.random.default_rng(seed)
        sel = np.sort(rng.choice(n, self.nlist, replace=False))
        reps_d = torch.as_tensor(np.asarray(reps, np.float32) if isinstance(reps, np.ndarray)
                                 else reps).to(device=self.device, dtype=torch.float32)
        init = reps_d[torch.from_numpy(sel).to(self.device)]
        block = min(self.train_block, n)
        centroids = _kmeans_device(reps_d, init, self.nlist, iters, block)
        self.centroids = _split_heavy_cells(reps_d, centroids, self.nlist, block, seed=seed)
        self._bulk_state = None

    # -- population -----------------------------------------------------------------------------

    def add(self, reps) -> None:
        """Assign and bucket host rows on the device (one pass)."""
        self.add_device(torch.from_numpy(np.asarray(reps, np.float32)))

    def _capacity(self, counts: np.ndarray, N: int) -> int:
        """Per-cell capacity (ivf.py:263-278): capacity_factor x the mean,
        grown until the overflow holds at most ovf_frac of the rows (up to
        max_capacity_factor x the mean); above 512 a multiple of 512."""
        mean = max(1.0, N / self.nlist)

        def round_cap(c: float) -> int:
            g = 512 if c > 512 else 8
            return int(-(-c // g) * g)

        C = round_cap(self.capacity_factor * mean)
        c_max = max(C, round_cap(self.max_capacity_factor * mean))
        while C < c_max and np.maximum(counts - C, 0).sum() > self.ovf_frac * N:
            C = round_cap(C + (512 if C >= 512 else 8))
        return C

    def _check_build(self) -> None:
        if not self.is_trained:
            raise RuntimeError(f"{type(self).__name__}: add before train()")
        if self._values is not None:
            raise RuntimeError(f"{type(self).__name__}: the build is one-shot")

    def add_chunks(self, chunk_fn, n_rows: int, chunk_rows: int = 500_000) -> None:
        """Two-pass build for corpora too large to sit beside the cell buffer
        (ivf.py:280-383): ``chunk_fn(start, rows)`` returns rows [start,
        start + rows) (host or device), deterministically, once per pass.
        Pass 1 assigns, pass 2 quantizes (K7) or casts and writes each chunk
        into the cell buffer in place; host work is O(N) integers."""
        self._check_build()
        N = int(n_rows)
        assign_all = np.empty(N, np.int32)
        for start in range(0, N, chunk_rows):
            rows = min(chunk_rows, N - start)
            chunk = _chunk(chunk_fn, start, rows, self.device)
            assign_all[start:start + rows] = _assign_device(
                chunk, self.centroids, min(8192, max(8, rows))).cpu().numpy()
            del chunk
        counts = np.bincount(assign_all, minlength=self.nlist)
        C = self._capacity(counts, N)
        starts = np.zeros(self.nlist, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        # the host map: each row's cluster-major slot, or -1 for the overflow
        order = np.argsort(assign_all, kind="stable")
        sa = assign_all[order]
        pos = np.arange(N, dtype=np.int64) - starts[sa]
        in_cell = pos < C
        dest_sorted = np.where(in_cell, sa.astype(np.int64) * C + pos, -1)
        dest = np.empty(N, np.int64)
        dest[order] = dest_sorted
        row_ids_flat = np.full(self.nlist * C, -1, np.int32)
        row_ids_flat[dest_sorted[in_cell]] = order[in_cell].astype(np.int32)

        int8 = self.dtype == "int8"
        values = torch.zeros((self.nlist, C, self.dim), dtype=self._cell_dtype(),
                             device=self.device)
        scales = torch.ones((self.nlist, C), dtype=torch.float32, device=self.device) \
            if int8 else None
        parts_v, parts_s, parts_i = [], [], []
        for start in range(0, N, chunk_rows):
            rows = min(chunk_rows, N - start)
            chunk = _chunk(chunk_fn, start, rows, self.device)
            if int8:
                qv, qs = quantize_int8_device(chunk)
            else:
                qv, qs = chunk.to(self._cell_dtype()), None
            del chunk
            d = dest[start:start + rows]
            inside = d >= 0
            local = torch.from_numpy(np.nonzero(inside)[0]).to(self.device)
            at = torch.from_numpy(d[inside]).to(self.device)
            values.view(-1, self.dim).index_copy_(0, at, qv[local])
            if qs is not None:
                scales.view(-1).index_copy_(0, at, qs[local])
            if not inside.all():
                out = np.nonzero(~inside)[0]
                sel = torch.from_numpy(out).to(self.device)
                parts_v.append(qv[sel])
                parts_i.append(start + out)  # chunk order, as the value parts
                if qs is not None:
                    parts_s.append(qs[sel])
            del qv, qs
        self._values, self._scales = values, scales
        self._row_ids = torch.from_numpy(row_ids_flat.reshape(self.nlist, C)).to(self.device)
        if parts_v:
            self._ovf_ids = torch.from_numpy(np.concatenate(parts_i).astype(np.int32)).to(
                self.device)
            self._ovf_values = torch.cat(parts_v)
            self._ovf_scales = torch.cat(parts_s) if parts_s else None
        self._n = N
        self._bulk_state = None

    def add_device(self, reps) -> None:
        """One-pass build from device rows (ivf.py:385-436): only the [N]
        assignment comes to the host, to size the cells and the overflow. int8
        rows quantize (K7) before they are scattered."""
        self._check_build()
        reps = torch.as_tensor(reps).to(self.device)
        N = int(reps.shape[0])
        assign = _assign_device(reps, self.centroids, min(8192, max(8, N)))
        counts = np.bincount(assign.cpu().numpy(), minlength=self.nlist)
        C = self._capacity(counts, N)
        n_ovf = int((counts - np.minimum(counts, C)).sum())
        starts = np.zeros(self.nlist, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        starts = torch.from_numpy(starts).to(self.device)
        if self.dtype == "int8":
            qv, qs = quantize_int8_device(reps)
        else:
            qv, qs = reps.to(self._cell_dtype()), None
        values, row_ids, cell_scales, ovf_rows, ovf_ids, ovf_scales = _bucket_device(
            qv, assign, starts, C, self.nlist, n_ovf, scales=qs)
        self._values = values.reshape(self.nlist, C, self.dim)
        self._scales = None if cell_scales is None else cell_scales.reshape(self.nlist, C)
        self._row_ids = row_ids.reshape(self.nlist, C)
        if n_ovf:
            self._ovf_ids, self._ovf_values, self._ovf_scales = ovf_ids, ovf_rows, ovf_scales
        self._n = N
        self._bulk_state = None

    # -- search --------------------------------------------------------------------------------

    def _probe_tile(self, q: torch.Tensor, k: int, nprobe: int):
        """The ``probe`` mode over one query tile (ivf.py:440-494): the probed
        cells' rows gathered and scored in fp32 (bf16 cells: bf16 queries),
        empty slots masked, then the overflow slab reduced to its own top-k
        and merged."""
        C = self._values.shape[1]
        cells = _descending(torch.matmul(q, self.centroids.T), nprobe)
        rows = self._values[cells]                                   # [T, np, C, dim]
        ids = self._row_ids[cells].reshape(q.shape[0], nprobe * C)
        qc = q.to(torch.bfloat16 if self._values.dtype == torch.bfloat16 else torch.float32)
        s = torch.einsum("td,tpcd->tpc", qc.float(), rows.float())
        if self._scales is not None:
            s = s * self._scales[cells]
        s = torch.where(ids >= 0, s.reshape(q.shape[0], nprobe * C), float("-inf"))
        top_s, top_i = _top(s, ids, min(k, nprobe * C))
        if self._ovf_values is not None:
            so = torch.matmul(qc.float(), self._ovf_values.float().T)
            if self._ovf_scales is not None:
                so = so * self._ovf_scales[None, :]
            so_top, so_ids = _top(so, self._ovf_ids.expand(q.shape[0], -1),
                                  min(k, so.shape[1]))
            top_s, top_i = _top(torch.cat([top_s, so_top], 1), torch.cat([top_i, so_ids], 1), k)
        return top_s, top_i

    def _cell_plan(self, Qcap: int, k: int) -> Tuple[int, int, int]:
        """(block, sel, J) of K13 in the bulk search: the reference's tiles
        (ivf.py:502-523), the largest of 1024 / 512 (fp32) or 2048 / 1024 /
        512 rows dividing C with Qcap x block <= 262144 (a TPU VMEM budget,
        kept so the result is the reference's) and the Poisson J, then the
        :func:`selection_plan` of that J over cells of C rows."""
        C = int(self._values.shape[1])
        caps = (1024, 512) if self.dtype == "float32" else (2048, 1024, 512)
        for b in caps:
            if C >= b and C % b == 0 and max(8, Qcap) * b <= 262144:
                break
        else:
            b = 512 if C >= 512 and C % 512 == 0 else C
        J = serve_j(k, b, C)
        if getattr(self, "bulk_j", None):
            J = min(self.bulk_j, k, b)
        return (b, *selection_plan(k, b, C, J))

    SIDE_BLOCK = 512  # side-scan block and slab padding granule

    def _side_slab(self, hot_ids: np.ndarray):
        """The dense side-scan slab (ivf.py:527-569): overflow rows plus the
        rows of the hot cells, real rows first, padded to a SIDE_BLOCK
        multiple. Returns (values, scales or None, ids, real rows)."""
        parts_v, parts_s, parts_i = [], [], []
        if self._ovf_values is not None:
            parts_v.append(self._ovf_values)
            parts_i.append(self._ovf_ids)
            if self._ovf_scales is not None:
                parts_s.append(self._ovf_scales)
        if hot_ids.size:
            hot = torch.from_numpy(np.asarray(hot_ids, np.int64)).to(self.device)
            parts_v.append(self._values[hot].reshape(-1, self.dim))
            parts_i.append(self._row_ids[hot].reshape(-1))
            if self._scales is not None:
                parts_s.append(self._scales[hot].reshape(-1))
        return self._pack_side(parts_v, parts_s, parts_i)

    def _pack_side(self, parts_v, parts_s, parts_i):
        if not parts_v:
            return None, None, None, 0
        sv, si = torch.cat(parts_v), torch.cat(parts_i)
        ss = torch.cat(parts_s) if parts_s else None
        valid = si >= 0
        order = torch.argsort((~valid).to(torch.uint8), stable=True)
        sv, si = sv[order], si[order]
        ss = None if ss is None else ss[order]
        n_valid = int(valid.sum())
        pad = (-sv.shape[0]) % self.SIDE_BLOCK
        if pad:
            sv = torch.nn.functional.pad(sv, (0, 0, 0, pad))
            si = torch.nn.functional.pad(si, (0, pad))
            ss = None if ss is None else torch.nn.functional.pad(ss, (0, pad))
        return sv, ss, si, n_valid

    def _new_state(self, nprobe: int) -> dict:
        state = {"key": (nprobe,), "qcap": None}
        self._set_hot(state, np.zeros((0,), np.int64))
        return state

    def _set_hot(self, state: dict, hot: np.ndarray) -> None:
        """The hot set, its side slab, and its probe penalty (-inf) on the device."""
        state["hot"] = hot
        state["side"] = self._side_slab(hot)
        hp = None
        if hot.size:
            hp = torch.zeros(self.nlist, dtype=torch.float32, device=self.device)
            hp[torch.from_numpy(hot).to(self.device)] = float("-inf")
        state["hp"] = hp

    def _tune(self, state: dict, counts, lam: float, Qcap: int, qcap_cap: int,
              B: int, nprobe: int) -> Optional[int]:
        """One step of the bulk tuner (ivf.py:642-661): None when the drops
        are negligible or nothing is left to tune, else the next Qcap (the
        hot set may have grown instead)."""
        if self.last_dropped <= max(8, int(0.001 * B * nprobe)):
            return None
        counts_np = counts.cpu().numpy()
        overloaded = np.where(counts_np > max(2.0 * lam, float(Qcap)))[0]
        new_hot = np.setdiff1d(overloaded, state["hot"])
        max_hot = self.max_hot if self.max_hot is not None else max(1, self.nlist // 16)
        if new_hot.size and state["hot"].size < max_hot:
            # the most overloaded cells move to the dense side scan
            new_hot = new_hot[np.argsort(-counts_np[new_hot])]
            room = max_hot - state["hot"].size
            self._set_hot(state, np.concatenate([state["hot"], new_hot[:room]]).astype(np.int64))
            return Qcap
        if Qcap >= qcap_cap:
            return None  # graceful drops (rank-priority slotting) remain
        return min(qcap_cap, Qcap * 2)

    def _pad_queries(self, q_reps) -> Tuple[torch.Tensor, int]:
        """fp32 queries on the device, padded to a multiple of 8 (256 above
        256 rows), and the real count."""
        q = self._queries(q_reps)
        B0 = q.shape[0]
        pad = (-B0) % (256 if B0 > 256 else 8)
        if pad:
            q = torch.cat([q, q.new_zeros((pad, self.dim))])
        return q, B0

    def _qcap_start(self, state: dict, lam: float, qcap_cap: int) -> int:
        if state["qcap"] is not None:
            return state["qcap"]
        return min(qcap_cap, int(-(-max(8.0, self.qcap_factor * lam) // 8) * 8))

    def search_bulk(self, q_reps, k: int = 100, nprobe: Optional[int] = None,
                    i8_native: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Cell-major bulk search (ivf.py:571-664) on K13. The first batch of
        an ``nprobe`` teaches the index its hot cells (moved to the side scan,
        kept out of the probe) and Qcap; both are kept. One host sync per
        tuning step reads the drop count."""
        if self._values is None:
            raise RuntimeError(f"{type(self).__name__}.search before add()")
        k = min(k, self._n)
        nprobe = self.nprobe if nprobe is None else min(nprobe, self.nlist)
        q, B0 = self._pad_queries(q_reps)
        B = q.shape[0]
        lam = B * nprobe / self.nlist
        # Qcap slots are padding work for every cell: at most 4x the mean load,
        # and 512 (the reference's VMEM budget, kept so results are the same)
        qcap_cap = min(int(-(-B * nprobe // 8) * 8), max(64, int(-(-4.0 * lam // 8) * 8)), 512)
        state = self._bulk_state
        if state is None or state["key"] != (nprobe,):
            state = self._new_state(nprobe)
        Qcap = self._qcap_start(state, lam, qcap_cap)
        while True:
            block, sel, J = self._cell_plan(Qcap, k)
            sv, ss, si, side_valid = state["side"]
            # a hot cell is never both probed and side-scanned
            np_eff = min(nprobe, self.nlist - int(state["hot"].size))
            sb = self.SIDE_BLOCK
            side_J = serve_j(k, sb, max(sb, side_valid)) if side_valid else 4
            tv, doc, dropped, counts = ivf_bulk_search(
                q, self.centroids, self._values, self._row_ids, self._scales, sv, ss, si,
                k=k, nprobe=np_eff, Qcap=Qcap, J=J, block=block, sel=sel, nlist=self.nlist,
                hot_penalty=state["hp"], side_valid=side_valid, side_J=side_J, side_block=sb,
                i8_native=bool(i8_native and self._scales is not None), n_real=B0)
            self.last_dropped = int(dropped)
            nxt = self._tune(state, counts, lam, Qcap, qcap_cap, B, nprobe)
            if nxt is None:
                break
            Qcap = nxt
        state["qcap"] = Qcap
        self._bulk_state = state
        return tv[:B0].cpu().numpy(), doc[:B0].cpu().numpy()

    def search(self, q_reps, k: int = 100, mode: str = "bulk",
               nprobe: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k in ``mode`` (``index/modes.py:resolve_ivf_mode``): bulk /
        serve and i8q on K13, probe per query tile, exact the flat scan."""
        if self._values is None:
            raise RuntimeError(f"{type(self).__name__}.search before add()")
        mode = resolve_ivf_mode(mode, self.dtype)
        k = min(k, self._n)
        if mode == "exact":
            return self._search_exact(self._queries(q_reps), k)
        if mode in ("bulk", "serve", "i8q"):
            return self.search_bulk(q_reps, k, nprobe=nprobe, i8_native=mode == "i8q")
        nprobe = self.nprobe if nprobe is None else min(nprobe, self.nlist)
        q = self._queries(q_reps)
        C = int(self._values.shape[1])
        # the tile's gathered rows, widened to fp32, stay under ~1 GB
        tile = max(1, min(self.query_tile, (1 << 30) // max(1, nprobe * C * self.dim * 4)))
        parts = [self._probe_tile(q[s:s + tile], k, nprobe) for s in range(0, q.shape[0], tile)]
        return (torch.cat([p[0] for p in parts]).cpu().numpy(),
                torch.cat([p[1] for p in parts]).cpu().numpy())

    def _stored_rows(self):
        """(fp32 rows, corpus ids) of every stored row: cells, then overflow."""
        flat_ids = self._row_ids.reshape(-1)
        mask = flat_ids >= 0
        vals = self._values.reshape(-1, self.dim)[mask].float()
        if self._scales is not None:
            vals = vals * self._scales.reshape(-1)[mask][:, None]
        ids = flat_ids[mask]
        if self._ovf_values is not None:
            ov = self._ovf_values.float()
            if self._ovf_scales is not None:
                ov = ov * self._ovf_scales[:, None]
            vals, ids = torch.cat([vals, ov]), torch.cat([ids, self._ovf_ids])
        return vals, ids

    def _search_exact(self, q: torch.Tensor, k: int):
        """Flat scan over every stored row, exact (parity checks)."""
        vals, ids = self._stored_rows()
        s, i = blockwise_topk(q, vals, k, min(4096, vals.shape[0]))
        return s.cpu().numpy(), ids[i.long()].cpu().numpy()

    def batch_search(self, q_reps, k: int, batch_size: int, quiet: bool = False,
                     mode: str = "bulk") -> Tuple[np.ndarray, np.ndarray]:
        out_s, out_i = [], []
        for start in range(0, q_reps.shape[0], batch_size):
            s, i = self.search(q_reps[start:start + batch_size], k, mode=mode)
            out_s.append(s)
            out_i.append(i)
        return np.concatenate(out_s), np.concatenate(out_i)

    # -- persistence ---------------------------------------------------------------------------

    def _meta(self) -> dict:
        return {"kind": "ivf", "dim": self.dim, "nlist": self.nlist, "nprobe": self.nprobe,
                "dtype": self.dtype, "n": self._n, "docid": self.docid}

    def _payload(self) -> dict:
        payload = {"centroids": self.centroids.float().cpu().numpy(),
                   "values": _to_numpy(self._values), "row_ids": self._row_ids.cpu().numpy()}
        if self._scales is not None:
            payload["scales"] = self._scales.cpu().numpy()
        if self._ovf_values is not None:
            payload["ovf_values"] = _to_numpy(self._ovf_values)
            payload["ovf_ids"] = self._ovf_ids.cpu().numpy()
            if self._ovf_scales is not None:
                payload["ovf_scales"] = self._ovf_scales.cpu().numpy()
        return payload

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path + ".npz", **self._payload())
        with open(path + ".meta.json", "w") as fh:
            json.dump(self._meta(), fh)

    @classmethod
    def _open(cls, path: str, device, extra=()):
        """(index, meta, {name: tensor on device}) of a saved index; ``extra``
        names meta fields the constructor takes."""
        with open(path + ".meta.json") as fh:
            meta = json.load(fh)
        idx = cls(meta["dim"], nlist=meta["nlist"], nprobe=meta["nprobe"], dtype=meta["dtype"],
                  device=device, **{k: meta[k] for k in extra})
        with np.load(path + ".npz") as z:
            arrays = {name: _from_numpy(z[name], meta["dtype"], idx.device) for name in z.files}
        idx.centroids = arrays.pop("centroids")
        idx._n = meta["n"]
        idx.docid = meta.get("docid", [])
        return idx, meta, arrays

    @classmethod
    def load(cls, path: str, device=None) -> "IVFFlatIndex":
        """Load ``path.npz`` + ``path.meta.json`` (kind ``ivf``) onto ``device``."""
        idx, _, z = cls._open(path, device)
        idx._values, idx._row_ids = z["values"], z["row_ids"]
        idx._scales = z.get("scales")
        idx._ovf_values, idx._ovf_ids = z.get("ovf_values"), z.get("ovf_ids")
        idx._ovf_scales = z.get("ovf_scales")
        return idx


class IVFRaggedIndex(IVFFlatIndex):
    """Ragged block-indirect IVF (ivf.py:777-1149), the bulk-serving layout:
    rows sorted by cell, each cell padded only to a ``block`` multiple, so
    there is no capacity cap and no overflow slab; the bulk search walks the
    block list on K14. Training and the bulk tuner are the parent's; the
    ``probe`` mode serves through the bulk kernel."""

    # Qcap x block cap of the reference's bulk kernel (a TPU VMEM budget),
    # kept so the learned Qcap is the reference's
    QCAP_ELEMS = 262144

    def __init__(self, dim: int, nlist: int = 1024, nprobe: int = 32, dtype: str = "int8",
                 block: int = 512, train_block: int = 8192, qcap_factor: float = 2.0,
                 device=None):
        super().__init__(dim, nlist=nlist, nprobe=nprobe, dtype=dtype, train_block=train_block,
                         qcap_factor=qcap_factor, device=device)
        self.block = block
        self._block_cell = None   # [nb_total] int32: each block's cell
        self._block_start = None  # [nlist + 1] int32: each cell's block range
        self._nb_max = 0
        self.last_assign = None

    # -- population -----------------------------------------------------------------------------

    def add_device(self, reps) -> None:
        reps = torch.as_tensor(reps).to(self.device)
        n = int(reps.shape[0])
        self.add_chunks(lambda s, r: reps[s:s + r], n, chunk_rows=max(1, min(500_000, n)))

    def _assign_pass(self, chunk_fn, N: int, chunk_rows: int) -> np.ndarray:
        """Pass 1: each row's nearest centroid, a chunk at a time."""
        assign_all = np.empty(N, np.int32)
        for start in range(0, N, chunk_rows):
            rows = min(chunk_rows, N - start)
            chunk = _chunk(chunk_fn, start, rows, self.device)
            assign_all[start:start + rows] = _assign_device(
                chunk, self.centroids, min(8192, max(8, rows))).cpu().numpy()
            del chunk
        return assign_all

    def _ragged_layout(self, assign_all: np.ndarray, N: int):
        """The padded-flat layout of an assignment (ivf.py:839-866): sets the
        block map and returns (dest [N] int64 flat position of each row,
        row_ids_flat [nb_total * block] int32, -1 in segment tails)."""
        block = self.block
        counts = np.bincount(assign_all, minlength=self.nlist)
        blocks_c = -(-counts // block)  # 0 blocks for an empty cell
        block_start = np.zeros(self.nlist + 1, np.int64)
        np.cumsum(blocks_c, out=block_start[1:])
        nb_total = int(block_start[-1])
        self._nb_max = int(max(1, blocks_c.max()))
        order = np.argsort(assign_all, kind="stable")
        sa = assign_all[order]
        cum = np.zeros(self.nlist + 1, np.int64)
        np.cumsum(counts, out=cum[1:])
        dest_sorted = block_start[:-1][sa] * block + np.arange(N, dtype=np.int64) - cum[sa]
        dest = np.empty(N, np.int64)
        dest[order] = dest_sorted
        row_ids_flat = np.full(nb_total * block, -1, np.int32)
        row_ids_flat[dest_sorted] = order.astype(np.int32)
        self._block_cell = torch.from_numpy(
            np.repeat(np.arange(self.nlist, dtype=np.int32), blocks_c)).to(self.device)
        self._block_start = torch.from_numpy(block_start.astype(np.int32)).to(self.device)
        return dest, row_ids_flat

    def add_chunks(self, chunk_fn, n_rows: int, chunk_rows: int = 500_000,
                   assign=None) -> None:
        """Two-pass ragged build (ivf.py:868-930); every row lands in its
        cell's block range. ``assign``: a precomputed [n_rows] assignment to
        these centroids, which skips pass 1."""
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
        int8 = self.dtype == "int8"
        values = torch.zeros((row_ids_flat.shape[0], self.dim), dtype=self._cell_dtype(),
                             device=self.device)
        scales = torch.ones(row_ids_flat.shape[0], dtype=torch.float32, device=self.device) \
            if int8 else None
        for start in range(0, N, chunk_rows):
            rows = min(chunk_rows, N - start)
            chunk = _chunk(chunk_fn, start, rows, self.device)
            if int8:
                qv, qs = quantize_int8_device(chunk)
            else:
                qv, qs = chunk.to(self._cell_dtype()), None
            del chunk
            at = torch.from_numpy(dest[start:start + rows]).to(self.device)
            values.index_copy_(0, at, qv)
            if qs is not None:
                scales.index_copy_(0, at, qs)
            del qv, qs
        self._values, self._scales = values, scales
        self._row_ids = torch.from_numpy(row_ids_flat).to(self.device)
        self._n = N
        self._bulk_state = None

    # -- search --------------------------------------------------------------------------------

    def _side_slab(self, hot_ids: np.ndarray):
        """The hot cells' own rows (their block ranges), real rows first,
        padded to a SIDE_BLOCK multiple (ivf.py:934-966)."""
        bs = self._block_start.cpu().numpy()
        parts_v, parts_s, parts_i = [], [], []
        for c in hot_ids:
            r0, r1 = int(bs[c]) * self.block, int(bs[c + 1]) * self.block
            if r1 > r0:
                parts_v.append(self._values[r0:r1])
                parts_i.append(self._row_ids[r0:r1])
                if self._scales is not None:
                    parts_s.append(self._scales[r0:r1])
        return self._pack_side(parts_v, parts_s, parts_i)

    def _cell_plan(self, Qcap: int, k: int) -> Tuple[int, int, int]:
        """(block, sel, J) of K14 in the bulk search: the layout's block, the
        reference's Poisson J over the cells' mean rows (ivf.py:982-986),
        then its :func:`selection_plan`. ``Qcap`` does not enter: the
        ragged layout's block is fixed when it is built."""
        block = self.block
        mean_rows = max(block, int(self._n / max(1, self.nlist)))
        J = serve_j(k, block, mean_rows)
        if getattr(self, "bulk_j", None):
            J = min(self.bulk_j, k, block)
        return (block, *selection_plan(k, block, mean_rows, J))

    def _bulk_call(self, q, k: int, nprobe: int, i8_native: bool, state: dict, Qcap: int,
                   n_real: int):
        """One search with an explicit tuning state; device results
        (scores, doc_rows, n_dropped, probe_counts), no host sync."""
        block, sel, J = self._cell_plan(Qcap, k)
        sv, ss, si, side_valid = state["side"]
        np_eff = min(nprobe, self.nlist - int(state["hot"].size))
        sb = self.SIDE_BLOCK
        side_J = serve_j(k, sb, max(sb, side_valid)) if side_valid else 4
        return ivf_ragged_search(
            q, self.centroids, self._values, self._row_ids, self._scales, self._block_cell,
            self._block_start, sv, ss, si, k=k, nprobe=np_eff, Qcap=Qcap, J=J, block=block,
            sel=sel, nlist=self.nlist, nb_max=self._nb_max, hot_penalty=state["hp"],
            side_valid=side_valid, side_J=side_J, side_block=sb,
            i8_native=bool(i8_native and self._scales is not None), n_real=n_real)

    def search_bulk_async(self, q_reps, k: int = 100, nprobe: Optional[int] = None,
                          i8_native: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """The bulk search against the kept tuning state, results left on the
        device (scores [B, k], doc_rows [B, k]) with no host sync; the drop
        count stays a device scalar in ``_last_dropped_dev``. Runs one tuning
        ``search_bulk`` first when no state is kept for this nprobe."""
        if self._values is None:
            raise RuntimeError("IVFRaggedIndex.search before add()")
        k = min(k, self._n)
        nprobe = self.nprobe if nprobe is None else min(nprobe, self.nlist)
        state = self._bulk_state
        if state is None or state["key"] != (nprobe,) or state["qcap"] is None:
            self.search_bulk(q_reps, k, nprobe=nprobe, i8_native=i8_native)
            state = self._bulk_state
        q, B0 = self._pad_queries(q_reps)
        tv, doc, dropped, _ = self._bulk_call(q, k, nprobe, i8_native, state, state["qcap"], B0)
        self._last_dropped_dev = dropped
        return tv[:B0], doc[:B0]

    def search_bulk(self, q_reps, k: int = 100, nprobe: Optional[int] = None,
                    i8_native: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """The ragged bulk search on K14 with the parent's tuner (ivf.py:1033-1082)."""
        if self._values is None:
            raise RuntimeError("IVFRaggedIndex.search before add()")
        k = min(k, self._n)
        nprobe = self.nprobe if nprobe is None else min(nprobe, self.nlist)
        q, B0 = self._pad_queries(q_reps)
        B = q.shape[0]
        lam = B * nprobe / self.nlist
        qcap_cap = min(int(-(-B * nprobe // 8) * 8), max(64, int(-(-4.0 * lam // 8) * 8)),
                       self.QCAP_ELEMS // self.block)
        state = self._bulk_state
        if state is None or state["key"] != (nprobe,):
            state = self._new_state(nprobe)
        Qcap = self._qcap_start(state, lam, qcap_cap)
        while True:
            tv, doc, dropped, counts = self._bulk_call(q, k, nprobe, i8_native, state, Qcap, B0)
            self.last_dropped = int(dropped)
            nxt = self._tune(state, counts, lam, Qcap, qcap_cap, B, nprobe)
            if nxt is None:
                break
            Qcap = nxt
        state["qcap"] = Qcap
        self._bulk_state = state
        return tv[:B0].cpu().numpy(), doc[:B0].cpu().numpy()

    def search(self, q_reps, k: int = 100, mode: str = "bulk",
               nprobe: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """``exact`` is the flat scan; every other mode is the bulk search
        (``probe`` too: the ragged layout has no per-query probe path; i8q
        with int8 queries)."""
        if self._values is None:
            raise RuntimeError("IVFRaggedIndex.search before add()")
        mode = resolve_ivf_mode(mode, self.dtype)
        k = min(k, self._n)
        if mode == "exact":
            return self._search_exact(self._queries(q_reps), k)
        return self.search_bulk(q_reps, k, nprobe=nprobe, i8_native=mode == "i8q")

    # -- persistence ---------------------------------------------------------------------------

    def _meta(self) -> dict:
        return dict(super()._meta(), kind="ivfr", block=self.block, nb_max=self._nb_max)

    def _payload(self) -> dict:
        return dict(super()._payload(), block_cell=self._block_cell.cpu().numpy(),
                    block_start=self._block_start.cpu().numpy())

    @classmethod
    def load(cls, path: str, device=None) -> "IVFRaggedIndex":
        """Load ``path.npz`` + ``path.meta.json`` (kind ``ivfr``) onto ``device``."""
        idx, meta, z = cls._open(path, device, extra=("block",))
        idx._values, idx._row_ids, idx._scales = z["values"], z["row_ids"], z.get("scales")
        idx._block_cell, idx._block_start = z["block_cell"], z["block_start"]
        idx._nb_max = meta["nb_max"]
        return idx
