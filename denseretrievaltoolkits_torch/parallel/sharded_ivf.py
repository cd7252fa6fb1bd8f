"""Sharded trained indexes: IVF cells split over the ranks, the mesh factory.

Counterpart of ``denseretrievaltoolkits_tpu/parallel/sharded_ivf.py``:

- :func:`collective_sample` (``_collective_sample`` there, :52-70): every
  rank's training sample, gathered in rank order, the same on every rank.
- Trained state is fitted once: rank 0 fits it on the gathered sample and
  broadcasts it (:func:`fit_on_rank0`, through the host: a few MB), so every
  rank holds the same bits. A fit on every rank would meet the same input but
  need not give the same bits (the card's float atomics sum in any order).
- :class:`CollectivePCATransform` (:73-105 there) and
  :class:`CollectiveTransform`: a PCA / PCAR / OPQ transform fitted so.
- :class:`ShardedIVFIndex` (:108-460): shared centroids, so every rank probes
  the same cells, and the union of the rows the ranks scan for a query is the
  one-card index's; rank r's contiguous rows live in its own ragged cell store
  (``index/ivf.py:IVFRaggedIndex``, K13 / K14) or IVF-PQ cells
  (``index/ivf_pq.py:IVFPQIndex``, K17, with the shared codebooks); the
  candidates merge as ``ShardedFlatIndex``'s do.
- :func:`sharded_index_factory` (:461-560) and :func:`load_sharded_index`
  (:561-582): the factory strings on the mesh and the load of any of them.

Every method that touches more than one rank (train, add, search, save,
load) is collective: every rank calls it, in the same order.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..index.ivf import IVFRaggedIndex
from ..index.modes import resolve_ivf_mode, resolve_ivfpq_mode
from ..index.transforms import OPQTransform, PCATransform, TransformedIndex
from ..utils.distributed import host_corpus_bounds
from .mesh import Mesh
from .sharded_index import merge_candidates, pad_candidates, rank_window

def _as_tensor(reps, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(reps, np.float32) if isinstance(reps, np.ndarray)
                           else reps).to(device=device, dtype=torch.float32)


def collective_sample(reps, mesh: Mesh, device) -> torch.Tensor:
    """Every rank's (possibly different-sized, possibly empty) sample rows,
    joined in rank order on ``device``: the same on every rank. Each rank pads
    its rows to the largest count by repeating them, as the reference does, so
    the gather's shapes agree; the padding is cut off again."""
    x = _as_tensor(reps, device)
    if mesh.size == 1:
        return x
    counts = torch.cat(mesh.all_gather(torch.tensor([x.shape[0]], dtype=torch.int64,
                                                    device=device))).tolist()
    n_max = max(counts)
    if n_max == 0:
        return x
    if x.shape[0] == 0:
        padded = torch.zeros((n_max,) + tuple(x.shape[1:]), dtype=x.dtype, device=device)
    else:
        padded = x.repeat((-(-n_max // x.shape[0]),) + (1,) * (x.dim() - 1))[:n_max]
    parts = mesh.all_gather(padded.contiguous())
    return torch.cat([p[:c] for p, c in zip(parts, counts) if c])


def fit_on_rank0(mesh: Mesh, fit, state, device) -> list:
    """Run ``fit()`` on rank 0 only; ``state()``'s arrays (the fitted centroids,
    codebooks or matrix), as fp32 numpy, on every rank."""
    if mesh.rank == 0:
        fit()
        box = [[np.asarray(v.float().cpu() if torch.is_tensor(v) else v, np.float32)
                for v in state()]]
    else:
        box = [None]
    if mesh.size > 1:
        torch.distributed.broadcast_object_list(
            box, mesh.global_rank(0), group=mesh.group,
            device=device if device.type == "cuda" else None)
    return box[0]


class CollectiveTransform:
    """A PCA / PCAR / OPQ transform whose fit is the same on every rank: the
    gathered sample (:func:`collective_sample`), fitted on rank 0, its matrix
    broadcast. The rest (``apply``, ``save``, ...) is the transform's; one rank
    is the transform itself."""

    def __init__(self, transform: PCATransform, mesh: Mesh):
        self._t = transform
        self.mesh = mesh

    def __getattr__(self, name):
        if name == "_t":  # copies construct without __init__
            raise AttributeError(name)
        return getattr(self._t, name)

    def train(self, reps, block: int = 65536) -> None:
        t = self._t
        sample = collective_sample(reps, self.mesh, t.device)
        (matrix,) = fit_on_rank0(self.mesh, lambda: t.train(sample, block=block),
                                 lambda: [t.matrix], t.device)
        t._set(matrix)


class CollectivePCATransform(CollectiveTransform):
    """``PCATransform`` fitted collectively (the JAX package's name)."""

    def __init__(self, dim: int, d_out: int, rotate: bool = True, seed: int = 0,
                 mesh: Optional[Mesh] = None, device=None):
        super().__init__(PCATransform(dim, d_out, rotate=rotate, seed=seed, device=device),
                         mesh or Mesh())


class ShardedTransformedIndex(TransformedIndex):
    """A collectively fitted transform in front of a sharded index: rank 0
    writes the transform, every rank its part of the inner index."""

    def __init__(self, transform, inner, mesh: Mesh):
        super().__init__(transform, inner)
        self.mesh = mesh

    @property
    def global_rows(self):
        return self.inner.global_rows

    @global_rows.setter
    def global_rows(self, value):
        self.inner.global_rows = value

    def save(self, path: str) -> None:
        if self.mesh.rank == 0:
            os.makedirs(path, exist_ok=True)
            self.transform.save(os.path.join(path, "transform.npz"))
            with open(os.path.join(path, "transformed_meta.json"), "w") as fh:
                json.dump({"inner_type": type(self.inner).__name__}, fh)
        self.mesh.barrier()
        self.inner.save(os.path.join(path, "inner"))


class ShardedIVFIndex:
    """Row-partitioned IVF over the mesh's ranks (module docstring): ragged
    cells of ``dtype`` float32 / bfloat16 / int8, or ``"pq"`` with ``M``
    subspaces of ``nbits``. Runs on ``device``, CUDA by default."""

    def __init__(self, mesh: Mesh, dim: int, nlist: int = 1024, nprobe: int = 32,
                 dtype: str = "int8", block: int = 512, M: Optional[int] = None, nbits: int = 8,
                 device=None):
        if dtype == "pq" and not M:
            raise ValueError("ShardedIVFIndex dtype='pq' needs M (subspaces)")
        self.mesh = mesh
        self.n_shards = mesh.size
        self.dim = dim
        self.nlist = nlist
        self.nprobe = min(nprobe, nlist)
        self.dtype = dtype
        self.block = block
        self.M = M
        self.nbits = nbits
        self._device = device
        # the trained state (centroids, PQ codebooks) every shard copies
        self._template = self._new_index()
        self.device = self._template.device
        self._shard = None  # this rank's cell store
        self._base = 0      # its first global row
        self._n = 0         # rows over every rank
        self.docid: List = []
        self.last_dropped = 0
        self.global_rows: Optional[int] = None

    def _new_index(self):
        if self.dtype == "pq":
            from ..index.ivf_pq import IVFPQIndex

            return IVFPQIndex(self.dim, nlist=self.nlist, nprobe=self.nprobe, M=self.M,
                              nbits=self.nbits, block=self.block, device=self._device)
        return IVFRaggedIndex(self.dim, nlist=self.nlist, nprobe=self.nprobe, dtype=self.dtype,
                              block=self.block, device=self._device)

    def _fitted_shard(self):
        """An empty shard holding the template's centroids (and codebooks)."""
        shard = self._new_index()
        shard.centroids = self._template.centroids.clone()
        if self.dtype == "pq":
            shard.codebooks = self._template.codebooks
            shard._set_codebooks()
        return shard

    def __len__(self):
        return self._n

    @property
    def is_trained(self) -> bool:
        return self._template.is_trained

    @property
    def centroids(self):
        return self._template.centroids

    def train(self, reps, **kw) -> None:
        """k-means (and the PQ codebooks) on the gathered sample, fitted on
        rank 0 and broadcast: every shard probes the same cells."""
        t = self._template
        sample = collective_sample(reps, self.mesh, t.device)
        names = ["centroids"] + (["codebooks"] if self.dtype == "pq" else [])
        state = fit_on_rank0(self.mesh, lambda: t.train(sample, **kw),
                             lambda: [getattr(t, n) for n in names], t.device)
        t.centroids = torch.from_numpy(state[0]).to(t.device)
        if self.dtype == "pq":
            t.codebooks = state[1]
            t._set_codebooks()
        t._bulk_state = None

    def add_chunks(self, chunk_fn, n_rows: int, chunk_rows: int = 500_000) -> None:
        """This rank's cell store from ``chunk_fn(start, rows)`` over its own
        window (0-based), ``n_rows`` long; one-shot."""
        if not self.is_trained:
            raise RuntimeError("ShardedIVFIndex.add_chunks before train()")
        if self._shard is not None:
            raise RuntimeError("ShardedIVFIndex build is one-shot")
        n, start, stop = rank_window(self.mesh, self.global_rows, int(n_rows),
                                     "ShardedIVFIndex")
        shard = self._fitted_shard()
        if stop > start:
            shard.add_chunks(chunk_fn, stop - start, chunk_rows=max(1, min(chunk_rows,
                                                                          stop - start)))
        self._shard, self._base, self._n = shard, start, n

    def add_device(self, reps) -> None:
        n = int(reps.shape[0])
        self.add_chunks(lambda s, r: reps[s:s + r], n, chunk_rows=max(1, min(500_000, n)))

    def add(self, reps: np.ndarray) -> None:
        self.add_chunks(lambda s, r: torch.from_numpy(np.asarray(reps[s:s + r], np.float32)),
                        int(reps.shape[0]))

    def search(self, q_reps, k: int = 100, mode: str = "bulk",
               nprobe: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """This rank's shard searched in ``mode``, then the candidates merged
        over the ranks; ``last_dropped`` counts this rank's dropped probes."""
        if self._shard is None:
            raise RuntimeError("ShardedIVFIndex.search before add()")
        if self.dtype == "pq":
            mode = resolve_ivfpq_mode(mode)
        else:
            mode = resolve_ivf_mode(mode, self.dtype)
        k = min(k, self._n)
        q = _as_tensor(q_reps, self.device)
        s = i = None
        self.last_dropped = 0
        if len(self._shard):
            s, i = self._shard.search(q, min(k, len(self._shard)), mode=mode, nprobe=nprobe)
            s, i = torch.as_tensor(s), torch.as_tensor(i)
            self.last_dropped = int(self._shard.last_dropped)
        s, i = pad_candidates(s, i, int(q.shape[0]), k, self._base, self.device)
        return merge_candidates(s, i, self.mesh, k)

    def batch_search(self, q_reps, k, batch_size, quiet=False, mode: str = "bulk"):
        out_s, out_i = [], []
        for start in range(0, q_reps.shape[0], batch_size):
            s, i = self.search(q_reps[start:start + batch_size], k, mode=mode)
            out_s.append(s)
            out_i.append(i)
        return np.concatenate(out_s), np.concatenate(out_i)

    # -- persistence: the JAX package's directory format ---------------------------------------

    def save(self, path: str) -> None:
        """``path/shard{r}`` for each rank that holds rows, the centroids
        (and codebooks) and ``sivf_meta.json`` from rank 0, then a barrier."""
        os.makedirs(path, exist_ok=True)
        populated = len(self._shard) > 0
        if populated:
            self._shard.save(os.path.join(path, f"shard{self.mesh.rank}"))
        flags = torch.cat(self.mesh.all_gather(torch.tensor(
            [int(populated)], dtype=torch.int64, device=self.device))).tolist()
        if self.mesh.rank == 0:
            np.save(os.path.join(path, "centroids.npy"),
                    self._template.centroids.float().cpu().numpy())
            if self.dtype == "pq":
                np.save(os.path.join(path, "codebooks.npy"),
                        np.asarray(self._template.codebooks, np.float32))
            bases = [host_corpus_bounds(self._n, self.mesh.size, r)[0]
                     for r in range(self.mesh.size)]
            with open(os.path.join(path, "sivf_meta.json"), "w") as fh:
                json.dump({"kind": "sivf", "dim": self.dim, "nlist": self.nlist,
                           "nprobe": self.nprobe, "dtype": self.dtype, "block": self.block,
                           "M": self.M, "nbits": self.nbits, "n": self._n,
                           "n_shards": self.n_shards, "bases": bases,
                           "populated": [r for r, f in enumerate(flags) if f],
                           "docid": self.docid}, fh)
        self.mesh.barrier()

    @classmethod
    def load(cls, path: str, mesh: Mesh, device=None) -> "ShardedIVFIndex":
        """Each rank restores its own shard of a save by either package made
        over as many shards as the mesh has ranks."""
        with open(os.path.join(path, "sivf_meta.json")) as fh:
            meta = json.load(fh)
        idx = cls(mesh, meta["dim"], nlist=meta["nlist"], nprobe=meta["nprobe"],
                  dtype=meta["dtype"], block=meta["block"], M=meta.get("M"),
                  nbits=meta.get("nbits", 8), device=device)
        if idx.n_shards != meta["n_shards"]:
            raise ValueError(f"index saved with {meta['n_shards']} shards, the mesh has "
                             f"{idx.n_shards} ranks")
        t = idx._template
        t.centroids = torch.from_numpy(np.load(os.path.join(path, "centroids.npy"))).to(
            t.device)
        if idx.dtype == "pq":
            t.codebooks = np.load(os.path.join(path, "codebooks.npy"))
            t._set_codebooks()
        shard_cls = type(t)
        if mesh.rank in set(meta.get("populated", range(meta["n_shards"]))):
            idx._shard = shard_cls.load(os.path.join(path, f"shard{mesh.rank}"),
                                        device=t.device)
        else:
            idx._shard = idx._fitted_shard()
        idx._base = int(meta["bases"][mesh.rank])
        idx._n = int(meta["n"])
        idx.global_rows = idx._n
        idx.docid = meta.get("docid", [])
        return idx


FLAT_DTYPES = {"flat": "float32", "ip": "float32", "bf16": "bfloat16", "flat16": "bfloat16",
               "sq8": "int8", "sqint8": "int8", "sq4": "int4", "sqint4": "int4"}


def _int(text: str) -> int:
    try:
        return int(text)
    except ValueError:
        return 0


def sharded_index_factory(mesh: Mesh, dim: int, factory_str: str, nprobe: int = 32,
                          device=None):
    """The factory strings on the mesh (the JAX package's, :461-560):

    - Flat / IP / BF16 / SQ8 / SQ4: ``ShardedFlatIndex`` at that dtype;
    - PCA{d} / PCAR{d},<any>: a :class:`CollectivePCATransform` in front of
      the sharded inner index; OPQ{M}[x4],<any>: a collectively fitted
      ``OPQTransform`` likewise;
    - PQ{M}[x4]: ``ShardedPQIndex``;
    - IVF{n} / IVFR{n},Flat|BF16|SQ8 (IVFR's default SQ8): ragged
      :class:`ShardedIVFIndex`; IVF{n} / IVFR{n},PQ{M}[x4]: its PQ cells.

    Any other string raises the one-card factory's error."""
    from ..index.flat import index_factory
    from .sharded_index import ShardedFlatIndex

    key = factory_str.strip().lower()
    head, _, tail = key.partition(",")
    if key in FLAT_DTYPES:
        return ShardedFlatIndex(mesh, dim, dtype=FLAT_DTYPES[key], device=device)
    if key.startswith("pca"):
        rotate = head.startswith("pcar")
        d_out = _int(head[4 if rotate else 3:])
        if d_out > 0 and tail:
            inner = sharded_index_factory(mesh, d_out, tail, nprobe=nprobe, device=device)
            return ShardedTransformedIndex(
                CollectivePCATransform(dim, d_out, rotate=rotate, mesh=mesh, device=device),
                inner, mesh)
    if key.startswith("opq"):
        spec, _, bits = head[3:].partition("x")
        m_rot = _int(spec)
        if m_rot > 0 and tail:
            inner = sharded_index_factory(mesh, dim, tail, nprobe=nprobe, device=device)
            rot_bits = getattr(inner, "nbits", None) or (_int(bits) if bits else 8)
            return ShardedTransformedIndex(
                CollectiveTransform(OPQTransform(dim, M=m_rot, nbits=rot_bits, device=device),
                                    mesh), inner, mesh)
    if key.startswith("pq"):
        spec, _, bits = key[2:].partition("x")
        m_sub = _int(spec)
        if m_sub > 0:
            from .sharded_pq import ShardedPQIndex

            return ShardedPQIndex(mesh, dim, M=m_sub, nbits=_int(bits) if bits else 8,
                                  device=device)
    if key.startswith("ivf"):
        ragged = head.startswith("ivfr")
        nlist = _int(head[4 if ragged else 3:])
        cell_dtype = FLAT_DTYPES.get(tail or ("sq8" if ragged else "flat"))
        if nlist > 0 and cell_dtype in ("float32", "bfloat16", "int8"):
            return ShardedIVFIndex(mesh, dim, nlist=nlist, nprobe=nprobe, dtype=cell_dtype,
                                   device=device)
        if nlist > 0 and tail.startswith("pq"):
            spec, _, bits = tail[2:].partition("x")
            if _int(spec) > 0:
                return ShardedIVFIndex(mesh, dim, nlist=nlist, nprobe=nprobe, dtype="pq",
                                       M=_int(spec), nbits=_int(bits) if bits else 8,
                                       device=device)
    index_factory(dim, factory_str, nprobe=nprobe, device=device)  # its error for a bad string
    raise ValueError(f"index_factory string {factory_str!r} has no sharded equivalent")


def load_sharded_index(path: str, mesh: Mesh, device=None):
    """Restore any index the mesh factory saves (``Trainer._load_index`` on a
    mesh), by the saved kind."""
    from .sharded_index import ShardedFlatIndex

    if os.path.isdir(path) and os.path.exists(os.path.join(path, "sivf_meta.json")):
        return ShardedIVFIndex.load(path, mesh, device=device)
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as fh:
            if json.load(fh).get("kind") == "pq":
                from .sharded_pq import ShardedPQIndex

                return ShardedPQIndex.load(path, mesh, device=device)
    if os.path.isdir(path) and os.path.exists(os.path.join(path, "transformed_meta.json")):
        transform = PCATransform.load(os.path.join(path, "transform.npz"), device=device)
        inner = load_sharded_index(os.path.join(path, "inner"), mesh, device=device)
        return ShardedTransformedIndex(CollectiveTransform(transform, mesh), inner, mesh)
    return ShardedFlatIndex.load(path, mesh, device=device)
