"""Device-resident flat inner-product index: fp32, bf16, int8 and int4 rows.

Counterpart of ``denseretrievaltoolkits_tpu/index/flat.py``:

- :func:`blockwise_topk` is the exact scan, a running top-k merged block by
  block. It is the plain version of the whole search, the reference for the
  kernel paths, and the last rung of the certified search. int8 and int4
  rows score fp32 queries against the rows times their scales, as the
  reference does (int4: two half-dim products, index/flat.py:108-120 there).
- :class:`FlatIPIndex` stages rows on the host (``add``) or takes device
  tensors (``add_device``, one slab per call, searched on its own and
  merged). int8 rows are quantized on the device by K7
  (``ops/quant.py:quantize_int8_device``), per row with an absmax / 127
  scale; int4 rows by K9 (``quantize_int4_device``), absmax / 7, two dims
  to a byte in column halves, half the memory of int8. On CUDA the modes of
  ``index/modes.py`` run:

  ======== ==============================================================
  exact    certified exact top-k: K5 (fp32/bf16 rows), K6 (int8) or K10
           (int4) candidates and the certificate ladder
           (``ops/topk.py:certified_topk``)
  serve    K8 (K11 on int4) candidates, J from the Poisson rule, no
           certificate (``ops/topk.py:serve_topk``), on every dtype
  partial  K5 candidates without the certificate, fp32/bf16 rows
  i8q      int8 / int4 rows: queries quantized by K7, scored by K12
  approx   the per-dtype alias of ``index/modes.py``
  ======== ==============================================================

  On the CPU every mode runs the exact scan, as the reference does off the
  TPU (index/modes.py). ``save``/``load`` use the reference's ``path.npz`` +
  ``path.meta.json`` format, int8 and int4 indexes as their native
  ``values`` + ``scales`` payload, so indexes interchange both ways.
- :func:`index_factory` builds the flat kinds, the trained IVF kinds of
  ``index/ivf.py`` and the PCA / PCAR chains of ``index/transforms.py`` from
  FAISS-style strings. The product-quantized kinds (PQ, OPQ, IVF-PQ) raise
  ``NotImplementedError`` naming their ROADMAP item; no dtype or mode
  silently runs another.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quant import quantize_int4_device, quantize_int8_device
from ..ops.topk import _scores, certified_topk, serve_topk
from .modes import QUANTIZED, resolve_mode

DEFAULT_BLOCK = 4096
# storage dtypes; int4 rows are nibble-packed into int8 [N, H/2]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
          "int4": torch.int8}


def blockwise_topk(q_reps: torch.Tensor, corpus: torch.Tensor, k: int,
                   block_size: int = DEFAULT_BLOCK, valid: Optional[int] = None,
                   scales: Optional[torch.Tensor] = None,
                   int4: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner-product search, O(k + block) memory per query.

    q_reps [Q,H] float; corpus [N,H] fp32/bf16, or int8 with per-row
    ``scales`` [N], or (``int4``) packed int4 [N, H/2] with ``scales``;
    ``valid`` counts the real rows (later rows are masked).
    Returns (scores [Q,k] fp32, ids [Q,k] int32) sorted descending; ties keep
    the smaller id, as ``lax.top_k`` does. fp32 products (fp32 and int8 rows)
    run in true fp32, which on CUDA needs
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default)."""
    if corpus.is_cuda and corpus.dtype != torch.bfloat16 and torch.backends.cuda.matmul.allow_tf32:
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
        s = _scores(qf, blk, None if scales is None else scales[start:start + block_size], int4)
        ids = torch.arange(start, start + blk.shape[0], dtype=torch.int32, device=corpus.device)
        s = torch.where(ids[None, :] < n_valid, s, float("-inf"))
        cat_s = torch.cat([run_s, s], dim=1)
        cat_i = torch.cat([run_i, ids.expand(Q, -1)], dim=1)
        sv, pos = torch.sort(cat_s, dim=1, descending=True, stable=True)
        run_s = sv[:, :k].contiguous()
        run_i = torch.gather(cat_i, 1, pos[:, :k])
    return run_s, run_i


class FlatIPIndex:
    """Device-resident flat IP index: add / add_device / search / batch_search /
    save / load. Runs on ``device``, CUDA by default: without a card it
    raises unless ``device='cpu'`` is given."""

    def __init__(self, dim_or_reps, dtype: str = "float32",
                 block_size: int = DEFAULT_BLOCK, device=None):
        if dtype not in DTYPES:
            raise ValueError(f"unsupported index dtype {dtype!r}")
        reps = dim_or_reps if isinstance(dim_or_reps, np.ndarray) else None
        self.dim = int(reps.shape[1]) if reps is not None else int(dim_or_reps)
        if dtype == "int4" and self.dim % 2:
            raise ValueError(f"int4 packing needs an even dim, got {self.dim}")
        self.dtype = dtype
        self.block_size = block_size
        self.device = resolve_device(device, "FlatIPIndex")
        self._chunks: List[np.ndarray] = []
        # device slabs: (values, scales or None, real rows); int8 / int4 slabs
        # are quantized on arrival and padded to a block multiple, as the reference
        self._device_slabs: List[Tuple[torch.Tensor, Optional[torch.Tensor], int]] = []
        self._device_corpus: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None
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

    def _quantize(self, reps: torch.Tensor, rows: Optional[int] = None):
        """(values, scales) of int8 (K7) or int4 (K9) rows; ``rows`` pads."""
        quantize = quantize_int8_device if self.dtype == "int8" else quantize_int4_device
        return quantize(reps, rows=rows)

    def add_device(self, p_reps: torch.Tensor) -> None:
        """Append device-resident embeddings without a host round trip; each
        call becomes one slab. int8 / int4 slabs quantize on the device (K7 /
        K9) right away, padded with zero rows of scale 1 to a block multiple,
        so the float reps can be freed."""
        if self._chunks:
            raise ValueError("mixing add() and add_device() is not supported")
        if p_reps.ndim != 2 or p_reps.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}] reps, got {tuple(p_reps.shape)}")
        n = int(p_reps.shape[0])
        p_reps = p_reps.to(self.device)
        if self.dtype in QUANTIZED:
            rows = -(-n // self.block_size) * self.block_size
            values, scales = self._quantize(p_reps, rows)
            self._device_slabs.append((values, scales, n))
        else:
            self._device_slabs.append((p_reps.to(DTYPES[self.dtype]).contiguous(), None, n))
        self._n += n

    def _materialize(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The staged rows on the device: (values, scales or None)."""
        if self._device_corpus is None:
            full = np.concatenate(self._chunks, axis=0) if len(self._chunks) != 1 \
                else self._chunks[0]
            reps = torch.from_numpy(full).to(self.device)
            if self.dtype in QUANTIZED:
                self._device_corpus = self._quantize(reps)
            else:
                self._device_corpus = (reps.to(DTYPES[self.dtype]), None)
        return self._device_corpus

    def search_block(self, rows: int) -> int:
        """The corpus block a search over ``rows`` rows (one slab) runs with."""
        return min(self.block_size, max(256, 1 << (rows - 1).bit_length()))

    def _topk(self, q: torch.Tensor, corpus: torch.Tensor, scales, n_valid: int, k: int,
              mode: str):
        block = self.search_block(corpus.shape[0])
        int4 = self.dtype == "int4"
        if not corpus.is_cuda:
            return blockwise_topk(q, corpus, k, block, valid=n_valid, scales=scales, int4=int4)
        if mode in ("exact", "partial"):
            return certified_topk(q, corpus, k, block, valid=n_valid, scales=scales,
                                  certify=mode == "exact", int4=int4)
        return serve_topk(q, corpus, k, block, scales=scales, valid=n_valid,
                          i8_native=mode == "i8q", int4=int4)

    def search(self, q_reps, k: int = 1000,
               mode: str = "exact") -> Tuple[np.ndarray, np.ndarray]:
        """Top-k search. Returns (scores [Q,k], indices [Q,k]) sorted descending.
        ``mode`` resolves through ``index/modes.py`` (see the module docstring)."""
        mode = resolve_mode(mode, self.dtype)
        k = min(k, self._n)
        q = torch.as_tensor(q_reps, dtype=torch.float32, device=self.device)
        if self._device_slabs:
            parts_v, parts_i, offset = [], [], 0
            for values, scales, n in self._device_slabs:
                s, i = self._topk(q, values, scales, n, min(k, n), mode)
                parts_v.append(s)
                parts_i.append(i + offset)
                offset += n
            cat_v = torch.cat(parts_v, dim=1)
            cat_i = torch.cat(parts_i, dim=1)
            # a stable sort keeps ties in slab order, i.e. to the smaller global id
            sv, pos = torch.sort(cat_v, dim=1, descending=True, stable=True)
            scores, ids = sv[:, :k], torch.gather(cat_i, 1, pos[:, :k])
        else:
            values, scales = self._materialize()
            scores, ids = self._topk(q, values, scales, self._n, k, mode)
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

    def _width(self) -> int:
        """Columns of the stored rows: H, or H/2 packed int4 bytes."""
        return self.dim // 2 if self.dtype == "int4" else self.dim

    def _native_int8_payload(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(values int8 [N,H] (int4: packed [N,H/2]), scales fp32 [N]): the
        index's own storage, saved as it is, so a load restores it bit for bit
        without requantizing."""
        if self.dtype not in QUANTIZED:
            return None
        if self._device_slabs:
            return (np.concatenate([v[:n].cpu().numpy() for v, _, n in self._device_slabs]),
                    np.concatenate([s[:n].cpu().numpy() for _, s, n in self._device_slabs]))
        if self._chunks:
            values, scales = self._materialize()
            return values.cpu().numpy(), scales.cpu().numpy()
        return np.zeros((0, self._width()), np.int8), np.zeros((0,), np.float32)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        native = self._native_int8_payload()
        if native is not None:
            np.savez(path + ".npz", values=native[0], scales=native[1])
        else:
            if self._device_slabs:
                # bf16/fp32 slabs: widen to fp32 (lossless) for the checkpoint
                full = torch.cat([v[:n].float() for v, _, n in self._device_slabs]).cpu().numpy()
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
        """Load ``path.npz`` + ``path.meta.json`` onto ``device`` (CUDA by
        default). A native int8 / int4 payload becomes one device slab, as
        ``add_device`` would have staged it, without requantizing."""
        with open(path + ".meta.json") as fh:
            meta = json.load(fh)
        idx = cls(meta["dim"], dtype=meta["dtype"], device=device)
        with np.load(path + ".npz") as z:
            if "values" in z:
                values, scales = z["values"], z["scales"]
                if values.ndim != 2 or values.shape[1] != idx._width():
                    raise ValueError(f"{path}.npz: {meta['dtype']} values of dim {idx.dim} "
                                     f"must be [n, {idx._width()}], got {values.shape}")
                if values.shape[0]:
                    idx._device_slabs.append((torch.from_numpy(values).to(idx.device),
                                              torch.from_numpy(scales).to(idx.device),
                                              int(values.shape[0])))
                    idx._n = int(values.shape[0])
            elif z["reps"].shape[0]:
                idx.add(z["reps"])
        idx.docid = meta.get("docid", [])
        return idx


FLAT_FACTORY = {
    "flat": "float32", "ip": "float32",
    "bf16": "bfloat16", "flat16": "bfloat16",
    "sq8": "int8", "sqint8": "int8",
    "sq4": "int4", "sqint4": "int4",
}
PQ_ITEM = ("is not ported yet (ROADMAP queue 1 item 12b, 'Trained indexes': PQ, IVF-PQ and "
           "OPQ; kernels K15-K17 in queue 2)")


def _count(text: str) -> int:
    """The count in a factory token ("IVF1024" -> 1024), 0 if there is none."""
    try:
        return int(text)
    except ValueError:
        return 0


def index_factory(dim: int, factory_str: str, block_size: int = DEFAULT_BLOCK, nprobe: int = 32,
                  device=None):
    """FAISS ``index_factory``-style constructor, as the reference's
    (index/flat.py:533-662), on ``device``:

    - "Flat" / "IP" fp32, "BF16" / "Flat16" bf16, "SQ8" / "SQint8" int8 and
      "SQ4" / "SQint4" int4 rows with per-row scales: :class:`FlatIPIndex`;
    - "IVF{n},Flat|BF16|SQ8": the fixed-capacity :class:`IVFFlatIndex`;
      "IVFR{n},Flat|BF16|SQ8" (default SQ8): the ragged
      :class:`IVFRaggedIndex`, both probing ``nprobe`` cells;
    - "PCA{d},<any of these>" / "PCAR{d},<...>": a :class:`PCATransform` to d
      dims (PCAR rotated) in front of the inner index.

    "IVF{n},SQ4" raises the reference's ``ValueError`` (the sq4 kernels are
    flat-corpus kernels); the product-quantized kinds ("PQ{M}", "OPQ{M},...",
    "IVF{n},PQ{M}") raise ``NotImplementedError`` naming their ROADMAP item."""
    key = factory_str.strip().lower()
    head, _, tail = key.partition(",")
    if key.startswith(("pq", "opq")) or (key.startswith("ivf") and tail.startswith("pq")):
        raise NotImplementedError(f"the product-quantized index {factory_str!r} {PQ_ITEM}")
    if key.startswith("pca"):
        rotate = head.startswith("pcar")
        d_out = _count(head[4 if rotate else 3:])
        if d_out > 0 and tail:
            from .transforms import PCATransform, TransformedIndex

            inner = index_factory(d_out, tail, block_size=block_size, nprobe=nprobe,
                                  device=device)
            return TransformedIndex(PCATransform(dim, d_out, rotate=rotate, device=device),
                                    inner)
    if key in FLAT_FACTORY:
        return FlatIPIndex(dim, dtype=FLAT_FACTORY[key], block_size=block_size, device=device)
    if key.startswith("ivfr"):
        cell_dtype = FLAT_FACTORY.get(tail or "sq8")
        if _count(head[4:]) > 0 and cell_dtype in ("float32", "bfloat16", "int8"):
            from .ivf import IVFRaggedIndex

            return IVFRaggedIndex(dim, nlist=_count(head[4:]), nprobe=nprobe, dtype=cell_dtype,
                                  device=device)
    if key.startswith("ivf"):
        cell_dtype = FLAT_FACTORY.get(tail or "flat")
        if cell_dtype == "int4":
            raise ValueError(
                "IVF cells support Flat/BF16/SQ8; for 4-bit storage use a flat SQ4 index "
                "(optionally behind PCAR) — the sq4 kernels are flat-corpus kernels")
        if _count(head[3:]) > 0 and cell_dtype is not None:
            from .ivf import IVFFlatIndex

            return IVFFlatIndex(dim, nlist=_count(head[3:]), nprobe=nprobe, dtype=cell_dtype,
                                device=device)
    raise ValueError(
        f"unsupported factory string {factory_str!r}; supported: Flat, IP, BF16, Flat16, SQ8, "
        f"SQint8, SQ4, SQint4, IVF{{n}},Flat|BF16|SQ8, IVFR{{n}},Flat|BF16|SQ8, and PCA{{d}} / "
        f"PCAR{{d}} in front of any of them (PQ, OPQ and IVF-PQ strings are not ported yet)")
