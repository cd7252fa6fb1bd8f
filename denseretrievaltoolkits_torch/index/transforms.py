"""Vector transforms in front of an index: the factory's ``PCA{d}``, ``PCAR{d}`` and ``OPQ{M}``.

Counterpart of ``denseretrievaltoolkits_tpu/index/transforms.py``. The
transform is one matmul: trained by a blockwise covariance on the device
and a host ``eigh`` of the [dim, dim] result. As in the reference it is a
pure orthogonal projection (no centering: inner products are the metric),
exact when d == dim; PCAR rotates the projection by a random orthogonal
matrix (numpy, from ``seed``) so variance spreads over the components, which
per-row quantization of the output wants. :class:`TransformedIndex` chains
the transform in front of any index at the reduced dimension: codecs train
on transformed rows, queries are transformed at search time, and
``add_chunks`` applies the transform chunk by chunk. ``save`` / ``load``:
the reference's directory (``transform.npz``, ``transformed_meta.json``,
``inner``). :class:`OPQTransform` learns a rotation for a PQ inner index
(the factory's ``OPQ{M}``).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device


class PCATransform:
    """Orthogonal projection dim -> d_out, with a random rotation when
    ``rotate`` (PCAR). ``train`` fits it to sample rows; ``apply`` is one
    matmul on ``device`` (CUDA by default)."""

    def __init__(self, dim: int, d_out: int, rotate: bool = True, seed: int = 0, device=None):
        if d_out > dim:
            raise ValueError(f"d_out {d_out} > dim {dim}")
        self.dim = dim
        self.d_out = d_out
        self.rotate = rotate
        self.seed = seed
        self.device = resolve_device(device, "PCATransform")
        self.matrix: Optional[np.ndarray] = None  # [dim, d_out] fp32
        self._matrix_d: Optional[torch.Tensor] = None

    @property
    def is_trained(self) -> bool:
        return self.matrix is not None

    def _set(self, matrix: np.ndarray) -> None:
        self.matrix = np.ascontiguousarray(matrix, np.float32)
        self._matrix_d = torch.from_numpy(self.matrix).to(self.device)

    def train(self, reps, block: int = 65536) -> None:
        """The top-``d_out`` eigenvectors of the uncentered covariance of
        ``reps`` (host or device rows), descending, then the PCAR rotation."""
        if reps.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}] rows, got {tuple(reps.shape)}")
        cov = torch.zeros((self.dim, self.dim), dtype=torch.float32, device=self.device)
        for start in range(0, reps.shape[0], block):
            x = torch.as_tensor(np.asarray(reps[start:start + block], np.float32)
                                if isinstance(reps, np.ndarray) else reps[start:start + block])
            x = x.to(device=self.device, dtype=torch.float32)
            cov += torch.matmul(x.T, x)
        _, eigvecs = np.linalg.eigh(cov.cpu().numpy())
        w = eigvecs[:, ::-1][:, :self.d_out]
        if self.rotate:
            g = np.random.default_rng(self.seed).standard_normal((self.d_out, self.d_out))
            q, r = np.linalg.qr(g)
            w = w @ (q * np.sign(np.diag(r)))  # unique, det-stable rotation
        self._set(w)

    def apply(self, x) -> torch.Tensor:
        """x [n, dim] (host or device) -> [n, d_out] fp32 on the device."""
        if not self.is_trained:
            raise RuntimeError("PCATransform.apply before train()")
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.float32)
        return torch.matmul(x, self._matrix_d)

    def save(self, path: str) -> None:
        np.savez(path, matrix=self.matrix,
                 meta=np.array([self.dim, self.d_out, int(self.rotate), self.seed], np.int64))

    @classmethod
    def load(cls, path: str, device=None) -> "PCATransform":
        with np.load(path) as data:
            dim, d_out, rotate, seed = (int(v) for v in data["meta"])
            t = cls(dim, d_out, rotate=bool(rotate), seed=seed, device=device)
            t._set(data["matrix"])
        return t


class OPQTransform(PCATransform):
    """The learned OPQ rotation (FAISS ``OPQ{M}``; transforms.py:90-135 of the
    JAX package): the OPQ-NP alternation (Ge et al., CVPR'13) from a random
    orthogonal start (the QR of ``default_rng(seed).standard_normal``), each
    of ``rounds`` rounds fitting PQ codebooks to the rotated sample
    (``pq_train``, seed + round, ``kmeans_iters`` iterations), encoding and
    decoding it, and taking the orthogonal Procrustes rotation U V^T of the
    host SVD of X^T X_hat. The sample is capped at 65,536 rows. At apply
    time it is one matmul, saved in ``PCATransform``'s format."""

    def __init__(self, dim: int, M: int, seed: int = 0, rounds: int = 6, kmeans_iters: int = 4,
                 nbits: int = 8, device=None):
        super().__init__(dim, dim, rotate=True, seed=seed, device=device)
        self.M = M
        self.rounds = rounds
        self.kmeans_iters = kmeans_iters
        self.nbits = nbits

    def train(self, reps, block: int = 65536) -> None:
        from ..ops.pq import pq_decode, pq_encode_device, pq_train

        if reps.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}] rows, got {tuple(reps.shape)}")
        n_cap = min(int(reps.shape[0]), 65536)
        xd = torch.as_tensor(np.asarray(reps[:n_cap], np.float32) if isinstance(reps, np.ndarray)
                             else reps[:n_cap]).to(device=self.device, dtype=torch.float32)
        g = np.random.default_rng(self.seed).standard_normal((self.dim, self.dim))
        q, r = np.linalg.qr(g)
        rot = np.ascontiguousarray(q * np.sign(np.diag(r)), np.float32)
        for t in range(self.rounds):
            xr = torch.matmul(xd, torch.from_numpy(rot).to(self.device))
            cb = pq_train(xr, self.M, iters=self.kmeans_iters, seed=self.seed + t,
                          block_rows=min(2048, n_cap), k=1 << self.nbits)
            cb_d = torch.from_numpy(cb).to(self.device)
            xhat = pq_decode(pq_encode_device(xr, cb_d), cb_d)
            u, _, vt = np.linalg.svd(torch.matmul(xd.T, xhat).cpu().numpy())
            rot = np.ascontiguousarray(u @ vt, np.float32)
        self._set(rot)


class TransformedIndex:
    """A transform in front of any index built at the reduced dimension
    (FAISS "PCAR64,SQ8"): the inner index trains on transformed rows, and
    queries are transformed at search time."""

    def __init__(self, transform: PCATransform, inner):
        self.transform = transform
        self.inner = inner

    def __len__(self):
        return len(self.inner)

    @property
    def dim(self):
        return self.transform.dim

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def docid(self):
        return self.inner.docid

    @docid.setter
    def docid(self, value):
        self.inner.docid = value

    @property
    def is_trained(self) -> bool:
        return self.transform.is_trained and getattr(self.inner, "is_trained", True)

    def train(self, reps, **kw) -> None:
        if not self.transform.is_trained:
            self.transform.train(reps)
        if hasattr(self.inner, "train"):
            self.inner.train(self.transform.apply(reps), **kw)

    def _check(self, what: str) -> None:
        if not self.transform.is_trained:
            raise RuntimeError(f"TransformedIndex.{what} before train()")

    def add(self, reps) -> None:
        self._check("add")
        self.inner.add(self.transform.apply(reps).cpu().numpy())

    def add_device(self, reps) -> None:
        self._check("add_device")
        self.inner.add_device(self.transform.apply(reps))

    def add_chunks(self, chunk_fn, n_rows: int, chunk_rows: int = 500_000) -> None:
        """The chunked build, the transform applied per chunk, so device
        memory holds one chunk at both widths, never the corpus. A flat inner
        index takes each transformed chunk as one ``add_device`` slab."""
        self._check("add_chunks")

        def transformed(start, rows):
            return self.transform.apply(chunk_fn(start, rows))

        if hasattr(self.inner, "add_chunks"):
            self.inner.add_chunks(transformed, n_rows, chunk_rows=chunk_rows)
        else:
            for start in range(0, int(n_rows), chunk_rows):
                self.inner.add_device(transformed(start, min(chunk_rows, int(n_rows) - start)))

    def search(self, q_reps, k: int = 1000, **kw) -> Tuple[np.ndarray, np.ndarray]:
        return self.inner.search(self.transform.apply(q_reps), k, **kw)

    def batch_search(self, q_reps, k: int, batch_size: int, quiet: bool = False, **kw):
        all_s, all_i = [], []
        for start in range(0, q_reps.shape[0], batch_size):
            s, i = self.search(q_reps[start:start + batch_size], k, **kw)
            all_s.append(s)
            all_i.append(i)
        return np.concatenate(all_s), np.concatenate(all_i)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        self.transform.save(os.path.join(path, "transform.npz"))
        with open(os.path.join(path, "transformed_meta.json"), "w") as fh:
            json.dump({"inner_type": type(self.inner).__name__}, fh)
        self.inner.save(os.path.join(path, "inner"))

    @classmethod
    def load(cls, path: str, device=None) -> "TransformedIndex":
        """The transform and, through ``io.load_index``'s dispatch on the
        saved kind, the inner index, on ``device``."""
        from .io import load_index

        transform = PCATransform.load(os.path.join(path, "transform.npz"), device=device)
        return cls(transform, load_index(os.path.join(path, "inner"), device=device))
