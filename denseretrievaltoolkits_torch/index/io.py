"""Index deserialization dispatch (flat indexes only).

Counterpart of ``denseretrievaltoolkits_tpu/index/io.py``. The trained index
kinds (IVF, PQ, IVF-PQ, transformed chains) are not ported yet and raise.
"""

from __future__ import annotations

import json
import os

from .flat import FlatIPIndex


def load_index(path: str, device=None) -> FlatIPIndex:
    """Load a saved flat index (``path.npz`` + ``path.meta.json``, fp32,
    bf16 or the native int8 / packed int4 payload) onto ``device``: the CUDA
    card unless the caller names another."""
    if os.path.isdir(path) and os.path.exists(os.path.join(path, "transformed_meta.json")):
        raise NotImplementedError(
            "transformed indexes (PCA/OPQ chains) are not ported yet "
            "(ROADMAP queue 1, item 'Trained indexes')")
    meta_path = path + ".meta.json"
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no index found at {path!r}")
    with open(meta_path) as fh:
        kind = json.load(fh).get("kind")
    if kind is not None:
        raise NotImplementedError(
            f"{kind!r} indexes are not ported yet (ROADMAP queue 1, item 'Trained indexes')")
    return FlatIPIndex.load(path, device=device)
