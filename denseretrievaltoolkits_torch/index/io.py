"""Index deserialization dispatch.

Counterpart of ``denseretrievaltoolkits_tpu/index/io.py``, the role of
``faiss.read_index``: every index class writes its own layout (flat and IVF:
``path.npz`` + ``path.meta.json``, whose ``kind`` names the class;
transformed chains: a directory with ``transformed_meta.json``), and
:func:`load_index` restores whichever lives at ``path``. The
product-quantized kinds (``pq``, ``ivfpq``) are not ported yet and raise.
"""

from __future__ import annotations

import json
import os

from .flat import PQ_ITEM, FlatIPIndex


def load_index(path: str, device=None):
    """Load a saved index of any ported kind (flat fp32 / bf16 / int8 / int4,
    ``ivf``, ``ivfr``, or a transformed chain) onto ``device``: the CUDA card
    unless the caller names another."""
    if os.path.isdir(path) and os.path.exists(os.path.join(path, "transformed_meta.json")):
        from .transforms import TransformedIndex

        return TransformedIndex.load(path, device=device)
    meta_path = path + ".meta.json"
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no index found at {path!r}")
    with open(meta_path) as fh:
        kind = json.load(fh).get("kind")
    if kind in ("pq", "ivfpq"):
        raise NotImplementedError(f"the {kind!r} index at {path!r} {PQ_ITEM}")
    if kind == "ivfr":
        from .ivf import IVFRaggedIndex

        return IVFRaggedIndex.load(path, device=device)
    if kind == "ivf":
        from .ivf import IVFFlatIndex

        return IVFFlatIndex.load(path, device=device)
    return FlatIPIndex.load(path, device=device)
