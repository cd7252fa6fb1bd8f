"""PCAR384,SQ4 at 38M rows on one card, against a slab-streamed exact reference.

Twin of the JAX package's ``recipes/bench_pcar_38m.py``. ``PCAR38M_DOCS`` (38M),
``PCAR38M_QUERIES`` (1024) and ``PCAR38M_SLAB`` (4M) as there. On the spectrumed
mixture (``recipes/bench_data.py``):

- the exact reference streams the int8 rows through the card a slab at a time
  (K7 in 500,000-row chunks, K8 int8 at J = 16 on 2048-row blocks), each slab's
  top-100 pulled to the host and merged by score; 38M x 768 int8 would fit an
  80 GB card, but the recipe is the streaming;
- the PCA fit on the 262,144-row sample (fewer for a small N: N / 8, at least
  4096), the int4 corpus by K9, serve (K11) and i8q (K12 sq4) at J = 4.

    python -m denseretrievaltoolkits_torch.recipes.bench_pcar_38m [--device cuda]

Prints the bodies each search ran, then one JSON line with the JAX file's keys
(``n_docs``, ``n_queries``, ``dout``, ``hbm_gb``, ``pca_kept_variance``,
``build_s``, ``serve`` / ``i8q``: ``qps``, ``recall100``); :func:`main` returns it,
with the reference's ids under ``"ref_ids"``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from . import bench_data as bd
from .bench_pcar_sq4 import BLOCK, DOUT, pcar_sq4_arms


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    from ..device import resolve_device
    from ..index.transforms import PCATransform

    n = int(os.environ.get("PCAR38M_DOCS", 38_000_000))
    nq = int(os.environ.get("PCAR38M_QUERIES", 1024))
    slab = int(os.environ.get("PCAR38M_SLAB", 4_000_000))
    device = resolve_device(args.device, "bench_pcar_38m")
    centers = bd.make_centers(device)
    q_np = bd.spectrumed_chunk(centers, 10**9, nq).cpu().numpy()
    q8 = torch.from_numpy(q_np).to(device=device, dtype=torch.bfloat16)
    before = bd.counters()
    _, ref_ids = bd.slab_reference(centers, q8, n, slab, block=BLOCK)
    bd.report_bodies("slab reference", before)

    sample = bd.spectrumed_chunk(centers, 2 * 10**9, min(262_144, max(4096, n // 8)))
    pca = PCATransform(bd.DIM, DOUT, rotate=True, device=device)
    pca.train(sample)
    W = torch.from_numpy(pca.matrix).to(device)
    kept = float(torch.sum(torch.var(sample @ W, dim=0)) / torch.sum(torch.var(sample, dim=0)))
    del sample
    bd.log(f"# pca kept variance {kept:.4f}")
    arms = pcar_sq4_arms(centers, W, ref_ids, q_np, n, "pcar384-sq4")
    bd.log(f"# serve: {arms['serve']['qps']:.0f} qps recall@100 {arms['serve']['recall100']:.4f}")
    bd.log(f"# i8q:   {arms['i8q']['qps']:.0f} qps recall@100 {arms['i8q']['recall100']:.4f}")
    result = {"n_docs": n, "n_queries": nq, "dout": DOUT, "hbm_gb": round(arms["hbm_gb"], 2),
              "pca_kept_variance": round(kept, 4), "build_s": round(arms["build_s"], 1),
              "serve": {k: round(v, 4 if k == "recall100" else 1)
                        for k, v in arms["serve"].items()},
              "i8q": {k: round(v, 4 if k == "recall100" else 1) for k, v in arms["i8q"].items()}}
    print(json.dumps(result), flush=True)
    return dict(result, ref_ids=ref_ids, matrix=pca.matrix)


if __name__ == "__main__":
    main()
