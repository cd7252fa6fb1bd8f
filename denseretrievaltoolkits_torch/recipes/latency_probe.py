"""Small-batch latency at 2M rows: flat serve vs IVF bulk vs the per-query probe mode.

Twin of the JAX package's ``recipes/latency_probe.py``. At ``LAT_DOCS`` rows of
the clustered mixture (``recipes/bench_data.py``) it measures the p50 ms of a
search at B = 1, 8 and 64 for three structures, built one after another:

- flat int8 serve: K7 builds the rows in 500,000-row chunks, then K8's int8
  body at J = 4 on 2048-row blocks, the queries padded to max(8, B);
- ``IVFRaggedIndex`` int8 (``LAT_NLIST`` cells, ``LAT_NPROBE`` probes) bulk: K14
  and its side scan (K8);
- ``IVFFlatIndex`` ``mode="probe"`` on the same centroids: the per-query gathered
  scoring, plain PyTorch as the reference's einsum.

    python -m denseretrievaltoolkits_torch.recipes.latency_probe [--device cuda]

Prints the bodies each search ran, then one JSON line
``{"n_docs", "nlist", "nprobe", "p50_ms": {"1": {"flat", "bulk", "probe"}, ...}}``;
:func:`main` returns it, with each arm's ids of the 64-query batch under
``"ids"``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from . import bench_data as bd

BATCHES = (1, 8, 64)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    from ..device import resolve_device
    from ..index.ivf import IVFFlatIndex, IVFRaggedIndex

    n_docs = int(os.environ.get("LAT_DOCS", 2_000_000))
    nlist = int(os.environ.get("LAT_NLIST", 256))
    nprobe = int(os.environ.get("LAT_NPROBE", 8))
    device = resolve_device(args.device, "latency_probe")
    centers = bd.make_centers(device)
    q_np = bd.clustered_chunk(centers, 10**9, 64).cpu().numpy()
    out = {str(b): {} for b in BATCHES}
    ids = {}
    before = bd.counters()

    # arm 1: flat int8 serve (K7 build, K8 int8 body at J = 4)
    block = 2048
    n = n_docs + ((-n_docs) % block)
    values = torch.zeros((n, bd.DIM), dtype=torch.int8, device=device)
    scales = torch.ones((n,), dtype=torch.float32, device=device)
    from ..ops.quant import quantize_int8_device

    for off in range(0, n, 500_000):
        r = min(500_000, n - off)
        v, s = quantize_int8_device(bd.clustered_chunk(centers, off, r))
        values[off:off + r], scales[off:off + r] = v, s
        del v, s
    for b in BATCHES:
        pad = max(8, b)
        qb = torch.from_numpy(q_np[:pad]).to(device=device, dtype=torch.bfloat16)
        fn = lambda qb=qb: bd.serve_topj(qb, values, scales, bd.TOPK, 4, block, n_docs)  # noqa
        ids["flat"] = fn()[1][:b].cpu().numpy()
        out[str(b)]["flat"] = round(bd.p50_latency_ms(fn, device), 2)
        bd.log(f"# flat B={b}: {out[str(b)]['flat']} ms")
    del values, scales
    before = bd.report_bodies("flat", before)

    # arm 2: ragged IVF bulk (K14, side scan K8)
    ragged = IVFRaggedIndex(bd.DIM, nlist=nlist, nprobe=nprobe, dtype="int8", block=2048,
                            device=device)
    ragged.train(bd.clustered_chunk(centers, 2 * 10**9, 262_144), iters=8)
    ragged.add_chunks(lambda s, r: bd.clustered_chunk(centers, s, r), n_docs,
                      chunk_rows=500_000)
    for b in BATCHES:
        ragged._bulk_state = None
        qb = np.ascontiguousarray(q_np[:b])
        ids["bulk"] = ragged.search_bulk(qb, bd.TOPK, nprobe=nprobe)[1]
        out[str(b)]["bulk"] = round(bd.p50_latency_ms(
            lambda qb=qb: ragged.search_bulk(qb, bd.TOPK, nprobe=nprobe), device), 2)
        bd.log(f"# bulk B={b}: {out[str(b)]['bulk']} ms")
    cents = ragged.centroids
    del ragged
    before = bd.report_bodies("bulk", before)

    # arm 3: the per-query probe mode on the fixed-capacity layout, same centroids
    probe_idx = IVFFlatIndex(bd.DIM, nlist=nlist, nprobe=nprobe, dtype="int8", device=device)
    probe_idx.centroids = cents
    probe_idx.add_chunks(lambda s, r: bd.clustered_chunk(centers, s, r), n_docs,
                         chunk_rows=500_000)
    for b in BATCHES:
        qb = np.ascontiguousarray(q_np[:b])
        ids["probe"] = probe_idx.search(qb, bd.TOPK, mode="probe", nprobe=nprobe)[1]
        out[str(b)]["probe"] = round(bd.p50_latency_ms(
            lambda qb=qb: probe_idx.search(qb, bd.TOPK, mode="probe", nprobe=nprobe),
            device), 2)
        bd.log(f"# probe B={b}: {out[str(b)]['probe']} ms")
    bd.report_bodies("probe", before)
    result = {"n_docs": n_docs, "nlist": nlist, "nprobe": nprobe, "p50_ms": out}
    print(json.dumps(result), flush=True)
    return dict(result, ids=ids)


if __name__ == "__main__":
    main()
