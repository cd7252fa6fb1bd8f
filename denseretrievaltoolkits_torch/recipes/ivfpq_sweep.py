"""nprobe sweep of the OPQ-chained IVF-PQ at ``BENCH_DOCS_INT8`` rows (8.8M by default).

Twin of the JAX package's ``recipes/ivfpq_sweep.py``. It builds
``OPQ192x4,IVF{BENCH_IVFPQ_NLIST},PQ192x4`` (``bulk_j`` ``BENCH_IVFPQ_J`` 8,
``max_hot`` ``BENCH_IVFPQ_MAXHOT`` 16, 2048-row blocks) over the spectrumed
mixture (``recipes/bench_data.py``) once, then walks nprobe in {8, 16, 32, 64}:

- the reference: ``bench_data.spec_reference`` (K7 builds the int8 rows, K8 int8
  ranks them at J = 16; the qps denominator at J = 4);
- the OPQ rotation, the centroids, the codebooks and the assignment come from
  the twins' cache (``bench_data.CACHE_DIR``) when it has them, else they are
  trained on ``bench_data.pq_sample`` and cached;
- each search: K17 over the probed cells and its side scan (K8).

    python -m denseretrievaltoolkits_torch.recipes.ivfpq_sweep [--device cuda]

Prints the bodies each search ran, then one JSON line an nprobe, with the
JAX file's keys: ``metric``, ``qps``, ``recall10in100``, ``vs_int8_serve``.
:func:`main` returns the lines.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import bench_data as bd

NPROBES = (8, 16, 32, 64)


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    from ..device import resolve_device
    from ..index.ivf_pq import IVFPQIndex

    device = resolve_device(args.device, "ivfpq_sweep")
    centers = bd.make_centers(device)
    n_docs = bd.N_DOCS_INT8
    before = bd.counters()
    spec = bd.spec_reference(centers)
    ref10 = spec["ref_ids"][:, :10]
    q_np = spec["q_np"]
    before = bd.report_bodies("reference", before)

    nlist = int(os.environ.get("BENCH_IVFPQ_NLIST", 256))
    tag = "ivfpq_opq192x4"
    rot = np.asarray(bd.opq_rotation(centers, 192, 4), np.float32)
    rot_dev = torch.from_numpy(rot).to(device)

    idx = IVFPQIndex(bd.DIM, nlist=nlist, nprobe=32, M=192, nbits=4, block=2048, device=device)
    idx.bulk_j = int(os.environ.get("BENCH_IVFPQ_J", 8))
    idx.max_hot = int(os.environ.get("BENCH_IVFPQ_MAXHOT", 16))
    cached = bd.cache_get(f"{tag}_train_v1_nlist{nlist}")
    if cached is not None:
        idx.centroids = torch.from_numpy(cached["centroids"]).to(device)
        idx.codebooks = cached["codebooks"]
        idx._set_codebooks()
    else:
        idx.train(torch.as_tensor(bd.pq_sample(centers)).to(device) @ rot_dev, iters=8)
        bd.cache_put(f"{tag}_train_v1_nlist{nlist}",
                     centroids=idx.centroids.cpu().numpy(), codebooks=idx.codebooks)

    def spec_chunk(s, r):
        return bd.spectrumed_chunk(centers, s, r) @ rot_dev

    akey = f"{tag}_assign_v1_nlist{nlist}_n{n_docs}"
    acache = bd.cache_get(akey)
    t0 = time.perf_counter()
    idx.add_chunks(spec_chunk, n_docs, chunk_rows=500_000,
                   assign=acache["assign"] if acache is not None else None)
    bd.sync(device)
    bd.log(f"# build {time.perf_counter() - t0:.0f}s (warm={acache is not None})")
    if acache is None:
        bd.cache_put(akey, assign=idx.last_assign)

    q_rot_np = np.asarray(q_np @ rot, np.float32)
    q_dev = torch.from_numpy(q_rot_np).to(device)
    lines = []
    for nprobe in NPROBES:
        _, doc_np = idx.search_bulk(q_rot_np, bd.TOPK, nprobe=nprobe)
        rec = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(doc_np, ref10)]))
        el, _ = bd.best_seconds(lambda: idx.search_bulk_async(q_dev, bd.TOPK, nprobe=nprobe),
                                device, repeats=3, calls=3)
        before = bd.report_bodies(f"nprobe {nprobe}", before)
        line = {"metric": f"ivfpq_opq192x4_nprobe{nprobe}_{n_docs // 1000}k",
                "qps": round(len(q_np) / el, 1), "recall10in100": round(rec, 4),
                "vs_int8_serve": round((len(q_np) / el) / spec["int8_qps"], 2)}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
