"""OPQ192x4 at 100M rows on one card (96 B a row), against a slab-streamed exact reference.

Twin of the JAX package's ``recipes/pq_capacity.py``, with its environment knobs:
``PQCAP_DOCS`` (100M), ``PQCAP_QUERIES`` (256), ``PQCAP_SLAB`` (4M), ``PQCAP_CHUNK``
(2M), ``PQCAP_IVFPQ`` (1: run the IVF-PQ arm), ``PQCAP_NLIST`` (1024),
``PQCAP_NPROBE`` (64), ``PQCAP_NPROBES`` (comma list, default the nprobe),
``PQCAP_J`` (8), ``PQCAP_MAXHOT`` (16). On the spectrumed mixture
(``recipes/bench_data.py``):

1. the exact int8 reference, slab-streamed (K7 in ``PQCAP_CHUNK`` chunks, K8 int8
   at J = 16 on 2048-row blocks, merged on the host);
2. the OPQ192x4 rotation (``bench_data.opq_rotation``: trained on the 262,144-row
   sample, or the twins' cache) and 16-entry codebooks (``pq_train``, 8 iterations)
   of the rotated sample;
3. ``pq_encode_device`` of every row into nibble-packed ``[96, n]`` codes;
4. the 4-bit PQ serve: K15 at the reference's J (a Poisson rule over the 2048-row
   blocks, pq_capacity.py:135-138 there); recall10@100 against the reference;
5. the IVF-PQ arm, ``OPQ192x4,IVF{nlist},PQ192x4`` on the same rotation: K17 and its
   side scan.

    python -m denseretrievaltoolkits_torch.recipes.pq_capacity [--device cuda]

Prints the bodies each search ran and the JAX file's JSON lines (``metric``,
``value``, ``unit``, ``recall10in100``, ...); :func:`main` returns them.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from . import bench_data as bd

M = 192  # 4-bit subquantizers: 96 packed bytes a row
BLOCK = 2048


def serve_j(n_pad: int, k: int = bd.TOPK) -> int:
    """The serve J over 2048-row blocks (pq_capacity.py:135-138 there)."""
    lam = k / (n_pad // BLOCK)
    return max(4, int(math.ceil(lam + 4.0 * math.sqrt(lam) + 4.0)))


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    from ..device import resolve_device
    from ..ops import pq as pq_ops
    from ..ops.topk import _top

    n = int(os.environ.get("PQCAP_DOCS", 100_000_000))
    nq = int(os.environ.get("PQCAP_QUERIES", 256))
    slab = int(os.environ.get("PQCAP_SLAB", 4_000_000))
    chunk = int(os.environ.get("PQCAP_CHUNK", 2_000_000))
    device = resolve_device(args.device, "pq_capacity")
    centers = bd.make_centers(device)
    q_np = bd.spectrumed_chunk(centers, 10**9, nq).cpu().numpy()
    q_bf = torch.from_numpy(q_np).to(device=device, dtype=torch.bfloat16)
    lines = []
    before = bd.counters()

    # 1) the slab-streamed exact int8 reference
    t_ref = time.perf_counter()
    _, best_i = bd.slab_reference(centers, q_bf, n, slab, block=BLOCK, chunk=chunk)
    ref10 = best_i[:, :10]
    t_ref = time.perf_counter() - t_ref
    before = bd.report_bodies("slab reference", before)

    # 2) the OPQ rotation and the 4-bit codebooks of the rotated sample
    t_train = time.perf_counter()
    sample = torch.as_tensor(bd.pq_sample(centers)).to(device)
    rot_np = np.asarray(bd.opq_rotation(centers, M, 4), np.float32)
    rot = torch.from_numpy(rot_np).to(device)
    cb = pq_ops.pq_train(sample @ rot, M, iters=8, k=16)
    cb_dev = torch.from_numpy(cb).to(device)
    table = pq_ops.bdcb_table(pq_ops.build_bdcb(cb), k=16)[0].to(device)
    t_train = time.perf_counter() - t_train

    # 3) the codes, a chunk of rows at a time
    t_enc = time.perf_counter()
    n_pad = n + ((-n) % BLOCK)
    codes = torch.zeros((M // 2, n_pad), dtype=torch.int8, device=device)
    for off in range(0, n, chunk):
        r = min(chunk, n - off)
        codes[:, off:off + r] = pq_ops.pq_encode_device(
            bd.spectrumed_chunk(centers, off, r) @ rot, cb_dev)
        if (off // chunk + 1) % 10 == 0:
            bd.log(f"# encoded {(off + r) // 1_000_000}M/{n // 1_000_000}M "
                   f"({time.perf_counter() - t_enc:.0f}s)")
    bd.sync(device)
    t_enc = time.perf_counter() - t_enc

    # 4) the 4-bit PQ serve (K15) and its window recall
    J = serve_j(n_pad)
    q_rot = (torch.from_numpy(q_np).to(device) @ rot).to(torch.bfloat16)

    def serve():
        vals, ids = pq_ops.pq_topj_blocks(q_rot, codes, table, J, BLOCK, n, nbits=4)
        return _top(vals, ids, bd.TOPK)

    el, res = bd.best_seconds(serve, device, repeats=3, calls=3)
    recall = float(np.mean([len(set(a) & set(b)) / 10
                            for a, b in zip(res[1].cpu().numpy(), ref10)]))
    before = bd.report_bodies(f"pq serve J={J}", before)
    line = {"metric": f"opq192x4_qps_{n // 1000}k_docs_top{bd.TOPK}",
            "value": round(nq / el, 1), "unit": "qps", "recall10in100": round(recall, 4),
            "hbm_codes_gb": round(n_pad * M // 2 / 2**30, 2), "ref_pass_s": round(t_ref),
            "train_s": round(t_train), "encode_s": round(t_enc)}
    print(json.dumps(line), flush=True)
    lines.append(line)

    # 5) the IVF-PQ arm on the same rotation and reference
    if os.environ.get("PQCAP_IVFPQ", "1") != "1":
        return lines
    del codes
    from ..index.ivf_pq import IVFPQIndex

    nlist = int(os.environ.get("PQCAP_NLIST", 1024))
    nprobe = int(os.environ.get("PQCAP_NPROBE", 64))
    idx = IVFPQIndex(bd.DIM, nlist=nlist, nprobe=nprobe, M=M, nbits=4, block=BLOCK,
                     device=device)
    idx.bulk_j = int(os.environ.get("PQCAP_J", 8))
    idx.max_hot = int(os.environ.get("PQCAP_MAXHOT", 16))
    t_train2 = time.perf_counter()
    idx.train(sample @ rot, iters=8)
    t_train2 = time.perf_counter() - t_train2
    t_build = time.perf_counter()
    idx.add_chunks(lambda s, r: bd.spectrumed_chunk(centers, s, r) @ rot, n, chunk_rows=chunk)
    bd.sync(device)
    t_build = time.perf_counter() - t_build
    bd.log(f"# ivfpq build {t_build:.0f}s blocks={int(idx._block_cell.shape[0])}")
    q_rot_np = np.asarray(q_np @ rot_np, np.float32)
    q_dev = torch.from_numpy(q_rot_np).to(device)
    for np_ in [int(p) for p in os.environ.get("PQCAP_NPROBES", str(nprobe)).split(",")]:
        _, doc_np = idx.search_bulk(q_rot_np, bd.TOPK, nprobe=np_)
        rec_ivf = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(doc_np, ref10)]))
        el2, _ = bd.best_seconds(lambda: idx.search_bulk_async(q_dev, bd.TOPK, nprobe=np_),
                                 device, repeats=3, calls=3)
        before = bd.report_bodies(f"ivfpq nprobe {np_}", before)
        line = {"metric": f"ivfpq_opq{M}x4_qps_{n // 1000}k_docs_top{bd.TOPK}",
                "value": round(nq / el2, 1), "unit": "qps", "recall10in100": round(rec_ivf, 4),
                "nlist": nlist, "nprobe": np_, "vs_flat_opq_qps": round(el / el2, 2),
                "train_s": round(t_train2), "build_s": round(t_build)}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
