"""PCAR384,SQ4 at 8.8M rows: 384 dims x 4 bits of the 768-dim spectrumed mixture.

Twin of the JAX package's ``recipes/bench_pcar_sq4.py``, which runs at import at
a fixed N; here :func:`main` takes ``--docs`` (default 8,800,000); 2048
queries as there. On the spectrumed mixture (``recipes/bench_data.py``):

1. the int8 reference over the 768-dim rows: K7 in 500,000-row chunks, then K8
   int8 at J = 16 (the ranking) and J = 4 (the serve rate, the denominator);
2. ``PCATransform(768, 384, rotate=True)`` fitted on the 262,144-row sample;
3. the transformed corpus quantized to packed int4 by K9;
4. serve: K11 (bf16 queries) at J = 4; i8q: ``quantize_queries`` (K7), then K12's
   sq4 body at J = 4. Recall@100 of each against the int8 reference.

    python -m denseretrievaltoolkits_torch.recipes.bench_pcar_sq4 [--docs N] [--device cuda]

Prints the JAX file's lines (``ref ranking done``, ``int8 serve``, ``pca train``,
``pcar-sq4 corpus built``, ``pcar384-sq4 serve``, ``pcar384-sq4 native``) and the
bodies each search ran; :func:`main` returns the readings.
"""

from __future__ import annotations

import argparse
import time

import torch

from . import bench_data as bd

DOUT = 384
BLOCK = 2048
NQ = 2048


def build_int4(centers: torch.Tensor, matrix: torch.Tensor, n_pad: int, chunk: int = 500_000):
    """The spectrumed rows [0, n_pad) times ``matrix``, quantized to packed int4 by
    K9 a chunk at a time: ([n_pad, DOUT / 2] int8, [n_pad] fp32 scales)."""
    from ..ops.quant import quantize_int4_device

    d_out = matrix.shape[1]
    v4 = torch.zeros((n_pad, d_out // 2), dtype=torch.int8, device=centers.device)
    s4 = torch.ones((n_pad,), dtype=torch.float32, device=centers.device)
    for off in range(0, n_pad, chunk):
        rows = min(chunk, n_pad - off)
        v, s = quantize_int4_device(bd.spectrumed_chunk(centers, off, rows) @ matrix)
        v4[off:off + rows], s4[off:off + rows] = v, s
        del v, s
    return v4, s4


def pcar_sq4_arms(centers, matrix, ref_ids, q_np, n, tag):
    """Build the PCAR384,SQ4 corpus of ``matrix`` over n rows, then time serve (K11)
    and i8q (K12 sq4) at J = 4 and hold their top-100 to ``ref_ids``:
    {"build_s", "serve": {"qps", "recall100"}, "i8q": {...}}."""
    from ..ops.quant import quantize_queries

    device = centers.device
    n_pad = n + ((-n) % BLOCK)
    t0 = time.perf_counter()
    v4, s4 = build_int4(centers, matrix, n_pad)
    bd.sync(device)
    out = {"build_s": time.perf_counter() - t0, "hbm_gb": n_pad * (DOUT // 2 + 4) / 2**30}
    print(f"pcar-sq4 corpus built {tuple(v4.shape)}", flush=True)
    qt_f = torch.from_numpy(q_np).to(device) @ matrix
    qt = qt_f.to(torch.bfloat16)
    before = bd.counters()
    el, res = bd.best_seconds(lambda: bd.serve_topj(qt, v4, s4, bd.TOPK, 4, BLOCK, n, int4=True),
                              device)
    out["serve"] = {"qps": len(q_np) / el,
                    "recall100": bd.recall_at(res[1].cpu().numpy(), ref_ids, bd.TOPK)}
    qi, qs = quantize_queries(qt_f)
    el, res = bd.best_seconds(
        lambda: bd.i8q_topj(qi, qs, v4, s4, bd.TOPK, 4, BLOCK, n, int4=True), device)
    out["i8q"] = {"qps": len(q_np) / el,
                  "recall100": bd.recall_at(res[1].cpu().numpy(), ref_ids, bd.TOPK)}
    bd.report_bodies(tag, before)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--docs", type=int, default=8_800_000)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    from ..device import resolve_device
    from ..index.transforms import PCATransform

    device = resolve_device(args.device, "bench_pcar_sq4")
    n, nq = args.docs, NQ
    centers = bd.make_centers(device)
    before = bd.counters()

    # 1) the int8 reference over the 768-dim spectrumed rows
    values, scales = bd.int8_corpus(centers, n, BLOCK)
    q_np = bd.spectrumed_chunk(centers, 10**9, nq).cpu().numpy()
    q = torch.from_numpy(q_np).to(device=device, dtype=torch.bfloat16)
    ref_ids = bd.serve_topj(q, values, scales, bd.TOPK, 16, BLOCK, n)[1].cpu().numpy()
    print("ref ranking done", ref_ids.shape, flush=True)
    el8, out = bd.best_seconds(lambda: bd.serve_topj(q, values, scales, bd.TOPK, 4, BLOCK, n),
                               device)
    qps8 = nq / el8
    hits8 = bd.recall_at(out[1].cpu().numpy(), ref_ids, bd.TOPK)
    print(f"int8 serve: {qps8:.0f} qps recall {hits8:.4f}", flush=True)
    del values, scales
    bd.report_bodies("int8 reference", before)

    # 2) the PCA fit on the 262,144-row sample
    sample = bd.spectrumed_chunk(centers, 2 * 10**9, 262_144)
    t0 = time.perf_counter()
    pca = PCATransform(bd.DIM, DOUT, rotate=True, device=device)
    pca.train(sample)
    W = torch.from_numpy(pca.matrix).to(device)
    kept = float(torch.sum(torch.var(sample @ W, dim=0)) / torch.sum(torch.var(sample, dim=0)))
    print(f"pca train {time.perf_counter() - t0:.0f}s; kept variance {kept:.4f}", flush=True)
    del sample

    # 3) + 4) the int4 corpus, serve and i8q
    arms = pcar_sq4_arms(centers, W, ref_ids, q_np, n, "pcar384-sq4")
    for name, label in (("serve", "serve"), ("i8q", "native")):
        a = arms[name]
        print(f"pcar384-sq4 {label}: {a['qps']:.0f} qps ({a['qps'] / qps8:.2f}x int8-serve) "
              f"recall@100 {a['recall100']:.4f}", flush=True)
    return {"n_docs": n, "n_queries": nq, "int8_qps": qps8, "int8_recall": hits8,
            "pca_kept_variance": kept, "ref_ids": ref_ids, "matrix": pca.matrix,
            "q_np": q_np, **arms}


if __name__ == "__main__":
    main()
