"""The benchmark helpers the hardware recipes share, rewritten in torch.

The port's own copies of what the JAX package's recipes take from its root
``bench.py`` (never imported here): the constants (bench.py:58-72, 271-272,
313), the clustered mixture (:306-362), the host-clock timers (:177-186,
288-303), the spectrumed sample and OPQ rotation (:790-816), the exact int8
reference over the spectrumed mixture (:732-787), the disk cache (:116-140) and
the bert-base model (:1235-1245).

The mixture: ``NCOMP_IVF`` centres N(0, 1) drawn from seed 77, rows ``centre +
IVF_SIGMA * N(0, 1)``, made on the device from explicit ``torch.Generator``s in
fixed ``GEN_GRANULE``-row granules keyed by their start, so any chunking of
[0, N) gives the same rows; a ``start`` >= 1e9 is a free-standing query or
sample block. They are not ``jax.random``'s rows (no generator of one makes
the other's): the CPU tests give both packages the same numpy rows instead.

The cache holds trained state (OPQ rotations, IVF-PQ centroids and codebooks,
assignments) under ``CACHE_DIR`` (``DRT_TORCH_BENCH_CACHE``, default
``.bench_cache_torch/`` beside the package; never the JAX package's
``.bench_cache/``). Every entry is a deterministic function of the seeds, so
reuse across processes is exact.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

DIM = 768
TOPK = 100
N_QUERIES = int(os.environ.get("BENCH_QUERIES", 2048))
N_DOCS_INT8 = int(os.environ.get("BENCH_DOCS_INT8", 8_800_000))
INT8_CHUNK = 500_000  # staging chunk of the int8 corpus builds (a GEN_GRANULE multiple)
NCOMP_IVF = 4096
IVF_SIGMA = 0.5
GEN_GRANULE = 100_000
CENTERS_SEED = 77
ROWS_SEED = 5
SPECTRUM = 0.35  # the spectrumed rows' column scale (d + 1) ** -SPECTRUM
PQ_SAMPLE_ROWS = 262_144

CACHE_DIR = os.environ.get("DRT_TORCH_BENCH_CACHE") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".bench_cache_torch")

_SPEC_STATE: Dict = {}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# -- the clustered mixture -------------------------------------------------------------------


def make_centers(device="cuda") -> torch.Tensor:
    """[NCOMP_IVF, DIM] fp32 centres, N(0, 1) from seed CENTERS_SEED."""
    g = torch.Generator(device=device).manual_seed(CENTERS_SEED)
    return torch.randn(NCOMP_IVF, DIM, generator=g, device=device)


def _block(centers: torch.Tensor, key: int, rows: int) -> torch.Tensor:
    g = torch.Generator(device=centers.device).manual_seed(ROWS_SEED * 10**12 + key)
    which = torch.randint(0, NCOMP_IVF, (rows,), generator=g, device=centers.device)
    return centers[which] + IVF_SIGMA * torch.randn(rows, centers.shape[1], generator=g,
                                                     device=centers.device)


def clustered_chunk(centers: torch.Tensor, start: int, rows: int) -> torch.Tensor:
    """Mixture rows [start, start + rows) on the centres' device (bench.py:316-362's
    contract): made in GEN_GRANULE-row granules keyed by their start, each granule
    whole and sliced, so the rows do not depend on the chunking; ``start`` is
    granule-aligned, or >= 1e9 for a free-standing query or sample block."""
    if start >= 10**9:
        return _block(centers, start, rows)
    if start % GEN_GRANULE:
        raise ValueError(f"clustered_chunk: start {start} is not a multiple of {GEN_GRANULE}")
    out = torch.empty(rows, centers.shape[1], device=centers.device)
    for off in range(start, start + rows, GEN_GRANULE):
        n = min(GEN_GRANULE, start + rows - off)
        out[off - start:off - start + n] = _block(centers, off, GEN_GRANULE)[:n]
    return out


def spectrum(device="cuda") -> torch.Tensor:
    """The column scale (d + 1) ** -0.35 of the spectrumed rows (bench.py:751)."""
    return (torch.arange(DIM, device=device, dtype=torch.float32) + 1.0) ** -SPECTRUM


def spectrumed_chunk(centers: torch.Tensor, start: int, rows: int) -> torch.Tensor:
    return clustered_chunk(centers, start, rows) * spectrum(centers.device)


def pq_sample(centers: torch.Tensor) -> torch.Tensor:
    """The 262,144-row spectrumed training sample (bench.py:790-799), on the
    centres' device, memoized per process."""
    if "sample" not in _SPEC_STATE:
        _SPEC_STATE["sample"] = spectrumed_chunk(centers, 2 * 10**9, PQ_SAMPLE_ROWS)
    return _SPEC_STATE["sample"]


# -- timing --------------------------------------------------------------------------------


def roundtrip(device="cuda") -> float:
    """Seconds of one tiny op and a synchronize, on the host clock (bench.py:177-186):
    the dispatch cost a timed loop subtracts. On a local card it is microseconds."""
    tiny = torch.ones(1, device=device)
    for _ in range(3):
        float(torch.sum(tiny + 1.0))
    t0 = time.perf_counter()
    for _ in range(5):
        float(torch.sum(tiny + 1.0))
    return (time.perf_counter() - t0) / 5


def p50_latency_ms(fn: Callable, device="cuda", n: int = 20) -> float:
    """p50 per-call latency in ms with a synchronize after each call (a serving request
    pays it), less a roundtrip measured just before (bench.py:288-303)."""
    rt = roundtrip(device)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync(device)
        ts.append(time.perf_counter() - t0 - rt)
    return max(0.0, float(np.median(ts)) * 1e3)


def best_seconds(fn: Callable, device="cuda", repeats: int = 3, calls: int = 5):
    """(the best of ``repeats`` mean seconds a call over ``calls`` calls, less a
    roundtrip, the last output), as the recipes time their searches."""
    rt = roundtrip(device)
    best, out = float("inf"), None
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn()
        sync(device)
        best = min(best, max(1e-9, (time.perf_counter() - t0 - rt) / calls))
    return best, out


# -- the searches the recipes call with an explicit J and block ------------------------------


def serve_topj(q: torch.Tensor, values: torch.Tensor, scales: torch.Tensor, k: int, J: int,
               block: int, n_valid: int, int4: bool = False):
    """``pallas_topk_serve_scaled`` / ``_sq4``: K8 (K11 for packed int4 rows) at the
    caller's J and block, then the merge. Returns (scores, ids) [Q, k]."""
    from ..ops import topk

    vals, ids = topk.block_topj_serve(q, values, J, block, n_valid, scales, int4)
    return topk._top(vals, ids, k)


def i8q_topj(qi: torch.Tensor, qs: torch.Tensor, values: torch.Tensor, scales: torch.Tensor,
             k: int, J: int, block: int, n_valid: int, int4: bool = False):
    """``pallas_topk_serve_sq4_i8q`` (and its int8 twin): K12 at the caller's J and block."""
    from ..ops import topk

    vals, ids = topk.block_topj_i8q(qi, qs, values, scales, J, block, n_valid, int4)
    return topk._top(vals, ids, k)


def recall_at(ids, ref_ids, k: int) -> float:
    """The mean share of each query's reference top-k found in its top-k."""
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    return float(np.mean([len(set(a[:k]) & set(b[:k])) / k for a, b in zip(ids, ref_ids)]))


def int8_corpus(centers: torch.Tensor, n: int, block: int, chunk: int = INT8_CHUNK,
                start: int = 0):
    """The spectrumed rows [start, start + n) quantized by K7 a chunk at a time into
    a [n padded to ``block``, DIM] int8 store and its scales; the padding rows are
    the mixture's next rows (masked by the searches' n_valid), as the reference
    builds them."""
    from ..ops.quant import quantize_int8_device

    n_pad = n + ((-n) % block)
    values = torch.zeros((n_pad, DIM), dtype=torch.int8, device=centers.device)
    scales = torch.ones((n_pad,), dtype=torch.float32, device=centers.device)
    for off in range(0, n_pad, chunk):
        rows = min(chunk, n_pad - off)
        v, s = quantize_int8_device(spectrumed_chunk(centers, start + off, rows))
        values[off:off + rows] = v
        scales[off:off + rows] = s
        del v, s
    return values, scales


def slab_reference(centers: torch.Tensor, q: torch.Tensor, n: int, slab: int, k: int = TOPK,
                   block: int = 2048, chunk: int = INT8_CHUNK, J: int = 16, tag: str = "ref"):
    """The exact int8 reference of the spectrumed rows [0, n), streamed through the
    device a ``slab`` at a time (bench_pcar_38m.py:66-100): each slab's K7 store and
    its K8 top-k at J, pulled to the host and merged by score. Returns (scores,
    ids) [Q, k] numpy, int64 ids."""
    Q = q.shape[0]
    best_s = np.full((Q, k), -np.inf, np.float32)
    best_i = np.full((Q, k), -1, np.int64)
    t0 = time.perf_counter()
    for lo in range(0, n, slab):
        rows = min(slab, n - lo)
        values, scales = int8_corpus(centers, rows, block, chunk, start=lo)
        s, i = serve_topj(q, values, scales, k, J, block, rows)
        del values, scales
        s = s.float().cpu().numpy()
        i = i.cpu().numpy().astype(np.int64) + lo
        cat_s = np.concatenate([best_s, s], axis=1)
        cat_i = np.concatenate([best_i, i], axis=1)
        take = np.argsort(-cat_s, axis=1, kind="stable")[:, :k]
        best_s = np.take_along_axis(cat_s, take, axis=1)
        best_i = np.take_along_axis(cat_i, take, axis=1)
        log(f"# {tag} slab done @{lo + rows}/{n} ({time.perf_counter() - t0:.0f}s)")
    return best_s, best_i


def spec_reference(centers: torch.Tensor) -> Dict:
    """The exact int8 reference over the spectrumed ``N_DOCS_INT8`` rows
    (bench.py:732-787), once a process: {"q_np": [Q, DIM] fp32, "ref_ids": [Q,
    TOPK], "int8_qps": the serve rate at J = 4}. K7 builds the store in INT8_CHUNK
    chunks, K8 ranks at J = 16 on 2048-row blocks."""
    if "ref_ids" in _SPEC_STATE:
        return _SPEC_STATE
    n, nq, block = N_DOCS_INT8, N_QUERIES, 2048
    values, scales = int8_corpus(centers, n, block)
    q_np = spectrumed_chunk(centers, 10**9, nq).cpu().numpy()
    q = torch.from_numpy(q_np).to(device=centers.device, dtype=torch.bfloat16)
    _, ref_ids = serve_topj(q, values, scales, TOPK, 16, block, n)
    el8, _ = best_seconds(lambda: serve_topj(q, values, scales, TOPK, 4, block, n),
                          centers.device)
    del values, scales
    _SPEC_STATE.update(q_np=q_np, ref_ids=ref_ids.cpu().numpy(), int8_qps=nq / el8)
    log(f"# spectrumed exact-int8 serve reference: {nq / el8:.0f} qps")
    return _SPEC_STATE


def opq_rotation(centers: torch.Tensor, M: int, nbits: int) -> np.ndarray:
    """The OPQ rotation for (M, nbits) trained on :func:`pq_sample`, cached
    (bench.py:802-816)."""
    from ..index.transforms import OPQTransform

    key = f"opq_{M}x{nbits}_v1"
    cached = cache_get(key)
    if cached is not None:
        return cached["rot"]
    opq = OPQTransform(DIM, M=M, nbits=nbits, device=centers.device)
    t0 = time.perf_counter()
    opq.train(pq_sample(centers))
    log(f"# opq{M}x{nbits} train: {time.perf_counter() - t0:.0f}s")
    cache_put(key, rot=np.asarray(opq.matrix, np.float32))
    return opq.matrix


# -- the cache -------------------------------------------------------------------------------


def cache_get(name: str):
    path = os.path.join(CACHE_DIR, name + ".npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError) as exc:
        log(f"# cache read {name} failed: {exc}")
        return None


def cache_put(name: str, **arrays) -> None:
    try:
        os.makedirs(CACHE_DIR, exist_ok=True)
        path = os.path.join(CACHE_DIR, name + ".npz")
        np.savez(path + ".tmp.npz", **arrays)
        os.replace(path + ".tmp.npz", path)
        log(f"# cache write {name}")
    except OSError as exc:
        log(f"# cache write {name} failed: {exc}")


# -- the model and the kernels' counters -------------------------------------------------------


def bert_base_model(attention: str = "xla", device="cuda", num_hidden_layers: int = 12):
    """The bert-base dual encoder in bf16 for serving, seeded random weights
    (bench.py:1235-1245): (config, model)."""
    from ..models.bert import BertConfig
    from ..models.biencoder import DRModelForInference, DRModelSpec
    from ..models.convert import init_params_numpy

    config = BertConfig(num_hidden_layers=num_hidden_layers)
    model = DRModelForInference(DRModelSpec(bert_config=config, dtype="bfloat16",
                                            attention=attention), device=device)
    model.load_tower_tree("lm_q", init_params_numpy(config, 0))
    return config, model


def counters() -> Dict[str, object]:
    """The search kernels' launch counters, generic-body counters and last bodies."""
    from ..ops import ivf_bulk, ivf_pq, pq, quant, topk

    out = {}
    for name, fn in (("block_topj_serve", topk.block_topj_serve),
                     ("block_topj_i8q", topk.block_topj_i8q), ("cell_topj", ivf_bulk.cell_topj),
                     ("ragged_topj", ivf_bulk.ragged_topj),
                     ("ragged_topj_pq", ivf_pq.ragged_topj_pq),
                     ("pq_topj_blocks", pq.pq_topj_blocks),
                     ("quantize_int8_device", quant.quantize_int8_device),
                     ("quantize_int4_device", quant.quantize_int4_device)):
        for attr, value in vars(fn).items():
            if attr.startswith("launches") or attr == "last_body":
                out[f"{name}.{attr}"] = value
    return out


def report_bodies(tag: str, before: Dict[str, object]) -> Dict[str, object]:
    """Print the counters that moved since ``before`` and the last body of each
    search wrapper that ran (``*_generic`` counts launches of ``block_topj.cu``'s
    body at a shape a Hopper body takes at others); returns the counters now."""
    now = counters()
    moved = {k: (v - before.get(k, 0) if isinstance(v, int) else v) for k, v in now.items()
             if v != before.get(k)}
    print(f"# bodies {tag}: {moved}", flush=True)
    return now
