#!/usr/bin/env python3
"""Time a kernel of this checkout of the port against the same kernel of another
checkout (say the parent commit), on one card, in turns.

    mkdir -p _chip_scratch/parent
    git archive <commit> denseretrievaltoolkits_torch | tar -x -C _chip_scratch/parent
    python3 kernel_ab.py --other _chip_scratch/parent
                         [--kernel mlp_ln|attn_ln|flash_bwd|pq|ivf|int4|ivfpq|contrastive|flat|serve|
                                   flat8]
                         [--seed 0] [--profile] [--ptxas] [--sass] [--variant V] [--out FILE]

``--kernel mlp_ln`` (the default): K2, called through its wrapper
``ops/attn.py:fused_mlp_ln`` as the encoder calls it, at the bf16 bert-base shapes
the main paths give it; its error is measured against its checkout's plain version
(abs, over max(3e-2, one bf16 ulp of the plain output), and the count of outputs
off by more than 3e-2).

``--kernel attn_ln``: K1, through ``ops/attn.py:fused_attention_ln``, at the same
shapes (nh 12, hd 64, ``chip_smoke.py``'s ragged mask); its error is measured
against its checkout's plain version (abs, over 3e-2, and the count of outputs off
by more than 3e-2). ``--profile`` splits a call into its CUDA kernels
(``attn_ln_stage_a`` / ``attn_ln_stage_b`` on the Hopper body); ``--ptxas`` reads
``attn_ln.cu``, which compiles both stages (stage B's body from ``wgmma_ln.cuh``).

``--kernel flash_bwd``: the flash backward at bert-base widths (nh 12, hd 64), bf16,
on ``chip_smoke.py``'s ragged mask with a cotangent zero on pad rows, at B=64, S=512
(the passage tower at p_max_len 512) and B=8, S=32 (the query tower trained): F-dkv
and F-dq through their wrappers, each alone, and the whole backward through
``flash_attention_qkv``'s autograd (D included, wherever the checkout computes it),
with SDPA's backward on the same inputs beside them. Errors are each gradient's
largest difference to its checkout's closed-form plain version over its largest
value.

``--kernel pq``: the PQ serve kernels K16 (PQ96, int8 codebook), K15 8-bit (PQ96,
bf16 table) and K15 4-bit (PQ192x4) through ``ops/pq.py:pq_topj_blocks`` at
``chip_smoke.py``'s ``phase_pq_kernels`` shapes: 1,000,000 spectrumed rows x 768,
2048 queries, k=100 (its serve plan: PQ96 1024-row blocks, PQ192x4 2048), codebooks
trained on 65,536 of the rows (4 iterations). The inputs are made once and saved, so
both checkouts score the same codes. Errors are the kernel's largest difference to
its checkout's plain version over the first 128 queries. Another chunk size is timed
as another checkout: a copy of this tree with ``ops/pq.py:PQ_CHUNK_ROWS`` edited.
``--profile`` splits a call by CUDA kernel (``pq_decode_kernel`` / ``pq_score_wgmma``,
or the parent's one ``block_topj_mma_kernel``); ``--ptxas`` reads ``pq_serve.cu``.

``--kernel ivf``: the IVF cell kernels K13 (``cell_topj``) and K14 (``ragged_topj``) at
``chip_smoke.py``'s phase 14 shapes (1,000,000 mixture rows x 768, 2048 queries, k=100,
``IVF1024`` / ``IVFR1024`` with 512-row blocks, nprobe 32; fp32, bf16 and int8 cells in
bulk, int8 in i8q) and K14 at phase 16's (8,841,823 rows in ``IVFR256,SQ8``, 2048-row
blocks, nprobe 8; bulk and i8q), each call as the search makes it after its tuning call
(Qcap, hot set, plan). The centroids are trained once and saved; each turn makes the same
rows from the seed, adds them to indexes on the saved centroids and reports checksums of
its layout and slabs, which must agree between turns. A checkout whose wrappers take
``slots`` gets the search's filled slots; errors are over the filled slots' lists against
the checkout's plain version (the i8q lists must be bit-equal). ``--profile`` splits a
call by CUDA kernel; ``--ptxas`` reads ``ivf_cell.cu``.

``--kernel int4``: K10, the certified int4 search's block top-J, through
``ops/topk.py:block_topj(int4=True)`` at ``chip_smoke.py``'s phase 10 shapes: 1,000,000
seeded N(0, 1) rows x 768 packed by K9 (row 0 zero), 1024 seeded fp32 queries, 4096-row
blocks, J = 8 (the search's) and 32 (its escalation's). Each turn makes the same rows from
the seed and reports checksums (which must agree) and the kernel's largest |score - fp64
score of the same fp32 queries| over every list, beside its time. ``--ptxas`` reads
``int4_certified.cu``.

``--kernel ivfpq``: K17 through ``ops/ivf_pq.py:ragged_topj_pq`` on one call's inputs
as ``chip_smoke.py``'s phase 19 makes it: 8,841,823 spectrumed rows in
``OPQ192x4,IVF256,PQ192x4`` (nprobe 8, 2048-row blocks, bulk J 8, 16 hot cells at most),
2048 queries, k=100, the search's own slab after its tuning call. The index is built once
by this checkout and the call's operands saved (checksums equal in every turn); a checkout
whose wrapper takes ``slots`` gets the search's filled slots. The same slab is scored again
against seeded random 8-bit codes of the same row bytes (PQ96, d_sub 8, a random bf16 table):
the 8-bit decode reads its table through L2. Errors are over the filled slots' lists
against the checkout's plain version. ``--ptxas`` reads ``ivf_cell.cu``.

``--kernel contrastive``: K3 (lse and tgt) and K4 (dq and dp) through
``ops/contrastive.py``'s wrappers, at ``chip_smoke.py``'s grad-cache shape (Q=4096,
P=32768) and the training path's own (Q=32, P=256), H=768, 0.3 N(0, 1) reps from the seed,
K4's lse from the checkout's K3; each output's largest difference to the fp64 value over its
largest value, the body that ran where the checkout names it, and checksums of the inputs
(which must agree) and of K3's outputs. ``--ptxas`` and ``--sass`` read ``contrastive.cu``.

``--kernel flat``: K5, the certified search's block top-J, through
``ops/topk.py:block_topj`` on 1,000,000 seeded N(0, 1) rows x 768 in fp32 and in bf16, 1024
seeded queries, 4096-row blocks, J = 8 (the search's) and 32 (its escalation's); each turn's
largest |score - fp64 score of the same ids| and checksums (which must agree), and the body
that ran where the checkout names it. ``--ptxas`` reads ``flat_certified.cu``.

``--kernel serve``: K11 (``block_topj_serve(int4=True)``, bf16 queries), K12's sq4 body
(``block_topj_i8q(int4=True)``) and K12's int8 body (``block_topj_i8q``) on 1,000,000 seeded
N(0, 1) rows x 768 (row 0 zero) quantized by K7 and packed by K9, 1024 seeded queries (K7's
query quantization for K12), 4096-row blocks at J = 7 (the 1M-row serve J) and 11 (the
262,144-row slabs'), K12 sq4 at J = 32 (its 32-key lists), and K12 int8 at the 8.8M IVFR256
i8q side scan's 512-row blocks and J = 9. Each
turn makes the same rows from the seed and reports checksums (which must agree); K12's
errors are against its checkout's plain version (0: bit-equal), K11's the largest |score -
fp64 score of the same bf16 queries|; the body that ran where the checkout names it.
``--ptxas`` reads ``flat_serve.cu``.

``--kernel flat8``: K6 (``block_topj`` over int8 rows, bf16 queries) at J = 8 and 32 and K8
(``block_topj_serve``) over fp32, bf16 and int8 rows at J = 7 (the 1M-row serve J) and 11 (the
262,144-row slabs'), on 1,000,000 seeded N(0, 1) rows x 768 (int8 by K7), 1024 seeded
queries, 4096-row blocks; and K8 fp32 and int8 at the IVF side scans' 512-row blocks (fp32 J =
12, int8 J = 9 and 6). Each turn makes the same rows from the seed and reports checksums
(which must agree), the largest |score - fp64 score of the same ids| over the first 256
queries (queries in the kernels' input type, int8 rows times their scales) and the body that
ran. ``--ptxas`` reads ``flat_serve.cu`` and ``flat_certified.cu``.

``--sass`` reads the SASS of the kernel's sources (``cuobjdump -sass``) and scans each CUDA
function for accesses to the registers of a wgmma still in flight: a write to its A
fragments or accumulators, or a read of its accumulators, before the ``WARPGROUP.DEPBAR``
that retires its group, following branches and loops (``gmma_hazards``: "may" on some path,
"must" on every path); ``--listing NAME`` writes the SASS of the functions whose name holds
NAME beside ``--out``. With ``--variant`` (``VARIANTS``), ``--ptxas`` and ``--sass``
compile an edited copy of a source instead: ``bi8-two-sets`` is ``flat_serve.cu``'s BI8 body
with two RS register sets in turn. Without ``--other`` only these reports run.

Four processes run in turn, other, this, this, other; each imports the port from
its own checkout (which builds its kernels into its own ``_build/``), makes the
same inputs from ``--seed`` and times the calls with CUDA events. ``--profile``
adds the device time of each CUDA kernel a call of this checkout launches
(``torch.profiler``); ``--ptxas`` prints ``nvcc -Xptxas -v``'s registers, shared
memory and spills of this checkout's source of the kernel. Needs a CUDA card;
prints the card's name and power limit, then the results as one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# K1 and K2: (B, S) of the bf16 calls: the passage tower at S=156 (serving), the
# training path's passages (256 x 128) and queries (32 x 32), the query tower (64 x 32)
SHAPES = ((64, 156), (256, 128), (32, 32), (64, 32))
H, F = 768, 3072
# chip_smoke.py's bf16 bound: K2's errors are reported over max(TOL, 1 bf16 ulp), K1's
# over TOL
TOL = 3e-2
# the flash backward: (B, S) at bert-base widths
FLASH_SHAPES = ((64, 512), (8, 32))
NH, HD = 12, 64
# the PQ serve kernels: (name, M, nbits, int8 codebook), at 1M rows x 768, 2048 queries
PQ_CASES = (("K16", 96, 8, True), ("K15 8-bit", 96, 8, False), ("K15 4-bit", 192, 4, False))
PQ_ROWS, PQ_DIM, PQ_QUERIES, PQ_K, PQ_TRAIN = 1_000_000, 768, 2048, 100, 65_536
# the IVF cell kernels: (name, layout, cell dtype, search mode); "scale" is the 8.8M-row
# IVFR256,SQ8 index
IVF_CASES = tuple((f"{k} 1M {d} {m}", layout, d, m)
                  for k, layout in (("K13", "IVF"), ("K14", "IVFR"))
                  for d, m in (("float32", "bulk"), ("bfloat16", "bulk"), ("int8", "bulk"),
                               ("int8", "i8q"))) + (
    ("K14 8.8M int8 bulk", "scale", "int8", "bulk"), ("K14 8.8M int8 i8q", "scale", "int8", "i8q"))
IVF_ROWS, IVF_QUERIES, IVF_K = 1_000_000, 2048, 100
# K10: 1M int4 rows x 768, 1024 queries, 4096-row blocks, at the search's J and its escalation's
INT4_ROWS, INT4_QUERIES, INT4_BLOCK, INT4_J = 1_000_000, 1024, 4096, (8, 32)
# K5: the same shape in fp32 and bf16 rows
FLAT_ROWS, FLAT_QUERIES, FLAT_BLOCK, FLAT_J = 1_000_000, 1024, 4096, (8, 32)
# K11 / K12: 1M rows x 768, 1024 queries; (body, J, block): the 1M-row serve J, the slabs' J,
# K12 sq4 at 32-key lists, and K12 int8 at the 8.8M IVFR256 i8q side scan's J and block
SERVE_ROWS, SERVE_QUERIES = 1_000_000, 1024
SERVE_CASES = tuple((b, j, 4096) for b in ("K11", "K12 sq4", "K12 int8") for j in (7, 11)) + (
    ("K12 sq4", 32, 4096), ("K12 int8", 9, 512))
# K6 / K8: 1M rows x 768, 1024 queries; (body, J, block): K6 at the certified J and its
# escalation's, K8 at the 1M-row serve J and the slabs', and at the IVF side scans' (block 512)
FLAT8_CASES = (("K6", 8, 4096), ("K6", 32, 4096)) + tuple(
    (f"K8 {d}", j, 4096) for d in ("fp32", "bf16", "int8") for j in (7, 11)) + (
    ("K8 fp32", 12, 512), ("K8 int8", 9, 512), ("K8 int8", 6, 512))
FLAT8_ERR_QUERIES = 256
# K3 / K4: (Q, P) of the grad-cache scale and of the training path, stride P / Q
CONTRASTIVE_SHAPES = ((4096, 32768), (32, 256))
SOURCES = {"mlp_ln": ("mlp_ln.cu",), "attn_ln": ("attn_ln.cu",), "flash_bwd": ("flash_attn.cu",),
           "pq": ("pq_serve.cu",), "ivf": ("ivf_cell.cu",), "int4": ("int4_certified.cu",),
           "ivfpq": ("ivf_cell.cu",), "contrastive": ("contrastive.cu",),
           "flat": ("flat_certified.cu",), "serve": ("flat_serve.cu",),
           "flat8": ("flat_serve.cu", "flat_certified.cu")}
# --variant: (source, [(text, its replacement)]) compiled for --ptxas / --sass in place of
# the checkout's source. bi8-two-sets: flat_serve.cu's BI8 body (K6, K8 int8) with two RS
# register sets in turn, each built after wait_group 1 (one group left in flight), as K11's.
VARIANTS = {"bi8-two-sets": ("flat_serve.cu", [
    ("""        unsigned a0[KS][4];
""", """        unsigned a0[KS][4], a1[KS][4];
"""),
    ("""          wgmma_wait<0>();  // the group that read the set is done""",
     """          if constexpr (KIND == BI8)
            wgmma_wait<1>();
          else
            wgmma_wait<0>();"""),
    ("""            products(a0, none, j);""", """            if (j & 1)
              products(a1, none, j);
            else
              products(a0, none, j);"""),
    ("""        for (int kk = 0; kk < KS; ++kk) fence_regs(a0[kk]);
""", """        for (int kk = 0; kk < KS; ++kk) fence_regs(a0[kk]), fence_regs(a1[kk]);
""")])}


def inputs(B, S, gen):
    """K2's arguments, as ``chip_smoke.py``'s phase 2 makes them."""
    def r(*shape, scale=1.0, dt=torch.bfloat16):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dt)

    ls, lb = 1 + r(H, scale=0.1, dt=torch.float32), r(H, scale=0.1, dt=torch.float32)
    return (r(B, S, H), r(H, F, scale=0.02), r(F, scale=0.02), r(F, H, scale=0.02),
            r(H, scale=0.02), ls, lb, 1e-12)


def k1_inputs(chip_smoke, B, S, gen):
    """K1's arguments, as ``chip_smoke.py``'s phase 2 makes them."""
    def r(*shape, scale=1.0, dt=torch.bfloat16):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dt)

    mask = chip_smoke.ragged_mask(gen, B, S, n_pad_rows=2)
    ls, lb = 1 + r(H, scale=0.1, dt=torch.float32), r(H, scale=0.1, dt=torch.float32)
    return (r(B, S, 3 * H), r(B, S, H), mask, r(H, H, scale=0.02), r(H, scale=0.02), ls, lb,
            HD ** -0.5, NH, HD, 1e-12)


def kernel_us(fn, iters=20):
    """Mean device microseconds a call of ``fn`` spends in each CUDA kernel, by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            times[e.name[:100]] = times.get(e.name[:100], 0.0) + e.time_range.elapsed_us() / iters
    return times


def block_rows(chip_smoke, seed, profile, k1=False):
    """K2 (or K1) of the imported checkout at every shape."""
    from denseretrievaltoolkits_torch.ops import attn

    fn, ref = ((attn.fused_attention_ln, attn._reference_attention_ln) if k1 else
               (attn.fused_mlp_ln, attn._reference_mlp_ln))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for B, S in SHAPES:
        args = k1_inputs(chip_smoke, B, S, gen) if k1 else inputs(B, S, gen)
        got = fn(*args)
        torch.cuda.synchronize()
        want = ref(*args).float()
        err = (got.float() - want).abs()
        bound = TOL if k1 else chip_smoke.bf16_ulp(want).clamp(min=TOL)
        row = {"ms": chip_smoke.cuda_ms(lambda: fn(*args), iters=20, warmup=3),
               "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
               "max_err_over_bound": (err / bound).max().item(),
               "n_past_tol": int((err > TOL).sum())}
        if profile:
            row["kernels_us"] = kernel_us(lambda: fn(*args))
        out[f"B={B} S={S}"] = row
    return out


def flash_bwd_rows(chip_smoke, seed, profile):
    """The flash backward of the imported checkout at every shape. A checkout whose
    ``flash_bwd_dq`` takes O computes D inside it; an older one takes D, which is
    then computed here as its backward computed it."""
    from denseretrievaltoolkits_torch.ops import flash

    d_inside = "o" in inspect.signature(flash.flash_bwd_dq).parameters
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale, Hq = HD ** -0.5, NH * HD
    out = {"d_inside_dq": d_inside}
    for B, S in FLASH_SHAPES:
        qkv = torch.randn(B, S, 3 * Hq, generator=gen, device="cuda").to(torch.bfloat16)
        mask = chip_smoke.ragged_mask(gen, B, S, n_pad_rows=2)
        do = (torch.randn(B, S, NH, HD, generator=gen, device="cuda")
              * mask[:, :, None, None]).to(torch.bfloat16)
        q, k, v = flash.split_qkv(qkv, NH, HD)
        o, lse = flash.flash_fwd(q, k, v, mask, scale)
        grad = torch.empty(B, S, 3, NH, HD, dtype=torch.bfloat16, device="cuda")
        D = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        if d_inside:
            def dq_call():
                return flash.flash_bwd_dq(q, k, v, mask, lse, do, o, scale, grad)
            kD = dq_call()
        else:
            def dq_call():
                return flash.flash_bwd_dq(q, k, v, mask, lse, do, D, scale, grad)
            dq_call()
            kD = D

        def dkv_call():
            flash.flash_bwd_dkv(q, k, v, mask, lse, do, kD, scale, grad)

        dkv_call()
        torch.cuda.synchronize()
        rdk, rdv = flash._reference_flash_bwd_dkv(q, k, v, mask, lse, do, D, scale)
        rdq = flash._reference_flash_bwd_dq(q, k, v, mask, lse, do, D, scale)
        row = {"rel_err": {n: chip_smoke.rel_err(got, want)[1] for n, got, want in
                           zip(("dq", "dk", "dv"), grad.unbind(2), (rdq, rdk, rdv))},
               "D_rel_err": chip_smoke.rel_err(kD, D)[1]}
        leaf = qkv.detach().requires_grad_(True)
        port_o = flash.flash_attention_qkv(leaf, mask, NH, HD)

        def bwd_call():
            torch.autograd.grad(port_o, leaf, do, retain_graph=True)

        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
        seg = mask[:, None, :, None] == mask[:, None, None, :]
        lib_o = sdpa(qt, kt, vt, attn_mask=seg, scale=scale)
        do_t = do.transpose(1, 2)
        ms = lambda fn: chip_smoke.cuda_ms(fn, iters=20, warmup=3)  # noqa: E731
        row.update(dkv_ms=ms(dkv_call), dq_ms=ms(dq_call), bwd_ms=ms(bwd_call),
                   sdpa_bwd_ms=ms(lambda: torch.autograd.grad(lib_o, (qt, kt, vt), do_t,
                                                              retain_graph=True)))
        row["kernels_ms"] = row["dkv_ms"] + row["dq_ms"]
        if profile:
            row["kernels_us"] = kernel_us(bwd_call)
        out[f"B={B} S={S}"] = row
        del qkv, q, k, v, o, lse, grad, D, kD, leaf, port_o, qt, kt, vt, lib_o, seg
        torch.cuda.empty_cache()
    return out


def pq_inputs(chip_smoke, seed, path):
    """K15 / K16's inputs, made by this checkout and saved to ``path``: the
    spectrumed rows' codes under codebooks trained on PQ_TRAIN of them, the
    kernels' tables, the queries, block and J of the serve plan."""
    sys.path.insert(0, ROOT)
    from denseretrievaltoolkits_torch.ops import pq
    from denseretrievaltoolkits_torch.ops.topk import serve_plan

    rows = chip_smoke.spectrumed(seed, PQ_DIM)
    x = rows(0, PQ_ROWS)
    out = {"q": rows(0, PQ_QUERIES, stream=1).to(torch.bfloat16)}
    for name, M, nbits, i8 in PQ_CASES:
        if name == "K15 8-bit":  # PQ96's codes again, through the bf16 table
            out[name] = dict(out["K16"], scale=None, table=pq.bdcb_table(pq.build_bdcb(cb))[0])
            continue
        cb = pq.pq_train(x[:PQ_TRAIN], M, iters=4, seed=seed, k=1 << nbits)
        codes = pq.pq_encode_device(x, torch.from_numpy(cb).cuda())
        table, scale = (pq.bdcb_table(*pq.build_bdcb_i8(cb)) if i8 else
                        pq.bdcb_table(pq.build_bdcb(cb), k=1 << nbits))
        block, J = serve_plan(PQ_K, PQ_ROWS, PQ_ROWS, 1024 if nbits == 8 else 2048)
        out[name] = {"codes": codes.cpu(), "table": table, "scale": scale, "nbits": nbits,
                     "block": block, "J": J}
    torch.save(out, path)


def pq_rows(chip_smoke, path, profile):
    """K15 / K16 of the imported checkout on the saved inputs."""
    from denseretrievaltoolkits_torch.ops import pq

    inputs = torch.load(path)
    q = inputs["q"].cuda()
    out = {}
    for name, *_ in PQ_CASES:
        a = inputs[name]
        codes, table = a["codes"].cuda(), a["table"].cuda()
        scale = None if a["scale"] is None else a["scale"].cuda()

        def call(qq=q):
            return pq.pq_topj_blocks(qq, codes, table, a["J"], a["block"], PQ_ROWS, scale,
                                     a["nbits"])
        v, i = call(q[:128])
        rv, ri = pq._pq_topj_reference(q[:128], codes, table, a["J"], a["block"], PQ_ROWS, scale,
                                       a["nbits"])
        fin = ri >= 0
        row = {"ms": chip_smoke.cuda_ms(call, iters=5, warmup=1),
               "max_abs_err": (v - rv).abs()[fin].max().item(),
               "ids_differing": int(((i != ri) & fin).sum()), "block": a["block"], "J": a["J"]}
        if profile:
            row["kernels_us"] = kernel_us(call, iters=3)
        out[name] = row
        del codes, v, i, rv, ri
        torch.cuda.empty_cache()
    return out


def ivf_inputs(chip_smoke, seed, path):
    """The centroids of the IVF cases, trained by this checkout as ``chip_smoke.py``'s
    phases 14 and 16 train them, saved to ``path``."""
    sys.path.insert(0, ROOT)
    from denseretrievaltoolkits_torch.index import flat, ivf

    rows = chip_smoke.mixture(seed + 7, H)
    small = ivf.IVFFlatIndex(H, nlist=chip_smoke.IVF_NLIST, nprobe=chip_smoke.IVF_NPROBE,
                             device="cuda")
    small.train(rows(0, chip_smoke.IVF_TRAIN_ROWS))
    rows = chip_smoke.mixture(seed + 11, H)
    scale = flat.index_factory(H, f"IVFR{chip_smoke.SCALE_IVF_NLIST},SQ8",
                               nprobe=chip_smoke.SCALE_IVF_NPROBE, device="cuda")
    scale.block = chip_smoke.SCALE_IVF_BLOCK
    scale.train(rows(0, chip_smoke.IVF_TRAIN_ROWS))
    torch.save({"1M": small.centroids.cpu(), "8.8M": scale.centroids.cpu()}, path)


def ivf_case(chip_smoke, ivf_bulk, idx, q, mode, profile):
    """The cell kernel call of ``idx``'s bulk search of q (after its tuning call), timed,
    against the checkout's plain version on the filled slots' lists."""
    has_slots = "slots" in inspect.signature(ivf_bulk.cell_topj).parameters
    idx.search(q, IVF_K, mode=mode)  # the tuning call: Qcap, hot set
    state, nlist = idx._bulk_state, idx.nlist
    qcap = state["qcap"]
    qd, B0 = idx._pad_queries(q)
    ps = ivf_bulk.probe_slab(qd, idx.centroids, idx._values.dtype, nlist,
                             min(idx.nprobe, nlist - int(state["hot"].size)), qcap, state["hp"],
                             B0, mode == "i8q")
    block, sel, J = idx._cell_plan(qcap, IVF_K)
    slots = ps.counts.clamp(max=qcap).to(torch.int32)
    extra = (slots,) if has_slots else ()
    values = idx._values.reshape(-1, H)
    row_ids = idx._row_ids.reshape(-1)
    scales = None if idx._scales is None else idx._scales.reshape(-1)
    per = -(-block // sel)
    if idx._values.dim() == 3:  # K13
        cell_blocks = int(idx._values.shape[1]) // block
        block_cell = None
        cells = (torch.arange(values.shape[0] // block, device="cuda") // cell_blocks)

        def call():
            return ivf_bulk.cell_topj(ps.qslab, idx._values, idx._row_ids, idx._scales, J, block,
                                      sel, ps.qscales, *extra)
    else:  # K14
        cell_blocks, block_cell = 1, idx._block_cell
        cells = block_cell.long()

        def call():
            return ivf_bulk.ragged_topj(block_cell, ps.qslab, idx._values, idx._row_ids,
                                        idx._scales, J, block, sel, ps.qscales, *extra)
    v, i = call()
    rv, ri = ivf_bulk._ivf_topj_reference(ps.qslab, values, row_ids, scales, ps.qscales,
                                          block_cell, cell_blocks, J, block, sel)
    filled = (torch.arange(qcap, device="cuda")[None, :]
              < slots.long()[cells.repeat_interleave(per)][:, None])[:, :, None].expand_as(v)
    fin = filled & (ri >= 0)
    row = {"ms": chip_smoke.cuda_ms(call, iters=5, warmup=1),
           "max_abs_err": float((v - rv).abs()[fin].max()) if fin.any() else 0.0,
           "ids_differing": int(((i != ri) & filled).sum()),
           "values_differing": int(((v != rv) & filled).sum()),
           "block": block, "sel": sel, "J": J, "qcap": qcap, "filled_slots": int(slots.sum()),
           "slots_passed": has_slots,
           "checksum": [float(ps.qslab.float().sum()), int(row_ids.long().sum()),
                        float(values[:: max(1, values.shape[0] // 65536)].float().sum()),
                        int(slots.sum())]}
    if profile:
        row["kernels_us"] = kernel_us(call, iters=3)
    del v, i, rv, ri, filled, fin
    return row


def ivf_rows(chip_smoke, seed, path, profile):
    """K13 / K14 of the imported checkout on indexes over the saved centroids."""
    from denseretrievaltoolkits_torch.index import flat, ivf
    from denseretrievaltoolkits_torch.ops import ivf_bulk

    saved = torch.load(path)
    out = {}
    rows = chip_smoke.mixture(seed + 7, H)
    x = rows(0, IVF_ROWS)
    q = rows(0, IVF_QUERIES, stream=1).cpu().numpy()
    for name, layout, dtype, mode in IVF_CASES:
        if layout == "scale":
            continue
        if mode == "bulk":
            cls = ivf.IVFFlatIndex if layout == "IVF" else ivf.IVFRaggedIndex
            kw = {"block": chip_smoke.IVF_RAGGED_BLOCK} if layout == "IVFR" else {}
            idx = cls(H, nlist=chip_smoke.IVF_NLIST, nprobe=chip_smoke.IVF_NPROBE, dtype=dtype,
                      device="cuda", **kw)
            idx.centroids = saved["1M"].cuda()
            idx.add_device(x)
        out[name] = ivf_case(chip_smoke, ivf_bulk, idx, q, mode, profile)
        if mode == "i8q" or dtype != "int8":
            del idx
            torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()
    rows = chip_smoke.mixture(seed + 11, H)
    index = flat.index_factory(H, f"IVFR{chip_smoke.SCALE_IVF_NLIST},SQ8",
                               nprobe=chip_smoke.SCALE_IVF_NPROBE, device="cuda")
    index.block = chip_smoke.SCALE_IVF_BLOCK
    index.centroids = saved["8.8M"].cuda()
    index.add_chunks(rows, chip_smoke.SCALE_ROWS, chunk_rows=chip_smoke.SCALE_IVF_CHUNK)
    q = rows(0, IVF_QUERIES, stream=1).cpu().numpy()
    for name, layout, _, mode in IVF_CASES:
        if layout == "scale":
            out[name] = ivf_case(chip_smoke, ivf_bulk, index, q, mode, profile)
    del index
    torch.cuda.empty_cache()
    return out


def int4_rows(chip_smoke, seed, profile):
    """K10 of the imported checkout at J = 8 and 32 on rows and queries made from the seed."""
    from denseretrievaltoolkits_torch.ops import quant, topk

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(INT4_ROWS, H, generator=gen, device="cuda")
    x[0] = 0
    values, scales = quant.quantize_int4_device(x)
    del x
    q = torch.randn(INT4_QUERIES, H, generator=gen, device="cuda")
    checksum = [float(q.sum()), int(values[::997].long().sum()), float(scales.sum())]
    out = {}
    for J in INT4_J:
        def call(j=J):
            return topk.block_topj(q, values, j, INT4_BLOCK, INT4_ROWS, scales, int4=True)
        vals, ids = call()
        err = 0.0
        for a in range(0, INT4_QUERIES, 64):
            want = chip_smoke.rescore(q[a:a + 64], values, ids[a:a + 64].reshape(64, -1), scales,
                                      torch.float32, True)
            err = max(err, float((want - vals[a:a + 64].reshape(64, -1).double()).abs().max()))
        row = {"ms": chip_smoke.cuda_ms(call, iters=5, warmup=1), "max_abs_err_fp64": err,
               "J": J, "checksum": checksum}
        if profile:
            row["kernels_us"] = kernel_us(call, iters=3)
        out[f"K10 J={J}"] = row
        del vals, ids
    return out


def ivfpq_inputs(chip_smoke, seed, path):
    """K17's call of the 8.8M-row ``OPQ192x4,IVF256,PQ192x4`` search, as ``chip_smoke.py``'s
    phase 19 builds and tunes it, saved to ``path``."""
    sys.path.insert(0, ROOT)
    from denseretrievaltoolkits_torch.index import flat
    from denseretrievaltoolkits_torch.ops import ivf_pq

    rows = chip_smoke.spectrumed(seed + 17, H)
    index = flat.index_factory(H, "OPQ192x4,IVF256,PQ192x4", nprobe=chip_smoke.SCALE_PQ_NPROBE,
                               device="cuda")
    inner = index.inner
    inner.block, inner.bulk_j = chip_smoke.SCALE_IVF_BLOCK, chip_smoke.SCALE_PQ_BULK_J
    inner.max_hot = chip_smoke.SCALE_PQ_MAX_HOT
    index.train(rows(0, chip_smoke.PQ_TRAIN_ROWS))
    index.add_chunks(rows, chip_smoke.SCALE_ROWS, chunk_rows=chip_smoke.SCALE_IVF_CHUNK)
    q = rows(0, chip_smoke.PQ_QUERIES, stream=1)
    index.search(q.cpu().numpy(), IVF_K, mode="bulk")  # the tuning call: Qcap, hot set
    call = chip_smoke.pq_cell_call(ivf_pq, inner, index.transform.apply(q), IVF_K)
    ps = call["ps"]
    # 8-bit codes at the same slab and row bytes (PQ96: 96 subspaces of 8 dims), seeded random
    # codes and table, for the 8-bit decode (its table read through L2) beside the 4-bit one
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    n_codes = inner._values.shape[1]
    codes8 = torch.randint(-128, 128, (96, n_codes), generator=gen, device="cuda",
                           dtype=torch.int8)
    table8 = torch.randn(96, 256, H // 96, generator=gen, device="cuda").to(torch.bfloat16)
    torch.save({"block_cell": inner._block_cell.cpu(), "qslab": ps.qslab.cpu(),
                "codes": inner._values.cpu(), "row_ids": inner._row_ids.cpu(),
                "poff": call["poff_slab"].cpu(), "table": inner._table.cpu(), "J": call["J"],
                "block": call["block"], "sel": call["sel"], "nbits": inner.nbits,
                "slots": call["slots"].cpu(), "codes8": codes8.cpu(), "table8": table8.cpu()},
               path)


def ivfpq_rows(chip_smoke, path, profile):
    """K17 of the imported checkout on the saved call, with its 4-bit codes and with the
    8-bit codes of the same slab."""
    a = {k: v.cuda() if isinstance(v, torch.Tensor) else v for k, v in torch.load(path).items()}
    out = {"K17 8.8M OPQ192x4,IVF256,PQ192x4": ivfpq_case(chip_smoke, a, a["codes"], a["table"],
                                                           a["nbits"], profile)}
    out["K17 8.8M slab, 8-bit PQ96 codes"] = ivfpq_case(chip_smoke, a, a["codes8"], a["table8"], 8,
                                                         profile)
    return out


def ivfpq_case(chip_smoke, a, codes, table, nbits, profile):
    """One K17 call on the saved slab and the given codes, timed, against the checkout's
    plain version on the filled slots' lists."""
    from denseretrievaltoolkits_torch.ops import ivf_pq

    has_slots = "slots" in inspect.signature(ivf_pq.ragged_topj_pq).parameters
    extra = (a["slots"],) if has_slots else ()
    args = (a["block_cell"], a["qslab"], codes, a["row_ids"], a["poff"], table, a["J"],
            a["block"], a["sel"], nbits)

    def call():
        return ivf_pq.ragged_topj_pq(*args, *extra)
    v, i = call()
    rv, ri = ivf_pq._ivf_pq_topj_reference(a["qslab"], codes, a["row_ids"], a["poff"], table,
                                           a["block_cell"], a["J"], a["block"], a["sel"], nbits)
    per = -(-a["block"] // a["sel"])
    cells = a["block_cell"].long().repeat_interleave(per)
    qcap = a["qslab"].shape[1]
    filled = (torch.arange(qcap, device="cuda")[None, :]
              < a["slots"].long()[cells][:, None])[:, :, None].expand_as(v)
    fin = filled & (ri >= 0)
    row = {"ms": chip_smoke.cuda_ms(call, iters=5, warmup=1),
           "max_abs_err": float((v - rv).abs()[fin].max()) if fin.any() else 0.0,
           "ids_differing": int(((i != ri) & filled).sum()),
           "empty_lists_cleared": bool(((i == -1) | filled).all()) if has_slots else None,
           "J": a["J"], "sel": a["sel"], "qcap": qcap, "filled_slots": int(a["slots"].sum()),
           "slots_passed": has_slots,
           "checksum": [float(a["qslab"].float().sum()), int(a["row_ids"].long().sum()),
                        int(codes[:, ::997].long().sum()), float(a["poff"].sum())]}
    if profile:
        row["kernels_us"] = kernel_us(call, iters=3)
    return row


def flat_rows(chip_smoke, seed, profile):
    """K5 of the imported checkout in fp32 and bf16 at J = 8 and 32 on rows and queries made
    from the seed."""
    from denseretrievaltoolkits_torch.ops import topk

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        corpus = torch.randn(FLAT_ROWS, H, generator=gen, device="cuda").to(dtype)
        q = torch.randn(FLAT_QUERIES, H, generator=gen, device="cuda")
        qc = q.to(dtype)
        checksum = [float(q.sum()), float(corpus[::997].float().sum())]
        for J in FLAT_J:
            def call(j=J):
                return topk.block_topj(qc, corpus, j, FLAT_BLOCK, FLAT_ROWS)
            vals, ids = call()
            row = {"ms": chip_smoke.cuda_ms(call, iters=5, warmup=1),
                   "max_abs_err_fp64": chip_smoke.fp64_err(q, corpus, vals, ids), "J": J,
                   "body": getattr(topk.block_topj, "last_body", None), "checksum": checksum}
            if profile:
                row["kernels_us"] = kernel_us(call, iters=3)
            out[f"K5 {str(dtype)[6:]} J={J}"] = row
            del vals, ids
        del corpus
        torch.cuda.empty_cache()
    return out


def serve_rows(chip_smoke, seed, profile):
    """K11 and K12 (both bodies) of the imported checkout at SERVE_CASES on rows and queries
    made from the seed."""
    from denseretrievaltoolkits_torch.ops import quant, topk

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(SERVE_ROWS, H, generator=gen, device="cuda")
    x[0] = 0
    c8, s8 = quant.quantize_int8_device(x)
    c4, s4 = quant.quantize_int4_device(x)
    del x
    q = torch.randn(SERVE_QUERIES, H, generator=gen, device="cuda")
    qi, qs = quant.quantize_queries(q)
    qb = q.bfloat16()
    checksum = [float(q.sum()), int(c8[::997].long().sum()), int(c4[::997].long().sum()),
                float(s8.sum()), float(s4.sum()), int(qi[::7].long().sum())]
    out = {}
    for body, J, blk in SERVE_CASES:
        if body == "K11":
            fn = topk.block_topj_serve
            def call(j=J, b=blk):
                return fn(qb, c4, j, b, SERVE_ROWS, s4, int4=True)
        else:
            fn = topk.block_topj_i8q
            c, sc, int4 = (c4, s4, True) if body == "K12 sq4" else (c8, s8, False)
            def call(j=J, b=blk, c=c, sc=sc, int4=int4):
                return fn(qi, qs, c, sc, j, b, SERVE_ROWS, int4=int4)
        vals, ids = call()
        row = {"ms": chip_smoke.cuda_ms(call, iters=5, warmup=1), "J": J, "block": blk,
               "body": getattr(fn, "last_body", None), "checksum": checksum}
        if body == "K11":  # against fp64 scores of the same bf16 queries
            err = 0.0
            for a in range(0, SERVE_QUERIES, 64):
                got = vals[a:a + 64].reshape(64, -1)
                want = chip_smoke.rescore(q[a:a + 64], c4, ids[a:a + 64].reshape(64, -1), s4,
                                          torch.bfloat16, True)
                err = max(err, float(torch.where(got.isfinite(), (want - got.double()).abs(),
                                                 0.0).max()))
            row["max_abs_err_fp64"] = err
        else:
            rv, ri = topk._block_topj_i8q_reference(qi, qs, c, sc, J, blk, SERVE_ROWS, int4=int4)
            row["max_abs_err"] = float((vals - rv).abs().max())
            row["bit_equal"] = bool(torch.equal(vals, rv) and torch.equal(ids, ri))
            del rv, ri
        if profile:
            row["kernels_us"] = kernel_us(call, iters=3)
        out[f"{body} J={J} block={blk}"] = row
        del vals, ids
    return out


def flat8_rows(chip_smoke, seed, profile):
    """K6 and K8 (fp32, bf16, int8 rows) of the imported checkout at FLAT8_CASES on rows and
    queries made from the seed."""
    from denseretrievaltoolkits_torch.ops import quant, topk

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(SERVE_ROWS, H, generator=gen, device="cuda")
    c8, s8 = quant.quantize_int8_device(x)
    q = torch.randn(SERVE_QUERIES, H, generator=gen, device="cuda")
    qb = q.bfloat16()
    rows = {"fp32": (q, x, None), "bf16": (qb, x.bfloat16(), None), "int8": (qb, c8, s8)}
    checksum = [float(q.sum()), float(x[::997].sum()), int(c8[::997].long().sum()),
                float(s8.sum())]
    out = {}
    for body, J, blk in FLAT8_CASES:
        qc, c, sc = rows["int8" if body == "K6" else body[3:]]
        fn = topk.block_topj if body == "K6" else topk.block_topj_serve

        def call(j=J, b=blk, qc=qc, c=c, sc=sc, fn=fn):
            return fn(qc, c, j, b, SERVE_ROWS, sc)

        vals, ids = call()
        n = FLAT8_ERR_QUERIES
        err = 0.0
        for a in range(0, n, 16):
            got = vals[a:a + 16].reshape(16, -1)
            want = chip_smoke.rescore(q[a:a + 16], c, ids[a:a + 16].reshape(16, -1), sc)
            err = max(err, float(torch.where(got.isfinite(), (want - got.double()).abs(),
                                             0.0).max()))
        row = {"ms": chip_smoke.cuda_ms(call, iters=5, warmup=1), "J": J, "block": blk,
               "max_abs_err_fp64": err, "body": getattr(fn, "last_body", None),
               "checksum": checksum}
        if profile:
            row["kernels_us"] = kernel_us(call, iters=3)
        out[f"{body} J={J} block={blk}"] = row
        del vals, ids
    return out


def contrastive_rows(chip_smoke, seed, profile):
    """K3's lse and tgt, K4's dq and dp of the imported checkout at the grad-cache and
    training shapes."""
    from denseretrievaltoolkits_torch.ops import contrastive as con

    out = {}
    for Q, P in CONTRASTIVE_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q = 0.3 * torch.randn(Q, H, generator=gen, device="cuda")
        p = 0.3 * torch.randn(P, H, generator=gen, device="cuda")
        stride, one = P // Q, torch.ones((), device="cuda")
        qd, pd = q.double(), p.double()
        rows = torch.arange(Q, device="cuda")
        sd = qd @ pd.T
        lse64 = torch.logsumexp(sd, 1)
        exact = {"lse": lse64, "tgt": sd[rows, rows * stride]}

        def fwd():
            return con.contrastive_fwd(q, p, stride)
        got = fwd()
        row = {"ms": chip_smoke.cuda_ms(fwd, iters=10, warmup=2),
               "body": getattr(con.contrastive_fwd, "last_body", None),
               "checksum": [float(q.sum()), float(p.sum())],
               "out_checksum": [float(got[0].double().sum()), float(got[1].double().sum())]}
        for name, x in zip(("lse", "tgt"), got):
            row[f"{name}_rel_err_fp64"] = float((x.double() - exact[name]).abs().max()
                                                / exact[name].abs().max())
        if profile:
            row["kernels_us"] = kernel_us(fwd, iters=3)
        out[f"K3 Q={Q} P={P}"] = row
        lse = got[0]
        g = torch.exp(sd - lse64[:, None])
        del sd, exact
        g[rows, rows * stride] -= 1.0
        g /= Q
        exact = {"dq": g @ pd, "dp": g.T @ qd}
        del g, qd, pd
        for name, fn in (("dq", con.contrastive_bwd_dq), ("dp", con.contrastive_bwd_dp)):
            def call(f=fn):
                return f(q, p, lse, stride, one)
            got = call()
            row = {"ms": chip_smoke.cuda_ms(call, iters=10, warmup=2),
                   "rel_err_fp64": float((got.double() - exact[name]).abs().max()
                                         / exact[name].abs().max()),
                   "body": getattr(fn, "last_body", None),
                   "checksum": [float(q.sum()), float(p.sum())]}
            if profile:
                row["kernels_us"] = kernel_us(call, iters=3)
            out[f"K4 {name} Q={Q} P={P}"] = row
        del exact
        torch.cuda.empty_cache()
    return out


def worker(checkout, kernel, seed, profile, inputs=""):
    """One turn: ``kernel`` of ``checkout`` at every shape, as a dict."""
    import chip_smoke  # this checkout's, before the other checkout leads the path
    sys.path.insert(0, os.path.abspath(checkout))
    from denseretrievaltoolkits_torch.ops import _native

    torch.backends.cuda.matmul.allow_tf32 = False
    _native.library()
    out = {"package": os.path.dirname(os.path.dirname(_native.__file__)),
           "build_s": _native.build_seconds}
    if kernel == "flash_bwd":
        out.update(flash_bwd_rows(chip_smoke, seed, profile))
    elif kernel == "pq":
        out.update(pq_rows(chip_smoke, inputs, profile))
    elif kernel == "ivf":
        out.update(ivf_rows(chip_smoke, seed, inputs, profile))
    elif kernel == "int4":
        out.update(int4_rows(chip_smoke, seed, profile))
    elif kernel == "ivfpq":
        out.update(ivfpq_rows(chip_smoke, inputs, profile))
    elif kernel == "flat":
        out.update(flat_rows(chip_smoke, seed, profile))
    elif kernel == "contrastive":
        out.update(contrastive_rows(chip_smoke, seed, profile))
    elif kernel == "serve":
        out.update(serve_rows(chip_smoke, seed, profile))
    elif kernel == "flat8":
        out.update(flat8_rows(chip_smoke, seed, profile))
    else:
        out.update(block_rows(chip_smoke, seed, profile, k1=kernel == "attn_ln"))
    return out


def source_path(name, variant, tmp):
    """This checkout's ``csrc/<name>``, or a copy in ``tmp`` with ``variant``'s edits where
    the variant edits that file."""
    sys.path.insert(0, ROOT)
    from denseretrievaltoolkits_torch.ops import _native
    src = os.path.join(_native.CSRC, name)
    if not variant or VARIANTS[variant][0] != name:
        return src
    text = open(src).read()
    for old, new in VARIANTS[variant][1]:
        if text.count(old) != 1:
            raise SystemExit(f"kernel_ab: variant {variant}: {old[:60]!r} is not in {name} once")
        text = text.replace(old, new)
    path = os.path.join(tmp, name)
    with open(path, "w") as fh:
        fh.write(text)
    return path


def ptxas(kernel, variant=""):
    """``nvcc -Xptxas -v`` on this checkout's sources of ``kernel``: the lines naming
    entries, registers, shared memory, spills and wgmma serialization; and nvcc's largest
    exit code."""
    sys.path.insert(0, ROOT)
    from denseretrievaltoolkits_torch.ops import _native
    rc, lines = 0, []
    with tempfile.TemporaryDirectory() as tmp:
        for name in SOURCES[kernel]:
            proc = subprocess.run([_native.find_nvcc(), *_native.COMPILE_FLAGS, "-Xptxas", "-v",
                                   "-I", _native.CSRC, "-c", "-o", os.path.join(tmp, "x.o"),
                                   source_path(name, variant, tmp)],
                                  capture_output=True, text=True)
            rc = max(rc, proc.returncode)
            lines += [ln for ln in (proc.stdout + proc.stderr).splitlines()
                      if any(w in ln for w in ("Compiling entry", "Used", "spill", "wgmma"))]
    return rc, lines


# --sass: the SASS of a source, scanned for accesses to the registers of an asynchronous
# wgmma (HGMMA / IGMMA) while it may still run: a write to its A fragments or its
# accumulators, or a read of its accumulators, before the WARPGROUP.DEPBAR that retires its
# group. A group ends at the GMMA marked gsb0 (wgmma.commit_group); `DEPBAR.LE gsb0, N`
# (wgmma.wait_group N) leaves the N newest in flight. The scan follows branches and loops
# (a data-flow fixpoint over the instructions) twice: "may" joins the paths into a branch
# target by union (a register in flight on some path; a loop that picks its register set by
# a runtime parity shows both sets in flight), "must" by intersection (in flight on every
# path: a hazard found so is one whichever way the branches went).
_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_REG = re.compile(r"(?<![\w.])R(\d+)\b")
_SASS_SHAPE = re.compile(r"\.64x(\d+)x\d+")
_SASS_GMMA = ("HGMMA", "IGMMA", "QGMMA", "BGMMA")
_SASS_NO_DEST = ("RED", "REDUX", "BAR", "BRA", "EXIT", "SYNCS", "WARPGROUP", "WARPSYNC",
                 "BSSY", "BSYNC", "NOP", "MEMBAR", "FENCE", "DEPBAR", "UTMALDG", "UTMASTG",
                 "UBLKCP", "CALL", "RET", "YIELD", "ERRBAR", "CCTL", "BPT", "UTMACCTL",
                 "UTMAPF", "ARRIVES")


def _sass_width(opcode):
    """Registers the wide operand of ``opcode`` spans: its destination, and the data of a
    store, the addend of a .WIDE multiply-add, every source of a double op."""
    parts = opcode.split(".")
    if parts[0] == "LDSM":
        return int(parts[-1]) if parts[-1] in ("1", "2", "4") else 1
    if "128" in parts:
        return 4
    if "64" in parts or "WIDE" in parts or "F64" in parts or parts[0] in ("DADD", "DMUL",
                                                                           "DFMA"):
        return 2
    return 1


def _sass_access(opcode, ops):
    """(registers written, registers read) by one non-GMMA instruction."""
    base, w = opcode.split(".")[0], _sass_width(opcode)
    store = base.startswith("ST") or base in ("RED", "ATOM", "ATOMG", "ATOMS")
    d = -1  # the operand index of the register destination
    if not store and base not in _SASS_NO_DEST and ops:
        if ops[0].startswith("R"):
            d = 0
        elif re.fullmatch(r"!?U?P(\d|T)", ops[0]) and len(ops) > 1 and ops[1].startswith("R"):
            d = 1  # a predicate, then the register written (SHFL, LOP3)
    writes = _sass_regs(ops[d], w) if d >= 0 else set()
    reads, last = set(), max((k for k, op in enumerate(ops) if _SASS_REG.search(op)),
                             default=-1)
    for k, op in enumerate(ops):
        if k == d:
            continue
        wide = base in ("DADD", "DMUL", "DFMA", "DSETP") or (
            k == last and (store or "WIDE" in opcode.split(".")))
        reads |= _sass_regs(op, w if wide else 1)
    return writes, reads


def _sass_operands(text):
    """The operands of an instruction's text, split at the top-level commas."""
    out, depth, cur = [], 0, ""
    for ch in text:
        if ch in "[(":
            depth += 1
        elif ch in "])":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return out


def _sass_regs(operand, width):
    """The registers an operand names: ``width`` from R<n> outside brackets, one inside."""
    regs = set()
    for m in _SASS_REG.finditer(operand):
        inside = operand[:m.start()].count("[") > operand[:m.start()].count("]")
        regs.update(range(int(m.group(1)), int(m.group(1)) + (1 if inside else width)))
    return regs


def parse_sass(text):
    """cuobjdump -sass text -> {function: [(address, guard, opcode, operands)]}, and each
    function's labels {label: address}."""
    funcs, labels, name, pending = {}, {}, None, []
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name], labels[name], pending = [], {}, []
            continue
        if name is None:
            continue
        m = _SASS_LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _SASS_INSTR.search(line)
        if not m:
            continue
        addr, body = int(m.group(1), 16), m.group(2).strip()
        guard = ""
        if body.startswith("@"):
            guard, body = body.split(None, 1)
        opcode, _, rest = body.partition(" ")
        for lab in pending:
            labels[name][lab] = addr
        pending = []
        funcs[name].append((addr, guard, opcode, _sass_operands(rest)))
    return funcs, labels


def gmma_hazards(instrs, labels, cap=8):
    """Scan one function's instructions: counts of GMMAs (with A from registers, marked
    gsb0), DEPBARs and local-memory accesses, and the hazards the may and the must scans
    find, the first few as (address, kind, instruction text, the GMMA whose registers)."""
    if not instrs:
        return {"instructions": 0}
    index = {a: i for i, (a, *_rest) in enumerate(instrs)}
    # successors of each instruction (a branch whose target is not found: its fall-through)
    succ, unresolved = [], 0
    for i, (addr, guard, opcode, ops) in enumerate(instrs):
        base = opcode.split(".")[0]
        nxt = [i + 1] if i + 1 < len(instrs) else []
        pred = bool(guard) and guard not in ("@PT", "@UPT")
        if base in ("BRA", "JMP"):
            tgt = None
            for op in ops:
                lab = re.search(r"\.L_x_\d+", op)
                if lab and lab.group(0) in labels:
                    tgt = labels[lab.group(0)]
                hexa = re.fullmatch(r"`?\(?(0x[0-9a-f]+)\)?", op)
                if hexa:
                    tgt = int(hexa.group(1), 16)
            t = [index[tgt]] if tgt in index else []
            unresolved += not t
            succ.append(t + (nxt if pred or not t else []))
        elif base in ("EXIT", "RET", "BPT") and not pred:
            succ.append([])
        else:
            succ.append(nxt)
    # a register in flight: (register, kind "a" or "acc"); a state is (the committed groups,
    # oldest first, each a frozenset of those; the open group)
    access = {i: _sass_access(op, ops) for i, (_a, _g, op, ops) in enumerate(instrs)
              if op.split(".")[0] not in _SASS_GMMA}

    def step(i, state):
        groups, open_ = state
        _addr, _guard, opcode, ops = instrs[i]
        base = opcode.split(".")[0]
        if base in _SASS_GMMA:
            shape = _SASS_SHAPE.search(opcode)
            regs = set()
            if ops and ops[0].startswith("R"):
                regs |= {(r, "acc") for r in
                         _sass_regs(ops[0], int(shape.group(1)) // 2 if shape else 1)}
            if len(ops) > 1 and ops[1].startswith("R"):
                regs |= {(r, "a") for r in _sass_regs(ops[1], 4)}
            open_ = open_ | frozenset(regs)
            if "gsb0" in ops:
                groups, open_ = groups + (open_,), frozenset()
                if len(groups) > cap:  # the oldest two as one: never fewer registers
                    groups = (groups[0] | groups[1],) + groups[2:]
        elif opcode.startswith("WARPGROUP.DEPBAR"):
            m = re.search(r"0x([0-9a-f]+)", " ".join(ops))
            keep = int(m.group(1), 16) if m else 0
            groups = groups[len(groups) - keep:] if keep < len(groups) else groups
        return groups, open_

    def check(i, state):
        if i not in access:
            return None
        writes, reads = access[i]
        live = set().union(*state[0], state[1])
        for r, kind in sorted(live):
            if r in writes:
                return "write", r
            if kind == "acc" and r in reads:
                return "read accumulator", r
        return None

    def owner(i, r):
        """The nearest GMMA before instruction i naming register r, in address order from i
        back to the function's start, then on from its end (a loop's back edge)."""
        for k in list(range(i - 1, -1, -1)) + list(range(len(instrs) - 1, i, -1)):
            _a, _g, op, ops = instrs[k]
            if op.split(".")[0] in _SASS_GMMA:
                shape = _SASS_SHAPE.search(op)
                if r in _sass_regs(ops[0], int(shape.group(1)) // 2 if shape else 1) or (
                        len(ops) > 1 and ops[1].startswith("R") and r in _sass_regs(ops[1], 4)):
                    return k
        return i

    def join(a, b, must):
        n = min(len(a[0]), len(b[0])) if must else max(len(a[0]), len(b[0]))
        ga = ((frozenset(),) * n + a[0])[-n:] if n else ()
        gb = ((frozenset(),) * n + b[0])[-n:] if n else ()
        if must:
            return tuple(x & y for x, y in zip(ga, gb)), a[1] & b[1]
        return tuple(x | y for x, y in zip(ga, gb)), a[1] | b[1]

    found = {}
    for must in (False, True):
        states, work, hazards = {0: ((), frozenset())}, [0], {}
        while work:
            i = work.pop()
            hit = check(i, states[i])
            if hit:
                hazards[instrs[i][0]] = (hit[0], instrs[owner(i, hit[1])][0])
            elif instrs[i][0] in hazards:
                del hazards[instrs[i][0]]  # a must state only shrinks
            out = step(i, states[i])
            for j in succ[i]:
                new = out if j not in states else join(states[j], out, must)
                if states.get(j) != new:
                    states[j] = new
                    work.append(j)
        found["must" if must else "may"] = hazards
    text = {a: f"{g + ' ' if g else ''}{op} {', '.join(ops)}" for a, g, op, ops in instrs}
    ops_of = [op for _a, _g, op, _o in instrs]
    gmma = [o for o in instrs if o[2].split(".")[0] in _SASS_GMMA]
    return {"instructions": len(instrs), "gmma": len(gmma),
            "gmma_a_from_registers": sum(1 for o in gmma if len(o[3]) > 1
                                         and o[3][1].startswith("R")),
            "gsb0": sum(1 for o in gmma if "gsb0" in o[3]),
            "depbar": sum(1 for op in ops_of if op.startswith("WARPGROUP.DEPBAR")),
            "unresolved_branches": unresolved,
            "ldl": sum(1 for op in ops_of if op.startswith("LDL")),
            "stl": sum(1 for op in ops_of if op.startswith("STL")),
            "hazards_may": len(found["may"]), "hazards_must": len(found["must"]),
            "first_hazards": [f"/*{a:04x}*/ {'must' if a in found['must'] else 'may'} {k}: "
                              f"{text[a]} (GMMA /*{o:04x}*/ {text[o]})"
                              for a, (k, o) in sorted(found["may"].items())[:6]]}


def sass(kernel, variant="", listing=""):
    """The SASS of this checkout's sources of ``kernel`` (``variant`` applied), each CUDA
    function scanned by :func:`gmma_hazards`. Returns (nvcc's or cuobjdump's largest exit
    code, {function: scan}, the listing of each function whose name holds ``listing``)."""
    sys.path.insert(0, ROOT)
    from denseretrievaltoolkits_torch.ops import _native
    nvcc = _native.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    rc, result, listed = 0, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in SOURCES[kernel]:
            cubin = os.path.join(tmp, name.replace(".cu", ".cubin"))
            proc = subprocess.run([nvcc, *_native.COMPILE_FLAGS, "-I", _native.CSRC, "-cubin",
                                   "-o", cubin, source_path(name, variant, tmp)],
                                  capture_output=True, text=True)
            if proc.returncode:
                print(proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode, result, listed
            proc = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True)
            rc = max(rc, proc.returncode)
            funcs, labels = parse_sass(proc.stdout)
            names = subprocess.run(["c++filt"], input="\n".join(funcs), capture_output=True,
                                   text=True).stdout.splitlines()
            for (mangled, instrs), pretty in zip(funcs.items(), names or list(funcs)):
                result[f"{name}: {pretty}"] = gmma_hazards(instrs, labels[mangled])
                if listing and listing in pretty:
                    at = {a: lab for lab, a in labels[mangled].items()}
                    listed[f"{name}: {pretty}"] = "\n".join(
                        (f"{at[a]}:\n" if a in at else "") + f"/*{a:04x}*/ {g} {op} {', '.join(o)}"
                        for a, g, op, o in instrs)
    return rc, result, listed


def describe(name, turn, kernel):
    """One line per turn."""
    rows = {k: v for k, v in turn.items() if isinstance(v, dict)}
    if kernel == "ivf":
        return f"{name} ({turn['package']}, build {turn['build_s']:.1f} s): " + "; ".join(
            f"{k} {v['ms']:.3f} ms (J={v['J']}, sel {v['sel']}, Qcap {v['qcap']}, "
            f"{v['filled_slots']} filled slots, slots passed {v['slots_passed']}), max_abs "
            f"{v['max_abs_err']:.3e}, {v['ids_differing']} ids / {v['values_differing']} "
            f"values differing, checksum {v['checksum']}" for k, v in rows.items())
    if kernel in ("int4", "flat", "flat8"):
        return f"{name} ({turn['package']}, build {turn['build_s']:.1f} s): " + "; ".join(
            f"{k} {v['ms']:.3f} ms{' (' + v['body'] + ')' if v.get('body') else ''}, max "
            f"|score - fp64| {v['max_abs_err_fp64']:.3e}, checksum {v['checksum']}"
            for k, v in rows.items())
    if kernel == "serve":
        return f"{name} ({turn['package']}, build {turn['build_s']:.1f} s): " + "; ".join(
            f"{k} {v['ms']:.3f} ms{' (' + v['body'] + ')' if v.get('body') else ''}, "
            + (f"max |score - fp64| {v['max_abs_err_fp64']:.3e}" if "max_abs_err_fp64" in v
               else f"vs plain {'bit-equal' if v['bit_equal'] else v['max_abs_err']}")
            + f", checksum {v['checksum']}" for k, v in rows.items())
    if kernel == "contrastive":
        return f"{name} ({turn['package']}, build {turn['build_s']:.1f} s): " + "; ".join(
            f"{k} {v['ms']:.4f} ms{' (' + v['body'] + ')' if v.get('body') else ''}, max "
            + (f"|x - fp64| of max|x| lse {v['lse_rel_err_fp64']:.3e} tgt "
               f"{v['tgt_rel_err_fp64']:.3e}, outputs' checksum {v['out_checksum']}"
               if k.startswith("K3") else
               f"|grad - fp64| of max|grad| {v['rel_err_fp64']:.3e}") for k, v in rows.items())
    if kernel == "ivfpq":
        return f"{name} ({turn['package']}, build {turn['build_s']:.1f} s): " + "; ".join(
            f"{k} {v['ms']:.3f} ms (J={v['J']}, sel {v['sel']}, Qcap {v['qcap']}, "
            f"{v['filled_slots']} filled slots, slots passed {v['slots_passed']}, empty lists "
            f"(-inf, -1): {v['empty_lists_cleared']}), max_abs {v['max_abs_err']:.3e}, "
            f"{v['ids_differing']} ids differing, checksum {v['checksum']}"
            for k, v in rows.items())
    if kernel == "pq":
        return f"{name} ({turn['package']}, build {turn['build_s']:.1f} s): " + "; ".join(
            f"{k} {v['ms']:.3f} ms, max_abs {v['max_abs_err']:.3e}, {v['ids_differing']} ids "
            f"differing" for k, v in rows.items())
    if "rel_err" not in next(iter(rows.values())):
        bound = f"{TOL:g}" if kernel == "attn_ln" else f"max({TOL:g}, 1 ulp)"
        return f"{name} ({turn['package']}, build {turn['build_s']:.1f} s): " + "; ".join(
            f"{k} {v['ms']:.4f} ms, max_abs {v['max_abs_err']:.4e} "
            f"({v['max_err_over_bound']:.3f} of {bound}, {v['n_past_tol']} past "
            f"{TOL:g})" for k, v in rows.items())
    return f"{name} ({turn['package']}, build {turn['build_s']:.1f} s): " + "; ".join(
        f"{k} F-dkv {v['dkv_ms']:.4f} F-dq {v['dq_ms']:.4f} (sum {v['kernels_ms']:.4f}) "
        f"backward {v['bwd_ms']:.4f} SDPA backward {v['sdpa_bwd_ms']:.4f} ms, rel err "
        + ", ".join(f"{g} {e:.3e}" for g, e in v["rel_err"].items())
        + f", D {v['D_rel_err']:.3e}" for k, v in rows.items())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", default="",
                        help="root of the other checkout (none: only --ptxas / --sass)")
    parser.add_argument("--kernel", choices=sorted(SOURCES), default="mlp_ln")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--ptxas", action="store_true")
    parser.add_argument("--sass", action="store_true")
    parser.add_argument("--variant", choices=sorted(VARIANTS), default="")
    parser.add_argument("--listing", default="",
                        help="--sass: write the SASS of the functions whose name holds this "
                             "beside --out")
    parser.add_argument("--out", default="")
    parser.add_argument("--worker", default="", help=argparse.SUPPRESS)
    parser.add_argument("--inputs", default="", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps(worker(args.worker, args.kernel, args.seed, args.profile, args.inputs)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}", flush=True)
    result = {"card": smi, "kernel": args.kernel, "seed": args.seed, "turns": []}
    if args.variant:
        result["variant"] = args.variant
    if args.ptxas:
        rc, lines = ptxas(args.kernel, args.variant)
        print("\n".join(lines), flush=True)
        result["ptxas"] = lines
        if rc:
            return 1
    if args.sass:
        rc, scans, listed = sass(args.kernel, args.variant, args.listing)
        if listed and args.out:
            with open(args.out[:-len(".json")] + ".sass" if args.out.endswith(".json")
                      else args.out + ".sass", "w") as fh:
                fh.write("\n\n".join(f"// {fn}\n{text}" for fn, text in listed.items()))
        for fn, scan in scans.items():
            print(f"sass {fn}: " + ", ".join(f"{k} {v}" for k, v in scan.items()
                                             if k != "first_hazards"), flush=True)
            for line in scan.get("first_hazards", []):
                print(f"  {line}", flush=True)
        result["sass"] = scans
        if rc:
            return 1
    if not args.other:
        if not (args.ptxas or args.sass):
            parser.error("--other is needed unless --ptxas or --sass is given")
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(result, fh, indent=1)
        print(smi)
        print(json.dumps(result))
        return 0
    with tempfile.TemporaryDirectory() as tmp:  # the saved inputs of --kernel pq / ivf / ivfpq
        inputs = os.path.join(tmp, "inputs.pt")
        saved = {"pq": pq_inputs, "ivf": ivf_inputs, "ivfpq": ivfpq_inputs}
        if args.kernel in saved:
            import chip_smoke
            saved[args.kernel](chip_smoke, args.seed, inputs)
            torch.cuda.empty_cache()
        for i, (name, checkout) in enumerate((("other", args.other), ("this", ROOT), ("this", ROOT),
                                              ("other", args.other))):
            cmd = [sys.executable, os.path.abspath(__file__), "--other", args.other,
                   "--kernel", args.kernel, "--seed", str(args.seed), "--worker", checkout,
                   "--inputs", inputs]
            if args.profile and name == "this" and i == 1:
                cmd.append("--profile")
            proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
            if proc.returncode:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                return 1
            turn = json.loads(proc.stdout.strip().splitlines()[-1])
            result["turns"].append({"name": name, **turn})
            print(describe(name, turn, args.kernel), flush=True)
            for k, v in turn.items():
                if isinstance(v, dict) and "kernels_us" in v:
                    print(f"  {k} device us a call by kernel: " + ", ".join(
                        f"{n} {t:.2f}" for n, t in v["kernels_us"].items()), flush=True)
    flash = args.kernel == "flash_bwd"
    fields = ("dkv_ms", "dq_ms", "kernels_ms", "bwd_ms", "sdpa_bwd_ms") if flash else ("ms",)
    keys = [k for k, v in result["turns"][0].items() if isinstance(v, dict)]
    if args.kernel in ("ivf", "int4", "ivfpq", "flat", "contrastive", "serve", "flat8"):
        for key in keys:
            sums = {json.dumps(t[key]["checksum"]) for t in result["turns"]}
            if len(sums) != 1:
                print(f"{args.kernel} {key}: the turns' inputs differ: {sorted(sums)}", file=sys.stderr)
                return 1
    for key in keys:
        result[key] = {}
        for field in fields:
            ms = {n: [t[key][field] for t in result["turns"] if t["name"] == n]
                  for n in ("this", "other")}
            means = {n: sum(v) / len(v) for n, v in ms.items()}
            result[key].update({f"this_{field}": means["this"], f"other_{field}": means["other"]})
            print(f"{args.kernel} {key} {field}: this {means['this']:.4f} ms {ms['this']}, "
                  f"other {means['other']:.4f} ms {ms['other']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
