"""The search-mode contract: one meaning per mode string, for every index.

The port's own copy of ``denseretrievaltoolkits_tpu/index/modes.py``: the same
names, tables and resolution (raises included), so a mode string means the
same in both packages. What each mode runs on CUDA:

Flat indexes (``FlatIPIndex``):

======== ==================================================================
mode     mechanism
======== ==================================================================
exact    certified exact top-k: K5 (fp32/bf16 rows) or K6 (int8 rows)
         candidates, the exactness certificate, J escalation, and the exact
         scan for what stays flagged
serve    K8 candidates (J from the Poisson rule), merged, no certificate;
         every dtype. Scores are exact; selection may miss a row only when a
         block overflows its J
partial  K5 candidates without the certificate, fp32/bf16 rows only —
         raises on int8/int4. (The H100 has no PartialReduce; the reference
         itself degrades partial to uncertified candidates where
         PartialReduce cannot run.)
i8q      quantized-QUERY native-int8 path: queries quantize per row with K7
         and K12 scores s8*s8->s32 on the tensor cores. int8/int4 rows only
         — raises on fp32/bf16. Recall is below serve's (near-tie swaps from
         query quantization)
approx   ALIAS, resolved per dtype by ``APPROX_ALIAS`` below: the fastest
         approximate path for the index's storage dtype.
======== ==================================================================

``approx`` resolution table (documented contract — a caller who needs a
specific mechanism and recall contract should name it explicitly):

========= ===================
dtype     approx resolves to
========= ===================
float32   partial
bfloat16  partial
int8      i8q
int4      i8q
========= ===================

IVF indexes (``index/ivf.py``) have no flat scan, so their mode set is:
``exact`` (flat parity scan), ``bulk`` (default; alias ``serve``) — the
cell-major search on K13 (fixed-capacity cells) or K14 (ragged), ``probe`` —
the per-query-tile gathered path, ``i8q`` — bulk with int8-quantized queries
(int8 rows only), and ``approx`` — alias for ``i8q`` on int8 rows, else
``bulk``.  ``partial`` raises.

On the CPU every flat-index mode runs the exact blockwise scan (the kernels
run only on the card), and the IVF modes run their algorithm on the kernels'
plain versions, as the reference runs its IVF kernels in interpret mode there;
the mode/dtype VALIDATION here still applies so code paths fail the same way
everywhere.
"""

from __future__ import annotations

QUANTIZED = ("int8", "int4")

# the documented per-dtype alias table for flat indexes
APPROX_ALIAS = {
    "float32": "partial",
    "bfloat16": "partial",
    "int8": "i8q",
    "int4": "i8q",
}

FLAT_MODES = ("exact", "serve", "partial", "i8q", "approx")
IVF_MODES = ("exact", "bulk", "serve", "probe", "i8q", "approx")

# Product-quantized indexes (index/pq.py): scores are ADC approximations by
# construction, so "exact" means exact-ADC (fp32 ip against the
# reconstruction); "serve" is the decode-and-scan kernel (K16 for 8-bit
# codes, K15 for 4-bit).  There is no partial (scores never exist as a flat fp32 scan) and no i8q
# (queries already score against lossy reconstructions; quantizing them too
# would stack a second uncontrolled loss) — both raise.
PQ_MODES = ("exact", "serve", "approx")


def resolve_mode(mode: str, dtype: str) -> str:
    """Resolve a flat-index search mode against the storage dtype.

    Returns one of exact|serve|partial|i8q.  Raises ``ValueError`` when the
    mode names a mechanism the dtype cannot run (see module docstring)."""
    if mode not in FLAT_MODES:
        raise ValueError(
            f"unknown search mode {mode!r}; flat-index modes: {FLAT_MODES}")
    if mode == "approx":
        mode = APPROX_ALIAS[dtype]
    if mode == "i8q" and dtype not in QUANTIZED:
        raise ValueError(
            f"mode='i8q' is the quantized-query native-int8 path and "
            f"needs int8/int4 rows; this index stores {dtype}. Use 'serve' "
            f"or 'partial' (or the 'approx' alias).")
    if mode == "partial" and dtype in QUANTIZED:
        raise ValueError(
            f"mode='partial' (uncertified K5 candidates) needs fp32/bf16 rows; "
            f"this index stores {dtype}. Use 'i8q' (or the 'approx' alias).")
    return mode


def resolve_pq_mode(mode: str) -> str:
    """Resolve a PQ-index search mode.  Returns exact|serve."""
    if mode not in PQ_MODES:
        if mode == "partial":
            raise ValueError(
                "mode='partial' (uncertified candidates) needs a flat fp32/bf16 "
                "scan; PQ scores are decoded in-kernel. Use 'serve' (or 'approx').")
        if mode == "i8q":
            raise ValueError(
                "mode='i8q' quantizes queries against int8 rows; PQ already "
                "scores against lossy reconstructions. Use 'serve'.")
        raise ValueError(
            f"unknown search mode {mode!r}; PQ-index modes: {PQ_MODES}")
    return "serve" if mode == "approx" else mode


# IVF-PQ (index/ivf_pq.py): cells store PQ codes, so every score is
# reconstruction ADC — "exact" means exact-ADC over every reconstruction
# (parity checks), "bulk"/"serve" the decode-and-scan cell kernel K17.
# No per-query probe path (the ragged layout serves bulk only), no i8q
# (reconstructions are already lossy), no partial (no flat fp32 scan).
IVFPQ_MODES = ("exact", "bulk", "serve", "approx")


def resolve_ivfpq_mode(mode: str) -> str:
    """Resolve an IVF-PQ search mode.  Returns exact|bulk."""
    if mode not in IVFPQ_MODES:
        if mode == "partial":
            raise ValueError(
                "mode='partial' (uncertified candidates) needs a flat fp32/bf16 "
                "scan; IVF-PQ scores decode in-kernel. Use 'bulk' (or 'approx').")
        if mode == "i8q":
            raise ValueError(
                "mode='i8q' quantizes queries against int8 rows; IVF-PQ "
                "already scores against lossy reconstructions. Use 'bulk'.")
        if mode == "probe":
            raise ValueError(
                "mode='probe' is the per-query gathered path of the dense "
                "IVF families; IVF-PQ serves through the bulk kernel only.")
        raise ValueError(
            f"unknown search mode {mode!r}; IVF-PQ modes: {IVFPQ_MODES}")
    return "exact" if mode == "exact" else "bulk"


def resolve_ivf_mode(mode: str, dtype: str) -> str:
    """Resolve an IVF search mode against the storage dtype.

    Returns one of exact|bulk|serve|probe|i8q."""
    if mode not in IVF_MODES:
        if mode == "partial":
            raise ValueError(
                "mode='partial' (uncertified candidates) is a flat-index mode; IVF "
                "approximation is the probe set itself (tune nprobe).")
        raise ValueError(
            f"unknown search mode {mode!r}; IVF modes: {IVF_MODES}")
    if mode == "approx":
        mode = "i8q" if dtype in QUANTIZED else "bulk"
    if mode == "i8q" and dtype not in QUANTIZED:
        raise ValueError(
            f"mode='i8q' needs int8 IVF cells; this index stores {dtype}. "
            f"Use 'bulk' (or the 'approx' alias).")
    return mode
