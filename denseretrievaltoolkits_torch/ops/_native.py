"""Build and load the hand-written CUDA kernels of ``csrc/``.

At first use every ``csrc/*.cu`` is compiled with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and the objects
are linked into ONE shared library with a plain C interface, which is then
loaded with ``ctypes``. The library lands in ``_build/`` next to this package
(git-ignored), named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused.

Every C entry point takes device pointers and the CUDA stream as ``void*``
and returns ``cudaGetLastError()`` after its launch; :func:`check` raises on
a non-zero code. If ``nvcc`` is missing or the build fails, :func:`library`
raises with the compiler's output — there is no stub and no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: name -> argtypes (every entry returns an int: a cudaError_t unless noted)
SIGNATURES = {
    # qkv, x, mask, o_kernel, o_bias, ln_scale, ln_bias, out,
    # B, S, nh, hd, sm_scale, eps, is_bf16, stream
    "drt_attn_ln": [_P] * 8 + [_I, _I, _I, _I, _F, _F, _I, _P],
    # x, wi, bi, wo, bo, ln_scale, ln_bias, out, rows, H, F, eps, is_bf16, stream
    "drt_mlp_ln": [_P] * 8 + [_I, _I, _I, _F, _I, _P],
    # q, corpus, corpus_scales, query_scales, out_vals, out_ids,
    # Q, N, H, n_valid, block, J, qtype, ctype, serve, stream
    "drt_block_topj": [_P] * 6 + [_I] * 9 + [_P],
    # qslab, values, cell_scales, slot_scales, row_ids, block_cell, out_vals, out_ids,
    # Qcap, N, H, block, sel, J, cell_blocks, qtype, ctype, stream
    "drt_ivf_topj": [_P] * 8 + [_I] * 9 + [_P],
    # x, values, scales, n_in, n_out, H, is_bf16, stream
    "drt_quantize_int8": [_P] * 3 + [_I] * 4 + [_P],
    # x, packed, scales, n_in, n_out, H, is_bf16, stream
    "drt_quantize_int4": [_P] * 3 + [_I] * 4 + [_P],
    # nh, hd, is_bf16 -> the longest S drt_attn_ln takes (not a cudaError_t)
    "drt_attn_ln_max_seq": [_I, _I, _I],
    # q, p, lse, tgt, Q, P, H, stride, stream
    "drt_contrastive_fwd": [_P] * 4 + [_I] * 4 + [_P],
    # q, p, lse, gout, dq (dp), Q, P, H, stride, stream
    "drt_contrastive_dq": [_P] * 5 + [_I] * 4 + [_P],
    "drt_contrastive_dp": [_P] * 5 + [_I] * 4 + [_P],
    # -> the widest H the contrastive kernels take (not a cudaError_t)
    "drt_contrastive_max_h": [],
}

# wall seconds the last build took (0.0 when a cached library was reused)
build_seconds = 0.0


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of denseretrievaltoolkits_torch "
            "are compiled at first use and need the CUDA toolkit")
    return nvcc


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + ["|"] + LINK_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile ``csrc/*.cu`` into ``_build/libdrt_kernels_<hash>.so`` unless it
    exists: one ``nvcc -c`` per source, run in parallel, then one link.
    Returns the library path; raises with nvcc's output on failure."""
    global build_seconds
    target = os.path.join(BUILD_DIR, f"libdrt_kernels_{_digest()}.so")
    if os.path.exists(target):
        build_seconds = 0.0
        return target
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        t0 = time.perf_counter()
        jobs = []
        for src in _sources():
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-I", CSRC, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.PIPE, text=True)))
        errors = []
        for cmd, _, proc in jobs:  # wait for every compile, failed or not
            out, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
        if errors:
            raise RuntimeError("\n".join(errors))
        tmp = os.path.join(work, "lib.so")
        cmd = [nvcc, *LINK_FLAGS, "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        build_seconds = time.perf_counter() - t0
        os.replace(tmp, target)  # atomic: a concurrent build never sees a partial .so
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return target


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.drt_error_string.argtypes = [_I]
    lib.drt_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``. The kernels
    return ``cudaErrorInvalidValue`` for a shape they do not take (for
    example a sequence whose K/V does not fit in shared memory)."""
    if code != 0:
        what = library().drt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: cudaError_t {code} ({what})")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
