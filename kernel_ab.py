#!/usr/bin/env python3
"""Time K2 of this checkout of the port against K2 of another checkout (say the
parent commit), on one card, in turns.

    mkdir -p _chip_scratch/parent
    git archive <commit> denseretrievaltoolkits_torch | tar -x -C _chip_scratch/parent
    python3 kernel_ab.py --other _chip_scratch/parent [--seed 0] [--profile] [--ptxas]
                         [--out FILE]

K2 is called through its wrapper ``ops/attn.py:fused_mlp_ln``, as the encoder
calls it, at the bf16 bert-base shapes the main paths give it. Four processes run in turn,
other, this, this, other; each imports the port from its own checkout (which
builds its kernels into its own ``_build/``), makes the same inputs from
``--seed``, measures the kernel's error against its checkout's plain version
(abs, over max(3e-2, one bf16 ulp of the plain output), and the count of
outputs off by more than 3e-2) and times it.
``--profile`` adds the device time of each CUDA kernel a call of this
checkout's K2 launches (``torch.profiler``); ``--ptxas`` prints ``nvcc -Xptxas
-v``'s registers, shared memory and spills of this checkout's ``csrc/mlp_ln.cu``.
Needs a CUDA card; prints the card's name and power limit, then the results as
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# (B, S) of the bf16 calls: the passage tower at S=156 (serving), the training path's
# passages (256 x 128) and queries (32 x 32), the query tower (64 x 32)
SHAPES = ((64, 156), (256, 128), (32, 32), (64, 32))
H, F = 768, 3072
TOL = 3e-2  # chip_smoke.py's bf16 bound: an error is reported over max(TOL, 1 bf16 ulp)


def inputs(B, S, gen):
    """K2's arguments, as ``chip_smoke.py``'s phase 2 makes them."""
    def r(*shape, scale=1.0, dt=torch.bfloat16):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dt)

    ls, lb = 1 + r(H, scale=0.1, dt=torch.float32), r(H, scale=0.1, dt=torch.float32)
    return (r(B, S, H), r(H, F, scale=0.02), r(F, scale=0.02), r(F, H, scale=0.02),
            r(H, scale=0.02), ls, lb, 1e-12)


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


def worker(checkout, seed, profile):
    """One turn: K2 of ``checkout`` at every shape, as a dict."""
    import chip_smoke  # this checkout's, before the other checkout leads the path
    sys.path.insert(0, os.path.abspath(checkout))
    from denseretrievaltoolkits_torch.ops import _native, attn

    torch.backends.cuda.matmul.allow_tf32 = False
    _native.library()
    fn, ref = attn.fused_mlp_ln, attn._reference_mlp_ln
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {"package": os.path.dirname(attn.__file__), "build_s": _native.build_seconds}
    for B, S in SHAPES:
        args = inputs(B, S, gen)
        got = fn(*args)
        torch.cuda.synchronize()
        want = ref(*args).float()
        err = (got.float() - want).abs()
        bound = chip_smoke.bf16_ulp(want).clamp(min=TOL)
        row = {"ms": chip_smoke.cuda_ms(lambda: fn(*args), iters=20, warmup=3),
               "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
               "max_err_over_bound": (err / bound).max().item(),
               "n_past_tol": int((err > TOL).sum())}
        if profile:
            row["kernels_us"] = kernel_us(lambda: fn(*args))
        out[f"B={B} S={S}"] = row
    return out


def ptxas():
    """``nvcc -Xptxas -v`` on this checkout's ``csrc/mlp_ln.cu``: the lines naming
    entries, registers, shared memory and spills; and nvcc's exit code."""
    sys.path.insert(0, ROOT)
    from denseretrievaltoolkits_torch.ops import _native
    src = os.path.join(_native.CSRC, "mlp_ln.cu")
    obj = os.path.join(_native.BUILD_DIR, "ptxas_mlp_ln.o")
    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    proc = subprocess.run([_native.find_nvcc(), *_native.COMPILE_FLAGS, "-Xptxas", "-v", "-I",
                           _native.CSRC, "-c", "-o", obj, src], capture_output=True, text=True)
    lines = [ln for ln in (proc.stdout + proc.stderr).splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    return proc.returncode, lines


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True, help="root of the other checkout")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--ptxas", action="store_true")
    parser.add_argument("--out", default="")
    parser.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps(worker(args.worker, args.seed, args.profile)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}", flush=True)
    result = {"card": smi, "seed": args.seed, "turns": []}
    if args.ptxas:
        rc, lines = ptxas()
        print("\n".join(lines), flush=True)
        result["ptxas"] = lines
        if rc:
            return 1
    for i, (name, checkout) in enumerate((("other", args.other), ("this", ROOT), ("this", ROOT),
                                          ("other", args.other))):
        cmd = [sys.executable, os.path.abspath(__file__), "--other", args.other,
               "--seed", str(args.seed), "--worker", checkout]
        if args.profile and name == "this" and i == 1:
            cmd.append("--profile")
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        result["turns"].append({"name": name, **turn})
        print(f"{name} ({turn['package']}, build {turn['build_s']:.1f} s): " + "; ".join(
            f"{k} {v['ms']:.4f} ms, max_abs {v['max_abs_err']:.4e} "
            f"({v['max_err_over_bound']:.3f} of max({TOL:g}, 1 ulp), {v['n_past_tol']} past "
            f"{TOL:g})" for k, v in turn.items()
            if isinstance(v, dict)), flush=True)
        for k, v in turn.items():
            if isinstance(v, dict) and "kernels_us" in v:
                print(f"  {k} device us a call by kernel: " + ", ".join(
                    f"{n} {t:.2f}" for n, t in v["kernels_us"].items()), flush=True)
    for B, S in SHAPES:
        key = f"B={B} S={S}"
        ms = {n: [t[key]["ms"] for t in result["turns"] if t["name"] == n] for n in ("this",
                                                                                 "other")}
        result[key] = {f"{n}_ms": sum(v) / len(v) for n, v in ms.items()}
        print(f"K2 bf16 {key} ({B * S} rows): this {result[key]['this_ms']:.4f} ms "
              f"{ms['this']}, other {result[key]['other_ms']:.4f} ms {ms['other']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
