"""The port's benchmark: one run of one cell on one H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The cell is an entry of ``BENCHMARK.json`` and a file
``benchmark/workloads/<cell>.json``. A run sets up the port's model and data from the
seed, warms up every shape it will use, measures for ``--seconds``, frees the port's
state, checks what the window produced against the plain float32 reference of
``benchmark/reference/`` and prints one JSON line last on standard output. With
``--trace 1`` the window runs under ``torch.profiler`` and the line carries the cell's
per-layer metrics, the device's busy seconds and a breakdown; with ``--trace 0`` its
end-to-end metrics. The compared numbers and their limits close standard error and the
line (``checks``).

Without a CUDA card, or with fewer than the cell asks for, it exits with code 2 and
prints no result; also when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))  # the checkout: the port's package
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import core

    manifest = core.load_json(core.ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; one of {sorted(cells)}", file=sys.stderr)
        return 2
    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"no result: the cell needs {need} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        return 2
    result = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START, manifest=manifest)
    found = core.forbidden_loaded()
    if found:
        print(f"no result: the run loaded {found}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
