"""The readings a cell's limits are set from: the port's, and its control's, on many seeds.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 3

For each seed, in one process (the kernels build once), it sets up the cell as a run
does, runs a short window at the cell's own load, and prints one JSON line with the
compared numbers of the port (``sound``) and of each of the driver's
``control_variants``: ``control``, the reference put in the port's place at the
precision below the configuration's bfloat16 (fp8 e4m3; for the search, the port's own
int8-query search ``i8q``), and the planted faults a cell can have (``half_batch``: the
loss's mean over half of the queries). The benchmark's own runs never run these. The
lower reading of a limit is the largest ``sound`` over a dozen seeds or more, the upper
the smallest control or fault that reads three (ten, for a fault) times the lower.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def readings(cell: str, seed: int, seconds: float, device: str = "cuda", **overrides):
    """{"seed", "sound": {...}, <variant>: {...}} of one seed."""
    from harness import core

    run = core.Run(cell, seed, seconds, False, device, **overrides)
    try:
        driver, _ = core.measure(run, time.perf_counter())
        if hasattr(driver, "program_control"):
            driver.program_control()
        driver.release()
        out = {"seed": seed, "sound": driver.readings("sound")}
        for variant in driver.control_variants:
            out[variant] = driver.readings(variant)
        return out
    finally:
        import shutil

        shutil.rmtree(run.scratch, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
