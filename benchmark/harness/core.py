"""One run of one cell: set-up, the measured window, the per-layer readings, the check.

Everything a cell is made of is found by name. ``workloads/<cell>.json`` names the
configuration (``configs/<config>.json``), the traffic mix (``traffic/<traffic>.json``),
the port's model options and the limits of the check; the mix names its driver
(``drivers/<driver>.py``); ``BENCHMARK.json`` lists the metrics each cell reports, and
each per-layer metric has its reader, ``metrics/<metric>.py``.

A driver is a class ``Driver(run)`` whose constructor is the cell's set-up (the port's
model and data made from the seed, every shape warmed up); ``step()`` does one unit of
the cell's work in the window (its span is the driver's ``unit_span``), ``finish()``
waits for the device, ``end_to_end(window_s)`` gives the end-to-end values, ``release()``
frees the port's state and ``readings(variant)`` returns the compared numbers: ``sound``
(the port against the reference) or one of ``control_variants`` (the control, or a
planted fault, against the reference). Work counts the readers need go to
``run.counters`` during the window.

The measured window always runs untraced, so what the host clock reads there (the
end-to-end metrics, and the per-layer ``mfu.*``) is the port's own pace. A traced run
(``--trace 1``) then runs the cell on for a bounded part (``trace.TRACE_SECONDS``) under
``torch.profiler``; its units count into ``run.trace_counters``, and the readers of the
device trace take those.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch

from .trace import TRACE_SECONDS, Tracer

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "denseretrievaltoolkits_tpu")


def load_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold '.' and '-')."""
    path = os.path.join(BENCH, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merged(base: Dict, over: Optional[Dict]) -> Dict:
    """``base`` with ``over``'s keys set, nested dicts merged (the tests' small sizes)."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) \
            else v
    return out


def cell_end_to_end(manifest: Dict, cell: str) -> List[Dict]:
    """The end-to-end metrics ``cell`` reports: those listing it, and those listing none."""
    return [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]


def cell_per_layer(manifest: Dict, cell: str) -> List[Dict]:
    """The per-layer metrics ``cell`` reports: those listing it, and those listing none
    whose ``moves`` metric it reports."""
    e2e = {m["name"] for m in cell_end_to_end(manifest, cell)}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


class Run:
    """What a driver and a reader see of the run."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool, device,
                 config_over: Optional[Dict] = None, traffic_over: Optional[Dict] = None):
        self.cell = cell
        self.workload = load_json(BENCH, "workloads", cell + ".json")
        self.config = merged(load_json(BENCH, "configs", self.workload["config"] + ".json"),
                             config_over)
        self.traffic = merged(load_json(BENCH, "traffic", self.workload["traffic"] + ".json"),
                              traffic_over)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.tracer = Tracer(trace)
        self.counters: Dict = {}
        self.trace_counters: Dict = {}
        self.window_s: float = 0.0
        self.trace: Dict = {}
        self.scratch = tempfile.mkdtemp(prefix="bench-")  # under TMPDIR
        self.t_start = time.perf_counter()

    def mark(self, stage: str) -> None:
        """A set-up stage's end, in seconds since the process started, on standard error."""
        print(f"setup {stage} {time.perf_counter() - self.t_start:.3f} s", file=sys.stderr,
              flush=True)

    def span(self, name: str):
        return self.tracer.span(name)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def measure(run: Run, t_start: float):
    """Set-up, the untraced window, and in a traced run the traced part: (driver, setup_s)."""
    run.t_start = t_start
    run.mark("imports")
    driver = load_module("drivers", run.traffic["driver"]).Driver(run)
    run.sync()
    run.mark("done")
    setup_s = time.perf_counter() - t_start
    run.window_s = _window(run, driver, run.seconds)
    if run.tracer.enabled:
        window_counters = run.counters
        run.counters = _zeroed(window_counters)
        run.tracer.start()
        with run.span(driver.unit_span):  # the profiler's own start-up stays out of the trace
            driver.step()
        driver.finish()
        run.counters = _zeroed(window_counters)
        with run.span("window"):
            _window(run, driver, min(run.seconds, TRACE_SECONDS))
        run.trace = run.tracer.stop()
        run.trace_counters, run.counters = run.counters, window_counters
        print(f"pace untraced {run.counters.get('units', 0)} units in {run.window_s:.3f} s, "
              f"traced {run.trace_counters.get('units', 0)} units in "
              f"{run.trace.get('window_s', 0.0):.3f} s", file=sys.stderr, flush=True)
    return driver, setup_s


def _zeroed(counters: Dict) -> Dict:
    """Counters of the same names, each at nought (a count that is None stays None)."""
    return {k: [] if isinstance(v, list) else None if v is None else 0
            for k, v in counters.items()}


def _window(run: Run, driver, seconds: float) -> float:
    """Units of the cell's work until ``seconds`` have passed, the device waited for: the
    seconds it took."""
    t0 = time.perf_counter()
    while True:
        with run.span(driver.unit_span):
            driver.step()
        if time.perf_counter() - t0 >= seconds:
            break
    driver.finish()
    return time.perf_counter() - t0


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, manifest: Optional[Dict] = None,
             **overrides) -> Dict:
    """One run: the result line's dict (``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = manifest or load_json(ROOT, "BENCHMARK.json")
    run = Run(cell, seed, seconds, trace, device, **overrides)
    try:
        return _run(run, manifest, t_start)
    finally:
        shutil.rmtree(run.scratch, ignore_errors=True)


def _run(run: Run, manifest: Dict, t_start: float) -> Dict:
    cell, trace = run.cell, run.tracer.enabled
    driver, setup_s = measure(run, t_start)
    dev = device_info(run)  # the peak, before the reference runs
    if trace:
        dev["busy_s"] = run.trace.get("busy_s", 0.0)
        dev["window_s"] = run.trace.get("window_s", run.window_s)
    values = dict(driver.end_to_end(run.window_s), setup_s=setup_s)
    metrics = {}
    if trace:
        for m in cell_per_layer(manifest, cell):
            v = load_module("metrics", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell_end_to_end(manifest, cell):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    driver.release()
    readings = driver.readings("sound")
    limits = run.workload["limits"]
    # a reading that is not finite (a crash of the numbers) prints as 1e300, valid JSON
    checks = {k: {"value": readings[k] if math.isfinite(readings[k]) else 1e300,
                  "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": run.counters.get("units", 0),
           "failed": run.counters.get("failed", 0), "metrics": metrics, "device": dev}
    if trace and run.trace:
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = checks
    return out


def device_info(run: Run) -> Dict:
    if run.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(run.device)),
            "power_limit": power_limit()}


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it ('' where it cannot)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that no run may hold (compared whole)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))
