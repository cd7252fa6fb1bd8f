"""The traced run: the benchmark's spans, ``torch.profiler`` over a bounded part of the
run, and the reduction of its events to the numbers the per-layer readers take.

Spans are ``torch.profiler.record_function`` ranges that the harness and the drivers put
around their calls into the port (``window``, and each driver's own, such as
``encode_query``); their records carry the prefix ``bench.``, and every record with it
is a span, so a new driver's spans need no entry here. torch.optim records
``Optimizer.step#<Class>.step`` itself: every such record, whatever the optimizer, is the
span ``optimizer_step``. A device operation (kernel, copy or set) belongs to the span in
which the host launched it: its launch is the runtime call that shares its correlation
id, else the op it is linked to.

The profiler runs only after the measured window, for ``TRACE_SECONDS`` of the cell's
units (one more before them, outside ``window``, takes the profiler's start-up): a longer
trace costs the host more and the device reads idler than it is untraced.

The reduction gives:

- ``window_s``: the traced ``window`` span's length; ``busy_s``: the seconds of it in
  which some operation ran on the device (the union of their intervals);
- ``span_device_s`` / ``span_count``: per span name, the device seconds of the operations
  launched inside it, and how many times it was entered;
- ``device_ops``: the 10 device operations with the most time, [name, seconds];
- ``idle_gaps``: the device's idle time in the window by what the host was doing at the
  time (the innermost span, and the innermost op inside it), the 10 largest, [name, seconds].
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."
OPTIMIZER_PREFIX = "Optimizer.step#"
OPTIMIZER_SPAN = "optimizer_step"
TRACE_SECONDS = 5.0
NAME_CHARS = 120


def span_name(record: str) -> Optional[str]:
    """The span a profiler record is, or None where it is none."""
    if record.startswith(SPAN_PREFIX):
        return record[len(SPAN_PREFIX):]
    if record.startswith(OPTIMIZER_PREFIX):
        return OPTIMIZER_SPAN
    return None


def idle_share(run) -> Optional[float]:
    """The share (%) of the measured (untraced) window in which the device had nothing to
    run: one less the device seconds a unit of the traced part, times the window's units,
    over the window's seconds. The profiler slows the host, not the device's operations,
    so its cost stays out of this, as it does not out of the traced part's own idle time.
    None where no device operation was traced."""
    busy, traced = run.trace.get("busy_s"), run.trace_counters.get("units")
    if not busy or not traced or not run.window_s:
        return None
    return 100.0 * (1.0 - busy / traced * run.counters["units"] / run.window_s)


class Tracer:
    """Spans and the profiler of one run; inert unless ``enabled``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def span(self, name: str):
        """A span while the profiler runs; nothing at all before it starts."""
        if self.prof is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN_PREFIX + name)

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self) -> Dict:
        """Ends the profile; returns the reduction (empty when not enabled)."""
        if self.prof is None:
            return {}
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        return reduce_events(events)


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _activity(e) -> str:
    try:
        return str(e.activity_type())
    except (AttributeError, RuntimeError):
        return "kernel"


class _Intervals:
    """Sorted [start, end) intervals of one name, for containment queries."""

    def __init__(self, pairs: List[Tuple[int, int]]):
        pairs.sort()
        self.starts = [s for s, _ in pairs]
        self.pairs = pairs

    def containing(self, t: int):
        i = bisect.bisect_right(self.starts, t) - 1
        # spans of one name do not overlap, but a span may hold another of its name
        for j in range(i, max(-1, i - 4), -1):
            s, e = self.pairs[j]
            if s <= t < e:
                return s, e
        return None


def _union(intervals: List[Tuple[int, int]], lo: int, hi: int):
    """Merged, clipped intervals and the gaps between them inside [lo, hi)."""
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps, at = [], lo
    for s, e in merged:
        if s > at:
            gaps.append((at, s))
        at = e
    if hi > at:
        gaps.append((at, hi))
    return merged, gaps


def reduce_events(events) -> Dict:
    spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    ops: List[Tuple[int, int, str]] = []
    launch_by_corr: Dict[int, int] = {}
    op_start: Dict[int, int] = {}
    device = []
    for e in events:
        name = e.name()
        if _is_device(e):
            if _activity(e) in DEVICE_ACTIVITIES and span_name(name) is None:
                device.append((e.start_ns(), e.end_ns(), name, e.correlation_id(),
                               e.linked_correlation_id()))
            continue
        s, t = e.start_ns(), e.end_ns()
        act = _activity(e)
        if act in ("cuda_runtime", "cuda_driver"):
            launch_by_corr[e.correlation_id()] = s
            continue
        op_start[e.correlation_id()] = s
        span = span_name(name)
        if span is not None:
            spans[span].append((s, t))
        else:
            ops.append((s, t, name))
    if not spans.get("window"):
        return {}
    lo, hi = spans["window"][0]
    # spans entered before the window (the unit that takes the profiler's start-up) go
    spans = {n: [(s, t) for s, t in v if lo <= s < hi] for n, v in spans.items()}
    index = {n: _Intervals(list(v)) for n, v in spans.items() if v}
    span_device = defaultdict(float)
    by_name = defaultdict(float)
    for start, end, name, corr, linked in device:
        t = launch_by_corr.get(corr, op_start.get(linked, start))
        for n, iv in index.items():
            if n != "window" and iv.containing(t) is not None:
                span_device[n] += (end - start) / 1e9
        if lo <= start < hi:
            by_name[name[:NAME_CHARS]] += (end - start) / 1e9
    merged, gaps = _union([(s, e) for s, e, *_ in device], lo, hi)
    busy = sum(e - s for s, e in merged) / 1e9
    ops.sort()
    op_starts = [s for s, _, _ in ops]
    idle = defaultdict(float)
    for s, e in gaps:
        idle[_doing((s + e) // 2, index, ops, op_starts)] += (e - s) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy,
            "span_device_s": dict(span_device),
            "span_count": {n: len(v) for n, v in spans.items()},
            "device_ops": top(by_name), "idle_gaps": top(idle)}


def _doing(t: int, index: Dict[str, _Intervals], ops, op_starts) -> str:
    """'<innermost span> > <innermost op>' of the host at time ``t``."""
    best, width = "window", None
    for n, iv in index.items():
        hit = iv.containing(t)
        if hit is not None and (width is None or hit[1] - hit[0] < width):
            best, width = n, hit[1] - hit[0]
    i = bisect.bisect_right(op_starts, t) - 1
    for j in range(i, max(-1, i - 64), -1):
        s, e, name = ops[j]
        if s <= t < e:
            return f"{best} > {name[:NAME_CHARS]}"
    return best
