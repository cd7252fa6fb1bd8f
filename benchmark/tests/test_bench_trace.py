"""The traced run: which profiler records are spans, the reduction of a trace, and the
bounded traced part after the untraced window."""

import time

from benchsupport import CELLS, core, tiny

from harness import trace


class Event:
    """A profiler event as ``trace.reduce_events`` reads one."""

    def __init__(self, name, start, end, corr=0, device=False, activity="cpu_op", linked=0):
        self._v = (name, start, end, corr, device, activity, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[4] else "DeviceType.CPU"

    def activity_type(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def test_span_names():
    assert trace.span_name("bench.encode_query") == "encode_query"
    assert trace.span_name("bench.a_new_drivers_span") == "a_new_drivers_span"
    assert trace.span_name("Optimizer.step#AdamW.step") == trace.OPTIMIZER_SPAN
    assert trace.span_name("Optimizer.step#Adafactor.step") == trace.OPTIMIZER_SPAN
    assert trace.span_name("aten::mm") is None


def test_reduction_of_a_small_trace():
    events = [
        Event("bench.train_step", -300, -100),  # before the window: not counted
        Event("cudaLaunchKernel", -250, -240, corr=3, activity="cuda_runtime"),
        Event("warm", -200, -150, corr=3, device=True, activity="kernel"),
        Event("bench.window", 0, 1000),
        Event("bench.train_step", 100, 500),
        Event("Optimizer.step#Adafactor.step", 300, 450),
        Event("Optimizer.step#Inner.step", 320, 400),  # nested: its ops count once
        Event("aten::mm", 120, 200, corr=1),
        Event("cudaLaunchKernel", 130, 140, corr=1, activity="cuda_runtime"),
        Event("cudaLaunchKernel", 330, 340, corr=2, activity="cuda_runtime"),
        Event("gemm", 200, 300, corr=1, device=True, activity="kernel"),
        Event("adam_kernel", 600, 650, corr=2, device=True, activity="kernel"),
        Event("bench.train_step", 600, 610, device=True, activity="gpu_user_annotation"),
    ]
    r = trace.reduce_events(events)
    assert r["window_s"] == 1000e-9
    assert abs(r["busy_s"] - 150e-9) < 1e-15
    assert abs(r["span_device_s"][trace.OPTIMIZER_SPAN] - 50e-9) < 1e-15
    assert abs(r["span_device_s"]["train_step"] - 150e-9) < 1e-15
    assert r["span_count"]["train_step"] == 1
    assert [n for n, _ in r["device_ops"]] == ["gemm", "adam_kernel"]
    assert abs(sum(s for _, s in r["idle_gaps"]) - 850e-9) < 1e-15


def test_traced_part_follows_the_untraced_window():
    cell = CELLS[0]
    run = core.Run(cell, 2**31 + 7, 0.2, True, "cpu", **tiny(cell))
    try:
        core.measure(run, time.perf_counter())
    finally:
        import shutil

        shutil.rmtree(run.scratch, ignore_errors=True)
    assert run.counters["units"] >= 1 and run.trace_counters["units"] >= 1
    assert run.trace["span_count"]["window"] == 1
    # the traced part's own units, less the one that takes the profiler's start-up
    assert run.trace["span_count"][core.load_module(
        "drivers", run.traffic["driver"]).Driver.unit_span] == run.trace_counters["units"]
    assert run.trace["window_s"] < run.window_s + trace.TRACE_SECONDS
