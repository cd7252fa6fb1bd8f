"""What the benchmark's CPU tests share: the import path and the cells at tiny sizes.

The tests run the harness on the port's CPU path (every kernel's plain version) at sizes
a test run holds. Each configuration and each traffic file keeps its own tiny sizes under
its ``tiny`` key, which only the tests read, so a new cell brings its own. Widths shrink
there and nowhere else; the BERT weights are drawn wider (initializer_range 0.1) so that
two layers of 64 wide move the reps as a deep wide model does, and a lower precision
shows in them; the T5 tower is 128 wide and the batch 8 queries, so that bf16 rounding
stays under the limits set at the published sizes.
"""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import core  # noqa: E402

CELLS = [w["name"] for w in core.load_json(ROOT, "BENCHMARK.json")["workloads"]]


def tiny(cell: str) -> dict:
    """``run_cell`` / ``Run`` overrides that shrink ``cell`` for the CPU: the ``tiny``
    sizes of its configuration's and its traffic's files."""
    w = core.load_json(BENCH, "workloads", cell + ".json")
    return {"config_over": core.load_json(BENCH, "configs", w["config"] + ".json")["tiny"],
            "traffic_over": core.load_json(BENCH, "traffic", w["traffic"] + ".json")["tiny"]}
