"""The benchmark's harness: what every cell shares (the run, the traffic generator, the
weights, the yardstick, the trace and the comparisons). A cell's own parts are data and
small files found by name: ``configs/``, ``traffic/``, ``workloads/``, ``drivers/`` and
``metrics/``."""
