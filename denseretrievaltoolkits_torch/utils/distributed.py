"""Multi-process data sharding (``denseretrievaltoolkits_tpu/utils/distributed.py``).

Only :func:`process_shard` is ported. Process-group initialization and the
multi-process corpus bounds wait for ROADMAP queue 1, item '`parallel/` and
`utils/distributed.py`'.
"""

from __future__ import annotations


def process_shard() -> tuple:
    """(shard_num, shard_idx) for host-side data loading in this process.
    The port runs one process on one card until multi-process training is
    ported (ROADMAP queue 1, item '`parallel/` and `utils/distributed.py`'),
    so this is (1, 0): the process loads every row."""
    return 1, 0
