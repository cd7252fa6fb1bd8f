"""Multi-process start-up and data sharding.

Counterpart of ``denseretrievaltoolkits_tpu/utils/distributed.py`` (:21-81).
The reference starts a torch NCCL process group in every entry point
(``run_random_sampling.py:59-61`` there); here the same happens from the
variables ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``). One process drives one card: rank r of a
host uses ``cuda:LOCAL_RANK``. The backend is the caller's to name: ``nccl``
for CUDA and ``gloo`` for the CPU by default; two ranks that share one card
must name ``gloo`` (NCCL refuses a card it already holds). Nothing switches
backend on an error.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 600


def local_device(device=None) -> torch.device:
    """This process's card: ``cuda:LOCAL_RANK`` unless ``device`` is given."""
    if device is not None:
        return torch.device(device)
    return torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")


def maybe_initialize_distributed(backend: Optional[str] = None, device=None,
                                 timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the default process group when ``WORLD_SIZE`` > 1 says this is one
    of several processes; safe to call unconditionally (a lone process, or a
    group already started, is left as it is). ``backend`` defaults to
    ``nccl`` when ``device`` is CUDA (``cuda:LOCAL_RANK`` when None) and
    ``gloo`` on the CPU. Every collective waits at most ``timeout_s``. Returns
    True when several processes run."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    device = local_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)  # NCCL's communicator binds the current card
    dist.init_process_group(backend=backend, init_method="env://", world_size=world_size,
                            rank=int(os.environ["RANK"]),
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("process group %s: rank %d of %d on %s", backend, dist.get_rank(),
                dist.get_world_size(), device)
    return True


def process_shard() -> tuple:
    """(shard_num, shard_idx) for host-side data loading in this process: the
    started process group's world size and this rank, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def host_corpus_bounds(n_rows: int, n_proc: Optional[int] = None, proc_idx: Optional[int] = None,
                       local_shards: int = 1) -> tuple:
    """Contiguous [start, stop) of corpus rows THIS process encodes, so the
    sharded index holds them without an exchange: shards of
    ``per = ceil(n / (n_proc * local_shards))`` rows, process p owning shards
    [p L, (p + 1) L). One process drives one card here, so ``local_shards``
    is 1 (the reference's formula keeps it)."""
    size, rank = process_shard()
    n_proc = size if n_proc is None else n_proc
    proc_idx = rank if proc_idx is None else proc_idx
    per = -(-n_rows // (n_proc * local_shards))
    start = min(n_rows, proc_idx * local_shards * per)
    stop = min(n_rows, (proc_idx + 1) * local_shards * per)
    return start, stop
