"""Process start-up and per-process data shares (counterpart:
seld_tpu/parallel/multihost.py).

The JAX package runs one program per host that sees every chip; the port
runs one process per GPU, started by torchrun, which sets RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT. NCCL needs one GPU
per rank: two ranks on one card are refused.
"""

from __future__ import annotations

import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def launched_world_size() -> int:
    """WORLD_SIZE of the launch (torchrun sets it); 1 for a plain launch."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def initialize_multihost(device: torch.device, init_method: str | None = None,
                         timeout_s: float = 600.0) -> bool:
    """Join the launch's process group, NCCL for a CUDA device and gloo for
    the CPU; returns True when this call created it (False when one
    exists).

    Rank and world size come from torchrun's RANK and WORLD_SIZE (0 and 1
    for a plain launch). A world of 1 needs no rendezvous: its group is
    built on an in-process store. Otherwise the group meets at
    `init_method` (default: env://, MASTER_ADDR and MASTER_PORT)."""
    if dist.is_initialized():
        return False
    rank = int(os.environ.get("RANK", "0"))
    world = launched_world_size()
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)  # NCCL's rank-to-card map
    timeout = datetime.timedelta(seconds=timeout_s)
    if world == 1 and init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world, timeout=timeout)
    logger.info("process group: rank %d of %d, %s on %s", rank, world, backend, device)
    return True


def process_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_local_indices(n_items: int, process_id: int | None = None,
                          num_processes: int | None = None) -> np.ndarray:
    """The contiguous slice of [0, n_items) this process is responsible
    for loading (corpus files, eval windows). Remainders go to the lowest
    process ids, so every index is covered exactly once and slice sizes
    differ by at most 1."""
    pid = process_rank() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    base, rem = divmod(n_items, n)
    start = pid * base + min(pid, rem)
    stop = start + base + (1 if pid < rem else 0)
    return np.arange(start, stop)


def local_batch_size(global_batch: int, num_processes: int | None = None) -> int:
    """Rows of the global batch each of `num_processes` processes supplies
    (default: the process group's size)."""
    n_proc = process_count() if num_processes is None else num_processes
    assert global_batch % n_proc == 0, (
        f"global batch {global_batch} not divisible by {n_proc} processes"
    )
    return global_batch // n_proc
