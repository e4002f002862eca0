"""Several processes, one batch (PyTorch port of ``opticalflow2d_tpu.
parallel.multihost``).

Each process calls ``initialize_multihost`` once, before any collective,
then registers its own slice of a globally indexed batch
(``shard_batch_for_host``) with ``register_batch`` on its own devices; the
slices are independent, so only the gathering of results (for example
``torch.distributed.all_gather``) crosses processes. Nothing tells a
program of a cluster here: the caller gives the coordinator's address, the
number of processes and this process's index, or sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` for ``env://``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> dict:
    """Join the process group: ``coordinator_address`` is ``host:port`` of
    process 0 (``tcp://``; ``None`` reads the ``env://`` variables).
    ``backend`` defaults to ``nccl`` where CUDA is present, else ``gloo``.
    Returns the JAX package's summary dict."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)
    local = torch.cuda.device_count() if backend == "nccl" else 1
    device = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else None
    total = torch.tensor([local], dtype=torch.int64, device=device)
    dist.all_reduce(total)
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": local,
        "global_devices": int(total.item()),
    }


def shard_batch_for_host(batch_size: int) -> slice:
    """The slice of a globally indexed batch that this process feeds: its
    rank's contiguous share; the whole batch when no process group is
    initialized (rank 0 of 1)."""
    initialized = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialized else 1
    i = dist.get_rank() if initialized else 0
    if batch_size % n != 0:
        raise ValueError(f"global batch {batch_size} not divisible by host count {n}")
    per = batch_size // n
    return slice(i * per, (i + 1) * per)
