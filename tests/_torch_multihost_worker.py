"""One of the processes of ``tests/test_torch_multihost.py`` (not collected
by pytest): joins the ``gloo`` process group, registers its
``shard_batch_for_host`` slice of a batch made from a seed, gathers every
process's motion and counts, and process 0 writes them to an npz file.

    python tests/_torch_multihost_worker.py RANK WORLD HOST:PORT OUT.npz
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from _torch_helpers import tiled_pair
from opticalflow2d_tpu_torch import Method, RegConfig
from opticalflow2d_tpu_torch.parallel import (
    initialize_multihost, register_batch, shard_batch_for_host)

BATCH = 4
SHAPE = (24, 20)
# Each pair stops at its own counts: [47, 27, 74, 77], [50, 35, 80, 77], ...
CFG = RegConfig(method=Method.DIFFUSION, niter=(80, 60), nscales=1, nrefine=2, alpha=0.1)


def batch():
    """The global batch, the same in every process: tiled pairs shifted
    apart."""
    pairs = [tiled_pair(*SHAPE, shift=(0.5 + 0.4 * i, -0.3 * i), seed=i) for i in range(BATCH)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def main():
    rank, world, coordinator, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    info = initialize_multihost(coordinator, world, rank, backend="gloo")
    assert info == {"process_index": rank, "process_count": world, "local_devices": 1,
                    "global_devices": world}, info
    rows = shard_batch_for_host(BATCH)
    irefs, imovs = batch()
    res = register_batch(irefs[rows], imovs[rows], CFG, device="cpu")
    counts = torch.stack([t.iterations for t in res.traces], dim=1)  # [local, traces]
    motions = [torch.empty_like(res.motion) for _ in range(world)]
    all_counts = [torch.empty_like(counts) for _ in range(world)]
    dist.all_gather(motions, res.motion)
    dist.all_gather(all_counts, counts)
    if rank == 0:
        np.savez(out, motion=torch.cat(motions).numpy(), iterations=torch.cat(all_counts).numpy(),
                 rows=np.array([rows.start, rows.stop]))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
