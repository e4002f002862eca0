"""The port's multi-process launcher (``parallel.multihost``): two ``gloo``
processes on the CPU each register their ``shard_batch_for_host`` slice of
one batch and gather the results, which must equal a single-process
``register_batch`` of the whole batch bit for bit."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from opticalflow2d_tpu_torch.parallel import register_batch, shard_batch_for_host

sys.path.insert(0, os.path.dirname(__file__))
import _torch_multihost_worker as worker  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_equal_one(tmp_path):
    out = str(tmp_path / "gathered.npz")
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, worker.__file__, str(rank), "2", coordinator, out],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    got = np.load(out)
    irefs, imovs = worker.batch()
    want = register_batch(irefs, imovs, worker.CFG, device="cpu")
    assert np.array_equal(got["motion"], want.motion.numpy())
    assert np.array_equal(got["iterations"],
                          torch.stack([t.iterations for t in want.traces], dim=1).numpy())
    assert got["rows"].tolist() == [0, 2]  # process 0 fed the first half
    assert len({tuple(r) for r in got["iterations"].tolist()}) > 1


def test_one_process_feeds_the_whole_batch():
    assert shard_batch_for_host(6) == slice(0, 6)
