"""The port's checkpoint and resume (``utils.checkpoint``) on the CPU.

A resumed run is held to an uninterrupted ``register`` bit for bit, field,
counts and trace history: the port's pyramid is phased on the host, so the
split points change no operation (the JAX package's compiled levels agree
only to ~6e-8). A checkpoint written by the JAX package's
``save_checkpoint`` loads its motion and traces here unchanged.
"""

import os

import numpy as np
import pytest
import torch

import opticalflow2d_tpu as J
import opticalflow2d_tpu_torch as T
from _torch_helpers import npy, tiled_pair
from opticalflow2d_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from opticalflow2d_tpu_torch.utils import (
    load_checkpoint, load_checkpoint_traces, register_resumable, save_checkpoint)

SHAPE = (48, 40)
# Three scales (coarsest 12 x 10); the fluid case regrids.
CASES = {
    "diffusion": T.RegConfig(method=T.Method.DIFFUSION, niter=(60, 50, 40), nscales=2,
                             nrefine=2, alpha=0.1),
    "fluid": T.RegConfig(method=T.Method.FLUID, niter=(12, 10, 8), nscales=2, mu=0.25,
                         lam=0.1, omega=1.5, regrid_threshold=0.95),
}


@pytest.fixture(scope="module")
def pair():
    return tiled_pair(*SHAPE)


def _assert_same(got, want):
    assert torch.equal(got.motion, want.motion)
    assert [(t.scale, t.iterations, t.regrids, t.fallbacks) for t in got.traces] == [
        (t.scale, t.iterations, t.regrids, t.fallbacks) for t in want.traces]
    assert all(torch.equal(a.errors, b.errors) for a, b in zip(got.traces, want.traces))


@pytest.mark.parametrize("name,crash_after", [("diffusion", 2), ("diffusion", 1),
                                              ("fluid", 1)])
def test_crash_and_resume_equals_register(tmp_path, pair, name, crash_after):
    cfg = CASES[name]
    path = str(tmp_path / "resume.npz")
    assert register_resumable(*pair, cfg, path, device="cpu",
                              _crash_after_scale=crash_after) is None
    assert load_checkpoint(path, cfg)[1] == crash_after
    assert [t.scale for t in load_checkpoint_traces(path)] == [
        s for s in (2, 1, 0) if s >= crash_after for _ in range(cfg.nrefine)]
    resumed = register_resumable(*pair, cfg, path, device="cpu")
    straight = T.register(*pair, cfg, device="cpu")
    _assert_same(resumed, straight)
    if name == "fluid":
        assert any(t.regrids for t in resumed.traces)
    # A finished checkpoint returns its field and the whole history.
    _assert_same(register_resumable(*pair, cfg, path, device="cpu"), straight)


def test_resume_refuses_another_pair_or_config(tmp_path, pair):
    cfg = CASES["diffusion"]
    path = str(tmp_path / "pair.npz")
    register_resumable(*pair, cfg, path, device="cpu", _crash_after_scale=2)
    other_pair = tiled_pair(*SHAPE, seed=1)
    with pytest.raises(ValueError, match="different image pair"):
        register_resumable(*other_pair, cfg, path, device="cpu")
    other_cfg = T.RegConfig(method=T.Method.DIFFUSION, niter=(60, 50, 40), nscales=2,
                            nrefine=2, alpha=0.2)
    with pytest.raises(ValueError, match="different RegConfig"):
        register_resumable(*pair, other_cfg, path, device="cpu")


def test_round_trip_and_fingerprint(tmp_path):
    rng = np.random.default_rng(0)
    u = rng.standard_normal((2, 16, 12)).astype(np.float32)
    cfg = CASES["fluid"]
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, torch.from_numpy(u), cfg, level=1)
    got, level = load_checkpoint(path, cfg)
    assert np.array_equal(got, u) and level == 1
    assert load_checkpoint_traces(path) == ()
    quiet = T.RegConfig(method=T.Method.FLUID, niter=(12, 10, 8), nscales=2, mu=0.25,
                        lam=0.1, omega=1.5, regrid_threshold=0.95, verbose_stream=True)
    assert load_checkpoint(path, quiet)[1] == 1  # a logging knob changes nothing
    with pytest.raises(ValueError, match="different RegConfig"):
        load_checkpoint(path, CASES["diffusion"])
    assert not os.path.exists(path + ".tmp.npz")


def test_a_jax_checkpoint_loads(tmp_path, pair):
    """JAX's keys: its motion and traces load here (with ``cfg=None``: the
    fingerprint is of each package's own config)."""
    jcfg = J.RegConfig(method=J.Method.DIFFUSION, niter=(30, 20), nscales=1, nrefine=2,
                       alpha=0.1)
    res = J.register(*pair, jcfg)
    path = str(tmp_path / "jax.npz")
    jax_save_checkpoint(path, res.motion, jcfg, level=0, traces=res.traces)
    motion, level = load_checkpoint(path)
    assert level == 0 and np.array_equal(motion, np.asarray(res.motion))
    traces = load_checkpoint_traces(path)
    assert [(t.scale, t.iterations, t.regrids, t.fallbacks) for t in traces] == [
        (int(t.scale), int(t.iterations), int(t.regrids), int(t.fallbacks))
        for t in res.traces]
    for got, want in zip(traces, res.traces):
        assert got.errors.dtype == torch.float32
        assert np.array_equal(npy(got.errors), np.asarray(want.errors))
    with pytest.raises(ValueError, match="different RegConfig"):
        load_checkpoint(path, T.RegConfig(method=T.Method.DIFFUSION, niter=(30, 20),
                                          nscales=1, nrefine=2, alpha=0.1))


def test_resumable_default_device_needs_cuda(tmp_path, pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        register_resumable(*pair, CASES["diffusion"], str(tmp_path / "x.npz"))
