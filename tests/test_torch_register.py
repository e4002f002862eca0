"""The port's diffusion registration and session against the JAX package on
the same numpy pairs (CPU), and the config and state interop.

The port's CPU path runs the plain versions of its kernels through the same
blocked driver the GPU runs. It is held against JAX's jnp path (the default
on a CPU) and against JAX's Pallas path in interpret mode. Tolerances:
motion 1e-5 px max-abs, iteration counts equal at every level, per-iteration
errors rtol 1e-4 / atol 1e-6 (the Logger sums are added in another order).
The niter values make the Logger stop, or the niter cap, land inside a
block of 8 iterations.
"""

import dataclasses

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import opticalflow2d_tpu as J
import opticalflow2d_tpu_torch as T
from _torch_helpers import assert_close, npy, tt
from conftest import make_pair
from opticalflow2d_tpu_torch.interop import (
    config_from_jax, result_from_numpy, result_to_numpy)

MOTION_TOL = 1e-5
SHIFT = (1.5, -0.8)
# Every test that needs no stop of its own shares this niter, so that the
# JAX side compiles each of its programs once per file.
NITER_CAP = (40, 30)


def _assert_same_run(got, want):
    assert [t.iterations for t in got.traces] == [int(t.iterations) for t in want.traces]
    assert [t.scale for t in got.traces] == [int(t.scale) for t in want.traces]
    for a, b in zip(got.traces, want.traces):
        assert_close(a.errors, b.errors, 1e-6, 1e-4)
    assert_close(got.motion, want.motion, MOTION_TOL)


def _configs(niter, **jax_kw):
    jcfg = J.RegConfig(method=J.Method.DIFFUSION, niter=niter, nscales=1, nrefine=2,
                       alpha=0.1, **jax_kw)
    return jcfg, config_from_jax(jcfg)


@pytest.mark.parametrize("shape,niter", [
    ((64, 48), (120, 120)),   # stops at 110 and 71 on the coarse level
    ((96, 64), (200, 200)),   # stops at 167 and 124
    ((64, 48), NITER_CAP),    # the niter cap 30 lands inside a block
])
def test_register_matches_jax(shape, niter):
    iref, imov = make_pair(*shape, shift=SHIFT)
    jcfg, tcfg = _configs(niter)
    want = J.register(iref, imov, jcfg)
    got = T.register(tt(iref), tt(imov), tcfg, device="cpu")
    _assert_same_run(got, want)
    assert got.motion.dtype == torch.float32 and got.motion.device.type == "cpu"
    assert_close(got.coarse_motion, want.coarse_motion, MOTION_TOL)


def test_register_matches_jax_pallas_interpret():
    """Against JAX's blocked Pallas driver (the TPU's production path), run
    in interpret mode."""
    iref, imov = make_pair(64, 48, shift=SHIFT)
    jcfg, tcfg = _configs((120, 120), use_pallas=True)
    with pltpu.force_tpu_interpret_mode():
        want = J.register(iref, imov, jcfg)
    _assert_same_run(T.register(iref, imov, tcfg, device="cpu"), want)


@pytest.mark.parametrize("block_k", [1, 3, 16])
def test_block_depth_does_not_change_the_result(block_k):
    """Every block depth, 1 included, gives the run of the default depth:
    stops inside a block recompute the taken steps."""
    iref, imov = make_pair(64, 48, shift=SHIFT)
    base = T.RegConfig(method=T.Method.DIFFUSION, niter=(120, 120), nscales=1,
                       nrefine=2, alpha=0.1)
    want = T.register(iref, imov, base, device="cpu")
    got = T.register(iref, imov, dataclasses.replace(base, block_k=block_k), device="cpu")
    assert [t.iterations for t in got.traces] == [t.iterations for t in want.traces]
    assert torch.equal(got.motion, want.motion)


def test_session_matches_jax():
    iref, imov = make_pair(64, 48, shift=SHIFT)
    args = ((64, 48), [120, 120], 1, J.Method.DIFFUSION, [0.1], 2)
    js = J.OpticalFlow2d(*args)
    ts = T.OpticalFlow2d(*args, device="cpu")
    js.register(iref, imov)
    ts.register(iref, imov)
    assert tuple(ts.get_motion().shape) == (64, 48, 2)
    assert_close(ts.get_motion(), js.get_motion(), MOTION_TOL)
    assert_close(ts.warp(imov), js.warp(imov), 1e-5)
    ts.close()
    with pytest.raises(RuntimeError):
        ts.get_motion()
    with pytest.raises(ValueError):
        ts.register(iref[:32], imov[:32])


def test_persistent_motion_session_matches_jax():
    """A second register continues from the first call's coarsest field.
    The JAX side runs the two registers its persistent session runs
    (``opticalflow2d_tpu/engine/session.py``), under the shared config."""
    iref, imov = make_pair(64, 48, shift=SHIFT)
    jcfg, _ = _configs(NITER_CAP)
    ts = T.OpticalFlow2d((64, 48), list(NITER_CAP), 1, T.Method.DIFFUSION, [0.1], 2,
                         device="cpu", compat=T.CompatFlags(persistent_motion=True))
    want = J.register(iref, imov, jcfg)
    _assert_same_run(ts.register(iref, imov), want)
    want = J.register(iref, imov, jcfg, initial_coarse_motion=want.coarse_motion)
    got = ts.register(iref, imov)
    _assert_same_run(got, want)
    assert not np.allclose(npy(got.traces[0].errors[:3]), 0)  # warm coarse start


def test_initial_motion_and_scale_range_match_jax(rng):
    """A warm start that seeds the coarse level, cut at the level boundary,
    then resumed from the JAX field at full resolution (checkpoint resume),
    each as JAX runs it."""
    iref, imov = make_pair(64, 48, shift=SHIFT)
    jcfg, tcfg = _configs(NITER_CAP)
    u0 = rng.uniform(-0.5, 0.5, (2, 64, 48)).astype(np.float32)
    want_c = J.register(iref, imov, jcfg, initial_motion=u0, stop_scale=1)
    got_c = T.register(iref, imov, tcfg, initial_motion=u0, stop_scale=1, device="cpu")
    _assert_same_run(got_c, want_c)
    assert [t.scale for t in got_c.traces] == [1, 1]
    seed = result_from_numpy(want_c, device="cpu")  # the JAX coarse run seeds the port
    _assert_same_run(
        T.register(iref, imov, tcfg, initial_motion=seed.motion, start_scale=0,
                   device="cpu"),
        J.register(iref, imov, jcfg, initial_motion=want_c.motion, start_scale=0))


def test_register_validates_like_jax():
    iref, imov = make_pair(32, 24)
    cfg = T.RegConfig(method=T.Method.DIFFUSION, niter=(5, 5), nscales=1)
    for kw in ({"start_scale": 2}, {"stop_scale": 2},
               {"initial_motion": np.zeros((2, 16, 12))},
               {"initial_coarse_motion": np.zeros((2, 32, 24))},
               {"initial_motion": np.zeros((2, 32, 24)),
                "initial_coarse_motion": np.zeros((2, 16, 12))}):
        with pytest.raises(ValueError):
            T.register(iref, imov, cfg, device="cpu", **kw)
    with pytest.raises(ValueError):
        T.register(iref, imov[:, :20], cfg, device="cpu")
    with pytest.raises(ValueError):
        T.register(iref, imov, dataclasses.replace(cfg, nscales=4, niter=(5,) * 5),
                   device="cpu")


def test_config_from_jax_round_trip():
    jcfg = J.RegConfig.from_regparams(
        J.Method.DIFFUSION, [30, 20, 10], 2, [0.25], 3, pallas_block_k=4,
        use_pallas=True, warp_halo=3, convergence_tol=0.002,
        compat=J.CompatFlags(maxabs_bug=True, persistent_motion=True))
    tcfg = config_from_jax(jcfg)
    assert tcfg == T.RegConfig.from_regparams(
        T.Method.DIFFUSION, [30, 20, 10], 2, [0.25], 3, block_k=4,
        convergence_tol=0.002,
        compat=T.CompatFlags(maxabs_bug=True, persistent_motion=True))
    assert tcfg.torch_dtype == torch.float32
    jnames = {f.name for f in dataclasses.fields(jcfg)}
    tnames = {f.name for f in dataclasses.fields(tcfg)}
    assert jnames - tnames == {"use_pallas", "warp_halo", "warp_halo_outer",
                               "warp_halo_auto", "pallas_block_k",
                               "pallas_block_elastic", "pallas_block_k_elastic"}
    assert config_from_jax(J.RegConfig(method=J.Method.ELASTIC, niter=(4,))) == \
        T.RegConfig(method=T.Method.ELASTIC, niter=(4,))


def test_result_numpy_round_trip_seeds_jax():
    """A port result crosses to numpy and seeds the JAX package's
    continuation, as a JAX result seeds the port's."""
    iref, imov = make_pair(64, 48, shift=SHIFT)
    jcfg, tcfg = _configs(NITER_CAP)
    got = T.register(iref, imov, tcfg, device="cpu")
    as_np = result_to_numpy(got)
    assert isinstance(as_np.motion, np.ndarray) and as_np.traces[0].iterations == 30
    back = result_from_numpy(as_np, device="cpu")
    assert torch.equal(back.motion, got.motion)
    assert torch.equal(back.coarse_motion, got.coarse_motion)
    _assert_same_run(
        T.register(iref, imov, tcfg, initial_coarse_motion=got.coarse_motion, device="cpu"),
        J.register(iref, imov, jcfg, initial_coarse_motion=as_np.coarse_motion))


def test_verbose_session_prints_banner_and_iterations(capsys):
    iref, imov = make_pair(32, 24, shift=SHIFT)
    ts = T.OpticalFlow2d((32, 24), [12], 0, T.Method.DIFFUSION, [0.1], verbose=True,
                         device="cpu")
    ts.register(iref, imov)
    out = capsys.readouterr().out
    assert "PyTorch implementation" in out and "alpha:           0.1" in out
    assert "[scale 0] iteration 12: relative error" in out
    assert "scale 0: 12 iterations" in out
