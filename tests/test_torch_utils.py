"""The port's health checks and profiling helpers (``utils.health``,
``utils.profiling``) on the CPU; ``assert_finite`` and ``divergence_guard``
against the JAX package's on the same arrays."""

import glob

import numpy as np
import pytest
import torch

import opticalflow2d_tpu_torch as T
from _torch_helpers import tiled_pair, tt
from opticalflow2d_tpu.utils import health as jax_health
from opticalflow2d_tpu_torch.kernels.diffusion_block import diffusion_block, stack_derivs
from opticalflow2d_tpu_torch.parallel import register_batch
from opticalflow2d_tpu_torch.solvers.base import derivatives
from opticalflow2d_tpu_torch.utils import (
    assert_finite, debug_nans, divergence_guard, kernel_timer, trace)

_RNG = np.random.default_rng(0)
TRACES = {
    "converging": np.geomspace(0.5, 1e-3, 40).astype(np.float32),
    "diverging": np.geomspace(1e-3, 0.5, 40).astype(np.float32),
    "flat": np.full(40, 0.02, np.float32),
    "short": np.array([0.1, 5.0, 9.0], np.float32),
    "zeros_then_growth": np.concatenate([np.zeros(20), np.geomspace(1e-2, 1.0, 12)]).astype(
        np.float32),
    "noise": _RNG.uniform(0.0, 1.0, 64).astype(np.float32),
}


@pytest.mark.parametrize("name", list(TRACES))
@pytest.mark.parametrize("window,factor", [(5, 10.0), (3, 2.0)])
def test_divergence_guard_matches_jax(name, window, factor):
    e = TRACES[name]
    want = jax_health.divergence_guard(e, window=window, factor=factor)
    assert divergence_guard(tt(e), window=window, factor=factor) == want
    assert divergence_guard(e, window=window, factor=factor) == want


@pytest.mark.parametrize("bad", [None, np.nan, np.inf, -np.inf])
def test_assert_finite_matches_jax(bad):
    motion = _RNG.standard_normal((2, 6, 5)).astype(np.float32)
    errors = np.linspace(0, 1, 7, dtype=np.float32)
    if bad is not None:
        motion[1, 2, 3] = bad
    tree_np = {"motion": motion, "traces": (errors, 3)}
    tree_t = {"motion": tt(motion), "traces": (tt(errors), 3)}
    if bad is None:
        jax_health.assert_finite(tree_np)
        assert_finite(tree_t)
        return
    with pytest.raises(FloatingPointError) as want:
        jax_health.assert_finite(tree_np, "res")
    with pytest.raises(FloatingPointError) as got:
        assert_finite(tree_t, "res")
    assert str(got.value) == str(want.value)


def test_assert_finite_reads_a_result():
    iref, imov = tiled_pair(32, 28)
    res = T.register(iref, imov, T.RegConfig(method=T.Method.DIFFUSION, niter=(8,)),
                     device="cpu")
    assert_finite(res, "result")
    bad = res.motion.clone()
    bad[0, 3, 4] = float("nan")
    with pytest.raises(FloatingPointError, match="leaf 0 has 1 non-finite"):
        assert_finite(res._replace(motion=bad))


def test_debug_nans_names_the_scale_and_refinement():
    iref, imov = tiled_pair(32, 28)
    imov[17, 9] = np.nan
    cfg = T.RegConfig(method=T.Method.DIFFUSION, niter=(6, 6), nscales=1, nrefine=2)
    quiet = T.register(iref, imov, cfg, device="cpu")  # off: nothing raised
    assert not all(bool(torch.isfinite(t.errors).all()) for t in quiet.traces)
    with debug_nans():
        with pytest.raises(FloatingPointError, match="scale 1, refinement 0"):
            T.register(iref, imov, cfg, device="cpu")
        with debug_nans(False):
            T.register(iref, imov, cfg, device="cpu")
        with pytest.raises(FloatingPointError, match="scale 1, refinement 0"):
            register_batch(np.stack([iref, iref]), np.stack([iref, imov]), cfg,
                           impl="vmap", device="cpu")
    T.register(iref, imov, cfg, device="cpu")  # restored: off again
    with debug_nans():
        T.register(*tiled_pair(32, 28), cfg, device="cpu")  # finite: nothing raised


def test_kernel_timer_times_a_step_on_the_cpu():
    iref, imov = (tt(x) for x in tiled_pair(32, 28))
    d = derivatives(iref, imov)
    g = stack_derivs(d.grad_i, d.it)
    per_step = kernel_timer(lambda u: diffusion_block(u, g, 0.1, 2)[0],
                            torch.zeros(2, 32, 28), iters_lo=2, iters_hi=6, reps=2)
    assert np.isfinite(per_step) and per_step > 0
    assert kernel_timer(lambda s: (s[0] + 1, s[1]), (torch.zeros(3), 0), 1, 3, 1) > 0
    with pytest.raises(ValueError, match="iters_lo"):
        kernel_timer(lambda u: u, torch.zeros(1), 5, 5)
    with pytest.raises(TypeError, match="no tensor"):
        kernel_timer(lambda u: u, 1.0, 1, 2)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as logdir:
        T.register(*tiled_pair(32, 28), T.RegConfig(method=T.Method.DIFFUSION, niter=(4,)),
                   device="cpu")
    assert logdir == str(tmp_path)
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1 and "traceEvents" in open(files[0]).read()
