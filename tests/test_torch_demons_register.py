"""The port's Thirion and diffeomorphic demons registration and session
against the JAX package on the same numpy pairs (CPU), and the default
device of the entry points.

The port's CPU path runs the plain versions of its kernels along the route
the GPU takes. It is held against JAX's jnp path with its exact gather
(``warp_halo=0``, ``warp_halo_outer=0``; JAX's roll paths compile into
other fused sums, which round apart and drift by up to 3e-5 px over a
capped level), and once against JAX's Pallas path in interpret mode.
Tolerances: motion 1e-5 px max-abs, iteration counts equal at every level,
per-iteration errors rtol 1e-4 / atol 1e-6 (the Logger sums are added in
another order). All tests share one pair and one ``niter``, under which
the Logger stop lands before the cap on the coarse level of every config
and on every level of ``diffeomorphic_expmap``.
"""

import dataclasses

import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import opticalflow2d_tpu as J
import opticalflow2d_tpu_torch as T
from _torch_helpers import assert_close, tt
from conftest import make_pair
from opticalflow2d_tpu_torch.interop import config_from_jax, result_from_numpy

MOTION_TOL = 1e-5
SHAPE = (48, 40)
NITER = (150, 150)
EXACT = dict(warp_halo=0, warp_halo_outer=0, warp_halo_auto=False)

# name -> (method, JAX config fields); every route of solvers/demons.py.
CONFIGS = {
    "thirion_composition": (J.Method.THIRIONS_DEMONS, {}),
    "thirion_addition": (J.Method.THIRIONS_DEMONS,
                         dict(accumulation=J.MotionAccumulation.ADDITION)),
    "diffeomorphic_identity": (J.Method.DIFFEOMORPHIC_DEMONS, {}),
    # sigma_x / (2 sigma_i) = 1: the exp map squares where |c| > 0.5.
    "diffeomorphic_expmap": (J.Method.DIFFEOMORPHIC_DEMONS,
                             dict(sigma_i=0.5, sigma_x=1.0, sigma_diffusion=3.0,
                                  kernelwidth=7)),
    "diffeomorphic_maxabs_bug": (J.Method.DIFFEOMORPHIC_DEMONS,
                                 dict(compat=J.CompatFlags(maxabs_bug=True))),
    "thirion_flatwrap": (J.Method.THIRIONS_DEMONS,
                         dict(compat=J.CompatFlags(conv_flatwrap=True))),
}


def _pair():
    return make_pair(*SHAPE, shift=(1.5, -0.8))


def _configs(name, nrefine=2, **jax_kw):
    method, fields = CONFIGS[name]
    jcfg = J.RegConfig(method=method, niter=NITER, nscales=1, nrefine=nrefine,
                       **{**EXACT, **jax_kw}, **fields)
    return jcfg, config_from_jax(jcfg)


def _assert_same_run(got, want):
    assert [t.iterations for t in got.traces] == [int(t.iterations) for t in want.traces]
    assert [t.scale for t in got.traces] == [int(t.scale) for t in want.traces]
    for a, b in zip(got.traces, want.traces):
        assert_close(a.errors, b.errors, 1e-6, 1e-4)
        assert a.fallbacks == 0 and a.regrids == 0
    assert_close(got.motion, want.motion, MOTION_TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_register_matches_jax(name):
    iref, imov = _pair()
    jcfg, tcfg = _configs(name)
    want = J.register(iref, imov, jcfg)
    got = T.register(tt(iref), tt(imov), tcfg, device="cpu")
    _assert_same_run(got, want)
    assert got.traces[0].iterations < NITER[1]  # the coarse level stops
    assert got.motion.dtype == torch.float32 and got.motion.device.type == "cpu"
    assert_close(got.coarse_motion, want.coarse_motion, MOTION_TOL)


def test_register_matches_jax_pallas_interpret():
    """Against JAX's one-pass Thirion kernel (the TPU's production path),
    run in interpret mode; one refinement, to keep the interpreter short."""
    iref, imov = _pair()
    jcfg, tcfg = _configs("thirion_composition", nrefine=1, warp_halo=2, use_pallas=True)
    with pltpu.force_tpu_interpret_mode():
        want = J.register(iref, imov, jcfg)
    _assert_same_run(T.register(iref, imov, tcfg, device="cpu"), want)


@pytest.mark.parametrize("method,regparams", [
    (J.Method.THIRIONS_DEMONS, [1.0, 0.25, 2.0, 2.0, 5, 0]),
    (J.Method.DIFFEOMORPHIC_DEMONS, [0.5, 1.0, 3.0, 2.0, 7]),
])
def test_session_matches_jax(method, regparams):
    iref, imov = _pair()
    args = (SHAPE, list(NITER), 1, method, regparams, 2)
    js = J.OpticalFlow2d(*args, **EXACT)
    ts = T.OpticalFlow2d(*args, device="cpu")
    _assert_same_run(ts.register(iref, imov), js.register(iref, imov))
    assert tuple(ts.get_motion().shape) == SHAPE + (2,)
    assert_close(ts.get_motion(), js.get_motion(), MOTION_TOL)
    assert_close(ts.warp(imov), js.warp(imov), 1e-5)
    ts.close()
    with pytest.raises(RuntimeError):
        ts.get_motion()


def test_persistent_motion_session_matches_jax():
    """A second register continues from the first call's coarsest field,
    as JAX's persistent session does."""
    iref, imov = _pair()
    jcfg, _ = _configs("thirion_composition")
    ts = T.OpticalFlow2d(SHAPE, list(NITER), 1, T.Method.THIRIONS_DEMONS,
                         [1.0, 0.25, 2.0, 2.0, 5, 0], 2, device="cpu",
                         compat=T.CompatFlags(persistent_motion=True))
    want = J.register(iref, imov, jcfg)
    _assert_same_run(ts.register(iref, imov), want)
    want = J.register(iref, imov, jcfg, initial_coarse_motion=want.coarse_motion)
    got = ts.register(iref, imov)
    _assert_same_run(got, want)
    assert got.traces[0].errors[1] != 0  # a warm coarse start


@pytest.mark.parametrize("method,regparams,extra", [
    (J.Method.THIRIONS_DEMONS, [0.8, 0.3, 1.5, 2.5, 7.9, 1], {}),
    (J.Method.DIFFEOMORPHIC_DEMONS, [0.25, 1.0, 2.0, 2.0, 5],
     dict(compat=J.CompatFlags(maxabs_bug=True, conv_flatwrap=True))),
])
def test_config_from_jax_demons(method, regparams, extra):
    jcfg = J.RegConfig.from_regparams(method, [30, 20], 1, regparams, 2, use_pallas=True,
                                      **extra)
    tcfg = config_from_jax(jcfg)
    assert tcfg == T.RegConfig.from_regparams(
        T.Method(int(method)), [30, 20], 1, regparams, 2,
        **{k: T.CompatFlags(**dataclasses.asdict(v)) for k, v in extra.items()})
    for field in ("sigma_i", "sigma_x", "sigma_diffusion", "sigma_fluid", "kernelwidth"):
        assert getattr(tcfg, field) == getattr(jcfg, field)
    assert int(tcfg.accumulation) == int(jcfg.accumulation)
    with pytest.raises(ValueError):
        T.RegConfig.from_regparams(T.Method(int(method)), [30, 20], 1, regparams[:-1])


def test_entry_points_default_to_cuda(monkeypatch):
    """No ``device`` means the GPU: on a host without CUDA every entry point
    raises and names ``device="cpu"``; with it the run takes place on the
    CPU, for arrays and tensors alike."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    iref, imov = make_pair(16, 16)
    cfg = T.RegConfig(method=T.Method.THIRIONS_DEMONS, niter=(3,))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.register(iref, imov, cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.OpticalFlow2d((16, 16), [3], 0, T.Method.THIRIONS_DEMONS,
                        [1.0, 0.25, 2.0, 2.0, 5, 0])
    got = T.register(iref, tt(imov), cfg, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        result_from_numpy(got)
    assert got.motion.device.type == "cpu" and got.traces[0].iterations == 3
    assert result_from_numpy(got, device="cpu").motion.device.type == "cpu"


def test_verbose_demons_session_prints_banner_and_iterations(capsys):
    iref, imov = make_pair(24, 20, shift=(1.5, -0.8))
    ts = T.OpticalFlow2d((24, 20), [4], 0, T.Method.DIFFEOMORPHIC_DEMONS,
                         [0.5, 1.0, 2.0, 2.0, 5], verbose=True, device="cpu")
    ts.register(iref, imov)
    out = capsys.readouterr().out
    assert "sigma_x:         1.0" in out and "accumulation" not in out
    assert "[scale 0] iteration 4: relative error" in out
    assert "scale 0: 4 iterations" in out
