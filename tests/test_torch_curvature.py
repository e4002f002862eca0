"""The port's DCT transforms, curvature eigenvalues, curvature step and
curvature registration against the JAX package on the same numpy inputs
(CPU), the ``dct_impl`` configuration, and the curvature registration
against the prebuilt C++ oracle.

The JAX side runs compiled: the curvature update is a contraction (its
eigenvalues are at most 1), so the ulps of XLA's fused multiply-adds do
not grow. Both packages take the same routes: ``"matmul"``, the dense
transform, and ``"fft"``, the Makhoul factorization (JAX's production
``"auto"`` is its split-radix MXU tier, which the port does not have).

Tolerances: transforms 2e-6 of max |out| (XLA's and PyTorch's matmul and
FFT add in other orders); the eigenvalue tables bit for bit; the
transform matrices at n = 2048, where JAX generates them on the device in
float32 and the port casts the float64 table, within 4 ulp of 2.0 (JAX's
own table is up to 3.25 ulp off); the step 1e-6 max-abs; registrations
1e-5 px with equal iteration counts at every (level, refinement); the
oracle as ``test_parity_oracle.py``'s curvature test: mean endpoint error
< 1e-5 and max < 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opticalflow2d_tpu as J
import opticalflow2d_tpu_torch as T
from _torch_helpers import assert_close, npy, tiled_pair, tt
from conftest import make_pair
from opticalflow2d_tpu.ops import dct as JD
from opticalflow2d_tpu.solvers.base import Derivatives as JDerivatives
from opticalflow2d_tpu.solvers.curvature import make_curvature_step as j_make_curvature_step
from opticalflow2d_tpu_torch.interop import config_from_jax
from opticalflow2d_tpu_torch.ops import dct as TD
from opticalflow2d_tpu_torch.solvers import make_curvature_step
from opticalflow2d_tpu_torch.solvers.base import derivatives

MOTION_TOL = 1e-5
SHAPE = (64, 48)
ALPHA, TAU = 0.1, 1.0
TRANSFORMS = ("dct2_fftw", "idct2_fftw", "dct2_fft", "idct2_fft")


@pytest.mark.parametrize("shape", [(32, 28), (64, 48), (5, 7), (2, 64, 48)])
@pytest.mark.parametrize("name", TRANSFORMS)
def test_transforms_match_jax(shape, name):
    a = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(getattr(JD, name)(jnp.asarray(a)))
    got = getattr(TD, name)(tt(a))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert_close(got, want, 2e-6 * np.abs(want).max())


@pytest.mark.parametrize("name", ["dct2", "idct2"])
@pytest.mark.parametrize("shape", [(64, 48), (5, 7)])
def test_fft_route_matches_matmul_route(shape, name):
    a = tt(np.random.default_rng(1).standard_normal(shape))
    want = getattr(TD, f"{name}_fftw")(a)
    assert_close(getattr(TD, f"{name}_fft")(a), want, 2e-6 * float(want.abs().max()))


def test_transforms_invert_each_other():
    a = tt(np.random.default_rng(2).standard_normal((2, 32, 28)))
    for fwd, inv in ((TD.dct2_fftw, TD.idct2_fftw), (TD.dct2_fft, TD.idct2_fft)):
        assert_close(inv(fwd(a)) / (4 * 32 * 28), a, 1e-5)


@pytest.mark.parametrize("shape", [(32, 28), (2048, 16), (16, 2048)])
def test_curvature_eigenvalues_bit_equal(shape):
    want = np.asarray(JD.curvature_eigenvalues(*shape, ALPHA, TAU))
    got = npy(TD.curvature_eigenvalues(*shape, ALPHA, TAU))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", [2, 3])
def test_transform_matrices_at_2048(kind):
    """The port casts the float64 table at every extent; JAX generates it on
    the device from 2048 up, a few ulp off."""
    n = 2048
    got = npy(TD.dct_matrix(n, kind, "cpu"))
    np.testing.assert_array_equal(got, TD._TABLES[kind](n).astype(np.float32))
    want = np.asarray(JD._dct_matrix(n, kind, jnp.float32))
    assert np.abs(got - want).max() <= 4 * np.spacing(np.float32(2.0))


@pytest.mark.parametrize("dct_impl", ["matmul", "fft"])
def test_curvature_step_matches_jax(dct_impl):
    """A step at the pair's derivatives and a motion of up to 1.5 px."""
    iref, imov = tiled_pair(*SHAPE)
    d = derivatives(tt(iref), tt(imov))
    g, it = npy(d.grad_i), npy(d.it)
    u = (1.5 * np.tanh(np.random.default_rng(3).standard_normal((2,) + SHAPE))).astype(np.float32)
    want = j_make_curvature_step(*SHAPE, ALPHA, TAU, dct_impl=dct_impl)(
        jnp.asarray(u), JDerivatives(jnp.asarray(g), jnp.asarray(it)))
    step = make_curvature_step(*SHAPE, ALPHA, TAU, dct_impl=dct_impl)
    got = step(tt(u), d)
    assert_close(got, want, 1e-6)
    assert torch.equal(step(tt(u), d), got)  # the cached table


def test_curvature_step_refuses_an_unknown_transform():
    with pytest.raises(ValueError, match="dct_impl"):
        make_curvature_step(*SHAPE, ALPHA, TAU, dct_impl="split_high")


def _assert_same_run(got, want):
    assert [t.iterations for t in got.traces] == [int(t.iterations) for t in want.traces]
    for a, b in zip(got.traces, want.traces):
        assert_close(a.errors, b.errors, 1e-6, 1e-4)
    assert_close(got.motion, want.motion, MOTION_TOL)


# At tol 0.01 the Logger stop lands at iterations 91 and 92 of the
# full-resolution level (the error falls as about 1/t on this pair); the
# coarse level runs to its cap of 60.
@pytest.mark.parametrize("dct_impl", ["matmul", "fft"])
def test_register_matches_jax(dct_impl):
    iref, imov = tiled_pair(*SHAPE)
    jcfg = J.RegConfig(method=J.Method.CURVATURE, niter=(150, 60), nscales=1, nrefine=2,
                       alpha=ALPHA, tau=TAU, dct_impl=dct_impl, convergence_tol=0.01)
    want = J.register(iref, imov, jcfg)
    got = T.register(tt(iref), tt(imov), config_from_jax(jcfg), device="cpu")
    _assert_same_run(got, want)
    assert any(t.iterations < 150 for t in got.traces if t.scale == 0)


@pytest.mark.parametrize("jax_impl,port_impl", [
    ("auto", "auto"), ("matmul", "matmul"), ("fft", "fft"), ("split", "matmul"),
    ("split_high", "matmul"), ("split_fast", "matmul"), ("matmul_high", "matmul"),
    ("matmul_fast", "matmul"),
])
def test_config_from_jax_carries_dct_impl(jax_impl, port_impl):
    jcfg = J.RegConfig.from_regparams(J.Method.CURVATURE, [20], 0, [0.1, 1.0],
                                      dct_impl=jax_impl)
    assert config_from_jax(jcfg).dct_impl == port_impl


@pytest.mark.parametrize("compat", [T.CompatFlags(), T.CompatFlags(maxabs_bug=True),
                                    T.CompatFlags(conv_flatwrap=True)])
def test_resolved_dct_impl(compat):
    """``"auto"`` is the dense transform for every config (the fft route is
    a choice; ``RegConfig.resolved_dct_impl`` says why): the compat configs'
    resolution is JAX's, the others' JAX's MXU tier at full float32."""
    cfg = T.RegConfig(method=T.Method.CURVATURE, niter=(5,), compat=compat)
    assert cfg.resolved_dct_impl == "matmul"
    for impl in ("matmul", "fft"):
        assert T.RegConfig(method=T.Method.CURVATURE, niter=(5,), compat=compat,
                           dct_impl=impl).resolved_dct_impl == impl
    jcfg = J.RegConfig(method=J.Method.CURVATURE, niter=(5,),
                       compat=J.CompatFlags(maxabs_bug=compat.maxabs_bug,
                                            conv_flatwrap=compat.conv_flatwrap))
    assert config_from_jax(J.RegConfig(method=J.Method.CURVATURE, niter=(5,),
                                       dct_impl=jcfg.resolved_dct_impl)).dct_impl == "matmul"


def test_config_refuses_an_unknown_dct_impl():
    with pytest.raises(ValueError, match="dct_impl"):
        T.RegConfig(method=T.Method.CURVATURE, niter=(5,), dct_impl="split_high")


def test_register_matches_oracle():
    """``test_parity_oracle.py::test_curvature_pyramid_bit_parity``'s setting:
    compat on, so the route is ``"matmul"``."""
    from oracle_utils import endpoint_error, ensure_oracle, run_oracle

    try:
        ensure_oracle()
    except Exception:  # pragma: no cover
        pytest.skip("oracle build failed")
    iref, imov = make_pair(48, 40, shift=(1.5, -0.8))
    u_ref, _ = run_oracle(iref, imov, 1, 2, int(T.Method.CURVATURE), [0.1, 1.0], [40, 20])
    cfg = T.RegConfig.from_regparams(T.Method.CURVATURE, [40, 20], 1, [0.1, 1.0], 2,
                                     compat=T.CompatFlags(maxabs_bug=True, conv_flatwrap=True))
    assert cfg.resolved_dct_impl == "matmul"
    u = npy(T.register(iref, imov, cfg, device="cpu").motion).astype(np.float64)
    assert endpoint_error(u, u_ref) < 1e-5
    assert np.abs(u - u_ref).max() < 2e-4


@pytest.mark.parametrize("dct_impl", ["matmul", "fft"])
def test_curvature_step_returns_a_contiguous_field(dct_impl):
    """The Logger norms kernel takes contiguous fields only."""
    iref, imov = tiled_pair(32, 28)
    d = derivatives(tt(iref), tt(imov))
    u = torch.zeros((2, 32, 28))
    assert make_curvature_step(32, 28, ALPHA, TAU, dct_impl=dct_impl)(u, d).is_contiguous()
