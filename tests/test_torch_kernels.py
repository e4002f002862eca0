"""The plain PyTorch versions of the port's CUDA kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU, on the same
numpy inputs; and the CPU behaviour of the kernel wrappers.

Tolerances: fields 1e-6 max-abs (the same operations in the same order;
values are of order 1), Logger sums 1e-5 relative (the per-block partial
sums are added in another order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_helpers import assert_close, npy, tt
from conftest import make_pair

from opticalflow2d_tpu.pallas_kernels.diffusion_block import (
    diffusion_block_pallas, stack_derivs as jstack_derivs)
from opticalflow2d_tpu.pallas_kernels.diffusion_fused import diffusion_step_pallas
from opticalflow2d_tpu.pallas_kernels.warp_fused import compose_pallas, warp2d_pallas
from opticalflow2d_tpu.solvers.base import derivatives as jderivatives
from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.kernels.diffusion_block import (
    diffusion_block, diffusion_block_ref, stack_derivs)
from opticalflow2d_tpu_torch.kernels.diffusion_fused import (
    diffusion_step_fused, diffusion_step_ref)
from opticalflow2d_tpu_torch.kernels.warp_fused import (
    compose, compose_ref, warp2d, warp2d_ref)
from opticalflow2d_tpu_torch.ops.reduce import motion_norm
from opticalflow2d_tpu_torch.solvers.base import derivatives

FIELD_TOL = 1e-6
SUMS_RTOL = 1e-5


def _inputs(nx, ny, rng):
    iref, imov = make_pair(nx, ny, shift=(1.2, -0.7))
    u = rng.standard_normal((2, nx, ny)).astype(np.float32)
    return iref, imov, u


@pytest.mark.parametrize("shape,k", [((64, 48), 8), ((48, 40), 5), ((64, 48), 1)])
def test_diffusion_block_ref_matches_pallas(shape, k, rng):
    iref, imov, u = _inputs(*shape, rng)
    jd = jderivatives(jnp.asarray(iref), jnp.asarray(imov))
    with pltpu.force_tpu_interpret_mode():
        want, want_sums = diffusion_block_pallas(
            jnp.asarray(u), jstack_derivs(jd.grad_i, jd.it), alpha=0.5, k=k)
    d = derivatives(tt(iref), tt(imov))
    got, sums = diffusion_block_ref(tt(u), stack_derivs(d.grad_i, d.it), 0.5, k)
    assert_close(got, want, FIELD_TOL)
    assert sums.shape == (k, 2)
    assert_close(sums, want_sums, 0, SUMS_RTOL)


@pytest.mark.parametrize("shape,alpha", [((64, 48), 0.5), ((48, 40), 0.1)])
def test_diffusion_step_ref_matches_pallas(shape, alpha, rng):
    iref, imov, u = _inputs(*shape, rng)
    jd = jderivatives(jnp.asarray(iref), jnp.asarray(imov))
    with pltpu.force_tpu_interpret_mode():
        want = diffusion_step_pallas(jnp.asarray(u), jd.grad_i, jd.it, alpha=alpha)
    d = derivatives(tt(iref), tt(imov))
    assert_close(diffusion_step_ref(tt(u), d.grad_i, d.it, alpha), want, FIELD_TOL)


@pytest.mark.parametrize("shape", [(64, 48), (45, 37)])
def test_warp_and_compose_ref_match_pallas(shape, rng):
    """Displacements inside the TPU kernel's halo of 2 (its contract); the
    gather of the port has no such bound (see test_torch_ops)."""
    iref, _, _ = _inputs(*shape, rng)
    u = rng.uniform(-1.9, 1.9, (2,) + shape).astype(np.float32)
    u_total = rng.standard_normal((2,) + shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_w = warp2d_pallas(jnp.asarray(iref), jnp.asarray(u), halo=2)
        want_c = compose_pallas(jnp.asarray(u_total), jnp.asarray(u), halo=2)
    assert_close(warp2d_ref(tt(iref), tt(u)), want_w, FIELD_TOL)
    assert_close(compose_ref(tt(u_total), tt(u)), want_c, FIELD_TOL)


def test_block_equals_k_single_steps_and_logger_sums(rng):
    """The block's interior is k single steps in the same op order, and its
    sums are the Logger's summed magnitudes of every step."""
    iref, imov, u = _inputs(40, 36, rng)
    d = derivatives(tt(iref), tt(imov))
    g = stack_derivs(d.grad_i, d.it)
    got, sums = diffusion_block_ref(tt(u), g, 0.3, 6)
    v = tt(u)
    n = v.shape[1] * v.shape[2]
    for t in range(6):
        new = diffusion_step_ref(v, d.grad_i, d.it, 0.3)
        assert_close(sums[t, 0], motion_norm(new - v) * n, 0, 1e-5)
        assert_close(sums[t, 1], motion_norm(v) * n, 0, 1e-5)
        v = new
    assert torch.equal(got, v)


def test_wrappers_take_the_plain_version_on_cpu(rng):
    iref, imov, u = _inputs(24, 20, rng)
    d = derivatives(tt(iref), tt(imov))
    g = stack_derivs(d.grad_i, d.it)
    before = dict(kernels.LAUNCHES)
    blk, sums = diffusion_block(tt(u), g, 0.2, 3)
    ref_blk, ref_sums = diffusion_block_ref(tt(u), g, 0.2, 3)
    assert torch.equal(blk, ref_blk) and torch.equal(sums, ref_sums)
    assert torch.equal(diffusion_step_fused(tt(u), g[:2], g[2], 0.2),
                       diffusion_step_ref(tt(u), g[:2], g[2], 0.2))
    assert torch.equal(warp2d(tt(imov), tt(u)), warp2d_ref(tt(imov), tt(u)))
    assert torch.equal(compose(tt(u), tt(u)), compose_ref(tt(u), tt(u)))
    assert kernels.LAUNCHES == before  # no kernel ran


@pytest.mark.parametrize("mixed", [False, True])
def test_wrappers_raise_on_other_devices(mixed):
    """No device but the CPU and CUDA has a path, and only inputs that all
    lie on the CPU take the plain version: the wrappers raise rather than
    fall back."""
    u = torch.zeros((2, 8, 8), device="meta")
    g = torch.zeros((3, 8, 8), device="cpu" if mixed else "meta")
    with pytest.raises(ValueError):
        diffusion_block(u, g, 0.1, 2)
    with pytest.raises(ValueError):
        diffusion_step_fused(u, g[:2], g[2], 0.1)
    with pytest.raises(ValueError):
        warp2d(g[0], u)
    with pytest.raises(ValueError):
        compose(g[:2], u)


@pytest.mark.parametrize("bad,exc", [
    (torch.zeros((2, 8, 8), dtype=torch.float64), TypeError),
    (torch.zeros((2, 8, 9)), ValueError),
    (torch.zeros((2, 8, 8)).transpose(1, 2), ValueError),
])
def test_check_cuda_rejects(bad, exc):
    with pytest.raises(exc):
        _build.check_cuda("u", bad, (2, 8, 8), torch.device("cpu"))


def test_build_names_and_rounding():
    path = _build.library_path()
    assert path == _build.library_path()  # stable for unchanged sources
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libof2d_kernels_")
    assert {p.name for p in _build.CSRC.glob("*.cu")} >= {
        "diffusion_block.cu", "diffusion_step.cu", "warp_gather.cu"}
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS) and "-fmad=false" in _build.NVCC_FLAGS
    assert _build.f32(0.1 * 0.1) == float(np.float32(0.1 * 0.1))


def test_stack_derivs(rng):
    a = rng.standard_normal((2, 5, 4)).astype(np.float32)
    b = rng.standard_normal((5, 4)).astype(np.float32)
    assert_close(stack_derivs(tt(a), tt(b)), jstack_derivs(jnp.asarray(a), jnp.asarray(b)), 0)
    assert npy(stack_derivs(tt(a), tt(b))).shape == (3, 5, 4)
