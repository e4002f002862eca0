"""The port's CUDA kernels against their plain PyTorch versions on the GPU.

Skipped without a CUDA device. On a machine with one (an H100; the kernels
are built for sm_90a), run without the JAX-side conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: fields 1e-6 max-abs (same operations in the same order with
-fmad=false: in practice bit-equal), Logger sums 1e-5 relative (partial
sums added in another order), registration motion 1e-5 px against the CPU.
"""

import numpy as np
import pytest
import torch

from _torch_helpers import npy
from opticalflow2d_tpu_torch import Method, RegConfig, kernels, register
from opticalflow2d_tpu_torch.kernels.diffusion_block import (
    diffusion_block, diffusion_block_ref, stack_derivs)
from opticalflow2d_tpu_torch.kernels.diffusion_fused import (
    diffusion_step_fused, diffusion_step_ref)
from opticalflow2d_tpu_torch.kernels.warp_fused import (
    compose, compose_ref, warp2d, warp2d_ref)
from opticalflow2d_tpu_torch.solvers.base import derivatives

pytestmark = pytest.mark.cuda

FIELD_TOL = 1e-6
SUMS_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda", 0)


def _blobs(nx, ny, shift=(0.0, 0.0)):
    xs = np.arange(nx)[:, None] - shift[0]
    ys = np.arange(ny)[None, :] - shift[1]
    g = np.zeros((nx, ny))
    for cx, cy, s, a in ((.4, .5, .125, 1.0), (.65, .3, .083, .7), (.3, .75, .104, .5)):
        g += a * np.exp(-((xs - cx * nx) ** 2 + (ys - cy * ny) ** 2) / (2 * (s * nx) ** 2))
    return g.astype(np.float32)


def _inputs(nx, ny, dev, seed=0):
    rng = np.random.default_rng(seed)
    iref = torch.from_numpy(_blobs(nx, ny)).to(dev)
    imov = torch.from_numpy(_blobs(nx, ny, (1.5, -0.8))).to(dev)
    d = derivatives(iref, imov)
    u = torch.from_numpy(rng.normal(0, 2, (2, nx, ny)).astype(np.float32)).to(dev)
    return iref, imov, stack_derivs(d.grad_i, d.it), u


def _max_abs(a, b):
    torch.cuda.synchronize()
    return float((a - b).abs().max())


@pytest.mark.parametrize("shape", [(256, 256), (100, 77), (4, 4), (33, 1000)])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_diffusion_block_matches_plain(cuda, shape, k):
    _, _, g, u = _inputs(*shape, cuda)
    got, sums = diffusion_block(u, g, 0.1, k)
    want, sums_ref = diffusion_block_ref(u, g, 0.1, k)
    assert _max_abs(got, want) <= FIELD_TOL
    np.testing.assert_allclose(npy(sums), npy(sums_ref), rtol=SUMS_RTOL)


@pytest.mark.parametrize("shape", [(256, 256), (100, 77)])
def test_diffusion_step_matches_plain(cuda, shape):
    _, _, g, u = _inputs(*shape, cuda)
    assert _max_abs(diffusion_step_fused(u, g[:2], g[2], 0.1),
                    diffusion_step_ref(u, g[:2], g[2], 0.1)) <= FIELD_TOL


@pytest.mark.parametrize("shape,scale", [((256, 256), 1.5), ((100, 77), 40.0)])
def test_warp_and_compose_match_plain(cuda, shape, scale):
    _, imov, _, u = _inputs(*shape, cuda)
    disp = u * scale
    total = u.flip(0).contiguous()
    assert _max_abs(warp2d(imov, disp), warp2d_ref(imov, disp)) <= FIELD_TOL
    assert _max_abs(compose(total, disp), compose_ref(total, disp)) <= FIELD_TOL


def test_register_gpu_matches_cpu_and_counts_launches(cuda):
    iref, imov, _, _ = _inputs(96, 64, cuda)
    cfg = RegConfig(method=Method.DIFFUSION, niter=(200, 200), nscales=1, nrefine=2,
                    alpha=0.1)
    cpu = register(iref.cpu(), imov.cpu(), cfg)
    kernels.reset_launches()
    gpu = register(iref, imov, cfg)
    assert [t.iterations for t in gpu.traces] == [t.iterations for t in cpu.traces]
    assert _max_abs(gpu.motion.cpu(), cpu.motion) <= 1e-5
    assert gpu.motion.device == cuda
    assert all(n > 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    _, imov, g, u = _inputs(32, 32, cuda)
    with pytest.raises(TypeError):
        diffusion_block(u.double(), g.double(), 0.1, 2)
    with pytest.raises(ValueError):
        diffusion_step_fused(u.transpose(1, 2), g[:2], g[2], 0.1)
    with pytest.raises(ValueError):
        warp2d(imov, u.cpu())
    with pytest.raises(ValueError, match="shared memory"):
        diffusion_block(u, g, 0.1, 64)
