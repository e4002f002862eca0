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
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.kernels import demons_fused, demons_onepass
from opticalflow2d_tpu_torch.kernels.diffusion_block import (
    diffusion_block, diffusion_block_ref, stack_derivs)
from opticalflow2d_tpu_torch.kernels.diffusion_fused import (
    diffusion_step_fused, diffusion_step_ref)
from opticalflow2d_tpu_torch.kernels.logger_norms import logger_norms, logger_norms_ref
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
    cpu = register(iref, imov, cfg, device="cpu")
    kernels.reset_launches()
    gpu = register(iref, imov, cfg)
    assert [t.iterations for t in gpu.traces] == [t.iterations for t in cpu.traces]
    assert _max_abs(gpu.motion.cpu(), cpu.motion) <= 1e-5
    assert gpu.motion.device == cuda
    diffusion_path = ("diffusion_block", "diffusion_step", "warp2d", "compose")
    assert all(kernels.LAUNCHES[name] > 0 for name in diffusion_path), kernels.LAUNCHES


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


@pytest.mark.parametrize("shape", [(256, 256), (100, 77), (33, 1000)])
def test_logger_norms_matches_plain(cuda, shape):
    _, _, _, u = _inputs(*shape, cuda)
    v = u.flip(1).contiguous()
    np.testing.assert_allclose(npy(logger_norms(u, v)), npy(logger_norms_ref(u, v)),
                               rtol=SUMS_RTOL)


def _demons_inputs(nx, ny, dev, scale):
    """The blob pair and a motion field of +-``scale`` px: samples fall
    inside, on the edges and outside the grid."""
    iref, imov, _, u = _inputs(nx, ny, dev)
    return imov, iref, (torch.tanh(u) * scale).contiguous()


@pytest.mark.parametrize("shape,kw,scale", [((256, 256), 5, 1.5), ((100, 77), 11, 30.0)])
@pytest.mark.parametrize("addition", [False, True])
def test_demons_onepass_matches_plain(cuda, shape, kw, scale, addition):
    iaux, iref, u = _demons_inputs(*shape, cuda, scale)
    args = (iaux, iref, u, 1.0, 0.25, 2.0, 1.5, kw, addition)
    got, sums = demons_onepass.thirion_onepass(*args, with_errors=True)
    want, sums_ref = demons_onepass.thirion_onepass_ref(*args, with_errors=True)
    assert _max_abs(got, want) <= FIELD_TOL
    np.testing.assert_allclose(npy(sums), npy(sums_ref), rtol=SUMS_RTOL)
    assert _max_abs(demons_onepass.thirion_onepass(*args), want) <= FIELD_TOL


@pytest.mark.parametrize("shape,kw,scale", [((256, 256), 5, 1.5), ((100, 77), 11, 30.0)])
def test_demons_correspondence_and_compose_smooth_match_plain(cuda, shape, kw, scale):
    iaux, iref, u = _demons_inputs(*shape, cuda, scale)
    c = demons_fused.demons_correspondence(iaux, iref, u, 0.25, 1.0, 2.0, kw)
    c_ref = demons_fused.demons_correspondence_ref(iaux, iref, u, 0.25, 1.0, 2.0, kw)
    assert _max_abs(c, c_ref) <= FIELD_TOL
    c = (c_ref * scale).contiguous()
    assert _max_abs(demons_fused.compose_smooth(u, c, 2.0, kw),
                    demons_fused.compose_smooth_ref(u, c, 2.0, kw)) <= FIELD_TOL


def test_demons_smem_sizes_match_the_kernels(cuda):
    lib = _build.load()
    for kw in (1, 5, 11, 43):
        assert lib.of2d_demons_onepass_smem_bytes(kw) == demons_onepass.onepass_smem_bytes(kw)
        assert lib.of2d_demons_correspondence_smem_bytes(kw) == \
            demons_fused.correspondence_smem_bytes(kw)
        assert lib.of2d_compose_smooth_smem_bytes(kw) == demons_fused.compose_smooth_smem_bytes(kw)
    assert lib.of2d_max_smem_optin(0) >= demons_onepass.MAX_SMEM_BYTES


@pytest.mark.parametrize("method,extra", [
    (Method.THIRIONS_DEMONS, {}),
    (Method.DIFFEOMORPHIC_DEMONS, dict(sigma_i=0.25, sigma_x=1.0)),
])
def test_register_demons_gpu_matches_cpu(cuda, method, extra):
    iref, imov, _, _ = _inputs(96, 64, cuda)
    cfg = RegConfig(method=method, niter=(150, 150), nscales=1, nrefine=2, **extra)
    cpu = register(iref, imov, cfg, device="cpu")
    kernels.reset_launches()
    gpu = register(iref, imov, cfg)
    assert [t.iterations for t in gpu.traces] == [t.iterations for t in cpu.traces]
    assert _max_abs(gpu.motion.cpu(), cpu.motion) <= 1e-5
    assert gpu.motion.device == cuda
    want = ["warp2d", "compose"] + (["demons_onepass"] if not extra else
                                    ["demons_correspondence", "compose_smooth", "logger_norms"])
    assert all(kernels.LAUNCHES[name] > 0 for name in want), kernels.LAUNCHES
