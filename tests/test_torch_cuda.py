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
from opticalflow2d_tpu_torch.kernels.elastic_block import elastic_block, elastic_block_ref
from opticalflow2d_tpu_torch.engine import registration
from opticalflow2d_tpu_torch.kernels.fluid_fused import (
    fluid_euler, fluid_euler_ref, fluid_iter, fluid_iter_ref, fluid_sweep_max,
    fluid_sweep_max_ref)
from opticalflow2d_tpu_torch.kernels.logger_norms import (
    fluid_metrics, fluid_metrics_ref, logger_norms, logger_norms_ref)
from opticalflow2d_tpu_torch.kernels.warp_fused import (
    compose, compose_ref, warp2d, warp2d_ref)
from opticalflow2d_tpu_torch.solvers.base import derivatives
from opticalflow2d_tpu_torch.solvers.fluid import make_fluid_step, make_fluid_two_pass_step
from opticalflow2d_tpu_torch.kernels import diffusion_block as k_diff
from opticalflow2d_tpu_torch.kernels import elastic_block as k_el
from opticalflow2d_tpu_torch.kernels import fluid_fused as k_fl
from opticalflow2d_tpu_torch.kernels import warp_fused as k_wf
from opticalflow2d_tpu_torch.parallel import make_mesh, make_register_sp, spatial

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


def _zero_border(u):
    u = u.clone()
    u[:, [0, -1], :] = 0
    u[:, :, [0, -1]] = 0
    return u


@pytest.mark.parametrize("shape", [(256, 256), (100, 77), (4, 4), (33, 1000)])
@pytest.mark.parametrize("k,ref_stencil", [(1, True), (2, True), (4, True), (4, False)])
def test_elastic_block_matches_plain(cuda, shape, k, ref_stencil):
    _, _, g, u = _inputs(*shape, cuda)
    u = _zero_border(u * 0.5)
    got, sums = elastic_block(u, g, 0.25, 0.1, 1.5, ref_stencil, k)
    want, sums_ref = elastic_block_ref(u, g, 0.25, 0.1, 1.5, ref_stencil, k)
    assert _max_abs(got, want) <= FIELD_TOL
    np.testing.assert_allclose(npy(sums), npy(sums_ref), rtol=SUMS_RTOL)


@pytest.mark.parametrize("shape", [(256, 256), (100, 77), (4, 4), (33, 1000)])
@pytest.mark.parametrize("ref_stencil,bug", [(True, False), (False, False), (True, True)])
def test_fluid_iter_matches_plain(cuda, shape, ref_stencil, bug):
    _, _, g, u = _inputs(*shape, cuda)
    vel = _zero_border(torch.tanh(u.flip(1)) * 0.3).contiguous()
    u = (torch.tanh(u) * 0.6).contiguous()
    got = fluid_iter(u, vel, g, 0.25, 0.1, 1.5, ref_stencil, bug)
    want = fluid_iter_ref(u, vel, g, 0.25, 0.1, 1.5, ref_stencil, bug)
    assert _max_abs(got[0], want[0]) <= FIELD_TOL
    assert _max_abs(got[1], want[1]) <= FIELD_TOL
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)


@pytest.mark.parametrize("shape,scale", [((256, 256), 3.0), ((100, 77), 0.5), ((33, 1000), 3.0)])
def test_fluid_metrics_matches_plain(cuda, shape, scale):
    _, _, _, u = _inputs(*shape, cuda)
    u_new = (torch.tanh(u) * scale).contiguous()
    u_prev = (u_new * 0.8).contiguous()
    got, want = npy(fluid_metrics(u_new, u_prev)), npy(fluid_metrics_ref(u_new, u_prev))
    np.testing.assert_allclose(got[:2], want[:2], rtol=SUMS_RTOL)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    assert scale < 1 or got[2] < 0.5


def test_elastic_block_rejects_a_tile_that_does_not_fit(cuda):
    _, _, g, u = _inputs(32, 32, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        elastic_block(u, g, 0.25, 0.1, 1.5, True, 16)


@pytest.mark.parametrize("method,extra", [
    (Method.ELASTIC, dict(mu=0.25, lam=0.1, omega=1.5)),
    (Method.FLUID, dict(mu=0.25, lam=0.0, regrid_threshold=0.95)),
])
def test_register_elastic_and_fluid_gpu_matches_cpu(cuda, method, extra):
    iref, imov, _, _ = _inputs(96, 64, cuda)
    cfg = RegConfig(method=method, niter=(150, 150), nscales=1, nrefine=2, **extra)
    cpu = register(iref, imov, cfg, device="cpu")
    kernels.reset_launches()
    gpu = register(iref, imov, cfg)
    assert [t.iterations for t in gpu.traces] == [t.iterations for t in cpu.traces]
    assert [t.regrids for t in gpu.traces] == [t.regrids for t in cpu.traces]
    assert _max_abs(gpu.motion.cpu(), cpu.motion) <= 1e-5
    want = (["elastic_block"] if method == Method.ELASTIC else
            ["fluid_iter", "fluid_metrics"]) + ["warp2d", "compose"]
    assert all(kernels.LAUNCHES[name] > 0 for name in want), kernels.LAUNCHES


@pytest.mark.parametrize("method", [Method.ELASTIC, Method.FLUID])
def test_lexicographic_sweep_runs_plain_on_the_gpu(cuda, method):
    """The lexicographic ordering has no kernel: it runs its plain version
    on CUDA tensors and matches the CPU run."""
    iref, imov, _, _ = _inputs(16, 12, cuda)
    cfg = RegConfig(method=method, niter=(12,), mu=0.25, lam=0.1, omega=1.5,
                    sor_ordering="lexicographic")
    cpu = register(iref, imov, cfg, device="cpu")
    gpu = register(iref, imov, cfg)
    assert [t.iterations for t in gpu.traces] == [t.iterations for t in cpu.traces]
    assert _max_abs(gpu.motion.cpu(), cpu.motion) <= 1e-5


def _fluid_inputs(shape, dev):
    _, _, g, u = _inputs(*shape, dev)
    vel = _zero_border(torch.tanh(u.flip(1)) * 0.3).contiguous()
    return (torch.tanh(u) * 0.6).contiguous(), vel, g


@pytest.mark.parametrize("shape", [(256, 256), (100, 77), (4, 4), (33, 1000)])
@pytest.mark.parametrize("ref_stencil,bug", [(True, False), (False, False), (True, True)])
def test_fluid_sweep_max_matches_plain_and_fluid_iter(cuda, shape, ref_stencil, bug):
    """B8 against its plain version, and bit for bit against B7's vel' and
    max |R|^2 on the same inputs."""
    u, vel, g = _fluid_inputs(shape, cuda)
    args = (u, vel, g, 0.25, 0.1, 1.5, ref_stencil, bug)
    got_v, got_m = fluid_sweep_max(*args)
    want_v, want_m = fluid_sweep_max_ref(*args)
    assert _max_abs(got_v, want_v) <= FIELD_TOL
    np.testing.assert_allclose(float(got_m), float(want_m), rtol=1e-6)
    b7_v, _, b7_m = fluid_iter(*args)
    assert torch.equal(got_v, b7_v) and torch.equal(got_m, b7_m)


@pytest.mark.parametrize("shape", [(256, 256), (100, 77), (2, 2), (33, 1000)])
@pytest.mark.parametrize("gate", [0.37, 0.0])
def test_fluid_euler_matches_plain(cuda, shape, gate):
    u, vel, _ = _fluid_inputs(shape, cuda)
    gate = torch.tensor(gate, device=cuda)
    got = fluid_euler(u, vel, gate)
    assert _max_abs(got, fluid_euler_ref(u, vel, gate)) <= FIELD_TOL
    if float(gate) == 0:
        assert torch.equal(got, u)


@pytest.mark.parametrize("shape", [(256, 256), (100, 77)])
def test_two_pass_iteration_equals_one_pass_iteration(cuda, shape):
    """One iteration by each route, bit for bit: B8 + gate + B9 against B7 +
    the plain Euler update; B9's R equals B7's."""
    u, vel, g = _fluid_inputs(shape, cuda)
    one = make_fluid_step(0.25, 0.1, 1.5)(u, vel, g)
    two = make_fluid_two_pass_step(0.25, 0.1, 1.5)(u, vel, g)
    assert torch.equal(two[0], one[0]) and torch.equal(two[1], one[1])
    v, r, _ = fluid_iter(u, vel, g, 0.25, 0.1, 1.5)
    assert torch.equal(fluid_euler(u, v, torch.tensor(1.0, device=cuda)), u + r)


def test_forced_two_pass_route_equals_default_gpu_run(cuda):
    """A fluid registration with every level on the two-pass route (the
    route's extent lowered) gives the default run's bits and counts, and
    launches B8 and B9 once an iteration."""
    iref, imov, _, _ = _inputs(96, 64, cuda)
    cfg = RegConfig(method=Method.FLUID, niter=(150, 150), nscales=1, nrefine=2, mu=0.25,
                    lam=0.0, regrid_threshold=0.95)
    want = register(iref, imov, cfg)
    kernels.reset_launches()
    saved = registration._DERIV_BARRIER_MIN_EXTENT
    registration._DERIV_BARRIER_MIN_EXTENT = 0
    try:
        got = register(iref, imov, cfg)
    finally:
        registration._DERIV_BARRIER_MIN_EXTENT = saved
    iterations = sum(t.iterations for t in got.traces)
    assert [t.iterations for t in got.traces] == [t.iterations for t in want.traces]
    assert [t.regrids for t in got.traces] == [t.regrids for t in want.traces]
    assert torch.equal(got.motion, want.motion)
    assert kernels.LAUNCHES["fluid_sweep_max"] == kernels.LAUNCHES["fluid_euler"] == iterations
    assert kernels.LAUNCHES["fluid_iter"] == 0


# --- the strip kernels K1-K4 (parallel.spatial) ---------------------------------

STRIP_SHAPES = [(256, 256), (100, 77)]  # 4 strips: nxl 64, and a ragged 25


def _strip_inputs(dev, shape, *fields, pad):
    """Each field cut into 4 strips and padded as the driver pads them."""
    return [spatial._halo_pad(spatial._split(f, [dev] * 4), pad) for f in fields]


def _strip_calls(fn, nx, *padded):
    nxl = nx // 4
    return [fn(*(p[s] for p in padded), s * nxl, nx) for s in range(4)]


@pytest.mark.parametrize("shape", STRIP_SHAPES)
@pytest.mark.parametrize("k,n_take", [(1, 1), (5, 5), (8, 8), (8, 3)])
def test_diffusion_block_strip_matches_plain_and_dense(cuda, shape, k, n_take):
    """n_take < k: the rerun of a stop inside a block, on the block's pad."""
    _, _, g, u = _inputs(*shape, cuda)
    pad = k_diff.required_pad(k)
    up, gp = _strip_inputs(cuda, shape, u, g, pad=pad)
    got = _strip_calls(lambda a, b, r0, nx: k_diff.diffusion_block_strip(
        a, b, r0, nx, 0.1, n_take, pad), shape[0], up, gp)
    want = _strip_calls(lambda a, b, r0, nx: k_diff.diffusion_block_strip_ref(
        a, b, r0, nx, 0.1, n_take, pad), shape[0], up, gp)
    dense, dense_sums = diffusion_block(u, g, 0.1, n_take)
    for (o, sm), (o_ref, sm_ref) in zip(got, want):
        assert _max_abs(o, o_ref) <= FIELD_TOL
        np.testing.assert_allclose(npy(sm), npy(sm_ref), rtol=SUMS_RTOL)
    assert torch.equal(torch.cat([o for o, _ in got], dim=1), dense)
    np.testing.assert_allclose(npy(sum(sm for _, sm in got)), npy(dense_sums), rtol=SUMS_RTOL)


@pytest.mark.parametrize("shape", STRIP_SHAPES)
@pytest.mark.parametrize("k,ref_stencil", [(1, True), (2, False), (4, True), (4, False)])
def test_elastic_block_strip_matches_plain_and_dense(cuda, shape, k, ref_stencil):
    _, _, g, u = _inputs(*shape, cuda)
    u = (torch.tanh(u) * 0.5).contiguous()
    up, gp = _strip_inputs(cuda, shape, u, g, pad=k_el.required_pad(k))
    args = (0.5, 0.0, 0.66, ref_stencil, k)
    got = _strip_calls(lambda a, b, r0, nx: k_el.elastic_block_strip(a, b, r0, nx, *args),
                       shape[0], up, gp)
    want = _strip_calls(lambda a, b, r0, nx: k_el.elastic_block_strip_ref(a, b, r0, nx, *args),
                        shape[0], up, gp)
    dense, dense_sums = elastic_block(u, g, *args)
    for (o, sm), (o_ref, sm_ref) in zip(got, want):
        assert _max_abs(o, o_ref) <= FIELD_TOL
        np.testing.assert_allclose(npy(sm), npy(sm_ref), rtol=SUMS_RTOL)
    assert torch.equal(torch.cat([o for o, _ in got], dim=1), dense)
    np.testing.assert_allclose(npy(sum(sm for _, sm in got)), npy(dense_sums), rtol=SUMS_RTOL)


@pytest.mark.parametrize("shape", STRIP_SHAPES)
@pytest.mark.parametrize("ref_stencil,bug", [(True, False), (False, False), (True, True)])
def test_fluid_iter_strip_matches_plain_and_dense(cuda, shape, ref_stencil, bug):
    _, _, g, u = _inputs(*shape, cuda)
    u = (torch.tanh(u) * 0.5).contiguous()
    vel = (torch.tanh(u.flip(1)) * 0.3).contiguous()
    padded = _strip_inputs(cuda, shape, u, vel, g, pad=k_fl.FLUID_PAD)
    args = (0.25, 0.0, 0.66, ref_stencil, bug)
    got = _strip_calls(lambda a, b, c, r0, nx: k_fl.fluid_iter_strip(a, b, c, r0, nx, *args),
                       shape[0], *padded)
    want = _strip_calls(lambda a, b, c, r0, nx: k_fl.fluid_iter_strip_ref(a, b, c, r0, nx,
                                                                         *args),
                        shape[0], *padded)
    dense = fluid_iter(u, vel, g, *args)
    for o, o_ref in zip(got, want):
        assert _max_abs(o[0], o_ref[0]) <= FIELD_TOL and _max_abs(o[1], o_ref[1]) <= FIELD_TOL
        np.testing.assert_allclose(npy(o[2]), npy(o_ref[2]), rtol=1e-6)
    for i in range(2):
        assert torch.equal(torch.cat([o[i] for o in got], dim=1), dense[i])
    assert torch.equal(torch.stack([o[2] for o in got]).max(), dense[2])


@pytest.mark.parametrize("shape", STRIP_SHAPES)
@pytest.mark.parametrize("halo,scale", [(2, 0.9), (5, 2.4), (2, 40.0)])
def test_warp_and_compose_strip_match_plain(cuda, shape, halo, scale):
    """scale < halo / 2: inside the contract, also equal to B3's rows; at
    40 px mostly outside it, where a sample takes no taps."""
    imov, _, _, u = _inputs(*shape, cuda)
    inc = (torch.tanh(u) * scale).contiguous()
    tot = (u * 0.5).contiguous()
    pad = spatial._gather_pad(halo)
    img_pad, tot_pad = _strip_inputs(cuda, shape, imov, tot, pad=pad)
    inc_s = spatial._split(inc, [cuda] * 4)
    nxl = shape[0] // 4
    for fn, ref, data, dense_fn, dense_data in (
            (k_wf.warp2d_strip, k_wf.warp2d_strip_ref, img_pad, warp2d, imov),
            (k_wf.compose_strip, k_wf.compose_strip_ref, tot_pad, compose, tot)):
        got = [fn(data[s], inc_s[s], s * nxl, shape[0], halo) for s in range(4)]
        for s in range(4):
            want = ref(data[s], inc_s[s], s * nxl, shape[0], halo)
            assert _max_abs(got[s], want) <= FIELD_TOL
        if scale < halo / 2:
            assert torch.equal(torch.cat(got, dim=-2), dense_fn(dense_data, inc))


@pytest.mark.parametrize("family,kw", [
    ("diffusion", dict(alpha=0.1, block_k=8)),
    ("elastic", dict(mu=0.5, lam=0.0, block_k=4)),
    ("fluid", dict(mu=0.25, lam=0.0)),
])
def test_register_sp_gpu_matches_cpu(cuda, family, kw):
    iref, imov, _, _ = _inputs(128, 128, cuda)
    args = dict(niter=[100, 100, 100], nscales=2, nrefine=2, halo=5, **kw)
    cpu = make_register_sp(make_mesh(x=4, devices=["cpu"] * 4), family, **args)(
        iref.cpu(), imov.cpu())
    kernels.reset_launches()
    gpu = make_register_sp(make_mesh(x=4, devices=[cuda] * 4), family, **args)(iref, imov)
    strip = {"diffusion": "diffusion_block_strip", "elastic": "elastic_block_strip",
             "fluid": "fluid_iter_strip"}[family]
    assert kernels.LAUNCHES[strip] > 0 and kernels.LAUNCHES["compose_strip"] > 0
    assert kernels.LAUNCHES["warp2d_strip"] > 0
    assert gpu.iterations == cpu.iterations and gpu.regrids == cpu.regrids
    assert _max_abs(gpu.motion.cpu(), cpu.motion) <= 1e-5
