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

from _torch_helpers import DOWNSAMPLE_CASES, npy, plain_solve_level_blocked, tiled_pair
from opticalflow2d_tpu_torch import Method, RegConfig, kernels, register
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.kernels import demons_fused, demons_onepass
from opticalflow2d_tpu_torch.kernels.derive import derive, derive_ref
from opticalflow2d_tpu_torch.kernels.downsample import (
    downsample_image, downsample_image_ref, downsample_motion, downsample_motion_ref)
from opticalflow2d_tpu_torch.kernels.diffusion_block import (
    diffusion_block, diffusion_block_ref, stack_derivs)
from opticalflow2d_tpu_torch.kernels.diffusion_fused import (
    diffusion_step_fused, diffusion_step_ref)
from opticalflow2d_tpu_torch.kernels.elastic_block import elastic_block, elastic_block_ref
from opticalflow2d_tpu_torch.engine import registration
from opticalflow2d_tpu_torch.kernels.fluid_fused import (
    fluid_euler, fluid_euler_ref, fluid_iter, fluid_iter_ref, fluid_sweep_max,
    fluid_sweep_max_ref, fluid_update_batch, fluid_update_batch_ref)
from opticalflow2d_tpu_torch.kernels.logger_norms import (
    fluid_metrics, fluid_metrics_ref, logger_norms, logger_norms_ref)
from opticalflow2d_tpu_torch.kernels.upsample import upsample_motion, upsample_motion_ref
from opticalflow2d_tpu_torch.kernels.warp_fused import (
    compose, compose_ref, warp2d, warp2d_ref)
from opticalflow2d_tpu_torch.ops import resample
from opticalflow2d_tpu_torch.ops.reduce import motion_max_normsq
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


@pytest.mark.parametrize("shape", [(256, 256), (100, 77), (4, 4), (33, 1000), (300, 300)])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8, 16, 22])
def test_diffusion_block_matches_plain(cuda, shape, k):
    """Bit for bit: k = 8 compiled in on 48 x 48 tiles, the other k up to 21
    at run time on them, 22 on 32 x 32; 300 x 300 has interior tiles at
    k <= 8."""
    _, _, g, u = _inputs(*shape, cuda)
    got, sums = diffusion_block(u, g, 0.1, k)
    want, sums_ref = diffusion_block_ref(u, g, 0.1, k)
    assert _max_abs(got, want) == 0.0
    np.testing.assert_allclose(npy(sums), npy(sums_ref), rtol=SUMS_RTOL)


def test_diffusion_plans_match_the_kernel(cuda):
    lib = _build.load()
    for k in range(1, 33):
        assert lib.of2d_diffusion_block_smem_bytes(k) == k_diff.diffusion_smem_bytes(k)
        for nx, ny in ((4, 4), (33, 1000), (100, 77), (25, 77), (4096, 4096)):
            want = k_diff.diffusion_tiles(nx, ny, k) if k_diff.diffusion_plan(k) else 0
            assert lib.of2d_diffusion_block_nblocks(nx, ny, k) == want


def test_fluid_plan_matches_the_kernel(cuda):
    lib = _build.load()
    assert lib.of2d_fluid_iter_smem_bytes() == 4 * k_fl.fluid_smem_floats(*k_fl.FLUID_PLAN)
    for nx, ny in ((2, 2), (4, 4), (33, 1000), (100, 77), (25, 77), (4096, 4096)):
        assert lib.of2d_sor_nblocks(nx, ny) == k_fl.fluid_tiles(nx, ny)


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


# --- the motion upsample (csrc/upsample.cu) ----------------------------------

# The cell's four levels to 4096^2, and odd, non-square and one-column shapes.
UPSAMPLE_SHAPES = [((256, 256), (4096, 4096)), ((512, 512), (4096, 4096)),
                   ((1024, 1024), (4096, 4096)), ((2048, 2048), (4096, 4096)),
                   ((21, 17), (41, 33)), ((5, 7), (64, 48)), ((300, 1), (600, 7))]


def _motion_with_zeros(shape, dev, seed=0):
    """A motion with negative values and exact zeros of both signs."""
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((2,) + shape) * 3).astype(np.float32)
    u.flat[::5] = 0.0
    u.flat[1::7] = -0.0
    return torch.from_numpy(u).to(dev)


def _same_bits(a, b) -> bool:
    """Equal bit for bit, signed zeros included."""
    torch.cuda.synchronize()
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("src,dst", UPSAMPLE_SHAPES)
def test_upsample_motion_equals_plain_bit_for_bit(cuda, src, dst):
    """One launch a call, which neither synchronises nor copies from the
    host, and the plain version's bits."""
    u = _motion_with_zeros(src, cuda)
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = upsample_motion(u, dst)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.LAUNCHES["upsample_motion"] == 1
    assert _same_bits(got, upsample_motion_ref(u, dst))


def test_upsample_motion_of_a_stack_through_each(cuda):
    """The lockstep batch driver's route: each pair of a ``[B, 2, nx, ny]``
    stack through ``_each``, one launch a pair."""
    stack = torch.stack([_motion_with_zeros((21, 17), cuda, seed=s) for s in range(3)])
    kernels.reset_launches()
    got = registration._each(resample.upsample_motion, stack, (41, 33))
    assert kernels.LAUNCHES["upsample_motion"] == 3
    for p in range(3):
        assert _same_bits(got[p], upsample_motion_ref(stack[p], (41, 33)))


def test_register_launches_one_upsample_a_level(cuda):
    iref, imov, _, _ = _inputs(1024, 1024, cuda)
    cfg = RegConfig(method=Method.DIFFUSION, niter=(50,) * 4, nscales=3, nrefine=1,
                    alpha=0.1)
    kernels.reset_launches()
    register(iref, imov, cfg)
    assert kernels.LAUNCHES["upsample_motion"] == cfg.nscales


def test_upsample_motion_rejects_what_the_kernel_does_not_take(cuda):
    u = _motion_with_zeros((8, 8), cuda)
    with pytest.raises(ValueError, match="below source"):
        upsample_motion(u, (4, 8))
    with pytest.raises(ValueError, match="contiguous"):
        upsample_motion(u.transpose(1, 2), (16, 16))
    with pytest.raises(TypeError):
        upsample_motion(u.double(), (16, 16))
    with pytest.raises(ValueError, match=r"\[2, nx, ny\]"):
        upsample_motion(u[:1], (16, 16))


# --- the box downsample (csrc/downsample.cu) ---------------------------------

# Every case of test_torch_downsample.py's CASES; ragged crops to level 6 of
# 1000 x 777 (66 x 64 patches there: past a tile, the direct route), a
# non-power-of-two patch through a tile (300^2 at level 5: 33 x 33), a 2 x 2
# patch on a width that is no power of two, and rows whose width is no
# multiple of 4 past 4096 (4-B staging).
DOWNSAMPLE_ODD = ([((1000, 777), level) for level in range(1, 7)]
                  + [((300, 300), 5), ((100, 77), 1), ((4105, 33), 1), ((4105, 33), 3)])


@pytest.mark.parametrize("shape,level", DOWNSAMPLE_CASES + DOWNSAMPLE_ODD,
                         ids=lambda v: str(v))
def test_downsample_equals_plain_bit_for_bit(cuda, shape, level):
    """2D images, a ``[2, nx, ny]`` stack and a motion, each one launch a
    call that neither synchronises nor copies from the host, with the plain
    version's bits."""
    dims = resample.pyramid_dims(shape, level)[level]
    stack = torch.stack([torch.from_numpy(x) for x in tiled_pair(*shape)]).to(cuda)
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [downsample_image(x, dims) for x in (stack[0], stack[1], stack)]
        got_motion = downsample_motion(stack, dims)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.LAUNCHES["downsample"] == 4
    for g, x in zip(got, (stack[0], stack[1], stack)):
        assert _same_bits(g, downsample_image_ref(x, dims))
    assert _same_bits(got_motion, downsample_motion_ref(stack, dims))


@pytest.mark.parametrize("n", [4096, 16384])
def test_downsample_equals_plain_at_the_cells_levels(cuda, n):
    """The cells' own pyramids: a 4096^2 and a 16384^2 image to levels 1-4
    and their fields to the seeds' levels 1-3, on a field of 3 px with exact
    zeros of both signs."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    image = torch.rand((n, n), generator=gen, device=cuda)
    u = torch.randn((2, n, n), generator=gen, device=cuda) * 3
    u.view(-1)[::10] = 0.0
    u.view(-1)[5::20] = -0.0
    dims = resample.pyramid_dims((n, n), 4)
    for level in range(1, 5):
        assert _same_bits(downsample_image(image, dims[level]),
                          downsample_image_ref(image, dims[level])), level
    for level in range(1, 4):
        assert _same_bits(downsample_motion(u, dims[level]),
                          downsample_motion_ref(u, dims[level])), level


def test_register_launches_8_pyramid_and_3_seed_downsamples(cuda):
    """An nscales = 4 ``register`` from zero motion: both images to levels
    1-4 and the seeds of levels 3-1, one launch each."""
    iref, imov = (torch.from_numpy(x).to(cuda) for x in tiled_pair(256, 256))
    cfg = RegConfig(method=Method.DIFFUSION, niter=(40,) * 5, nscales=4, nrefine=2, alpha=0.1)
    kernels.reset_launches()
    register(iref, imov, cfg)
    assert kernels.LAUNCHES["downsample"] == 8 + 3


def test_downsample_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.rand((2, 16, 12), device=cuda)
    with pytest.raises(ValueError, match="exceed"):
        downsample_image(x, (32, 6))
    with pytest.raises(ValueError, match="contiguous"):
        downsample_image(x.transpose(1, 2), (6, 8))
    with pytest.raises(ValueError, match="contiguous"):
        downsample_motion(x[:, ::2], (4, 6))
    with pytest.raises(TypeError):
        downsample_image(x.double(), (8, 6))
    with pytest.raises(ValueError, match=r"\[2, nx, ny\]"):
        downsample_motion(x[:1], (8, 6))


# --- the level's derivatives (csrc/derive.cu) --------------------------------

# Both border rows and columns alone (2 x 2), rows of one and of four
# points a thread, ragged last blocks, the slide cell's 4096^2 and the
# fluid cell's 16384^2 level.
DERIVE_SHAPES = [(2, 2), (2, 5), (3, 4), (5, 7), (33, 17), (31, 64), (1000, 777),
                 (257, 4096), (4096, 4096), (16384, 16384)]


@pytest.mark.parametrize("shape", DERIVE_SHAPES)
def test_derive_equals_plain_bit_for_bit(cuda, shape):
    """One launch a call, which neither synchronises nor copies from the
    host, and the plain version's bits."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    iref = torch.rand(shape, generator=gen, device=cuda)
    warped = torch.rand(shape, generator=gen, device=cuda)
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = derive(iref, warped)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.LAUNCHES["derive"] == 1
    assert _same_bits(got, derive_ref(iref, warped))


def test_derive_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((8, 8), device=cuda)
    with pytest.raises(ValueError, match="nx, ny >= 2"):
        derive(x[:1], x[:1])
    with pytest.raises(TypeError):
        derive(x.double(), x.double())
    with pytest.raises(ValueError, match="shape"):
        derive(x[:4], x)


def test_fluid_register_derives_once_a_solve_and_once_a_regrid(cuda):
    """The fluid driver launches the derivatives' kernel for each solve's
    force and again at each regrid, and gives the CPU's counts."""
    from torch_bench.data import nuclei_texture

    data = {"blob_sigma_px": [3, 8], "blobs_per_mpix": 2500, "amplitude": [0.3, 1.0],
            "displacement_peak_px": [16.0, 32.0], "displacement_grid": 8}
    iref, imov = nuclei_texture.make_pool(data, (192, 256), 1, 2 ** 31 + 7, cuda)[0]
    cfg = RegConfig(method=Method.FLUID, niter=(25,) * 3, nscales=2, nrefine=1, mu=0.25,
                    lam=0.0)
    kernels.reset_launches()
    result = register(iref, imov, cfg)
    regrids = sum(t.regrids for t in result.traces)
    assert regrids > 0
    assert kernels.LAUNCHES["derive"] == len(result.traces) + regrids
    on_cpu = register(iref.cpu(), imov.cpu(), cfg, device="cpu")
    assert [(t.iterations, t.regrids) for t in result.traces] == \
        [(t.iterations, t.regrids) for t in on_cpu.traces]


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
    # The level loop runs a stack of one pair: B1 and B2 by their pair-axis
    # entries, B3 and U2 by their single ones; U3 the pyramid.
    diffusion_path = ("diffusion_block_batch", "diffusion_step_batch", "warp2d", "compose",
                      "derive", "upsample_motion", "downsample")
    assert all(kernels.LAUNCHES[name] > 0 for name in diffusion_path), kernels.LAUNCHES
    assert kernels.LAUNCHES["diffusion_block"] == kernels.LAUNCHES["diffusion_step"] == 0


def test_register_lookahead_equals_the_plain_loop_and_reads_once_a_block(cuda, monkeypatch):
    """The blocked loop's lookahead on the card: a 1024^2 diffusion
    ``register`` gives the motion, errors and counts of the plain loop that
    reads each block before launching the next, bit for bit. Inside each
    solve the host waits once a block taken (the runtime syncs of the
    benchmark's ``syncs_per_iter``), and no solve after the first pins
    host memory."""
    from torch.profiler import ProfilerActivity, profile

    from opticalflow2d_tpu_torch.utils import profiling
    from torch_bench import trace

    iref, imov = (torch.from_numpy(x).to(cuda) for x in tiled_pair(1024, 1024))
    cfg = RegConfig(method=Method.DIFFUSION, niter=(400,) * 5, nscales=4, nrefine=2,
                    alpha=0.1)
    with monkeypatch.context() as m:
        m.setattr(registration, "_solve_level_blocked", plain_solve_level_blocked)
        want = register(iref, imov, cfg)
    registration._HostSums._cache.__dict__.clear()
    before = dict(registration.LOOKAHEAD)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = register(iref, imov, cfg)
        torch.cuda.synchronize()
    records = profiling.records()
    profiling.clear()
    assert torch.equal(got.motion, want.motion)
    assert [(t.scale, t.iterations) for t in got.traces] == \
        [(t.scale, t.iterations) for t in want.traces]
    assert all(torch.equal(t.errors, w.errors) for t, w in zip(got.traces, want.traces))
    k = cfg.block_k
    blocks = [-(-t.iterations // k) for t in got.traces]
    dropped = [int(b * k < cfg.niter[t.scale]) for b, t in zip(blocks, got.traces)]
    assert registration.LOOKAHEAD["discarded"] - before["discarded"] == sum(dropped) > 0
    assert registration.LOOKAHEAD["ahead"] - before["ahead"] == \
        sum(blocks) - len(blocks) + sum(dropped)
    _, runtime, _ = trace.reduce_events(prof.profiler.kineto_results.events())
    solves = [r for r in records if r[0] == "solve"]
    assert len(solves) == len(got.traces)
    syncs = [[e for e in runtime if e[0] in trace.SYNC_CALLS and s[1] <= e[1] <= s[1] + s[2]]
             for s in solves]
    assert [len(x) for x in syncs] == blocks, [sorted({e[0] for e in x}) for x in syncs]
    first_end = solves[0][1] + solves[0][2]
    pinned = [e for e in runtime if ("HostAlloc" in e[0] or "HostRegister" in e[0])
              and e[1] >= first_end]
    assert not pinned, pinned


def test_register_and_a_batch_of_one_pair_agree_and_launch_alike(cuda):
    """``register`` runs the lockstep loop on a stack of one pair: a
    ``register_batch`` of that pair gives its bits and counts and launches
    as many B1, B2 and U2. Both run the same loop and kernel wrappers, so
    this checks the wiring only; the route at one pair is held to the CPU
    by ``test_register_gpu_matches_cpu_and_counts_launches``, and each
    pair-axis kernel at one pair to its plain version and single entry by
    ``chip_smoke.py``'s ``check_one_pair``."""
    from opticalflow2d_tpu_torch.parallel import register_batch

    iref, imov = (torch.from_numpy(x).to(cuda) for x in tiled_pair(256, 256))
    cfg = RegConfig(method=Method.DIFFUSION, niter=(400,) * 3, nscales=2, nrefine=2,
                    alpha=0.1)
    kernels.reset_launches()
    one = register(iref, imov, cfg)
    launched_one = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    stack = register_batch(iref[None], imov[None], cfg, impl="vmap")
    launched_stack = dict(kernels.LAUNCHES)
    assert torch.equal(stack.motion[0], one.motion)
    assert [int(t.iterations[0]) for t in stack.traces] == [t.iterations for t in one.traces]
    assert all(torch.equal(t.errors[0], w.errors) for t, w in zip(stack.traces, one.traces))
    for name in ("diffusion_block_batch", "diffusion_step_batch", "derive"):
        assert launched_one[name] == launched_stack[name], name
    assert launched_one["diffusion_block_batch"] > 0 and launched_one["derive"] > 0


def test_a_4096_register_copies_and_fills_nothing_a_block(cuda):
    """A 4096^2 diffusion level on the card, 51 blocks with no stop and the
    cap 4 iterations into the last (recomputed by B2): besides the kernels
    of the loop, its only device operations are one read of the sums a
    block and the two zero fills of the motion and the first block's
    start (no gather, scatter, copy or fill a block)."""
    from torch.profiler import ProfilerActivity, profile

    from torch_bench import trace

    iref, imov = (torch.from_numpy(x).to(cuda) for x in tiled_pair(4096, 4096))
    cfg = RegConfig(method=Method.DIFFUSION, niter=(404,), nscales=0, nrefine=1, alpha=0.1,
                    convergence_tol=0.0)
    register(iref, imov, cfg)  # builds the kernels and warms the allocator
    torch.cuda.synchronize()
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = register(iref, imov, cfg)
        torch.cuda.synchronize()
    device, _, _ = trace.reduce_events(prof.profiler.kineto_results.events())
    reads = -(-result.traces[0].iterations // cfg.block_k)
    assert reads == kernels.LAUNCHES["diffusion_block_batch"] == 51
    assert kernels.LAUNCHES["diffusion_step_batch"] == 4
    to_host = [r for r in device if r[0].startswith("Memcpy DtoH")]
    assert len(to_host) == reads
    other = [r[0] for r in device if r[3] != "kernel" and not r[0].startswith("Memcpy DtoH")]
    copies = [r[0] for r in device if r[3] == "kernel"
              and any(w in r[0].lower() for w in ("copy", "fill", "index", "cat", "stack"))]
    assert len(other) + len(copies) <= 2, (other, copies)


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


# kw 5 (taps known at compile time, 64 x 64 tiles), 3 and 7 (64 x 64 at run
# time), 11 (B10: 32 x 32 with two staging buffers; B11, B12: 64 x 64) and 43
# (B10: 32 x 32 with one; B11: two; B12: 64 x 64); a +-30 px field at kw 5,
# whose compose taps lie past the tile's staged region on interior tiles;
# 4 x 4 and 33 x 1000 have border tiles only.
DEMONS_CASES = [((256, 256), 5, 1.5), ((100, 77), 11, 30.0), ((256, 256), 3, 1.5),
                ((256, 256), 7, 30.0), ((100, 77), 43, 1.5), ((4, 4), 5, 1.5),
                ((33, 1000), 7, 30.0), ((256, 256), 5, 30.0)]


@pytest.mark.parametrize("shape,kw,scale", DEMONS_CASES)
@pytest.mark.parametrize("addition", [False, True])
def test_demons_onepass_matches_plain(cuda, shape, kw, scale, addition):
    iaux, iref, u = _demons_inputs(*shape, cuda, scale)
    args = (iaux, iref, u, 1.0, 0.25, 2.0, 1.5, kw, addition)
    got, sums = demons_onepass.thirion_onepass(*args, with_errors=True)
    want, sums_ref = demons_onepass.thirion_onepass_ref(*args, with_errors=True)
    assert _max_abs(got, want) <= FIELD_TOL
    np.testing.assert_allclose(npy(sums), npy(sums_ref), rtol=SUMS_RTOL)
    assert _max_abs(demons_onepass.thirion_onepass(*args), want) <= FIELD_TOL


@pytest.mark.parametrize("shape,kw,scale", DEMONS_CASES)
def test_demons_correspondence_and_compose_smooth_match_plain(cuda, shape, kw, scale):
    iaux, iref, u = _demons_inputs(*shape, cuda, scale)
    c = demons_fused.demons_correspondence(iaux, iref, u, 0.25, 1.0, 2.0, kw)
    c_ref = demons_fused.demons_correspondence_ref(iaux, iref, u, 0.25, 1.0, 2.0, kw)
    assert _max_abs(c, c_ref) <= FIELD_TOL
    c = (c_ref * scale).contiguous()
    assert _max_abs(demons_fused.compose_smooth(u, c, 2.0, kw),
                    demons_fused.compose_smooth_ref(u, c, 2.0, kw)) <= FIELD_TOL
    c = u.flip(2).contiguous()  # the field of +-scale px itself
    assert _max_abs(demons_fused.compose_smooth(u, c, 2.0, kw),
                    demons_fused.compose_smooth_ref(u, c, 2.0, kw)) <= FIELD_TOL


@pytest.mark.parametrize("shape,kw,scale", [((256, 256), 57, 1.5), ((256, 256), 59, 30.0),
                                            ((100, 77), 63, 1.5)])
def test_compose_smooth_matches_plain_on_its_widest_plans(cuda, shape, kw, scale):
    """B12's widest 64 x 64 width (57) and the 32 x 32 plan past it, where
    no B10 tile fits."""
    _, _, u = _demons_inputs(*shape, cuda, scale)
    c = u.flip(2).contiguous()
    assert _max_abs(demons_fused.compose_smooth(u, c, 2.0, kw),
                    demons_fused.compose_smooth_ref(u, c, 2.0, kw)) <= FIELD_TOL


def test_demons_smem_sizes_match_the_kernels(cuda):
    lib = _build.load()
    for kw in range(1, 64, 2):
        assert lib.of2d_demons_onepass_smem_bytes(kw) == demons_onepass.onepass_smem_bytes(kw)
        assert lib.of2d_demons_correspondence_smem_bytes(kw) == \
            demons_fused.correspondence_smem_bytes(kw)
        assert lib.of2d_compose_smooth_smem_bytes(kw) == demons_fused.compose_smooth_smem_bytes(kw)
    for nx, ny in ((4, 4), (33, 1000), (250, 4096), (1000, 777)):
        for kw in (5, 11, 43):
            assert lib.of2d_demons_nblocks(nx, ny, kw) == demons_onepass.onepass_tiles(nx, ny, kw)
    assert lib.of2d_max_smem_optin(0) >= demons_fused.MAX_SMEM_BYTES


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


@pytest.mark.parametrize("shape", [(256, 256), (100, 77), (4, 4), (33, 1000), (300, 300)])
@pytest.mark.parametrize("k,ref_stencil", [(1, True), (2, True), (3, True), (3, False),
                                           (4, True), (4, False), (6, True), (12, False)])
def test_elastic_block_matches_plain(cuda, shape, k, ref_stencil):
    """k 1-4 compiled in on 48 x 48 tiles, 6 at run time on them, 12 on
    32 x 32; 300 x 300 has interior tiles at k <= 4."""
    _, _, g, u = _inputs(*shape, cuda)
    u = _zero_border(u * 0.5)
    got, sums = elastic_block(u, g, 0.25, 0.1, 1.5, ref_stencil, k)
    want, sums_ref = elastic_block_ref(u, g, 0.25, 0.1, 1.5, ref_stencil, k)
    assert _max_abs(got, want) <= FIELD_TOL
    np.testing.assert_allclose(npy(sums), npy(sums_ref), rtol=SUMS_RTOL)


@pytest.mark.parametrize("shape", [(256, 256), (100, 77), (4, 4), (33, 1000), (300, 300)])
@pytest.mark.parametrize("ref_stencil,bug", [(True, False), (False, False), (True, True)])
def test_fluid_iter_matches_plain(cuda, shape, ref_stencil, bug):
    """Bit for bit; 300 x 300 has interior tiles."""
    _, _, g, u = _inputs(*shape, cuda)
    vel = _zero_border(torch.tanh(u.flip(1)) * 0.3).contiguous()
    u = (torch.tanh(u) * 0.6).contiguous()
    got = fluid_iter(u, vel, g, 0.25, 0.1, 1.5, ref_stencil, bug)
    want = fluid_iter_ref(u, vel, g, 0.25, 0.1, 1.5, ref_stencil, bug)
    assert _max_abs(got[0], want[0]) == 0.0
    assert _max_abs(got[1], want[1]) == 0.0
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("shape,scale", [((256, 256), 3.0), ((100, 77), 0.5), ((33, 1000), 3.0)])
def test_fluid_metrics_matches_plain(cuda, shape, scale):
    _, _, _, u = _inputs(*shape, cuda)
    u_new = (torch.tanh(u) * scale).contiguous()
    u_prev = (u_new * 0.8).contiguous()
    got, want = npy(fluid_metrics(u_new, u_prev)), npy(fluid_metrics_ref(u_new, u_prev))
    np.testing.assert_allclose(got[:2], want[:2], rtol=SUMS_RTOL)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    assert scale < 1 or got[2] < 0.5


def test_elastic_plans_match_the_kernel(cuda):
    lib = _build.load()
    for k in range(1, 17):
        assert lib.of2d_elastic_block_smem_bytes(k) == k_el.elastic_smem_bytes(k)
        for nx, ny in ((4, 4), (33, 1000), (100, 77), (25, 77), (4096, 4096)):
            want = k_el.elastic_tiles(nx, ny, k) if k_el.elastic_plan(k) else 0
            assert lib.of2d_elastic_nblocks(nx, ny, k) == want


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


@pytest.mark.parametrize("shape", [(256, 256), (100, 77), (4, 4), (33, 1000), (300, 300)])
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
    U4; B9's R equals B7's."""
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
    assert kernels.LAUNCHES["fluid_iter"] == kernels.LAUNCHES["fluid_update"] == 0


# U4 on (stack shape, pairs listed): the 4DCT cell's level with a shuffled
# list of 5 of 8 pairs, a shape whose pair size is no multiple of 4 floats
# (the one-float words), and the one-pair step's list of one at 2048^2.
UPDATE_SHAPES = [((8, 512, 512), [5, 0, 7, 2, 3]), ((3, 33, 47), [2, 0, 1]),
                 ((1, 2048, 2048), [0])]


@pytest.mark.parametrize("shape,pairs", UPDATE_SHAPES)
def test_fluid_update_equals_plain_bit_for_bit(cuda, shape, pairs):
    """U4 against its plain version, bit for bit, into a NaN-filled stack:
    each listed pair's motion, the unlisted pairs unwritten; R in list
    order with (where the list has three pairs or more) one pair at rest
    (``maxsq`` 0) and one whose ``dt >= timestep_skip``, which keep u. The
    whole stack in order too, and one launch a call."""
    b, nx, ny = shape
    gen = torch.Generator(device=cuda).manual_seed(11)
    u = torch.randn((b, 2, nx, ny), generator=gen, device=cuda)
    for listed in (pairs, list(range(b))):
        r = torch.randn((len(listed), 2, nx, ny), generator=gen, device=cuda) * 0.3
        if len(listed) >= 3:
            r[1] = 0.0
            r[2] *= 1e-5
        maxsq = motion_max_normsq(r)
        fill = torch.full_like(u, float("nan"))
        kernels.reset_launches()
        got = fluid_update_batch(u, r, maxsq, listed, 0.65, 65.0, fill.clone())
        assert kernels.LAUNCHES["fluid_update"] == 1
        want = fluid_update_batch_ref(u, r, maxsq, listed, 0.65, 65.0, fill.clone())
        torch.cuda.synchronize()
        for z, p in enumerate(listed):
            assert torch.equal(got[p], want[p])
            if len(listed) >= 3 and z in (1, 2):
                assert torch.equal(got[p], u[p])
        for p in set(range(b)) - set(listed):
            assert bool(got[p].isnan().all())


def test_fluid_update_rejects_what_the_kernel_does_not_take(cuda):
    u = torch.zeros((3, 2, 16, 16), device=cuda)
    r, maxsq = torch.zeros((2, 2, 16, 16), device=cuda), torch.ones(2, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        fluid_update_batch(u, r, maxsq, [0], 0.65, 65.0, torch.empty_like(u))
    with pytest.raises(ValueError, match="share memory"):
        fluid_update_batch(u, r, maxsq, [0, 2], 0.65, 65.0, u)
    with pytest.raises(ValueError, match="distinct"):
        fluid_update_batch(u, r, maxsq, [1, 1], 0.65, 65.0, torch.empty_like(u))


@pytest.mark.parametrize("route", ["lockstep", "redblack", "lexicographic", "spectral"])
def test_every_fluid_step_updates_through_the_kernel(cuda, route):
    """U4 launches once for each lockstep iteration (as many as the loop's
    host reads, B5's launches) in a small ``register_batch``, and once for
    each one-pass iteration of ``register`` below 8192^2, in each branch of
    the step: B7, the lexicographic plain sweep, the spectral solve."""
    from opticalflow2d_tpu_torch.parallel import register_batch
    irefs, imovs, _, _ = _batch_stack((96, 64), cuda, n=3)
    imovs = torch.stack([torch.roll(imovs[i], (i, -i), (0, 1)) for i in range(3)])
    extra = {"lexicographic": dict(sor_ordering="lexicographic"),
             "spectral": dict(navier_lame_solver="spectral")}.get(route, {})
    cfg = RegConfig(method=Method.FLUID, niter=(25, 25), nscales=1, nrefine=2, mu=0.25,
                    lam=0.0, **extra)
    kernels.reset_launches()
    if route == "lockstep":
        res = register_batch(irefs, imovs, cfg, impl="vmap")
        reads = sum(int(t.iterations.max()) for t in res.traces)
        assert kernels.LAUNCHES["fluid_update"] == kernels.LAUNCHES["fluid_metrics_batch"] == reads
    else:
        res = register(irefs[0], imovs[0], cfg)
        iterations = sum(t.iterations for t in res.traces)
        assert kernels.LAUNCHES["fluid_update"] == iterations > 0, kernels.LAUNCHES
        assert kernels.LAUNCHES["fluid_iter"] == (iterations if route == "redblack" else 0)
    assert kernels.LAUNCHES["fluid_euler"] == 0


# --- the strip kernels K1-K4 (parallel.spatial) ---------------------------------

STRIP_SHAPES = [(256, 256), (100, 77)]  # 4 strips: nxl 64, and a ragged 25
ODD_STRIP_SHAPES = [(204, 77)]  # 4 strips of 51 rows: two start at odd rows


def _strip_inputs(dev, shape, *fields, pad):
    """Each field cut into 4 strips and padded as the driver pads them."""
    return [spatial._halo_pad(spatial._split(f, [dev] * 4), pad) for f in fields]


def _strip_calls(fn, nx, *padded):
    nxl = nx // 4
    return [fn(*(p[s] for p in padded), s * nxl, nx) for s in range(4)]


@pytest.mark.parametrize("shape", STRIP_SHAPES + ODD_STRIP_SHAPES)
@pytest.mark.parametrize("k,n_take", [(1, 1), (5, 5), (8, 8), (8, 3), (16, 16)])
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
        assert _max_abs(o, o_ref) == 0.0
        np.testing.assert_allclose(npy(sm), npy(sm_ref), rtol=SUMS_RTOL)
    assert torch.equal(torch.cat([o for o, _ in got], dim=1), dense)
    np.testing.assert_allclose(npy(sum(sm for _, sm in got)), npy(dense_sums), rtol=SUMS_RTOL)


@pytest.mark.parametrize("shape", STRIP_SHAPES)
@pytest.mark.parametrize("k,ref_stencil", [(1, True), (2, False), (3, True), (4, True),
                                           (4, False)])
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


@pytest.mark.parametrize("shape", STRIP_SHAPES + ODD_STRIP_SHAPES)
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
        assert _max_abs(o[0], o_ref[0]) == 0.0 and _max_abs(o[1], o_ref[1]) == 0.0
        assert torch.equal(o[2], o_ref[2])
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


DEMONS_SP = dict(sigma_x=1.0, sigma_diffusion=2.0, sigma_fluid=2.0, kernelwidth=5)


@pytest.mark.parametrize("family,kw", [
    ("diffusion", dict(alpha=0.1, block_k=8)),
    ("elastic", dict(mu=0.5, lam=0.0, block_k=4)),
    ("fluid", dict(mu=0.25, lam=0.0)),
    ("thirions", dict(sigma_i=1.0, **DEMONS_SP)),
    ("diffeo", dict(sigma_i=0.5, **DEMONS_SP)),
])
def test_register_sp_gpu_matches_cpu(cuda, family, kw):
    iref, imov, _, _ = _inputs(128, 128, cuda)
    args = dict(niter=[100, 100, 100], nscales=2, nrefine=2, halo=5, **kw)
    cpu = make_register_sp(make_mesh(x=4, devices=["cpu"] * 4), family, **args)(
        iref.cpu(), imov.cpu())
    kernels.reset_launches()
    gpu = make_register_sp(make_mesh(x=4, devices=[cuda] * 4), family, **args)(iref, imov)
    strip = {"diffusion": "diffusion_block_strip", "elastic": "elastic_block_strip",
             "fluid": "fluid_iter_strip", "thirions": "demons_onepass_strip",
             "diffeo": "compose_smooth_strip"}[family]
    assert kernels.LAUNCHES[strip] > 0 and kernels.LAUNCHES["compose_strip"] > 0
    assert kernels.LAUNCHES["warp2d_strip"] > 0
    assert gpu.iterations == cpu.iterations and gpu.regrids == cpu.regrids
    assert _max_abs(gpu.motion.cpu(), cpu.motion) <= 1e-5


# --- the demons strip kernels K5-K7 ---------------------------------------------------

@pytest.mark.parametrize("shape", STRIP_SHAPES)
@pytest.mark.parametrize("kw,halo,scale", [(5, 2, 0.9), (11, 5, 2.4), (5, 2, 30.0)])
def test_demons_strip_kernels_match_plain_and_dense(cuda, shape, kw, halo, scale):
    """K5, K6 and K7 on 4 strips against their plain versions; with scale <
    halo / 2 (inside the contract, the correspondence bound 0.5 <= halo),
    the strips equal B10's, B11's and B12's rows bit for bit; at 30 px
    mostly outside it, where a sample takes no taps."""
    imov, iref, u = _demons_inputs(*shape, cuda, scale)
    c_in = (torch.tanh(u.flip(1)) * min(scale, 0.45 * halo)).contiguous()
    nx, nxl = shape[0], shape[0] // 4
    inside = scale < halo / 2
    onepass = (1.0, 1.0, 2.0, 1.5, kw)
    corr, sd = (0.25, 1.0, 2.0, kw), 1.5
    cases = (
        (demons_onepass.thirion_onepass_strip, demons_onepass.thirion_onepass_strip_ref,
         demons_onepass.onepass_strip_pad(halo, kw), (imov, iref, u), onepass,
         lambda: demons_onepass.thirion_onepass(imov, iref, u, *onepass)),
        (demons_fused.demons_correspondence_strip, demons_fused.demons_correspondence_strip_ref,
         demons_fused.correspondence_strip_pad(halo, kw), (imov, iref, u), corr,
         lambda: demons_fused.demons_correspondence(imov, iref, u, *corr)),
        (demons_fused.compose_smooth_strip, demons_fused.compose_smooth_strip_ref,
         demons_fused.compose_smooth_strip_pad(halo, kw), (u, c_in), (sd, kw),
         lambda: demons_fused.compose_smooth(u, c_in, sd, kw)),
    )
    for fn, ref, pad, fields, params, dense in cases:
        padded = _strip_inputs(cuda, shape, *fields, pad=pad)
        got = [fn(*(p[s] for p in padded), s * nxl, nx, *params, halo) for s in range(4)]
        for s in range(4):
            want = ref(*(p[s] for p in padded), s * nxl, nx, *params, halo)
            assert _max_abs(got[s], want) <= FIELD_TOL
        if inside:
            assert torch.equal(torch.cat(got, dim=1), dense())


@pytest.mark.parametrize("shape", STRIP_SHAPES)
def test_compose_smooth_strip_on_32_tiles_matches_plain_and_dense(cuda, shape):
    """K7 at kw 59 (32 x 32 tiles) on 4 strips against its plain version
    and, inside the contract, B12's rows bit for bit."""
    kw, halo, nx, nxl = 59, 2, shape[0], shape[0] // 4
    _, _, u = _demons_inputs(*shape, cuda, 0.9)
    c = (torch.tanh(u.flip(1)) * 0.9).contiguous()
    pad = demons_fused.compose_smooth_strip_pad(halo, kw)
    up, cp = _strip_inputs(cuda, shape, u, c, pad=pad)
    got = [demons_fused.compose_smooth_strip(up[s], cp[s], s * nxl, nx, 1.5, kw, halo)
           for s in range(4)]
    for s in range(4):
        want = demons_fused.compose_smooth_strip_ref(up[s], cp[s], s * nxl, nx, 1.5, kw, halo)
        assert _max_abs(got[s], want) <= FIELD_TOL
    assert torch.equal(torch.cat(got, dim=1), demons_fused.compose_smooth(u, c, 1.5, kw))


def test_demons_strip_kernels_refuse_a_pad_below_the_reach(cuda):
    imov, iref, u = _demons_inputs(100, 77, cuda, 0.9)
    kw, halo = 5, 2
    for fn, need, fields, params in (
            (demons_onepass.thirion_onepass_strip, demons_onepass.onepass_strip_pad(halo, kw),
             (imov, iref, u), (1.0, 1.0, 2.0, 1.5, kw, halo)),
            (demons_fused.demons_correspondence_strip,
             demons_fused.correspondence_strip_pad(halo, kw), (imov, iref, u),
             (0.25, 1.0, 2.0, kw, halo)),
            (demons_fused.compose_smooth_strip, demons_fused.compose_smooth_strip_pad(halo, kw),
             (u, u), (1.5, kw, halo))):
        padded = _strip_inputs(cuda, (100, 77), *fields, pad=need - 1)
        with pytest.raises(ValueError, match="pad of at least"):
            fn(*(p[1] for p in padded), 25, 100, *params, need - 1)


# --- the spectral solvers: cuBLAS and cuFFT routes, no kernel of their own ---

SPECTRAL_RTOL = 1e-5  # GPU against CPU, of max |out|: the libraries add in other orders


def _rel_gpu_cpu(gpu, cpu) -> float:
    torch.cuda.synchronize()
    return float((gpu.cpu() - cpu).abs().max() / cpu.abs().max())


class _Tf32On:
    """The caller's TF32 switches on (cuBLAS and cuDNN) inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def _spectral_solvers(shape):
    from opticalflow2d_tpu_torch.solvers.curvature import make_curvature_solve
    from opticalflow2d_tpu_torch.solvers.navier_lame import (
        make_dirichlet_navier_lame_solver, make_spectral_navier_lame_solver)
    return {
        "curvature_matmul": make_curvature_solve(*shape, 0.1, 1.0, dct_impl="matmul"),
        "curvature_fft": make_curvature_solve(*shape, 0.1, 1.0, dct_impl="fft"),
        "navier_lame_periodic": make_spectral_navier_lame_solver(*shape, 0.25, 0.1),
        "navier_lame_dirichlet": make_dirichlet_navier_lame_solver(*shape, 0.25, 0.1),
    }


@pytest.mark.parametrize("shape", [(256, 256), (100, 77), (1000, 777)])
@pytest.mark.parametrize("name", ["curvature_matmul", "curvature_fft", "navier_lame_periodic",
                                  "navier_lame_dirichlet"])
def test_spectral_solve_gpu_matches_cpu_and_ignores_tf32(cuda, shape, name):
    f = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (2,) + shape)
                         .astype(np.float32))
    solve = _spectral_solvers(shape)[name]
    cpu = solve(f)
    gpu = solve(f.to(cuda))
    assert gpu.device == cuda and gpu.dtype == torch.float32
    e = _rel_gpu_cpu(gpu, cpu)
    if e > SPECTRAL_RTOL:
        # The Dirichlet system's condition grows as n^2: past 1e-5, hold the
        # card to the CPU solve's own change under a rounding of its input.
        noise = float((solve((f.double() * (1 + 1e-7)).float()) - cpu).abs().max()
                      / cpu.abs().max())
        assert e <= 3 * noise, (e, noise)
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with _Tf32On():
        tf32 = solve(f.to(cuda))
        assert torch.backends.cuda.matmul.allow_tf32  # the caller's setting, restored
    assert torch.equal(tf32, gpu)
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before


def test_fft_route_matches_matmul_route_on_the_gpu(cuda):
    f = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (2, 512, 384))
                         .astype(np.float32)).to(cuda)
    solvers = _spectral_solvers((512, 384))
    want = solvers["curvature_matmul"](f)
    got = solvers["curvature_fft"](f)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) <= SPECTRAL_RTOL


# Curvature and the periodic elastic solve run to their stop. The spectral
# fluid trajectory moves by 1e-6 px on one device alone when one input pixel
# moves by an ulp, and more past tens of iterations, so it runs 5 iterations
# a level; the Dirichlet solve's float32 noise can move a Logger stop, so it
# runs a fixed 12 (chip_smoke.py's FLUID_SPECTRAL_PARITY_NITER and
# DIRICHLET_PARITY).
# The level loop takes B4 through its pair-axis entry (a stack of one pair).
@pytest.mark.parametrize("method,extra,niter,want", [
    (Method.CURVATURE, dict(alpha=0.1, tau=1.0, dct_impl="matmul"), (40, 30),
     ["logger_norms_batch"]),
    (Method.CURVATURE, dict(alpha=0.1, tau=1.0, dct_impl="fft"), (40, 30),
     ["logger_norms_batch"]),
    (Method.ELASTIC, dict(mu=0.5, lam=0.0, navier_lame_solver="spectral"), (40, 30),
     ["logger_norms_batch"]),
    (Method.ELASTIC, dict(mu=0.5, lam=0.0, navier_lame_solver="spectral_dirichlet",
                          convergence_tol=0.0), (12, 12), ["logger_norms_batch"]),
    (Method.FLUID, dict(mu=0.25, lam=0.0, navier_lame_solver="spectral"), (5, 5),
     ["fluid_metrics"]),
])
def test_register_spectral_gpu_matches_cpu(cuda, method, extra, niter, want):
    iref, imov, _, _ = _inputs(96, 64, cuda)
    cfg = RegConfig(method=method, niter=niter, nscales=1, nrefine=2, **extra)
    cpu = register(iref, imov, cfg, device="cpu")
    kernels.reset_launches()
    gpu = register(iref, imov, cfg)
    assert [t.iterations for t in gpu.traces] == [t.iterations for t in cpu.traces]
    assert [t.regrids for t in gpu.traces] == [t.regrids for t in cpu.traces]
    assert _max_abs(gpu.motion.cpu(), cpu.motion) <= 1e-5
    assert all(kernels.LAUNCHES[name] > 0 for name in want + ["warp2d", "compose"]), \
        kernels.LAUNCHES
    assert sum(kernels.LAUNCHES[k] for k in ("elastic_block", "fluid_iter", "fluid_sweep_max",
                                             "diffusion_block")) == 0, kernels.LAUNCHES


def test_register_sp_curvature_gpu_matches_cpu(cuda):
    iref, imov, _, _ = _inputs(96, 64, cuda)
    kw = dict(niter=[30, 20], nscales=1, nrefine=2, halo=4, alpha=0.1, tau=1.0)
    cpu = make_register_sp(make_mesh(x=4, devices=["cpu"] * 4), "curvature", **kw)(
        iref.cpu(), imov.cpu())
    kernels.reset_launches()
    gpu = make_register_sp(make_mesh(x=4, devices=[cuda] * 4), "curvature", **kw)(iref, imov)
    assert gpu.iterations == cpu.iterations
    assert _max_abs(gpu.motion.cpu(), cpu.motion) <= 1e-5
    assert kernels.LAUNCHES["warp2d_strip"] > 0 and kernels.LAUNCHES["compose_strip"] > 0


# --- the pair axis (B1-B4 batched) and the lockstep batch driver -------------

def _batch_stack(shape, dev, n=3):
    """``n`` pairs of ``_inputs`` stacked, each from its own seed."""
    parts = [_inputs(*shape, dev, seed=s) for s in range(n)]
    return tuple(torch.stack([p[i] for p in parts]) for i in range(4))


@pytest.mark.parametrize("shape", [(256, 256), (100, 77), (33, 1000)])
@pytest.mark.parametrize("pairs", [[0, 1, 2], [2, 0]])
def test_batched_kernels_equal_single_launches(cuda, shape, pairs):
    """Bit for bit, fields and Logger sums: each listed pair equals its own
    single-pair launch and the plain version, whatever its place in the
    list; the other pairs of the output are not written."""
    from opticalflow2d_tpu_torch.kernels.diffusion_block import diffusion_block_batch
    from opticalflow2d_tpu_torch.kernels.diffusion_fused import diffusion_step_batch
    from opticalflow2d_tpu_torch.kernels.logger_norms import logger_norms_batch
    from opticalflow2d_tpu_torch.kernels.warp_fused import compose_batch, warp2d_batch
    irefs, imovs, g, u = _batch_stack(shape, cuda)
    v = (torch.tanh(u.flip(1)) * 0.5).contiguous()
    fill = torch.full_like(u, 7.0)
    for k in (3, 8):
        out, sums = diffusion_block_batch(u, g, 0.1, k, pairs, fill.clone())
        for z, p in enumerate(pairs):
            one, one_sums = diffusion_block(u[p], g[p], 0.1, k)
            ref, _ = diffusion_block_ref(u[p], g[p], 0.1, k)
            assert _max_abs(out[p], one) == 0.0 and _max_abs(out[p], ref) == 0.0
            assert torch.equal(sums[z], one_sums)
        for p in set(range(3)) - set(pairs):
            assert torch.equal(out[p], fill[p])
    step = diffusion_step_batch(u, g, 0.1, pairs)
    warped = warp2d_batch(imovs, u * 4, pairs)
    composed = compose_batch(v, u * 4, pairs)
    norms = logger_norms_batch(v, u, pairs)
    for z, p in enumerate(pairs):
        assert _max_abs(step[p], diffusion_step_fused(u[p], g[p, :2], g[p, 2], 0.1)) == 0.0
        assert _max_abs(step[p], diffusion_step_ref(u[p], g[p, :2], g[p, 2], 0.1)) == 0.0
        assert _max_abs(warped[p], warp2d(imovs[p], u[p] * 4)) == 0.0
        assert _max_abs(warped[p], warp2d_ref(imovs[p], u[p] * 4)) == 0.0
        assert _max_abs(composed[p], compose(v[p], u[p] * 4)) == 0.0
        assert _max_abs(composed[p], compose_ref(v[p], u[p] * 4)) == 0.0
        assert torch.equal(norms[z], logger_norms(v[p], u[p]))
        np.testing.assert_allclose(npy(norms[z]), npy(logger_norms_ref(v[p], u[p])),
                                   rtol=SUMS_RTOL)


@pytest.mark.parametrize("method,extra", [
    (Method.DIFFUSION, dict(alpha=0.1)),
    (Method.ELASTIC, dict(mu=0.25, lam=0.1, omega=1.5)),
    (Method.CURVATURE, dict(alpha=0.1, tau=1.0, convergence_tol=0.01)),
])
def test_register_batch_gpu_equals_register(cuda, method, extra):
    """The lockstep driver on the card against each pair's own ``register``
    there: bit for bit with equal counts (curvature's transforms run per
    pair); and map likewise."""
    from opticalflow2d_tpu_torch.parallel import register_batch
    irefs, imovs, _, _ = _batch_stack((96, 64), cuda)
    imovs = torch.stack([torch.roll(imovs[i], (i, -i), (0, 1)) for i in range(3)])
    cfg = RegConfig(method=method, niter=(150, 150), nscales=1, nrefine=2, **extra)
    kernels.reset_launches()
    vm = register_batch(irefs, imovs, cfg, impl="vmap")
    launches = dict(kernels.LAUNCHES)
    mp = register_batch(irefs, imovs, cfg, impl="map")
    for i in range(3):
        one = register(irefs[i], imovs[i], cfg)
        for res in (vm, mp):
            assert [int(t.iterations[i]) for t in res.traces] == [
                t.iterations for t in one.traces]
            assert _max_abs(res.motion[i], one.motion) == 0.0
    assert launches["warp2d_batch"] > 0 and launches["compose_batch"] > 0, launches
    assert launches["derive"] > 0, launches  # U2, once a pair and refinement
    want = {Method.DIFFUSION: ["diffusion_block_batch"], Method.ELASTIC: ["elastic_block"],
            Method.CURVATURE: ["logger_norms_batch"]}[method]
    assert all(launches[name] > 0 for name in want), launches


@pytest.mark.parametrize("shape", [(256, 256), (100, 77), (33, 1000)])
@pytest.mark.parametrize("pairs", [[0, 1, 2], [2, 0], [1]])
def test_batched_fluid_kernels_equal_single_launches(cuda, shape, pairs):
    """B7 and B5 by their pair axes, bit for bit: each listed pair's vel',
    R and max |R|^2, and its three fluid metrics, equal its own single
    launch and the plain version whatever its place in the list (R and the
    numbers in list order); a pair left out of the list is not written."""
    from opticalflow2d_tpu_torch.kernels.fluid_fused import fluid_iter_batch
    from opticalflow2d_tpu_torch.kernels.logger_norms import fluid_metrics_batch
    _, _, g, u = _batch_stack(shape, cuda)
    vel = (torch.tanh(u.flip(1)) * 0.3).contiguous()
    fill = torch.full_like(vel, float("nan"))
    for ref_stencil, bug in ((True, False), (False, True)):
        args = (u, vel, g, 0.25, 0.0, 0.66, ref_stencil, bug)
        vel_out, r, maxsq = fluid_iter_batch(*args, pairs=pairs, vel_out=fill.clone())
        for z, p in enumerate(pairs):
            one = fluid_iter(u[p], vel[p], g[p], 0.25, 0.0, 0.66, ref_stencil, bug)
            ref = fluid_iter_ref(u[p], vel[p], g[p], 0.25, 0.0, 0.66, ref_stencil, bug)
            assert torch.equal(vel_out[p], one[0]) and torch.equal(r[z], one[1])
            assert torch.equal(maxsq[z], one[2])
            assert _max_abs(vel_out[p], ref[0]) == 0.0 and _max_abs(r[z], ref[1]) == 0.0
            assert torch.equal(maxsq[z], ref[2])
        for p in set(range(3)) - set(pairs):
            assert bool(vel_out[p].isnan().all())
    metrics = fluid_metrics_batch(vel, u, pairs)
    for z, p in enumerate(pairs):
        assert torch.equal(metrics[z], fluid_metrics(vel[p], u[p]))
        want = fluid_metrics_ref(vel[p], u[p])
        np.testing.assert_allclose(npy(metrics[z, :2]), npy(want[:2]), rtol=SUMS_RTOL)
        assert torch.equal(metrics[z, 2], want[2])


@pytest.mark.parametrize("shape", [(256, 256), (100, 77), (33, 1000)])
@pytest.mark.parametrize("pairs", [[0, 1, 2], [2, 0], [1]])
def test_batched_derive_equals_single_launches(cuda, shape, pairs):
    """U2 by its pair axis, bit for bit: pair ``p``'s ``g`` from
    ``irefs[p]`` and the ``z``-th warped image equals its single launch
    and the plain version; a pair left out of the list is not written."""
    from opticalflow2d_tpu_torch.kernels.derive import derive_batch
    irefs, imovs, _, _ = _batch_stack(shape, cuda)
    warped = imovs[pairs].flip(-1).contiguous()
    g = derive_batch(irefs, warped, pairs, torch.full((3, 3) + shape, float("nan"), device=cuda))
    for z, p in enumerate(pairs):
        assert torch.equal(g[p], derive(irefs[p], warped[z]))
        assert torch.equal(g[p], derive_ref(irefs[p], warped[z]))
    for p in set(range(3)) - set(pairs):
        assert bool(g[p].isnan().all())


def test_register_batch_fluid_gpu_equals_register(cuda):
    """The lockstep fluid driver on the card against each pair's own
    ``register`` there, bit for bit, with equal iteration and regrid
    counts and Logger errors: B7 and B5 by their pair axes, one read an
    iteration; and map likewise. The pairs regrid and stop apart."""
    from opticalflow2d_tpu_torch.parallel import register_batch
    irefs, imovs, _, _ = _batch_stack((96, 64), cuda, n=4)
    imovs = torch.stack([torch.roll(imovs[i], (i, -i), (0, 1)) for i in range(4)])
    cfg = RegConfig(method=Method.FLUID, niter=(25, 25), nscales=1, nrefine=2, mu=0.25,
                    lam=0.0)
    kernels.reset_launches()
    vm = register_batch(irefs, imovs, cfg, impl="vmap")
    launches = dict(kernels.LAUNCHES)
    mp = register_batch(irefs, imovs, cfg, impl="map")
    for i in range(4):
        one = register(irefs[i], imovs[i], cfg)
        for res in (vm, mp):
            assert [int(t.iterations[i]) for t in res.traces] == [
                t.iterations for t in one.traces]
            assert [int(t.regrids[i]) for t in res.traces] == [t.regrids for t in one.traces]
            assert all(torch.equal(a.errors[i], b.errors) for a, b in zip(res.traces, one.traces))
            assert _max_abs(res.motion[i], one.motion) == 0.0
    assert launches["fluid_iter_batch"] > 0 and launches["fluid_metrics_batch"] > 0, launches
    assert launches["derive_batch"] > 0, launches
    assert launches["fluid_iter"] == 0 and launches["fluid_metrics"] == 0, launches
    assert launches["derive"] == 0, launches
    # The pyramid's level and the upsample: a launch a pair.
    assert launches["downsample"] == 8 and launches["upsample_motion"] == 4, launches
    assert launches["fluid_metrics_batch"] == sum(int(t.iterations.max()) for t in vm.traces)
    assert sum(int(t.regrids.sum()) for t in vm.traces) > 0
    assert len({tuple(int(t.iterations[i]) for t in vm.traces) for i in range(4)}) > 1


# --- B10's pair axis and the lockstep demons driver ------------------------------

def _demons_stack(shape, dev, n=3, scale=1.5):
    """``n`` demons inputs of ``_demons_inputs`` stacked, each from its own
    seed: ``iaux``, ``iref [n, nx, ny]`` and ``u [n, 2, nx, ny]``."""
    parts = []
    for s in range(n):
        iref, imov, _, u = _inputs(*shape, dev, seed=s)
        parts.append((torch.roll(imov, (s, -s), (0, 1)), iref, (torch.tanh(u) * scale)))
    return tuple(torch.stack([p[i] for p in parts]).contiguous() for i in range(3))


def _onepass_pairs_case(iaux, iref, u, pairs, kw, addition):
    """B10's pair axis on the listed pairs into a NaN-filled stack, one
    launch a call: each pair's field and Logger sums equal its own single
    launch bit for bit, the pairs left out still NaN."""
    args = (1.0, 0.25, 2.0, 1.5, kw, addition)
    fill = torch.full_like(u, float("nan"))
    kernels.reset_launches()
    out, sums = demons_onepass.thirion_onepass_batch(iaux, iref, u, *args, pairs=pairs, out=fill)
    assert kernels.LAUNCHES["demons_onepass_batch"] == 1
    assert kernels.LAUNCHES["demons_onepass"] == 0
    torch.cuda.synchronize()
    for z, p in enumerate(pairs):
        one, one_sums = demons_onepass.thirion_onepass(iaux[p], iref[p], u[p], *args,
                                                       with_errors=True)
        assert torch.equal(out[p], one), (p, _max_abs(out[p], one))
        assert torch.equal(sums[z], one_sums), (p, sums[z], one_sums)
    left = [p for p in range(u.shape[0]) if p not in set(pairs)]
    assert all(bool(out[p].isnan().all()) for p in left)
    return out, sums


@pytest.mark.parametrize("shape,kw,scale", DEMONS_CASES)
@pytest.mark.parametrize("pairs", [[0, 1, 2], [2, 0], [1]])
def test_batched_onepass_equals_single_launches(cuda, shape, kw, scale, pairs):
    """Every plan (kw 5 with its taps known, 3, 7, 11 and 43), odd and
    all-border shapes, fields of +-30 px: bit for bit against the single
    launches and within the plain version's tolerance, by composition and
    by addition."""
    iaux, iref, u = _demons_stack(shape, cuda, scale=scale)
    for addition in (False, True):
        out, sums = _onepass_pairs_case(iaux, iref, u, pairs, kw, addition)
        for z, p in enumerate(pairs):
            want, want_sums = demons_onepass.thirion_onepass_ref(
                iaux[p], iref[p], u[p], 1.0, 0.25, 2.0, 1.5, kw, addition, True)
            assert _max_abs(out[p], want) <= FIELD_TOL
            np.testing.assert_allclose(npy(sums[z]), npy(want_sums), rtol=SUMS_RTOL)


def test_batched_onepass_at_the_4dct_size(cuda):
    """640 pairs of 512^2, the 4DCT cell's finest level, every pair listed
    and 3 in 4 of them shuffled: each pair's field and sums equal its own
    single launch's bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(24)
    b, n = 640, 512
    iref = torch.rand((b, n, n), generator=gen, device=cuda)
    iaux = (iref + 0.05 * torch.randn((b, n, n), generator=gen, device=cuda)).contiguous()
    u = torch.randn((b, 2, n, n), generator=gen, device=cuda) * 2.0
    listed = [p for p in np.random.default_rng(24).permutation(b).tolist() if p % 4]
    for pairs in (list(range(b)), listed):
        _onepass_pairs_case(iaux, iref, u, pairs, 5, False)


def test_batched_onepass_refuses_what_it_does_not_take(cuda):
    iaux, iref, u = _demons_stack((64, 48), cuda)
    args = (1.0, 0.25, 2.0, 1.5, 5)
    with pytest.raises(ValueError, match="share memory"):
        demons_onepass.thirion_onepass_batch(iaux, iref, u, *args, pairs=[0], out=u)
    with pytest.raises(ValueError, match="shape"):
        demons_onepass.thirion_onepass_batch(iaux[:2], iref, u, *args, pairs=[0])
    with pytest.raises(ValueError, match="distinct"):
        demons_onepass.thirion_onepass_batch(iaux, iref, u, *args, pairs=[0, 0])


@pytest.mark.parametrize("method,extra", [
    (Method.THIRIONS_DEMONS, {}),
    (Method.THIRIONS_DEMONS, dict(accumulation=1)),
    (Method.DIFFEOMORPHIC_DEMONS, {}),
])
def test_register_batch_demons_gpu_equals_register(cuda, method, extra):
    """The lockstep demons driver on the card against each pair's own
    ``register`` there, bit for bit with equal counts and Logger errors:
    B10 by its pair axis, one read an iteration; and map likewise. The
    pairs stop apart (a Logger tolerance of 0.05)."""
    from opticalflow2d_tpu_torch.config import MotionAccumulation
    from opticalflow2d_tpu_torch.parallel import register_batch
    irefs, imovs, _, _ = _batch_stack((96, 64), cuda, n=4)
    imovs = torch.stack([torch.roll(imovs[i], (i, -i), (0, 1)) for i in range(4)])
    if "accumulation" in extra:
        extra = dict(accumulation=MotionAccumulation(extra["accumulation"]))
    cfg = RegConfig(method=method, niter=(40, 40), nscales=1, nrefine=2, convergence_tol=0.05,
                    **extra)
    kernels.reset_launches()
    vm = register_batch(irefs, imovs, cfg, impl="vmap")
    launches = dict(kernels.LAUNCHES)
    au = register_batch(irefs, imovs, cfg, impl="auto")
    mp = register_batch(irefs, imovs, cfg, impl="map")
    for i in range(4):
        one = register(irefs[i], imovs[i], cfg)
        for res in (vm, au, mp):
            assert [int(t.iterations[i]) for t in res.traces] == [
                t.iterations for t in one.traces]
            assert all(torch.equal(a.errors[i], b.errors) for a, b in zip(res.traces, one.traces))
            assert _max_abs(res.motion[i], one.motion) == 0.0
    assert launches["demons_onepass_batch"] == sum(int(t.iterations.max()) for t in vm.traces)
    assert launches["demons_onepass"] == 0, launches
    assert launches["warp2d_batch"] > 0 and launches["compose_batch"] > 0, launches
    assert len({tuple(int(t.iterations[i]) for t in vm.traces) for i in range(4)}) > 1
