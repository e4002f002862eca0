"""The port's batched registration (``parallel.register_batch``) and the
pair axis of its kernels' plain versions, against the JAX package's
``register_batch`` and against the port's own single-pair ``register`` on
the same numpy stacks (CPU).

Tolerances: against JAX's ``impl="vmap"`` (its jnp kernels under
``jax.vmap``) 1e-5 px with equal per-pair iteration counts at every
(level, refinement), as every registration of the port is held to JAX's;
the port's lockstep driver against its map path and each pair's own
``register``: equal counts and bit-equal fields (the plain versions reduce
each pair on its own). The pairs differ in their shift, so that their
Logger stops land at different counts; the tests assert that they do.
"""

import jax
import numpy as np
import pytest
import torch

import opticalflow2d_tpu as J
import opticalflow2d_tpu_torch as T
from _torch_helpers import assert_close, npy, tiled_pair, tt
from conftest import make_pair
from opticalflow2d_tpu.parallel.batch import register_batch as jax_register_batch
from opticalflow2d_tpu_torch.interop import config_from_jax
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.kernels.diffusion_block import (
    diffusion_block_batch, diffusion_block_ref, stack_derivs)
from opticalflow2d_tpu_torch.kernels.diffusion_fused import (
    diffusion_step_batch, diffusion_step_ref)
from opticalflow2d_tpu_torch.kernels.logger_norms import logger_norms_batch, logger_norms_ref
from opticalflow2d_tpu_torch.kernels.warp_fused import (
    compose_batch, compose_ref, warp2d_batch, warp2d_ref)
from opticalflow2d_tpu_torch.parallel import make_mesh, register_batch
from opticalflow2d_tpu_torch.parallel.batch import _resolve_impl
from opticalflow2d_tpu_torch.solvers.base import derivatives

MOTION_TOL = 1e-5
SHAPE = (48, 40)
SHIFTS = ((1.5, -0.8), (0.7, 0.4), (2.2, -1.4))
# The three lockstep families: the stops land at [95, 88, 101], [80, 89,
# 90], [184, 153, 200] (diffusion), [89, 91, 95] (curvature, at its full
# resolution) and [57, 59, 62], [162, 168, 176] (elastic).
FAMILIES = {
    "diffusion": dict(method=J.Method.DIFFUSION, niter=(200, 200), alpha=0.1),
    "curvature": dict(method=J.Method.CURVATURE, niter=(150, 60), alpha=0.1, tau=1.0,
                      convergence_tol=0.01),
    "elastic": dict(method=J.Method.ELASTIC, niter=(200, 200), mu=0.25, lam=0.1, omega=1.5),
}


@pytest.fixture(scope="module")
def stacks():
    pairs = [tiled_pair(*SHAPE, shift=s, seed=i) for i, s in enumerate(SHIFTS)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _jax_cfg(name):
    return J.RegConfig(nscales=1, nrefine=2, **FAMILIES[name])


def _counts(res):
    """Per-pair iteration counts, pair-major: ``[pair][trace]``."""
    return np.array([np.asarray(npy(t.iterations)) for t in res.traces]).T.tolist()


def _pair(res, i):
    """Pair ``i`` of a batch result: its motion and its per-trace counts and
    errors."""
    return (res.motion[i], [int(t.iterations[i]) for t in res.traces],
            [int(t.regrids[i]) for t in res.traces], [t.errors[i] for t in res.traces])


@pytest.mark.parametrize("name", list(FAMILIES))
def test_vmap_matches_jax_vmap(stacks, name):
    jcfg = _jax_cfg(name)
    want = jax_register_batch(*stacks, jcfg, impl="vmap")
    got = register_batch(*stacks, config_from_jax(jcfg), impl="vmap", device="cpu")
    assert _counts(got) == _counts(want)
    assert len({tuple(c) for c in _counts(got)}) > 1  # the stops land apart
    # JAX's vmap batches every leaf, the scale too.
    assert [[t.scale] * len(SHIFTS) for t in got.traces] == [
        np.asarray(t.scale).tolist() for t in want.traces]
    for a, b in zip(got.traces, want.traces):
        assert_close(a.errors, b.errors, 1e-6, 1e-4)
    assert_close(got.motion, want.motion, MOTION_TOL)
    assert_close(got.coarse_motion, want.coarse_motion, MOTION_TOL)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_vmap_map_and_register_agree(stacks, name):
    cfg = config_from_jax(_jax_cfg(name))
    vm = register_batch(*stacks, cfg, impl="vmap", device="cpu")
    mp = register_batch(*stacks, cfg, impl="map", device="cpu")
    for i in range(len(SHIFTS)):
        one = T.register(stacks[0][i], stacks[1][i], cfg, device="cpu")
        want = (one.motion, [t.iterations for t in one.traces],
                [t.regrids for t in one.traces], [t.errors for t in one.traces])
        for res in (vm, mp):
            got = _pair(res, i)
            assert got[1:3] == want[1:3]
            assert torch.equal(got[0], want[0])
            assert all(torch.equal(a, b) for a, b in zip(got[3], want[3]))
        assert torch.equal(vm.coarse_motion[i], one.coarse_motion)


def test_result_holds_a_pair_axis_on_every_leaf(stacks):
    cfg = config_from_jax(_jax_cfg("diffusion"))
    for impl in ("vmap", "map"):
        res = register_batch(*stacks, cfg, impl=impl, device="cpu")
        b = len(SHIFTS)
        assert tuple(res.motion.shape) == (b, 2) + SHAPE
        assert tuple(res.coarse_motion.shape) == (b, 2, SHAPE[0] // 2, SHAPE[1] // 2)
        assert len(res.traces) == 4
        for t, niter in zip(res.traces, (200, 200, 200, 200)):
            assert isinstance(t.scale, int)
            assert tuple(t.errors.shape) == (b, niter)
            for counts in (t.iterations, t.regrids, t.fallbacks):
                assert counts.dtype == torch.int64 and tuple(counts.shape) == (b,)


def test_fluid_auto_runs_map_and_matches_jax():
    """Fluid resolves to the lockstep fluid driver, and it and map are held
    to JAX's map run op by op (as the fluid tests hold ``register``):
    equal iteration and regrid counts."""
    pairs = [make_pair(32, 28, shift=s) for s in SHIFTS]
    irefs, imovs = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
    jcfg = J.RegConfig(method=J.Method.FLUID, niter=(10, 10), nscales=1, mu=0.25, lam=0.1,
                       omega=1.5, warp_halo=0, warp_halo_outer=0, warp_halo_auto=False)
    cfg = config_from_jax(jcfg)
    assert _resolve_impl(cfg, "auto", irefs.shape[1:]) == "vmap"
    with jax.disable_jit():
        want = jax_register_batch(irefs, imovs, jcfg, impl="map")
    for impl in ("auto", "map"):
        got = register_batch(irefs, imovs, cfg, impl=impl, device="cpu")
        assert _counts(got) == _counts(want)
        assert [t.regrids.tolist() for t in got.traces] == [
            np.asarray(t.regrids).tolist() for t in want.traces]
        assert any(t.regrids.any() for t in got.traces)
        assert_close(got.motion, want.motion, MOTION_TOL)


@pytest.mark.parametrize("method,impl", [
    (T.Method.DIFFUSION, "vmap"), (T.Method.CURVATURE, "vmap"), (T.Method.ELASTIC, "vmap"),
    (T.Method.FLUID, "map"), (T.Method.THIRIONS_DEMONS, "map"),
    (T.Method.DIFFEOMORPHIC_DEMONS, "map"),
])
def test_auto_resolves_by_method(method, impl):
    """At 16384^2: fluid maps there, since its levels past 8192 take the
    two-pass step, which has no pair axis (below it fluid runs in lockstep,
    ``test_torch_fluid_batch.py``)."""
    cfg = T.RegConfig(method=method, niter=(5,))
    assert _resolve_impl(cfg, "auto", (16384, 16384)) == impl
    assert _resolve_impl(cfg, "map") == "map" and _resolve_impl(cfg, "vmap") == "vmap"


@pytest.mark.parametrize("impl", ["vmap", "map"])
def test_warm_start(stacks, impl):
    """``initial_motions`` seeds each pair as ``register(initial_motion=...)``
    does."""
    cfg = config_from_jax(_jax_cfg("diffusion"))
    first = register_batch(*stacks, cfg, impl=impl, device="cpu")
    warm = register_batch(*stacks, cfg, impl=impl, initial_motions=npy(first.motion),
                          device="cpu")
    for i in range(len(SHIFTS)):
        one = T.register(stacks[0][i], stacks[1][i], cfg, initial_motion=first.motion[i],
                         device="cpu")
        assert _pair(warm, i)[1] == [t.iterations for t in one.traces]
        assert torch.equal(warm.motion[i], one.motion)
    assert _counts(warm) != _counts(first)


@pytest.mark.parametrize("impl", ["vmap", "map"])
def test_data_mesh_equals_no_mesh(stacks, impl):
    cfg = config_from_jax(_jax_cfg("elastic"))
    refs, movs = stacks[0][:2], stacks[1][:2]
    mesh = make_mesh(data=2, devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 2, "x": 1}
    assert mesh.data_devices() == [torch.device("cpu")] * 2
    got = register_batch(refs, movs, cfg, mesh=mesh, impl=impl)
    want = register_batch(refs, movs, cfg, impl=impl, device="cpu")
    assert _counts(got) == _counts(want)
    assert torch.equal(got.motion, want.motion)
    assert torch.equal(got.coarse_motion, want.coarse_motion)
    for a, b in zip(got.traces, want.traces):
        assert torch.equal(a.errors, b.errors) and torch.equal(a.regrids, b.regrids)


def _refused(stacks):
    cfg = T.RegConfig(method=T.Method.DIFFUSION, niter=(5,))
    refs, movs = stacks
    mesh = make_mesh(data=2, devices=["cpu", "cpu"])
    return {
        "not_a_stack": (ValueError, "matching", lambda: register_batch(
            refs[0], movs[0], cfg, device="cpu")),
        "mismatched": (ValueError, "matching", lambda: register_batch(
            refs, movs[:, :, :-1], cfg, device="cpu")),
        "not_divisible": (ValueError, "divisible", lambda: register_batch(
            refs, movs, cfg, mesh=mesh)),
        "initial_motions": (ValueError, r"\[B, 2, nx, ny\]", lambda: register_batch(
            refs, movs, cfg, initial_motions=np.zeros((3, 2, 4, 4), np.float32),
            device="cpu")),
        "unknown_impl": (ValueError, "unknown impl", lambda: register_batch(
            refs, movs, cfg, impl="scan", device="cpu")),
        "mesh_and_device": (ValueError, "not both", lambda: register_batch(
            refs[:2], movs[:2], cfg, mesh=mesh, device="cpu")),
    }


@pytest.mark.parametrize("case", ["not_a_stack", "mismatched", "not_divisible",
                                  "initial_motions", "unknown_impl", "mesh_and_device"])
def test_refuses_bad_arguments(stacks, case):
    error, match, call = _refused(stacks)[case]
    with pytest.raises(error, match=match):
        call()


@pytest.mark.parametrize("method", [T.Method.FLUID, T.Method.THIRIONS_DEMONS,
                                    T.Method.DIFFEOMORPHIC_DEMONS])
def test_vmap_of_fluid_and_demons_is_not_ported(stacks, method):
    """Demons have no lockstep driver; fluid has one for the red-black SOR
    sweep only, so the lexicographic one is refused."""
    extra = dict(sor_ordering="lexicographic") if method == T.Method.FLUID else {}
    cfg = T.RegConfig(method=method, niter=(5,), **extra)
    with pytest.raises(NotImplementedError, match="impl='map' or 'auto' runs it"):
        register_batch(*stacks, cfg, impl="vmap", device="cpu")


def test_default_device_needs_cuda(stacks):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        register_batch(*stacks, T.RegConfig(method=T.Method.DIFFUSION, niter=(5,)))


# --- the pair axis of the kernels' plain versions ----------------------------

def _batch_inputs(seed=0):
    rng = np.random.default_rng(seed)
    pairs = [tiled_pair(*SHAPE, shift=s, seed=i) for i, s in enumerate(SHIFTS)]
    irefs = tt(np.stack([p[0] for p in pairs]))
    imovs = tt(np.stack([p[1] for p in pairs]))
    d = derivatives(irefs, imovs)
    g = stack_derivs(d.grad_i, d.it)
    u = tt(rng.normal(0, 1.5, (len(SHIFTS), 2) + SHAPE))
    return irefs, imovs, g, u


@pytest.mark.parametrize("pairs", [[0, 1, 2], [2, 0], [1]])
def test_batched_plain_versions_equal_single_calls(pairs):
    """Each listed pair bit-equal to its single-pair plain version, in list
    order; the other pairs of ``out`` left as they were."""
    irefs, imovs, g, u = _batch_inputs()
    v = torch.tanh(u.flip(1)) * 0.5
    rest = [p for p in range(len(SHIFTS)) if p not in pairs]
    fill = torch.full_like(u, 7.0)
    out_b, sums_b = diffusion_block_batch(u, g, 0.1, 3, pairs, fill.clone())
    out_s = diffusion_step_batch(u, g, 0.1, pairs, fill.clone())
    out_w = warp2d_batch(imovs, u, pairs)
    out_c = compose_batch(v, u, pairs)
    sums_n = logger_norms_batch(v, u, pairs)
    assert tuple(sums_b.shape) == (len(pairs), 3, 2) and tuple(sums_n.shape) == (len(pairs), 2)
    for z, p in enumerate(pairs):
        gp = stack_derivs(*derivatives(irefs[p], imovs[p]))
        assert torch.equal(gp, g[p])
        want_b, want_sums = diffusion_block_ref(u[p], g[p], 0.1, 3)
        assert torch.equal(out_b[p], want_b) and torch.equal(sums_b[z], want_sums)
        assert torch.equal(out_s[p], diffusion_step_ref(u[p], g[p, :2], g[p, 2], 0.1))
        assert torch.equal(out_w[p], warp2d_ref(imovs[p], u[p]))
        assert torch.equal(out_c[p], compose_ref(v[p], u[p]))
        assert torch.equal(sums_n[z], logger_norms_ref(v[p], u[p]))
    for p in rest:
        assert torch.equal(out_b[p], fill[p]) and torch.equal(out_s[p], fill[p])
        assert not out_w[p].any() and not out_c[p].any()


@pytest.mark.parametrize("pairs,match", [([], "1 to"), ([0, 0], "distinct"), ([3], "distinct"),
                                         ([-1], "distinct")])
def test_pair_lists_are_checked(pairs, match):
    _, _, g, u = _batch_inputs()
    with pytest.raises(ValueError, match=match):
        diffusion_block_batch(u, g, 0.1, 2, pairs)
    with pytest.raises(ValueError, match=match):
        _build.Pairs(pairs, len(SHIFTS))
