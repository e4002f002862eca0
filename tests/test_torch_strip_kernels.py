"""The plain versions of the port's strip kernels (K1-K7) against the JAX
package's strip kernels, run in interpret mode on the CPU, on the same numpy
inputs; the strip halo exchange, pyramid, Gaussian and exp map against
JAX's inside ``shard_map`` on the conftest's eight virtual CPU devices.

Strips are carved from a 64x48 field padded with zeros beyond its edges,
what the halo exchange provides (``tests/test_diffusion_block.py:112``),
at rows 0, 16, 32 and 48 and at the odd row 17; each side gets its own
pad (the demons strips: the port's exact reach, JAX's rounded to 8).
Tolerances: fields 1e-6 max-abs (the same operations in the same order),
per-strip Logger sums 1e-5 relative (added in another order), max |R|^2
1e-6 relative. The strips of an image, concatenated, equal the port's
dense plain version bit for bit; the strip pyramid equals JAX's bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import PartitionSpec as P

from _torch_helpers import assert_close, npy, tiled_pair, tt
from opticalflow2d_tpu.pallas_kernels import demons_fused as j_df
from opticalflow2d_tpu.pallas_kernels import demons_onepass as j_op
from opticalflow2d_tpu.pallas_kernels import diffusion_block as j_diff
from opticalflow2d_tpu.pallas_kernels import elastic_block as j_el
from opticalflow2d_tpu.pallas_kernels import fluid_fused as j_fl
from opticalflow2d_tpu.pallas_kernels import warp_fused as j_wf
from opticalflow2d_tpu.parallel import spatial as j_sp
from opticalflow2d_tpu.parallel.mesh import make_mesh as j_make_mesh
from opticalflow2d_tpu_torch.kernels.demons_fused import (
    compose_smooth_ref, compose_smooth_strip, compose_smooth_strip_pad, compose_smooth_strip_ref,
    correspondence_strip_pad, demons_correspondence_ref, demons_correspondence_strip,
    demons_correspondence_strip_ref)
from opticalflow2d_tpu_torch.kernels.demons_onepass import (
    onepass_strip_pad, thirion_onepass_ref, thirion_onepass_strip, thirion_onepass_strip_ref)
from opticalflow2d_tpu_torch.kernels.diffusion_block import (
    diffusion_block_ref, diffusion_block_strip, diffusion_block_strip_ref, stack_derivs)
from opticalflow2d_tpu_torch.kernels.elastic_block import (
    elastic_block_ref, elastic_block_strip, elastic_block_strip_ref)
from opticalflow2d_tpu_torch.kernels.fluid_fused import (
    fluid_iter_ref, fluid_iter_strip, fluid_iter_strip_ref)
from opticalflow2d_tpu_torch.kernels.warp_fused import (
    compose_ref, compose_strip, compose_strip_ref, warp2d_ref, warp2d_strip, warp2d_strip_ref)
from opticalflow2d_tpu_torch.ops.conv import convolve2d_clip
from opticalflow2d_tpu_torch.ops.warp import expmap, expmap_nsq
from opticalflow2d_tpu_torch.parallel import make_mesh, spatial
from opticalflow2d_tpu_torch.solvers.base import derivatives

FIELD_TOL = 1e-6
SUMS_RTOL = 1e-5
SHAPE = (64, 48)
NXL = 16
ROW0S = (0, 16, 32, 48, 17)  # the tiling, and an odd first row
MU, LAM, OMEGA = 0.5, 0.1, 0.66


@pytest.fixture(scope="module")
def fields():
    """Images, their derivatives g, a motion u of up to ~2 px and a
    velocity, as numpy arrays."""
    rng = np.random.default_rng(5)
    iref, imov = tiled_pair(*SHAPE)
    d = derivatives(tt(iref), tt(imov))
    g = npy(stack_derivs(d.grad_i, d.it))
    u = (2.0 * np.tanh(rng.standard_normal((2,) + SHAPE))).astype(np.float32)
    vel = (0.3 * np.tanh(rng.standard_normal((2,) + SHAPE))).astype(np.float32)
    return iref, imov, g, u, vel


def _strip(a: np.ndarray, row0: int, pad: int) -> np.ndarray:
    """Rows ``row0 - pad .. row0 + NXL + pad`` of ``a [..., nx, ny]``,
    zeros beyond its edges."""
    padded = np.pad(a, [(0, 0)] * (a.ndim - 2) + [(pad, pad), (0, 0)])
    return np.ascontiguousarray(padded[..., row0:row0 + NXL + 2 * pad, :])


def _tiled(strips):
    return torch.cat([strips[r] for r in ROW0S[:4]], dim=-2)


@pytest.mark.parametrize("k", [1, 4, 8])
def test_diffusion_strip_ref_matches_pallas(fields, k):
    _, _, g, u, _ = fields
    pad = j_diff.required_pad(k)
    got, got_sums = {}, []
    for row0 in ROW0S:
        args = (_strip(u, row0, pad), _strip(g, row0, pad), row0, SHAPE[0])
        with pltpu.force_tpu_interpret_mode():
            want, want_sums = j_diff.diffusion_block_strip(
                *map(jnp.asarray, args[:2]), row0, SHAPE[0], alpha=0.5, k=k)
        out, sums = diffusion_block_strip_ref(*map(tt, args[:2]), row0, SHAPE[0], 0.5, k)
        assert_close(out, want, FIELD_TOL)
        assert_close(sums, want_sums, 0, SUMS_RTOL)
        wrapped = diffusion_block_strip(*map(tt, args[:2]), row0, SHAPE[0], 0.5, k)
        assert all(torch.equal(a, b) for a, b in zip(wrapped, (out, sums)))
        got[row0] = out
        got_sums.append(sums)
    dense, dense_sums = diffusion_block_ref(tt(u), tt(g), 0.5, k)
    assert torch.equal(_tiled(got), dense)
    assert torch.equal(got[17], dense[:, 17:17 + NXL])
    assert_close(sum(got_sums[:4]), dense_sums, 0, SUMS_RTOL)


def test_diffusion_strip_rerun_with_the_block_pad(fields):
    """A stop inside a block reruns n_take < k iterations from the block's
    padded start: the same bits as n_take iterations."""
    _, _, g, u, _ = fields
    pad = j_diff.required_pad(8)
    up, gp = tt(_strip(u, 17, pad)), tt(_strip(g, 17, pad))
    rerun, _ = diffusion_block_strip(up, gp, 17, SHAPE[0], 0.5, 3, pad)
    dense, _ = diffusion_block_ref(tt(u), tt(g), 0.5, 3)
    assert torch.equal(rerun, dense[:, 17:17 + NXL])
    with pytest.raises(ValueError, match="needs more than"):
        diffusion_block_strip(up[:, :10], gp[:, :10], 17, SHAPE[0], 0.5, 3, pad)


@pytest.mark.parametrize("k,ref_stencil", [(1, True), (2, False), (4, True), (4, False)])
def test_elastic_strip_ref_matches_pallas(fields, k, ref_stencil):
    _, _, g, u, _ = fields
    u = u * 0.25
    pad = j_el.required_pad(k)
    got, got_sums = {}, []
    for row0 in ROW0S:
        args = (_strip(u, row0, pad), _strip(g, row0, pad))
        with pltpu.force_tpu_interpret_mode():
            want, want_sums = j_el.elastic_block_strip(
                *map(jnp.asarray, args), row0, SHAPE[0], MU, LAM, OMEGA, ref_stencil, k=k)
        out, sums = elastic_block_strip_ref(*map(tt, args), row0, SHAPE[0], MU, LAM, OMEGA,
                                            ref_stencil, k)
        assert_close(out, want, FIELD_TOL)
        assert_close(sums, want_sums, 0, SUMS_RTOL)
        wrapped = elastic_block_strip(*map(tt, args), row0, SHAPE[0], MU, LAM, OMEGA,
                                      ref_stencil, k)
        assert all(torch.equal(a, b) for a, b in zip(wrapped, (out, sums)))
        got[row0] = out
        got_sums.append(sums)
    dense, dense_sums = elastic_block_ref(tt(u), tt(g), MU, LAM, OMEGA, ref_stencil, k)
    assert torch.equal(_tiled(got), dense)
    assert torch.equal(got[17], dense[:, 17:17 + NXL])
    assert_close(sum(got_sums[:4]), dense_sums, 0, SUMS_RTOL)


@pytest.mark.parametrize("ref_stencil,bug", [(True, False), (False, False), (True, True)])
def test_fluid_strip_ref_matches_pallas(fields, ref_stencil, bug):
    _, _, g, u, vel = fields
    u = u * 0.3
    pad = j_fl._PAD
    got = {}
    for row0 in ROW0S:
        args = tuple(_strip(a, row0, pad) for a in (u, vel, g))
        with pltpu.force_tpu_interpret_mode():
            want = j_fl.fluid_iter_strip(*map(jnp.asarray, args), row0, SHAPE[0], MU, LAM,
                                         OMEGA, ref_stencil, bug)
        out = fluid_iter_strip_ref(*map(tt, args), row0, SHAPE[0], MU, LAM, OMEGA,
                                   ref_stencil, bug)
        assert_close(out[0], want[0], FIELD_TOL)
        assert_close(out[1], want[1], FIELD_TOL)
        assert_close(out[2], want[2], 0, 1e-6)
        wrapped = fluid_iter_strip(*map(tt, args), row0, SHAPE[0], MU, LAM, OMEGA,
                                   ref_stencil, bug)
        assert all(torch.equal(a, b) for a, b in zip(wrapped, out))
        got[row0] = out
    dense = fluid_iter_ref(tt(u), tt(vel), tt(g), MU, LAM, OMEGA, ref_stencil, bug)
    for i in range(2):
        assert torch.equal(torch.cat([got[r][i] for r in ROW0S[:4]], dim=-2), dense[i])
        assert torch.equal(got[17][i], dense[i][:, 17:17 + NXL])
    assert torch.equal(torch.stack([got[r][2] for r in ROW0S[:4]]).max(), dense[2])


@pytest.mark.parametrize("halo", [2, 5])
def test_warp_compose_strip_refs_match_pallas(fields, halo):
    """Inside the contract (floor offsets within [-halo, halo]) the strip
    warp and compose equal JAX's strip kernel and the dense gather."""
    _, imov, _, u, _ = fields
    u_inc = u * (0.25 * halo)  # floor offsets within [-halo, halo]
    u_tot = u * 0.5
    pad = j_wf._PAD
    warped, composed = {}, {}
    for row0 in ROW0S:
        inc = np.ascontiguousarray(u_inc[:, row0:row0 + NXL])
        img_pad, tot_pad = _strip(imov, row0, pad), _strip(u_tot, row0, pad)
        with pltpu.force_tpu_interpret_mode():
            want_w = j_wf.warp2d_pallas_strip(jnp.asarray(img_pad), jnp.asarray(inc), row0,
                                              SHAPE[0], halo)
            want_c = j_wf.compose_pallas_strip(jnp.asarray(tot_pad), jnp.asarray(inc), row0,
                                               SHAPE[0], halo)
        warped[row0] = warp2d_strip_ref(tt(img_pad), tt(inc), row0, SHAPE[0], halo)
        composed[row0] = compose_strip_ref(tt(tot_pad), tt(inc), row0, SHAPE[0], halo)
        assert_close(warped[row0], want_w, FIELD_TOL)
        assert_close(composed[row0], want_c, FIELD_TOL)
        assert torch.equal(warp2d_strip(tt(img_pad), tt(inc), row0, SHAPE[0], halo),
                           warped[row0])
        assert torch.equal(compose_strip(tt(tot_pad), tt(inc), row0, SHAPE[0], halo),
                           composed[row0])
    assert torch.equal(_tiled(warped), warp2d_ref(tt(imov), tt(u_inc)))
    assert torch.equal(_tiled(composed), compose_ref(tt(u_tot), tt(u_inc)))


@pytest.mark.parametrize("offset", [1, 3])
def test_warp_outside_the_contract_matches_jax(fields, offset):
    """Floor offsets of halo + 1 and halo + 3 on part of the grid: the strip
    warp gives 0 there, as JAX's jnp strip route (``use_pallas=False``)
    does. Those pixels must be equal; the others within the field
    tolerance, because compiled XLA contracts the tap sum into fused
    multiply-adds an ulp apart (run op by op, ``jax.disable_jit()``, JAX
    equals the port bit for bit on both cases, at 20 s a call)."""
    halo = 2
    _, imov, _, _, _ = fields
    rng = np.random.default_rng(offset)
    u = (rng.uniform(-1.0, 1.0, (2,) + SHAPE)).astype(np.float32)
    far = rng.uniform(size=SHAPE) < 0.3
    u[0][far] += halo + offset
    u[1][far[::-1]] -= halo + offset
    j_warp = j_sp.make_warp2d_sharded(j_make_mesh(data=1, x=8), halo=halo)
    want = np.asarray(j_warp(jnp.asarray(imov), jnp.asarray(u)))
    got = npy(spatial.make_warp2d_sharded(make_mesh(x=8, devices=["cpu"] * 8), halo)(
        tt(imov), tt(u)))
    rx = np.floor(np.arange(SHAPE[0])[:, None] + u[0]) - np.arange(SHAPE[0])[:, None]
    ry = np.floor(np.arange(SHAPE[1])[None, :] + u[1]) - np.arange(SHAPE[1])[None, :]
    outside = (np.abs(rx) > halo) | (np.abs(ry) > halo)
    assert np.array_equal(got[outside], want[outside])
    assert (got[outside] == 0).mean() > 0.5
    assert_close(got, want, FIELD_TOL)


DEMONS_STRIP_CASES = [(5, 2), (7, 3)]  # (kernelwidth, halo) that JAX's gates admit


@pytest.mark.parametrize("kw,halo", DEMONS_STRIP_CASES)
def test_thirion_onepass_strip_ref_matches_pallas(fields, kw, halo):
    """K5's plain version against JAX's ``prepadded=True`` kernel, each on
    its own pad (the exact reach here, JAX's rounded up to 8), by
    composition; the motion inside the contract and the correspondence
    bound sigma_x / (2 sigma_i) = 0.5 <= halo."""
    iref, imov, _, u, _ = fields
    u = u * 0.5
    params = (1.0, 1.0, 2.0, 1.5, kw)
    j_pad, pad = j_op.required_pad(halo, kw), onepass_strip_pad(halo, kw)
    got = {}
    for row0 in ROW0S:
        with pltpu.force_tpu_interpret_mode():
            want = j_op.thirion_onepass_pallas(
                *(jnp.asarray(_strip(a, row0, j_pad)) for a in (imov, iref, u)), *params,
                halo=halo, addition=False, row0=row0, nx_glob=SHAPE[0], prepadded=True)
        args = [tt(_strip(a, row0, pad)) for a in (imov, iref, u)]
        got[row0] = thirion_onepass_strip_ref(*args, row0, SHAPE[0], *params, halo)
        assert_close(got[row0], want, FIELD_TOL)
        assert torch.equal(thirion_onepass_strip(*args, row0, SHAPE[0], *params, halo),
                           got[row0])
    dense = thirion_onepass_ref(tt(imov), tt(iref), tt(u), *params)
    assert torch.equal(_tiled(got), dense)
    assert torch.equal(got[17], dense[:, 17:17 + NXL])


@pytest.mark.parametrize("kw,halo", DEMONS_STRIP_CASES)
def test_demons_fused_strip_refs_match_pallas(fields, kw, halo):
    """K6 and K7's plain versions against JAX's ``prepadded=True`` kernels
    (pad 8, ``_PAD``), at the diffeomorphic parameters; K7's correspondence
    inside the contract."""
    iref, imov, _, u, _ = fields
    u_tot, c_inc = u * 0.5, u * (0.25 * halo)
    corr_params, sd = (0.25, 1.0, 2.0, kw), 1.5
    j_pad = j_df._PAD
    corr, comp = {}, {}
    for row0 in ROW0S:
        with pltpu.force_tpu_interpret_mode():
            want_c = j_df.demons_correspondence_pallas(
                *(jnp.asarray(_strip(a, row0, j_pad)) for a in (imov, iref, u_tot)),
                *corr_params, halo=halo, row0=row0, nx_glob=SHAPE[0], prepadded=True)
            want_s = j_df.compose_smooth_pallas(
                *(jnp.asarray(_strip(a, row0, j_pad)) for a in (u_tot, c_inc)), sd, kw,
                halo=halo, row0=row0, nx_glob=SHAPE[0], prepadded=True)
        pad = correspondence_strip_pad(halo, kw)
        args = [tt(_strip(a, row0, pad)) for a in (imov, iref, u_tot)]
        corr[row0] = demons_correspondence_strip_ref(*args, row0, SHAPE[0], *corr_params, halo)
        assert_close(corr[row0], want_c, FIELD_TOL)
        assert torch.equal(demons_correspondence_strip(*args, row0, SHAPE[0], *corr_params,
                                                       halo), corr[row0])
        pad = compose_smooth_strip_pad(halo, kw)
        args = [tt(_strip(a, row0, pad)) for a in (u_tot, c_inc)]
        comp[row0] = compose_smooth_strip_ref(*args, row0, SHAPE[0], sd, kw, halo)
        assert_close(comp[row0], want_s, FIELD_TOL)
        assert torch.equal(compose_smooth_strip(*args, row0, SHAPE[0], sd, kw, halo), comp[row0])
    dense_c = demons_correspondence_ref(tt(imov), tt(iref), tt(u_tot), *corr_params)
    dense_s = compose_smooth_ref(tt(u_tot), tt(c_inc), sd, kw)
    for got, dense in ((corr, dense_c), (comp, dense_s)):
        assert torch.equal(_tiled(got), dense)
        assert torch.equal(got[17], dense[:, 17:17 + NXL])


def test_demons_strip_wrappers_refuse_a_pad_below_the_reach(fields):
    """A pad one row short of the reach raises, on the CPU as on the card."""
    iref, imov, _, u, _ = fields
    kw, halo = 5, 2
    for fn, need, arrays, params in (
            (thirion_onepass_strip, onepass_strip_pad(halo, kw), (imov, iref, u),
             (1.0, 1.0, 2.0, 1.5, kw, halo)),
            (demons_correspondence_strip, correspondence_strip_pad(halo, kw), (imov, iref, u),
             (0.25, 1.0, 2.0, kw, halo)),
            (compose_smooth_strip, compose_smooth_strip_pad(halo, kw), (u, u), (1.5, kw, halo))):
        args = [tt(_strip(a, 16, need - 1)) for a in arrays]
        with pytest.raises(ValueError, match="pad of at least"):
            fn(*args, 16, SHAPE[0], *params, need - 1)


@pytest.mark.parametrize("kw", [5, 9])
def test_gaussian_local_matches_jax(kw):
    """The strip Gaussian (a kw // 2-row halo exchange, the renormalization
    from global rows) against JAX's ``make_gaussian_smooth_sharded``, which
    compiled XLA contracts into fused multiply-adds an ulp apart, and bit
    for bit against the port's dense ``convolve2d_clip``; kw 9 reaches past
    a 4-row strip (the multi-hop exchange)."""
    x = np.random.default_rng(kw).standard_normal((2,) + SHAPE).astype(np.float32)
    jmesh = j_make_mesh(data=1, x=8)
    want = np.asarray(j_sp.make_gaussian_smooth_sharded(jmesh, 1.5, kw)(jnp.asarray(x)))
    dense = convolve2d_clip(tt(x), 1.5, kw)
    for n in (8, 16):
        got = spatial._gather(spatial._gaussian_local(spatial._split(x, ["cpu"] * n), 1.5, kw))
        assert_close(got, want, FIELD_TOL)
        assert torch.equal(got, dense)


@pytest.mark.parametrize("maxabs,nsq", [(0.3, 0), (1.6, 2), (3.5, 3)])
def test_expmap_strip_matches_jax(maxabs, nsq):
    """The strip exp map, with maxabs set by one pixel away from a squaring
    boundary (no squaring, two and three, within the contract at halo 5):
    bit for bit against the port's dense ``expmap``, and against JAX's
    inside ``shard_map``. Compiled XLA contracts the compose's tap sum into
    fused multiply-adds an ulp apart, and each squaring composes the field
    with itself, which about doubles a difference: the tolerance is
    FIELD_TOL * 2^nsq (1.6e-6 measured at two squarings)."""
    halo = 5
    rng = np.random.default_rng(nsq)
    c = (0.5 * maxabs * np.tanh(rng.standard_normal((2,) + SHAPE))).astype(np.float32)
    c[:, 37, 5] = [maxabs, 0.0]
    assert expmap_nsq(maxabs) == nsq
    jmesh = j_make_mesh(data=1, x=8)
    want = _j_strips(lambda f: j_sp._expmap_strip(f, halo, "x"), c, P(None, "x", None), jmesh)
    got = spatial._gather(spatial._expmap_strip(spatial._split(c, ["cpu"] * 8), halo))
    assert torch.equal(got, expmap(tt(c)))
    assert_close(got, want, FIELD_TOL * 2 ** nsq)
    assert np.array_equal(npy(got), c) == (nsq == 0)


def test_strip_wrappers_refuse_other_devices():
    """A tensor that lies neither on the CPU nor on CUDA gets no plain
    version: the wrapper raises."""
    with pytest.raises(ValueError, match="no elastic block"):
        elastic_block_strip(torch.zeros(2, 20, 8, device="meta"),
                            torch.zeros(3, 20, 8, device="meta"), 0, 4, 1.0, 0.0, 0.66, True, 1)


def _j_strips(fn, x, spec, mesh):
    return np.asarray(jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,), out_specs=spec,
                                        check_vma=False))(jnp.asarray(x)))


@pytest.mark.parametrize("ny", [48, 64])
@pytest.mark.parametrize("stack", [False, True])
def test_strip_pyramid_matches_jax(ny, stack):
    """The strip downsample takes XLA's order on the strip's own shape
    (``ny`` a power of two or not; an image and a ``[2, nx, ny]`` field),
    and the strip upsample, with its halo row and the image's last row,
    equals JAX's bit for bit."""
    rng = np.random.default_rng(ny)
    iref, _ = tiled_pair(64, ny)
    x = np.stack([iref, iref[::-1] * 0.7]) if stack else iref
    x = (x + rng.uniform(0.0, 1e-3, x.shape)).astype(np.float32)
    spec = P(None, "x", None) if stack else P("x", None)
    jmesh = j_make_mesh(data=1, x=8)
    devices = ["cpu"] * 8
    want_down = _j_strips(lambda f: j_sp._downsample2_local(f, "x"), x, spec, jmesh)
    got_down = spatial._gather(spatial._downsample2_local(spatial._split(x, devices)))
    assert np.array_equal(npy(got_down), want_down)
    want_up = _j_strips(lambda f: j_sp._upsample2_local(f, "x"), want_down, spec, jmesh)
    got_up = spatial._gather(spatial._upsample2_local(spatial._split(got_down, devices)))
    assert np.array_equal(npy(got_up), want_up)


@pytest.mark.parametrize("k", [1, 8, 20])
def test_halo_pad_matches_jax(k):
    """Halos of 1 row, of 8 (a whole 8-row strip), and of 20 rows, which
    pull three strips (the multi-hop branch), zeros beyond the image."""
    x = np.arange(2 * 64 * 6, dtype=np.float32).reshape(2, 64, 6)
    jmesh = j_make_mesh(data=1, x=8)
    want = jax.jit(shard_map(lambda f: j_sp._halo_pad(f, k, "x"), mesh=jmesh,
                             in_specs=(P(None, "x", None),), out_specs=P(None, "x", None),
                             check_vma=False))(jnp.asarray(x))
    got = spatial._halo_pad(spatial._split(x, ["cpu"] * 8), k)
    assert np.array_equal(npy(torch.cat(got, dim=-2)), np.asarray(want))
