"""Strip-parallel registration: the explicit strip drivers of
``opticalflow2d_tpu.parallel.spatial`` (its path 2) for the diffusion,
curvature, elastic, fluid, Thirion and diffeomorphic demons families,
ported to PyTorch.

An image is cut into strips along x, one per device of the mesh's ``"x"``
axis (``parallel.mesh``). A sharded field is the list of its strips in mesh
order, each ``[..., nxl, ny]`` on its strip's device; one process drives
them all, as the JAX package's single controller drives its ``shard_map``.
The functions below mirror the JAX strip-local bodies, with these
counterparts:

- ``lax.ppermute`` halo exchange: a neighbour's rows moved with ``.to``
  (a slice when both strips share a device); zeros beyond the image.
- ``lax.psum``/``pmax``/``pmin``: the strips' values combined in strip
  order 0..S-1 on the first strip's device, a fixed sequence with no
  atomics, so a Logger stop repeats from run to run.
- ``lax.all_to_all(..., tiled=True)`` (the curvature transform's
  transposes): ``_all_to_all``, which cuts every strip into S chunks along
  one axis and gives strip j the j-th chunks of all strips, concatenated in
  strip order along the other.
- ``lax.while_loop``: a host loop that reads what the stop needs once a
  block (diffusion and elastic: the ``[k, 2]`` Logger sums) or once an
  iteration (the per-step route and the demons: the Logger error; fluid:
  the error and the minimum Jacobian determinant together). The
  diffeomorphic exp map reads its squaring count once more an iteration.

The strip kernels (``kernels``) carry the blocked diffusion and elastic
passes, the fluid iteration, the demons iteration and every warp and
compose; on CPU tensors their plain versions do. The per-step diffusion and
elastic bodies, the gradients, norms, the fluid timestep and Euler update
and the pyramid are plain PyTorch on every device, as they are jnp in the
JAX package; the curvature solve is the dense per-axis DCT matmuls
(cuBLAS, full float32) around the two transposes. The ``use_pallas``
switch, JAX's ``dct_precision`` (an MXU tier) and the TPU's tile gates are
gone.

A demons iteration takes one of three routes, chosen from the
configuration before any launch (``demons_strip_route``), as JAX's
``_demons_iter_strip`` does (``spatial.py:441-489``):
- ``"onepass"``, K5: Thirion whose correspondence bound ``sigma_x / (2
  sigma_i)`` fits the halo (``onepass_supported`` without its pad limit);
- ``"two_kernel"``, K6, the exp map's squarings on K4 (diffeomorphic
  only), then K7: diffeomorphic demons, and Thirion whose bound exceeds the
  halo;
- ``"op_chain"``, plain strip ops on K4's warp and compose, where the
  kernelwidth's tile does not fit the kernels' shared memory
  (``demons_onepass.tile_fits``).
Thirion always composes and diffeomorphic demons never takes K5, as in the
JAX strips. The TPU's tiling gates (``required_pad <= 16``, ``nxl %
required_pad == 0``, ``onepass_feasible``'s tiers, ``fused_supported``'s
8-row pad) are gone, and each kernel's pad is its exact reach; JAX's own
tests pin the three routes to one field, so the route changes the launches,
not the result. The level-warped moving image and the reference are padded
once a level, not once an iteration.

Semantics kept from the JAX strip drivers, which differ from the dense
driver (``engine.registration``):
- the fluid velocity starts at zero on every level solve, so with
  ``nrefine > 1`` it restarts at each refinement;
- the pyramid is built and the motion seeded strip-locally: each level
  downsampled from the one above, the motion by ``_downsample2_local * 0.5``
  and ``_upsample2_local * 2``;
- the displacement contract: a warp or compose sample whose floor offset
  lies outside ``[-halo, halo]`` on either axis takes no taps.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from opticalflow2d_tpu_torch.engine.logger import block_stop, relative_errors
from opticalflow2d_tpu_torch.kernels.demons_fused import (
    compose_smooth_strip,
    compose_smooth_strip_pad,
    correspondence_strip_pad,
    demons_correspondence_strip,
)
from opticalflow2d_tpu_torch.kernels.demons_onepass import (
    onepass_strip_pad,
    thirion_onepass_strip,
    tile_fits,
)
from opticalflow2d_tpu_torch.kernels.diffusion_block import (
    diffusion_block_strip,
    required_pad as diffusion_pad,
    stack_derivs,
)
from opticalflow2d_tpu_torch.kernels.elastic_block import (
    elastic_block_strip,
    required_pad as elastic_pad,
)
from opticalflow2d_tpu_torch.kernels.fluid_fused import FLUID_PAD, fluid_iter_strip
from opticalflow2d_tpu_torch.kernels.warp_fused import compose_strip, warp2d_strip
from opticalflow2d_tpu_torch.ops.conv import convolve2d_clip_rows
from opticalflow2d_tpu_torch.ops.dct import curvature_eigenvalues, dct_matrix, full_f32
from opticalflow2d_tpu_torch.ops.grid import partial_x_rows, partial_y
from opticalflow2d_tpu_torch.ops.reduce import sqrt_rounded
from opticalflow2d_tpu_torch.ops.resample import box_mean
from opticalflow2d_tpu_torch.ops.warp import expmap_nsq
from opticalflow2d_tpu_torch.parallel.mesh import Mesh
from opticalflow2d_tpu_torch.solvers.base import Derivatives, demons_force
from opticalflow2d_tpu_torch.solvers.elastic import _gs_candidate, sor_scalars
from opticalflow2d_tpu_torch.solvers.fluid import _timestep

Strips = List[torch.Tensor]

# Rows a side that a warp or compose strip gets: the TPU kernel's _PAD
# (warp_fused.py:30), or halo + 1 where the halo is wider.
_GATHER_PAD = 8

_FAMILIES = ("diffusion", "curvature", "elastic", "fluid", "thirions", "diffeo")
_DEMONS = ("thirions", "diffeo")


def _check_family(family: str) -> None:
    if family not in _FAMILIES:
        raise ValueError(f"unknown family {family!r}")


# --- strips and collectives ------------------------------------------------

def _strip_devices(mesh: Mesh) -> List[torch.device]:
    if mesh.shape["data"] != 1:
        raise NotImplementedError(
            "the strip drivers take a mesh of one data row, as the JAX package's do; "
            "a batch of pairs goes to parallel.register_batch")
    return mesh.x_devices()


def _split(x, devices: Sequence[torch.device]) -> Strips:
    """Cut ``x [..., nx, ny]`` into ``len(devices)`` strips along x."""
    x = torch.as_tensor(x)
    n, nx = len(devices), x.shape[-2]
    if nx % n:
        raise ValueError(f"nx = {nx} must be divisible by the mesh's x size {n}")
    nxl = nx // n
    return [x[..., s * nxl:(s + 1) * nxl, :].to(d).contiguous() for s, d in enumerate(devices)]


def _gather(f: Strips) -> torch.Tensor:
    """The whole field, on the first strip's device."""
    return torch.cat([x.to(f[0].device) for x in f], dim=-2)


def _psum(vals: Strips) -> torch.Tensor:
    total = vals[0]
    for v in vals[1:]:
        total = total + v.to(total.device)
    return total


def _pmax(vals: Strips) -> torch.Tensor:
    out = vals[0]
    for v in vals[1:]:
        out = torch.maximum(out, v.to(out.device))
    return out


def _pmin(vals: Strips) -> torch.Tensor:
    out = vals[0]
    for v in vals[1:]:
        out = torch.minimum(out, v.to(out.device))
    return out


def _all_to_all(f: Strips, split_axis: int, concat_axis: int) -> Strips:
    """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)`` over the
    strips: strip j gets chunk j of every strip's ``split_axis``, the
    chunks concatenated in strip order along ``concat_axis``."""
    n = len(f)
    chunk = f[0].shape[split_axis] // n
    return [torch.cat([x.narrow(split_axis, j * chunk, chunk).to(dst.device) for x in f],
                      dim=concat_axis)
            for j, dst in enumerate(f)]


def _strip_info(f: Strips, s: int):
    """(gi [nxl, 1], gj [1, ny], nx_glob): global row and column indices of
    strip ``s``."""
    nxl, ny = f[s].shape[-2], f[s].shape[-1]
    dev = f[s].device
    gi = torch.arange(s * nxl, (s + 1) * nxl, device=dev)[:, None]
    gj = torch.arange(ny, device=dev)[None, :]
    return gi, gj, len(f) * nxl


def _halo_exchange_k(f: Strips, k: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The ``(top, bot)`` halo blocks ``[..., k, ny]`` of every strip, zeros
    at the image's border. ``k > nxl`` (a halo wider than a strip, at coarse
    pyramid levels) pulls whole strips from up to ``ceil(k / nxl)`` strips
    away and slices the halo from their concatenation."""
    n, nxl = len(f), f[0].shape[-2]
    hops = -(-k // nxl)
    out = []
    for s, x in enumerate(f):
        def away(t):
            return f[t].to(x.device) if 0 <= t < n else torch.zeros_like(x)
        if k <= nxl:
            top = away(s - 1)[..., -k:, :]
            bot = away(s + 1)[..., :k, :]
        else:
            top = torch.cat([away(s - h) for h in range(hops, 0, -1)], dim=-2)[..., -k:, :]
            bot = torch.cat([away(s + h) for h in range(1, hops + 1)], dim=-2)[..., :k, :]
        out.append((top, bot))
    return out


def _halo_pad(f: Strips, k: int) -> Strips:
    """Every strip extended with ``k`` exchanged halo rows a side."""
    return [torch.cat([top, x, bot], dim=-2) for x, (top, bot) in zip(f, _halo_exchange_k(f, k))]


# --- strip stencils ----------------------------------------------------------

def _qlaplacian_halo(f: Strips) -> Strips:
    """Quasi-laplacian (4-neighbour average, zero on the image's border) of
    each strip, with a 1-row halo exchange."""
    out = []
    for s, (x, fp) in enumerate(zip(f, _halo_pad(f, 1))):
        x_sum = fp[..., 2:, :] + fp[..., :-2, :]
        y_pad = F.pad(x, (1, 1))
        y_sum = y_pad[..., :, 2:] + y_pad[..., :, :-2]
        q = (x_sum + y_sum) * 0.25
        gi, gj, nx_glob = _strip_info(f, s)
        border = (gi == 0) | (gi == nx_glob - 1) | (gj == 0) | (gj == x.shape[-1] - 1)
        out.append(torch.where(border, 0.0, q))
    return out


def _partials_strip(f: Strips) -> Tuple[Strips, Strips]:
    """(d/dx, d/dy) of each strip: central differences with a 1-row halo
    exchange in x, one-sided at the image's border (``ops.grid``)."""
    gx = []
    for s, fp in enumerate(_halo_pad(f, 1)):
        gi, _, nx_glob = _strip_info(f, s)
        gx.append(partial_x_rows(fp, gi, nx_glob))
    return gx, [partial_y(x) for x in f]


def _gradient_local(img: Strips) -> Strips:
    """``[nxl, ny] -> [2, nxl, ny]`` spatial gradient of each strip."""
    gx, gy = _partials_strip(img)
    return [torch.stack([a, b]) for a, b in zip(gx, gy)]


def _norm_psum(v: Strips) -> torch.Tensor:
    """Mean per-pixel magnitude of a motion field over all strips (the
    reference Logger's norm, src/Logger.cpp:32-58)."""
    total = _psum([torch.sqrt(x[0] ** 2 + x[1] ** 2).sum() for x in v])
    count = float(np.float32(sum(x[0].numel() for x in v)))
    return total / count


def _rel_err_psum(u_new: Strips, prev: Strips) -> torch.Tensor:
    """The Logger's relative step error, 0 where the previous norm is 0."""
    pn = _norm_psum(prev)
    dn = _norm_psum([a - b for a, b in zip(u_new, prev)])
    return torch.where(pn == 0, 0.0, dn / torch.where(pn == 0, 1.0, pn))


def _redblack_masks(f: Strips, s: int):
    """(red, black) interior checkerboard masks of strip ``s`` in global
    coordinates: a strip whose first row is odd flips its local colours."""
    gi, gj, nx_glob = _strip_info(f, s)
    ny = f[s].shape[-1]
    interior = (gi >= 1) & (gi <= nx_glob - 2) & (gj >= 1) & (gj <= ny - 2)
    even = (gi + gj) % 2 == 0
    return even & interior, ~even & interior


def _sor_sweep_strip(x: Strips, b: Strips, mu: float, lam: float, omega: float,
                     reference_stencil: bool) -> Strips:
    """One red-black Navier-Lame SOR sweep on the strips with a 1-row halo
    exchange per half-sweep: ``solvers.elastic``'s candidate on the
    halo-padded strip, global masks, borders untouched. The body of the
    per-step elastic route and of ``make_sor_sweeps_sharded``."""
    sc = sor_scalars(mu, lam, omega)
    masks = [_redblack_masks(x, s) for s in range(len(x))]
    b_pad = [F.pad(v, (0, 0, 1, 1)) for v in b]

    def half(x, colour):
        out = []
        for s, xp in enumerate(_halo_pad(x, 1)):
            cand = _gs_candidate(xp, b_pad[s], sc, reference_stencil)
            new = x[s].clone()
            new[:, :, 1:-1] = torch.where(masks[s][colour][:, 1:-1], cand, x[s][:, :, 1:-1])
            out.append(new)
        return out

    return half(half(x, 0), 1)


# --- strip warp and compose (kernel K4) ---------------------------------------

def _gather_pad(halo: int) -> int:
    return max(halo + 1, _GATHER_PAD)


def _warp_local(img: Strips, u: Strips, halo: int) -> Strips:
    """Backward warp of each strip of ``img`` by its motion, within the
    displacement contract ``|floor offset| <= halo``."""
    nxl, nx_glob = u[0].shape[-2], len(u) * u[0].shape[-2]
    return [warp2d_strip(xp, v, s * nxl, nx_glob, halo)
            for s, (xp, v) in enumerate(zip(_halo_pad(img, _gather_pad(halo)), u))]


def _compose_local(u_tot: Strips, u_inc: Strips, halo: int) -> Strips:
    """``u_inc + u_tot(x + u_inc)`` on each strip, within the contract."""
    nxl, nx_glob = u_inc[0].shape[-2], len(u_inc) * u_inc[0].shape[-2]
    return [compose_strip(tp, v, s * nxl, nx_glob, halo)
            for s, (tp, v) in enumerate(zip(_halo_pad(u_tot, _gather_pad(halo)), u_inc))]


# --- strip Gaussian, exp map and the demons iteration (K5-K7) --------------------

def _gaussian_local(f: Strips, sigma: float, width: int) -> Strips:
    """Boundary-renormalized separable Gaussian of each strip, equal to
    ``ops.conv.convolve2d_clip`` of the image on its rows: a ``width // 2``
    -row halo exchange for the x pass, the renormalization from global
    rows."""
    c = (width - 1) // 2
    nxl, nx_glob = f[0].shape[-2], len(f) * f[0].shape[-2]
    padded = _halo_pad(f, c) if c else f
    return [convolve2d_clip_rows(fp, s * nxl - c, nx_glob, sigma, width)
            for s, fp in enumerate(padded)]


def _expmap_strip(c: Strips, halo: int) -> Strips:
    """Scaling and squaring of a correspondence field on the strips
    (``ops.warp.expmap``): the squaring count from the strips' max |c|^2,
    rooted in float64 (``sqrt_rounded``) and read once, the squarings on
    the strip compose (K4)."""
    m2 = _pmax([(x[0] ** 2 + x[1] ** 2).max() for x in c])
    nsq = expmap_nsq(float(sqrt_rounded(m2)))  # the iteration's second host read
    if nsq == 0:
        return c
    v = [x * float(2.0 ** -nsq) for x in c]
    for _ in range(nsq):
        v = _compose_local(v, v, halo)
    return v


def demons_strip_route(family: str, p: dict, halo: int) -> str:
    """The route of a demons strip iteration, from the configuration:
    ``"onepass"`` (K5) for Thirion whose correspondence bound
    ``sigma_x / (2 sigma_i)`` fits the halo, ``"two_kernel"`` (K6, the exp
    map, K7) for the rest when the kernels' tile fits the kernelwidth, else
    ``"op_chain"``."""
    if not tile_fits(p["kernelwidth"]):
        return "op_chain"
    if (family == "thirions" and halo >= 1 and p["sigma_i"] > 0
            and p["sigma_x"] / (2.0 * p["sigma_i"]) <= halo):
        return "onepass"
    return "two_kernel"


def _demons_chain_strip(u_est: Strips, iref_l: Strips, iaux: Strips, p: dict, halo: int,
                        diffeomorphic: bool) -> Strips:
    """One demons iteration as plain strip ops on the strip warp and
    compose (K4): warp, gradient, force, sigma_fluid smooth, (exp map,)
    compose, sigma_diffusion smooth."""
    kw = int(p["kernelwidth"])
    iwar = _warp_local(iaux, u_est, halo)
    c = [demons_force(Derivatives(g, w - r), p["sigma_i"], p["sigma_x"])
         for g, w, r in zip(_gradient_local(iwar), iwar, iref_l)]
    c = _gaussian_local(c, p["sigma_fluid"], kw)
    if diffeomorphic:
        c = _expmap_strip(c, halo)
    return _gaussian_local(_compose_local(u_est, c, halo), p["sigma_diffusion"], kw)


def _demons_stepper(family: str, iref_l: Strips, iaux: Strips, p: dict,
                    halo: int) -> Callable[[Strips], Strips]:
    """``u_est -> u_new``, one demons iteration on the strips by the route
    of ``demons_strip_route``. ``iaux`` (the level-warped moving image) and
    ``iref_l`` are padded here, once for every iteration it runs."""
    nxl, nx_glob = iaux[0].shape[-2], len(iaux) * iaux[0].shape[-2]
    si, sx, sf, sd, kw = (p["sigma_i"], p["sigma_x"], p["sigma_fluid"], p["sigma_diffusion"],
                          int(p["kernelwidth"]))
    route = demons_strip_route(family, p, halo)
    if route == "op_chain":
        return lambda v: _demons_chain_strip(v, iref_l, iaux, p, halo, family == "diffeo")
    if route == "onepass":
        pad = onepass_strip_pad(halo, kw)
        ia, ir = _halo_pad(iaux, pad), _halo_pad(iref_l, pad)

        def onepass(v):
            return [thirion_onepass_strip(ia[s], ir[s], vp, s * nxl, nx_glob, si, sx, sf, sd, kw,
                                          halo, pad)
                    for s, vp in enumerate(_halo_pad(v, pad))]

        return onepass
    pc, ps = correspondence_strip_pad(halo, kw), compose_smooth_strip_pad(halo, kw)
    ia, ir = _halo_pad(iaux, pc), _halo_pad(iref_l, pc)

    def two_kernel(v):
        c = [demons_correspondence_strip(ia[s], ir[s], vp, s * nxl, nx_glob, si, sx, sf, kw, halo,
                                         pc)
             for s, vp in enumerate(_halo_pad(v, pc))]
        if family == "diffeo":
            c = _expmap_strip(c, halo)
        return [compose_smooth_strip(vp, cp, s * nxl, nx_glob, sd, kw, halo, ps)
                for s, (vp, cp) in enumerate(zip(_halo_pad(v, ps), _halo_pad(c, ps)))]

    return two_kernel


# --- family bodies -------------------------------------------------------------

def _curvature_solver_strip(nx_g: int, ny_g: int, alpha: float, tau: float):
    """Distributed semi-implicit curvature solve ``rhs [c, nxl, ny] strips ->
    strips``: the y-DCT on each strip, a transpose across strips, the x-DCT,
    the eigenvalue multiply on each strip's y-slice and the inverse x-DCT,
    the transpose back, the inverse y-DCT (two transposes in all, JAX's
    ``_curvature_solve_strip``). Matches ``solvers.curvature``
    (OpticalFlowCurvature.cpp:144-167) to the transforms' rounding. The
    eigenvalue table is built on the first call, once a device."""
    scale = 1.0 / (4.0 * nx_g * ny_g)
    eigs = {}

    def eig_slice(j: int, n: int, dev):
        if dev not in eigs:
            eigs[dev] = curvature_eigenvalues(nx_g, ny_g, alpha, tau, dev)
        nyl = ny_g // n
        return eigs[dev][:, j * nyl:(j + 1) * nyl]

    def solve(rhs: Strips) -> Strips:
        with full_f32():
            t = [torch.matmul(r, dct_matrix(ny_g, 2, r.device).T) for r in rhs]
            t = _all_to_all(t, 2, 1)
            t = [torch.matmul(dct_matrix(nx_g, 2, x.device), x) * eig_slice(j, len(t), x.device)
                 for j, x in enumerate(t)]
            t = _all_to_all([torch.matmul(dct_matrix(nx_g, 3, x.device), x) for x in t], 1, 2)
            return [torch.matmul(x, dct_matrix(ny_g, 3, x.device).T) * scale for x in t]

    return solve


def _curvature_step_strip(u: Strips, grad_i: Strips, it_img: Strips, tau: float,
                          solve: Callable[[Strips], Strips]) -> Strips:
    """One curvature iteration on the strips: the L-SSD force, the rhs
    ``u - tau f``, the distributed DCT solve (``_curvature_solver_strip``)."""
    rhs = [v - tau * (g * (t + v[0] * g[0] + v[1] * g[1])[None])
           for v, g, t in zip(u, grad_i, it_img)]
    return solve(rhs)


def _diffusion_consts_strip(grad_i: Strips, it_img: Strips, alpha: float) -> Strips:
    return [alpha * alpha + g[0] ** 2 + g[1] ** 2 for g in grad_i]


def _diffusion_step_strip(u: Strips, grad_i: Strips, it_img: Strips, den: Strips) -> Strips:
    """One Horn-Schunck Jacobi update of the strips (``solvers.diffusion``'s
    jnp order)."""
    out = []
    for q, g, t, d in zip(_qlaplacian_halo(u), grad_i, it_img, den):
        inner = t + q[0] * g[0] + q[1] * g[1]
        out.append(q - g * inner[None] / d[None])
    return out


def _elastic_step_strip(u: Strips, grad_i: Strips, it_img: Strips, p: dict) -> Strips:
    """One elastic iteration: the L-SSD force, then one red-black SOR sweep
    on the motion (``solvers.elastic.elastic_step``)."""
    b = [g * (t + v[0] * g[0] + v[1] * g[1])[None] for v, g, t in zip(u, grad_i, it_img)]
    return _sor_sweep_strip(u, b, p["mu"], p["lam"], p.get("omega", 0.66),
                            p.get("reference_stencil", True))


def _fluid_level_strip(u: Strips, iref_l: Strips, imov_l: Strips, niter: int, halo: int,
                       p: dict, convergence_tol: float):
    """A viscous-fluid level solve on the strips (``ImageRegistrationFluid.
    cpp:67-142``): each iteration runs the strip kernel K3 (force, red-black
    sweep of the velocity, increment R, the strip's max |R|^2), the
    timestep from the strips' max and the gated Euler step on the device,
    and one host read of the Logger error and the minimum Jacobian
    determinant, which decide the stop and a regrid. The velocity starts at
    zero on every call. Returns ``(u, iterations, regrids)``."""
    mu, lam, omega = p["mu"], p["lam"], p.get("omega", 0.66)
    ref_stencil = p.get("reference_stencil", True)
    dumax32 = float(np.float32(p.get("dumax", 0.65)))
    skip32 = float(np.float32(p.get("timestep_skip", 65.0)))
    threshold = np.float32(p.get("regrid_threshold", 0.5))
    tol = np.float32(convergence_tol)
    nxl, nx_glob = u[0].shape[-2], len(u) * u[0].shape[-2]

    def derive(u_tot):
        ia = _warp_local(imov_l, u_tot, halo)
        g = [stack_derivs(gr, a - r) for gr, a, r in zip(_gradient_local(ia), ia, iref_l)]
        return _halo_pad(g, FLUID_PAD)  # loop-invariant until the next regrid

    g_pad = derive(u)
    u_tot = u
    zeros = [torch.zeros_like(x) for x in u]
    u_est, prev, vel = zeros, zeros, zeros
    it, conv, nregrid = 0, False, 0
    while it < niter and not conv:
        out = [fluid_iter_strip(up, vp, gp, s * nxl, nx_glob, mu, lam, omega, ref_stencil)
               for s, (up, vp, gp) in enumerate(zip(_halo_pad(u_est, FLUID_PAD),
                                                    _halo_pad(vel, FLUID_PAD), g_pad))]
        vel = [o[0] for o in out]
        dt = _timestep(_pmax([o[2] for o in out]), dumax32)
        do_step = dt < skip32
        step = torch.where(do_step, dt, 0.0)
        u_new = [torch.where(do_step.to(v.device), v + o[1] * step.to(v.device), v)
                 for v, o in zip(u_est, out)]
        dudx, dudy = _partials_strip(u_new)
        jac_min = _pmin([((1.0 + a[0]) * (1.0 + b[1]) - a[1] * b[0]).min()
                         for a, b in zip(dudx, dudy)])
        err, jac = torch.stack([_rel_err_psum(u_new, prev), jac_min]).cpu().numpy()
        _, conv = block_stop([err], it, niter, tol)
        # The Logger's prev is the pre-regrid estimate (it lives outside the
        # regrid block in the reference).
        prev = u_new
        if not conv and jac < threshold:
            u_tot = _compose_local(u_tot, u_new, halo)
            g_pad = derive(u_tot)
            u_new = zeros
            nregrid += 1
        u_est = u_new
        it += 1
    return _compose_local(u_tot, u_est, halo), it, nregrid


def _level_blocked_strip(u: Strips, niter: int, k: int, pad: int, halo: int,
                         convergence_tol: float, block_call: Callable) -> Tuple[Strips, int]:
    """Blocked level loop: halo-pad the estimate by ``pad`` rows, run the
    k-iteration strip kernel on every strip, add the strips' ``[k, 2]``
    sums in order and read them once; the Logger gate as the dense driver's.
    A stop (or the niter cap) inside a block reruns the kernel for the
    taken iterations from the block's padded start, the same bits as that
    many steps. ``block_call(s, u_pad, k) -> (u_k, sums)``."""
    tol = np.float32(convergence_tol)
    u_est = [torch.zeros_like(x) for x in u]
    it, conv = 0, False
    while it < niter and not conv:
        u_pad = _halo_pad(u_est, pad)
        out = [block_call(s, up, k) for s, up in enumerate(u_pad)]
        sums = _psum([o[1] for o in out]).cpu().numpy()  # the one host read a block
        n_take, conv = block_stop(relative_errors(sums[:, 0], sums[:, 1]), it, niter, tol)
        if n_take < k:
            u_est = [block_call(s, up, n_take)[0] for s, up in enumerate(u_pad)]
        else:
            u_est = [o[0] for o in out]
        it += n_take
    return _compose_local(u, u_est, halo), it


def _diffusion_level_blocked_strip(u: Strips, grad_i: Strips, it_img: Strips, alpha: float,
                                   niter: int, k: int, halo: int, convergence_tol: float):
    """Diffusion level loop over the strip kernel K1: one ``pad``-row halo
    exchange and one pass per ``k`` iterations."""
    pad = diffusion_pad(k)
    g_pad = _halo_pad([stack_derivs(g, t) for g, t in zip(grad_i, it_img)], pad)
    nxl, nx_glob = u[0].shape[-2], len(u) * u[0].shape[-2]

    def block_call(s, u_pad, kk):
        return diffusion_block_strip(u_pad, g_pad[s], s * nxl, nx_glob, alpha, kk, pad)

    return _level_blocked_strip(u, niter, k, pad, halo, convergence_tol, block_call)


def _elastic_level_blocked_strip(u: Strips, grad_i: Strips, it_img: Strips, p: dict,
                                 niter: int, k: int, halo: int, convergence_tol: float):
    """Elastic level loop over the strip kernel K2 (its cone is 2 rows an
    iteration)."""
    pad = elastic_pad(k)
    g_pad = _halo_pad([stack_derivs(g, t) for g, t in zip(grad_i, it_img)], pad)
    nxl, nx_glob = u[0].shape[-2], len(u) * u[0].shape[-2]
    args = (p["mu"], p["lam"], p.get("omega", 0.66), bool(p.get("reference_stencil", True)))

    def block_call(s, u_pad, kk):
        return elastic_block_strip(u_pad, g_pad[s], s * nxl, nx_glob, *args, kk, pad)

    return _level_blocked_strip(u, niter, k, pad, halo, convergence_tol, block_call)


def _iterate_level_strip(one_step: Callable, u: Strips, niter: int, halo: int,
                         convergence_tol: float) -> Tuple[Strips, int]:
    """Per-step level loop: ``one_step`` until niter or the Logger stop,
    with one host read of the error an iteration, then the level estimate
    composed into the incoming motion."""
    tol = np.float32(convergence_tol)
    u_est = [torch.zeros_like(x) for x in u]
    prev, it, conv = u_est, 0, False
    while it < niter and not conv:
        u_new = one_step(u_est)
        err = np.float32(_rel_err_psum(u_new, prev).item())  # the one host read
        _, conv = block_stop([err], it, niter, tol)
        u_est = prev = u_new
        it += 1
    return _compose_local(u, u_est, halo), it


def _level_local(family: str, u: Strips, iref_l: Strips, imov_l: Strips, level_niter: int,
                 halo: int, p: dict, convergence_tol: float):
    """One level solve on the strips: the family's iterations, the Logger
    stop and the final composition. Returns ``(u, iterations, regrids)``.
    Diffusion and elastic take the blocked strip kernels when
    ``block_k > 1`` and the images are float32, else the per-step body;
    curvature the per-step body around the distributed DCT solve, which
    needs ny divisible by the strip count; the demons take the route of
    ``demons_strip_route``."""
    _check_family(family)
    if family == "fluid":
        return _fluid_level_strip(u, iref_l, imov_l, level_niter, halo, p, convergence_tol)
    iaux = _warp_local(imov_l, u, halo)
    if family in _DEMONS:
        one_step = _demons_stepper(family, iref_l, iaux, p, halo)
        u, it = _iterate_level_strip(one_step, u, level_niter, halo, convergence_tol)
        return u, it, 0
    grad_i = _gradient_local(iaux)
    it_img = [a - r for a, r in zip(iaux, iref_l)]
    if family == "curvature":
        nxl, ny = iref_l[0].shape
        if ny % len(iref_l):
            raise ValueError(f"curvature on strips needs ny ({ny}) divisible by the mesh's "
                             f"x size {len(iref_l)}")
        tau = p.get("tau", 1.0)
        solve = _curvature_solver_strip(len(iref_l) * nxl, ny, p["alpha"], tau)
        u, it = _iterate_level_strip(
            lambda v: _curvature_step_strip(v, grad_i, it_img, tau, solve), u, level_niter,
            halo, convergence_tol)
        return u, it, 0
    bk = int(p.get("block_k", 0))
    blocked = bk > 1 and iref_l[0].dtype == torch.float32
    if family == "diffusion":
        if blocked:
            u, it = _diffusion_level_blocked_strip(u, grad_i, it_img, p["alpha"], level_niter,
                                                   bk, halo, convergence_tol)
            return u, it, 0
        den = _diffusion_consts_strip(grad_i, it_img, p["alpha"])

        def one_step(v):
            return _diffusion_step_strip(v, grad_i, it_img, den)
    else:
        if blocked:
            u, it = _elastic_level_blocked_strip(u, grad_i, it_img, p, level_niter, bk, halo,
                                                 convergence_tol)
            return u, it, 0

        def one_step(v):
            return _elastic_step_strip(v, grad_i, it_img, p)
    u, it = _iterate_level_strip(one_step, u, level_niter, halo, convergence_tol)
    return u, it, 0


# --- strip pyramid ---------------------------------------------------------------

def _downsample2_local(f: Strips) -> Strips:
    """Factor-2 box downsample of each strip, local to it (``nxl`` even),
    in XLA's order for the strip's shape (``ops.resample.box_mean``)."""
    return [box_mean(x, 2, 2) for x in f]


def _upsample2_local(f: Strips) -> Strips:
    """Factor-2 origin-aligned bilinear upsample of each strip with a 1-row
    halo: output row 2i is input row i, row 2i+1 the mean of rows i and
    i+1 (the next strip's first row for the last), or row i alone at the
    image's last row; then the same along y."""
    out = []
    for s, (x, (_top, bot)) in enumerate(zip(f, _halo_exchange_k(f, 1))):
        nxl, ny = x.shape[-2], x.shape[-1]
        gi, gj, nx_glob = _strip_info(f, s)
        nxt = torch.cat([x[..., 1:, :], bot], dim=-2)
        odd = torch.where(gi == nx_glob - 1, x, (x + nxt) * 0.5)
        up_x = torch.stack([x, odd], dim=-2).reshape(*x.shape[:-2], 2 * nxl, ny)
        nxt_y = torch.cat([up_x[..., :, 1:], torch.zeros_like(up_x[..., :, :1])], dim=-1)
        odd_y = torch.where(gj == ny - 1, up_x, (up_x + nxt_y) * 0.5)
        out.append(torch.stack([up_x, odd_y], dim=-1).reshape(*up_x.shape[:-1], 2 * ny))
    return out


# --- factories ---------------------------------------------------------------------

class SPResult(NamedTuple):
    """A strip-parallel registration: the motion ``[2, nx, ny]`` on the
    mesh's first device, and per (level, refinement), coarse to fine and
    refine-major, the iterations and (fluid) the regrids. The JAX driver
    returns ``(motion, iterations)`` and drops the regrids."""

    motion: torch.Tensor
    iterations: Tuple[int, ...]
    regrids: Tuple[int, ...]


def make_diffusion_sweeps_sharded(mesh: Mesh, alpha: float, niter: int):
    """``niter`` Horn-Schunck sweeps on the strips, with a 1-row halo
    exchange a sweep. Returns ``(u [2, nx, ny], grad_i [2, nx, ny],
    it [nx, ny]) -> u``; nx must be divisible by the mesh's x size."""
    devices = _strip_devices(mesh)

    def sweeps(u, grad_i, it_img):
        u, grad_i, it_img = (_split(x, devices) for x in (u, grad_i, it_img))
        den = _diffusion_consts_strip(grad_i, it_img, alpha)
        for _ in range(niter):
            u = _diffusion_step_strip(u, grad_i, it_img, den)
        return _gather(u)

    return sweeps


def make_sor_sweeps_sharded(mesh: Mesh, mu: float, lam: float, omega: float, niter: int,
                            reference_stencil: bool = True):
    """``niter`` red-black Navier-Lame SOR sweeps on the strips, with a
    1-row halo exchange a half-sweep. Returns ``(x [2, nx, ny],
    b [2, nx, ny]) -> x``."""
    devices = _strip_devices(mesh)

    def sweeps(x, b):
        x, b = _split(x, devices), _split(b, devices)
        for _ in range(niter):
            x = _sor_sweep_strip(x, b, mu, lam, omega, reference_stencil)
        return _gather(x)

    return sweeps


def make_warp2d_sharded(mesh: Mesh, halo: int):
    """Backward warp on the strips with a ``halo``-bounded displacement
    (max(halo + 1, 8) halo rows exchanged): ``(image [nx, ny],
    u [2, nx, ny]) -> warped [nx, ny]``. A sample whose floor offset lies
    outside ``[-halo, halo]`` gives 0."""
    devices = _strip_devices(mesh)

    def warp(image, u):
        return _gather(_warp_local(_split(image, devices), _split(u, devices), halo))

    return warp


def make_variational_level_sharded(mesh: Mesh, method: str, niter: int, halo: int = 2,
                                   alpha: float = 1.0, tau: float = 1.0, mu: float = 1.0,
                                   lam: float = 0.0, omega: float = 0.66,
                                   convergence_tol: float = 0.001,
                                   reference_stencil: bool = True, grid_shape=None):
    """A diffusion, elastic or curvature level solve on the strips (the
    per-step route): derivatives once, then iterations with halo exchange
    (curvature: the distributed DCT solve, ``tau`` its time step and
    ``alpha`` its weight), the Logger stop and the final composition.
    Returns ``(u [2, nx, ny], iref, imov) -> (u, iterations)``. Curvature
    needs nx and ny divisible by the mesh's x size, checked here when
    ``grid_shape`` is given, else at the call."""
    if method not in ("diffusion", "elastic", "curvature"):
        raise ValueError(method)
    devices = _strip_devices(mesh)
    if method == "curvature" and grid_shape is not None:
        if grid_shape[0] % len(devices) or grid_shape[1] % len(devices):
            raise ValueError("curvature grid dims must divide the mesh x size")
    p = dict(alpha=alpha, tau=tau, mu=mu, lam=lam, omega=omega,
             reference_stencil=reference_stencil)

    def solve(u, iref, imov):
        u, iref, imov = (_split(x, devices) for x in (u, iref, imov))
        u, it, _ = _level_local(method, u, iref, imov, niter, halo, p, convergence_tol)
        return _gather(u), it

    return solve


def _demons_params(sigma_i: float, sigma_x: float, sigma_diffusion: float, sigma_fluid: float,
                   kernelwidth: int) -> dict:
    return dict(sigma_i=sigma_i, sigma_x=sigma_x, sigma_diffusion=sigma_diffusion,
                sigma_fluid=sigma_fluid, kernelwidth=int(kernelwidth))


def make_demons_step_sharded(mesh: Mesh, sigma_i: float, sigma_x: float, sigma_diffusion: float,
                             sigma_fluid: float, kernelwidth: int, halo: int = 2,
                             diffeomorphic: bool = False):
    """One Thirion (composition) or diffeomorphic demons iteration on the
    strips, by the route of ``demons_strip_route``. Returns ``(u [2, nx,
    ny], iref, imov) -> u``; every warp and compose within the displacement
    contract."""
    devices = _strip_devices(mesh)
    p = _demons_params(sigma_i, sigma_x, sigma_diffusion, sigma_fluid, kernelwidth)
    family = "diffeo" if diffeomorphic else "thirions"

    def step(u, iref, imov):
        u, iref, imov = (_split(x, devices) for x in (u, iref, imov))
        return _gather(_demons_stepper(family, iref, imov, p, halo)(u))

    return step


def make_demons_level_sharded(mesh: Mesh, sigma_i: float, sigma_x: float,
                              sigma_diffusion: float, sigma_fluid: float, kernelwidth: int,
                              niter: int, halo: int = 2, diffeomorphic: bool = False,
                              convergence_tol: float = 0.001):
    """A demons level solve on the strips: the level warp, iterations with
    the Logger stop (one host read an iteration, two on the diffeomorphic
    exp map) and the final composition. Returns ``(u [2, nx, ny], iref,
    imov) -> (u, iterations)``."""
    devices = _strip_devices(mesh)
    p = _demons_params(sigma_i, sigma_x, sigma_diffusion, sigma_fluid, kernelwidth)
    family = "diffeo" if diffeomorphic else "thirions"

    def solve(u, iref, imov):
        u, iref, imov = (_split(x, devices) for x in (u, iref, imov))
        u, it, _ = _level_local(family, u, iref, imov, niter, halo, p, convergence_tol)
        return _gather(u), it

    return solve


def make_fluid_level_sharded(mesh: Mesh, mu: float, lam: float, omega: float, niter: int,
                             halo: int = 2, dumax: float = 0.65, timestep_skip: float = 65.0,
                             regrid_threshold: float = 0.5, convergence_tol: float = 0.001,
                             reference_stencil: bool = True):
    """A viscous-fluid level solve on the strips (``_fluid_level_strip``).
    Returns ``(u [2, nx, ny], iref, imov) -> (u, iterations, regrids)``."""
    devices = _strip_devices(mesh)
    p = dict(mu=mu, lam=lam, omega=omega, dumax=dumax, timestep_skip=timestep_skip,
             regrid_threshold=regrid_threshold, reference_stencil=reference_stencil)

    def solve(u, iref, imov):
        u, iref, imov = (_split(x, devices) for x in (u, iref, imov))
        u, it, nregrid = _fluid_level_strip(u, iref, imov, niter, halo, p, convergence_tol)
        return _gather(u), it, nregrid

    return solve


def make_register_sp(mesh: Mesh, family: str, niter, nscales: int = 1, nrefine: int = 1,
                     halo: int = 2, convergence_tol: float = 0.001, **params):
    """A whole multi-resolution registration on the strips, for
    ``family`` in {"diffusion", "curvature", "elastic", "fluid", "thirions",
    "diffeo"}:
    the strip pyramid, the level solves (``_level_local``) and the factor-2
    resampling of the motion between levels, coarse to fine; ``nrefine``
    refinements a level, each a fresh estimate from zero composed into the
    motion.

    ``params`` are the family's: ``alpha`` (diffusion, curvature); ``tau``
    (curvature: every level's ny must divide by the mesh's x size);
    ``mu``, ``lam``,
    ``omega``, ``reference_stencil`` (elastic, fluid); ``dumax``,
    ``timestep_skip``, ``regrid_threshold`` (fluid); ``block_k``: diffusion
    and elastic run ``block_k`` iterations a kernel pass when it is > 1;
    ``sigma_i``, ``sigma_x``, ``sigma_diffusion``, ``sigma_fluid``,
    ``kernelwidth`` (thirions, diffeo: Thirion always composes).
    Needs nx divisible by ``2^nscales`` times the mesh's x size and ny by
    ``2^nscales``, and every warp within the displacement contract
    ``|floor offset| <= halo``. Returns ``(iref, imov) -> SPResult``."""
    _check_family(family)
    devices = _strip_devices(mesh)
    niter = tuple(int(v) for v in niter)
    nrefine = int(nrefine)
    if len(niter) < nscales + 1:
        raise ValueError(f"niter needs {nscales + 1} entries, got {len(niter)}")

    def solve(iref, imov) -> SPResult:
        iref, imov = torch.as_tensor(iref), torch.as_tensor(imov)
        nx, ny = iref.shape
        f = 2 ** nscales
        if nx % (f * len(devices)) or ny % f:
            raise ValueError(f"grid {(nx, ny)} must be divisible by 2^nscales * x = "
                             f"{f * len(devices)} along x and 2^nscales = {f} along y")
        irefs, imovs = [_split(iref, devices)], [_split(imov, devices)]
        for _ in range(nscales):
            irefs.append(_downsample2_local(irefs[-1]))
            imovs.append(_downsample2_local(imovs[-1]))
        iters, regrids = [], []
        u_full = [torch.zeros((2,) + x.shape, dtype=x.dtype, device=x.device)
                  for x in irefs[0]]
        for sc in range(nscales, -1, -1):
            if sc == nscales and sc > 0:
                # The coarsest level starts from zero (the reference skips
                # the motion downsample at s == nscales).
                u = [torch.zeros((2,) + x.shape, dtype=x.dtype, device=x.device)
                     for x in irefs[sc]]
            else:
                # Intermediate levels re-derive their motion from the
                # running full-resolution field (ImageRegistration.cpp:
                # 137-151).
                u = u_full
                for _ in range(sc):
                    u = [x * 0.5 for x in _downsample2_local(u)]
            for _refine in range(nrefine):
                u, it, rg = _level_local(family, u, irefs[sc], imovs[sc], niter[sc], halo,
                                         params, convergence_tol)
                iters.append(it)
                regrids.append(rg)
            for _ in range(sc):
                u = [x * 2.0 for x in _upsample2_local(u)]
            u_full = u
        return SPResult(_gather(u_full), tuple(iters), tuple(regrids))

    return solve


def make_register_demons_sp(mesh: Mesh, sigma_i: float, sigma_x: float, sigma_diffusion: float,
                            sigma_fluid: float, kernelwidth: int, niter, nscales: int = 1,
                            halo: int = 2, convergence_tol: float = 0.001):
    """The Thirion registration on the strips: ``make_register_sp`` for
    ``"thirions"``."""
    return make_register_sp(mesh, "thirions", niter, nscales=nscales, halo=halo,
                            convergence_tol=convergence_tol,
                            **_demons_params(sigma_i, sigma_x, sigma_diffusion, sigma_fluid,
                                             kernelwidth))
