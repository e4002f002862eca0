"""Build the port's CUDA kernels and drive its main paths once on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

0. Card check: fail without CUDA; print the card's name and power limit.
1. Build every kernel from ``opticalflow2d_tpu_torch/csrc`` for sm_90a
   (one ``nvcc`` per source, all started together).
2. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and a ragged one (fields <= 1e-6 max-abs, Logger sums
   <= 1e-5 relative, max |R|^2 and the minimum Jacobian determinant
   <= 1e-6 relative): the diffusion kernels, warp and compose with
   displacements up to +-40 px, the Logger norms, the three demons kernels
   at kernelwidth 5 and 11 (the one-pass kernel by composition and by
   addition) with small displacements and with ones that send samples out
   of bounds, the elastic block at k = 1, 2, 4 with either stencil, the
   fluid iteration with either stencil and either maxabs with a nonzero
   velocity, and the fluid metrics on a field of up to 3 px whose
   Jacobian determinant falls below 0.5. The two-pass fluid kernels with
   either stencil and either maxabs: the sweep-and-max pass, whose vel'
   and max |R|^2 must also equal the fluid iteration's bit for bit, and
   the Euler pass at a gate > 0 and a gate of 0. Then the fluid_16k
   path's kernels at its own shapes past 4096, on its tiled pair, with the
   same fields and checks: warp, compose, the fluid metrics and the three
   fluid kernels at 16384^2 and 8192^2. Then the strip kernels K1-K4 of the
   strip-parallel driver on 4 strips of 4096^2 and of 1000x777 (nxl 250),
   each strip padded by the strip driver's halo exchange, against their plain
   versions and, concatenated, against the dense kernel's rows: the
   diffusion strip at k = 8 and at a rerun of 3 on the k = 8 pad, the
   elastic strip at k = 1, 2, 4 with either stencil, the fluid strip with
   either stencil and either maxabs, warp and compose inside the
   displacement contract and (plain version only) far outside it.
3. The main paths through the session API at 4096^2, each with the launch
   counts set to 0 just before it and read just after:
   a. diffusion on a pair of three blobs, 5 levels (SSD reduction >= 0.9,
      finite motion). Five levels put the coarsest at 256^2, where the
      24 px shift is 1.5 px; with three levels every level stops at the
      400-iteration cap and the SSD reduction stays near 0.87;
   b. Thirion demons with the default parameters (the one-pass kernel);
   c. diffeomorphic demons with sigma_i = 0.25, sigma_x = 1.0, where the
      exp map is not the identity (correspondence kernel, squarings on the
      compose kernel, compose+smooth kernel, Logger norms);
   d. elastic [0.5, 0] on the tiled pair, 3 levels (the elastic block);
   e. fluid [0.25, 0] on the tiled pair, 3 levels (the fluid iteration,
      the fluid metrics, compose and warp for the regrids). It must
      regrid at least once; if it does not, a second run at regrid
      threshold 0.95 drives the regrid branch.
   f. fluid_16k: fluid [0.25, 0] on the tiled pair at 16384^2, 3 levels,
      through the session's route past 8192 (register_phased): the 16384^2
      level runs the two-pass iteration (sweep and max, then the Euler
      pass), the coarser ones the fluid iteration. Its B8 and B9 launches
      must equal the 16384^2 level's iterations, B7's the coarser levels';
      it prints the peak device memory. The pair is built on the card.
   g. sp_diffusion (alpha 0.1, block_k 8), sp_elastic ([0.5, 0],
      block_k 4) and sp_fluid ([0.25, 0]): make_register_sp on
      make_mesh(x=4) over one card, 4096^2 in 4 strips of 1024 rows, on
      the tiled pair, nscales 2, nrefine 2, halo 5 (fluid: 32, see
      SP_FLUID_HALO): the strip kernels K1, K2, K3 and K4. Each must stay
      inside its contract (the final motion's in-bounds floor offsets
      within the halo) and launch its strip
      kernels; beside each, its difference and counts against the dense
      run of the family on the same pair (3d, 3e, and a dense diffusion
      run on the tiled pair), reported, not gated.
   Every path needs SSD reduction >= 0.9 and a finite motion; the phase
   prints iterations, regrids, wall time, host reads per level and
   launches. The tiled pair keeps its sigma = 6 px blobs at every size;
   the three-blob pair's widths scale with n, which leaves fluid's
   increment so small at 512^2 and above that every step is skipped.
   Three levels put the coarsest at 1024^2, where the blobs are 1.5 px.
4. Profiles of runs 3c, 3e and the three 3g runs, and of the dense
   elastic and tiled diffusion runs: the device's busy share and the host
   syncs.
5. Slice parity at 512^2 for each path: the CPU (plain versions) against
   the GPU (kernels), motion <= 1e-5 px and equal iteration and regrid
   counts at every level; and the fluid run again with every level on the
   two-pass route (its extent lowered to 0), equal to the default GPU run
   bit for bit, with equal counts; and the three sp_* paths at 512^2 in 4
   strips, CPU against GPU, with the same gates.
6. Times at 4096^2: median of 20 CUDA-event-timed runs of 10 calls each,
   of each kernel and of its plain version, and its bound; and of one
   fluid iteration by each route (B7 and the plain Euler tail; B8, the
   gate and B9); and of each strip kernel on one 1024x4096 strip of the
   4096^2 grid, its bound counting the halo rows it reads.

The line before the last two is the ``{"kernels": [...]}`` summary; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from opticalflow2d_tpu_torch import Method, OpticalFlow2d, RegConfig, register
from opticalflow2d_tpu_torch import kernels
from opticalflow2d_tpu_torch.engine import registration
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.kernels.demons_fused import (
    compose_smooth, compose_smooth_ref, demons_correspondence, demons_correspondence_ref)
from opticalflow2d_tpu_torch.kernels.demons_onepass import (
    thirion_onepass, thirion_onepass_ref)
from opticalflow2d_tpu_torch.kernels.diffusion_block import (
    diffusion_block, diffusion_block_ref, stack_derivs)
from opticalflow2d_tpu_torch.kernels.diffusion_fused import (
    diffusion_step_fused, diffusion_step_ref)
from opticalflow2d_tpu_torch.kernels.elastic_block import elastic_block, elastic_block_ref
from opticalflow2d_tpu_torch.kernels.fluid_fused import (
    fluid_euler, fluid_euler_ref, fluid_iter, fluid_iter_ref, fluid_sweep_max,
    fluid_sweep_max_ref)
from opticalflow2d_tpu_torch.kernels.logger_norms import (
    fluid_metrics, fluid_metrics_ref, logger_norms, logger_norms_ref)
from opticalflow2d_tpu_torch.kernels.warp_fused import (
    compose, compose_ref, warp2d, warp2d_ref)
from opticalflow2d_tpu_torch.kernels import diffusion_block as k_diff
from opticalflow2d_tpu_torch.kernels import elastic_block as k_el
from opticalflow2d_tpu_torch.kernels import fluid_fused as k_fl
from opticalflow2d_tpu_torch.kernels import warp_fused as k_wf
from opticalflow2d_tpu_torch.metrics import ssd_reduction
from opticalflow2d_tpu_torch.parallel import make_mesh, make_register_sp, spatial
from opticalflow2d_tpu_torch.solvers.base import derivatives
from opticalflow2d_tpu_torch.solvers.demons import demons_route
from opticalflow2d_tpu_torch.solvers.fluid import make_fluid_step, make_fluid_two_pass_step

FIELD_TOL = 1e-6      # kernel vs plain version, max-abs
SUMS_RTOL = 1e-5      # Logger sums, relative
SCALAR_RTOL = 1e-6    # max |R|^2 and the minimum Jacobian determinant, relative
PARITY_TOL = 1e-5     # GPU vs CPU motion, px
SSD_BAR = 0.9
N_MAIN = 4096
N_HUGE = 16384  # the fluid_16k path: past 8192, the two-pass fluid route
N_PARITY = 512
ALPHA = 0.1
NREFINE = 2
MAIN_NSCALES = 4
TILED_NSCALES = 2  # the elastic and fluid paths: coarsest level 1024^2
PARITY_NSCALES = 2
NITER = 400  # at every level
DEMONS_PARITY_NITER = 200  # at every level of the CPU-timed demons parity runs
SP_PARITY_NITER = 200  # and of the strip paths' parity runs
SEED = 0
KERNEL_SHAPES = ((4096, 4096), (2048, 2048), (1000, 777))
# The fluid_16k path's levels past 4096: 16384^2 runs B3, B5, B8 and B9,
# 8192^2 B3, B5 and B7. At 16384^2 g's third plane starts 2^31 bytes in.
HUGE_KERNEL_SHAPES = (N_HUGE, N_HUGE // 2)

# The strip kernels' checks: 4 strips of these shapes (nxl 1024 and a ragged 250).
STRIP_SHAPES = ((4096, 4096), (1000, 777))
SP_STRIPS = 4
SP_HALO = 5
# The fluid run on the tiled pair folds at its coarse level (400 iterations
# and 200 regrids there in the dense driver too) and leaves displacements
# of about 10 px, past a halo of 5 (on an H100, PERF.md); sp_fluid takes a
# halo that holds them.
SP_FLUID_HALO = 32

ELASTIC = (0.5, 0.0, 0.66)  # mu, lambda, omega of the elastic path and the kernel checks
FLUID = (0.25, 0.0, 0.66)
REGRID_FALLBACK = 0.95  # regrid threshold of the second fluid run, if the first has none

# The main paths: (name, method, regparams, pair, nscales). DIFFUSION_TILED
# is the dense diffusion run beside sp_diffusion, on its pair.
PATHS = (
    ("diffusion", Method.DIFFUSION, [ALPHA], "blob", MAIN_NSCALES),
    ("thirion", Method.THIRIONS_DEMONS, [1.0, 0.25, 2.0, 2.0, 5, 0], "blob", MAIN_NSCALES),
    ("diffeomorphic", Method.DIFFEOMORPHIC_DEMONS, [0.25, 1.0, 2.0, 2.0, 5], "blob",
     MAIN_NSCALES),
    ("elastic", Method.ELASTIC, [0.5, 0.0], "tiled", TILED_NSCALES),
    ("fluid", Method.FLUID, [0.25, 0.0], "tiled", TILED_NSCALES),
)

DIFFUSION_TILED = ("diffusion_tiled", Method.DIFFUSION, [ALPHA], "tiled", TILED_NSCALES)

# The strip-parallel paths: (name, family, make_register_sp parameters, the
# method and regparams of the dense run of the family on the same pair).
SP_PATHS = (
    ("sp_diffusion", "diffusion", dict(alpha=ALPHA, block_k=8, halo=SP_HALO), Method.DIFFUSION,
     [ALPHA]),
    ("sp_elastic", "elastic", dict(mu=0.5, lam=0.0, block_k=4, halo=SP_HALO), Method.ELASTIC,
     [0.5, 0.0]),
    ("sp_fluid", "fluid", dict(mu=0.25, lam=0.0, halo=SP_FLUID_HALO), Method.FLUID,
     [0.25, 0.0]),
)
# The strip kernel each strip path must launch, beside warp and compose.
SP_KERNEL = {"diffusion": "diffusion_block_strip", "elastic": "elastic_block_strip",
             "fluid": "fluid_iter_strip"}

KERNELS = {
    "diffusion_block": ("cuda", "opticalflow2d_tpu_torch/csrc/diffusion_block.cu",
                        "opticalflow2d_tpu/pallas_kernels/diffusion_block.py:223"),
    "diffusion_step": ("cuda", "opticalflow2d_tpu_torch/csrc/diffusion_step.cu",
                       "opticalflow2d_tpu/pallas_kernels/diffusion_fused.py:106"),
    "warp2d": ("cuda", "opticalflow2d_tpu_torch/csrc/warp_gather.cu",
               "opticalflow2d_tpu/pallas_kernels/warp_fused.py:173"),
    "compose": ("cuda", "opticalflow2d_tpu_torch/csrc/warp_gather.cu",
                "opticalflow2d_tpu/pallas_kernels/warp_fused.py:173"),
    "logger_norms": ("cuda", "opticalflow2d_tpu_torch/csrc/logger_norms.cu",
                     "opticalflow2d_tpu/pallas_kernels/logger_norms.py:178"),
    "demons_onepass": ("cuda", "opticalflow2d_tpu_torch/csrc/demons_onepass.cu",
                       "opticalflow2d_tpu/pallas_kernels/demons_onepass.py:310"),
    "demons_correspondence": ("cuda", "opticalflow2d_tpu_torch/csrc/demons_fused.cu",
                              "opticalflow2d_tpu/pallas_kernels/demons_fused.py:401"),
    "compose_smooth": ("cuda", "opticalflow2d_tpu_torch/csrc/demons_fused.cu",
                       "opticalflow2d_tpu/pallas_kernels/demons_fused.py:481"),
    "elastic_block": ("cuda", "opticalflow2d_tpu_torch/csrc/elastic_block.cu",
                      "opticalflow2d_tpu/pallas_kernels/elastic_block.py:206"),
    "fluid_iter": ("cuda", "opticalflow2d_tpu_torch/csrc/fluid_iter.cu",
                   "opticalflow2d_tpu/pallas_kernels/fluid_fused.py:188"),
    "fluid_metrics": ("cuda", "opticalflow2d_tpu_torch/csrc/logger_norms.cu",
                      "opticalflow2d_tpu/pallas_kernels/logger_norms.py:129"),
    "fluid_sweep_max": ("cuda", "opticalflow2d_tpu_torch/csrc/fluid_iter.cu",
                        "opticalflow2d_tpu/pallas_kernels/fluid_fused.py:345"),
    "fluid_euler": ("cuda", "opticalflow2d_tpu_torch/csrc/fluid_euler.cu",
                    "opticalflow2d_tpu/pallas_kernels/fluid_fused.py:428"),
    "diffusion_block_strip": ("cuda", "opticalflow2d_tpu_torch/csrc/diffusion_block.cu",
                              "opticalflow2d_tpu/pallas_kernels/diffusion_block.py:318"),
    "elastic_block_strip": ("cuda", "opticalflow2d_tpu_torch/csrc/elastic_block.cu",
                            "opticalflow2d_tpu/pallas_kernels/elastic_block.py:281"),
    "fluid_iter_strip": ("cuda", "opticalflow2d_tpu_torch/csrc/fluid_iter.cu",
                         "opticalflow2d_tpu/pallas_kernels/fluid_fused.py:250"),
    "warp2d_strip": ("cuda", "opticalflow2d_tpu_torch/csrc/warp_gather.cu",
                     "opticalflow2d_tpu/pallas_kernels/warp_fused.py:263"),
    "compose_strip": ("cuda", "opticalflow2d_tpu_torch/csrc/warp_gather.cu",
                      "opticalflow2d_tpu/pallas_kernels/warp_fused.py:278"),
}

# H100 SXM peaks (NVIDIA's data sheet): device memory and float32 outside
# the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
KW = 5  # the demons kernelwidth of the main paths
# Per output pixel at the main paths' settings: float32 planes each kernel
# must read and write once, and the float operations it does on them
# (interior counts, halo recomputation not included). B1 runs k = 8 steps
# of 33 operations; a k-tap separable Gaussian of two channels is 8k. An
# elastic iteration is the force (6), two SOR candidates (32) and the
# Logger sums (12); B6 runs k = 4 of them. The fluid iteration adds the
# material derivative and max |R|^2 (20) to the force and candidates, as
# does the sweep-and-max pass, which writes no R; the Euler pass is the
# material derivative and the gated update (20); the fluid metrics are the
# Logger sums and the determinant with its minimum.
ELASTIC_K = 4
# A strip kernel does its dense kernel's work on the strip's pixels and
# also reads the halo rows of its padded inputs (STRIP_PADDED planes, 8 rows
# a side at the timed settings).
STRIP_OF = {"diffusion_block_strip": "diffusion_block", "elastic_block_strip": "elastic_block",
            "fluid_iter_strip": "fluid_iter", "warp2d_strip": "warp2d",
            "compose_strip": "compose"}
STRIP_PADDED = {"diffusion_block_strip": 5, "elastic_block_strip": 5, "fluid_iter_strip": 7,
                "warp2d_strip": 1, "compose_strip": 2}
PLANES = {"diffusion_block": 7, "diffusion_step": 7, "warp2d": 4, "compose": 6,
          "logger_norms": 4, "demons_onepass": 6, "demons_correspondence": 6,
          "compose_smooth": 6, "elastic_block": 7, "fluid_iter": 11, "fluid_metrics": 4,
          "fluid_sweep_max": 9, "fluid_euler": 6}
OPS = {"diffusion_block": 8 * 33, "diffusion_step": 21, "warp2d": 25, "compose": 36,
       "logger_norms": 12, "demons_onepass": 93 + 16 * KW,
       "demons_correspondence": 45 + 8 * KW, "compose_smooth": 36 + 8 * KW,
       "elastic_block": ELASTIC_K * 50, "fluid_iter": 58, "fluid_metrics": 26,
       "fluid_sweep_max": 58, "fluid_euler": 20}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def blob_pair(n: int):
    """Three Gaussian blobs scaled to an n x n image; the moving image is
    shifted by (1.5, -0.8) * n / 256 px."""
    xs = np.arange(n, dtype=np.float64)[:, None]
    ys = np.arange(n, dtype=np.float64)[None, :]
    blobs = [((.4, .5), .125, 1.0), ((.65, .3), .083, .7), ((.3, .75), .104, .5)]

    def img(ox, oy):
        g = np.zeros((n, n))
        for (cx, cy), s, a in blobs:
            g += a * np.exp(-((xs - ox - cx * n) ** 2 + (ys - oy - cy * n) ** 2)
                            / (2 * (s * n) ** 2))
        return g.astype(np.float32)

    return img(0.0, 0.0), img(1.5 * n / 256, -0.8 * n / 256)


def tiled_pair(n: int, dev=torch.device("cpu")):
    """Gaussian blobs of sigma = 6 px on a 32 px grid, amplitudes 0.3-1.0
    from the seed; the moving image is shifted by (1.5, -0.8) px. Unlike
    ``blob_pair``, the features keep their size at every n, so the image
    gradients, the force and the fluid increment do too. The sum of the
    blobs is separable per blob: ``Gx^T A Gy``, computed in float64 on
    ``dev`` (275 GFLOP an image at 16384^2, so the card builds that one)."""
    sigma, step = 6.0, 32
    kw = dict(dtype=torch.float64, device=dev)
    centers = torch.arange(step // 2, n, step, **kw)
    amp = torch.from_numpy(
        np.random.default_rng(SEED).uniform(0.3, 1.0, (len(centers), len(centers)))).to(dev)
    coords = torch.arange(n, **kw)

    def img(ox, oy):
        gx = torch.exp(-((coords[None, :] - ox - centers[:, None]) ** 2) / (2 * sigma ** 2))
        gy = torch.exp(-((coords[None, :] - oy - centers[:, None]) ** 2) / (2 * sigma ** 2))
        return (gx.T @ amp @ gy).float()

    return img(0.0, 0.0), img(1.5, -0.8)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a - b).abs() / b.abs()).max())


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "card", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    seconds = time.perf_counter() - t0
    report = [line.strip() for line in path.with_suffix(".log").read_text().splitlines()
              if "Used" in line or "spill" in line or line.startswith("==")]
    emit({"phase": "build", "seconds": seconds, "library": path.name, "ptxas": report})


def check(err: dict, name: str, got, want, shape, **info) -> None:
    """Hold a kernel's field (and Logger sums, for a pair) against its
    plain version's."""
    sums_rel = None
    if isinstance(got, tuple):
        (got, sums), (want, sums_ref) = got, want
        sums_rel = rel_err(sums, sums_ref)
    torch.cuda.synchronize()
    e = max_abs(got, want)
    emit({"phase": "kernels", "kernel": name, "shape": list(shape), **info,
          "max_abs_err": e, **({} if sums_rel is None else {"sums_rel_err": sums_rel})})
    require(e <= FIELD_TOL and (sums_rel is None or sums_rel <= SUMS_RTOL),
            f"{name} {shape} {info}: err {e}, sums {sums_rel}")
    err[name] = max(err[name], e)


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version on the same CUDA inputs: every
    kernel at KERNEL_SHAPES on the blob pair, and the kernels of the
    fluid_16k path at its own shapes past 4096 on its tiled pair."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = {name: 0.0 for name in KERNELS}
    for nx, ny in KERNEL_SHAPES:
        iref, imov = (x[:nx, :ny].contiguous() for x in pair_on(dev, "blob", max(nx, ny)))
        check_shape(err, dev, gen, iref, imov, every=True)
    for n in HUGE_KERNEL_SHAPES:
        check_shape(err, dev, gen, *tiled_pair(n, dev), every=False)
        torch.cuda.empty_cache()
    for nx, ny in STRIP_SHAPES:
        iref, imov = (x[:nx, :ny].contiguous() for x in pair_on(dev, "blob", max(nx, ny)))
        check_strips(err, dev, gen, iref, imov)
    return err


def strip_inputs(dev, pad: int, *fields):
    """Each field cut into SP_STRIPS strips, each padded with ``pad`` halo
    rows a side by the strip driver's exchange."""
    return [spatial._halo_pad(spatial._split(f, [dev] * SP_STRIPS), pad) for f in fields]


def check_rows(name: str, strips, dense: torch.Tensor, shape, **info) -> None:
    """The strips' outputs, concatenated, against the dense kernel's."""
    got = torch.cat(list(strips), dim=-2)
    torch.cuda.synchronize()
    e = max_abs(got, dense)
    emit({"phase": "kernels", "kernel": name, "shape": list(shape), "against": "dense rows",
          **info, "max_abs_err": e, "bit_equal": bool(torch.equal(got, dense))})
    require(e <= FIELD_TOL, f"{name} {shape} {info}: strips differ from the dense kernel by {e}")


def check_strips(err: dict, dev, gen: torch.Generator, iref, imov) -> None:
    """K1-K4 on SP_STRIPS strips of the pair's shape, each strip against its
    plain version, the strips together against the dense kernel."""
    nx, ny = shape = tuple(iref.shape)
    nxl = nx // SP_STRIPS
    d = derivatives(iref, imov)
    g = stack_derivs(d.grad_i, d.it)
    del d
    u = torch.randn((2, nx, ny), generator=gen, device=dev) * 2
    small = (torch.tanh(u) * 0.5).contiguous()
    strips = range(SP_STRIPS)

    pad = k_diff.required_pad(8)
    up, gp = strip_inputs(dev, pad, u, g)
    for k in (8, 3):  # 3: the rerun of a stop inside a block, on the k = 8 pad
        outs = []
        for s in strips:
            args = (up[s], gp[s], s * nxl, nx, ALPHA, k, pad)
            outs.append(k_diff.diffusion_block_strip(*args))
            check(err, "diffusion_block_strip", outs[-1], k_diff.diffusion_block_strip_ref(*args),
                  shape, k=k, row0=s * nxl)
        dense, dense_sums = diffusion_block(u, g, ALPHA, k)
        check_rows("diffusion_block_strip", (o[0] for o in outs), dense, shape, k=k)
        e = rel_err(sum(o[1] for o in outs), dense_sums)
        require(e <= SUMS_RTOL, f"diffusion_block_strip {shape}: strips' sums {e}")
    del up, outs, dense

    for k in (1, 2, ELASTIC_K):
        sp, gp = strip_inputs(dev, k_el.required_pad(k), small, g)
        for ref_stencil in (True, False):
            outs = []
            for s in strips:
                args = (sp[s], gp[s], s * nxl, nx, *ELASTIC, ref_stencil, k)
                outs.append(k_el.elastic_block_strip(*args))
                check(err, "elastic_block_strip", outs[-1], k_el.elastic_block_strip_ref(*args),
                      shape, k=k, reference_stencil=ref_stencil, row0=s * nxl)
            dense, _ = elastic_block(small, g, *ELASTIC, ref_stencil, k)
            check_rows("elastic_block_strip", (o[0] for o in outs), dense, shape, k=k,
                       reference_stencil=ref_stencil)
    del outs, dense

    vel = (torch.tanh(u.flip(1)) * 0.3).contiguous()
    sp, vp, gp = strip_inputs(dev, k_fl.FLUID_PAD, small, vel, g)
    for ref_stencil in (True, False):
        for bug in (False, True):
            outs = []
            for s in strips:
                args = (sp[s], vp[s], gp[s], s * nxl, nx, *FLUID, ref_stencil, bug)
                outs.append(k_fl.fluid_iter_strip(*args))
                want = k_fl.fluid_iter_strip_ref(*args)
                info = dict(reference_stencil=ref_stencil, maxabs_bug=bug, row0=s * nxl)
                check(err, "fluid_iter_strip", outs[-1][0], want[0], shape, out="vel", **info)
                check(err, "fluid_iter_strip", outs[-1][1], want[1], shape, out="R", **info)
                check_scalar("fluid_iter_strip", outs[-1][2], want[2], shape, out="max|R|^2",
                             **info)
            dense = fluid_iter(small, vel, g, *FLUID, ref_stencil, bug)
            info = dict(reference_stencil=ref_stencil, maxabs_bug=bug)
            check_rows("fluid_iter_strip", (o[0] for o in outs), dense[0], shape, out="vel",
                       **info)
            check_rows("fluid_iter_strip", (o[1] for o in outs), dense[1], shape, out="R", **info)
            m = torch.stack([o[2] for o in outs]).max()
            require(torch.equal(m, dense[2]),
                    f"fluid_iter_strip {shape} {info}: the strips' max|R|^2 differs from B7's")
    del sp, vp, gp, outs, dense, g, vel

    # Warp and compose at the strip paths' halos: increments of up to 2.4
    # px, inside the contract (also against B3's rows), and of up to +-40
    # px, partly outside it, where a sample takes no taps (plain version
    # only).
    i = torch.arange(nx, device=dev, dtype=torch.float32)[:, None] / nx
    j = torch.arange(ny, device=dev, dtype=torch.float32)[None, :] / ny
    far = torch.stack([30 * torch.sin(6 * j + 1) * torch.cos(4 * i),
                       30 * torch.cos(5 * i + 2) * torch.sin(3 * j)])
    far += torch.rand((2, nx, ny), generator=gen, device=dev) * 20 - 10
    total = (u * 2.5).contiguous()
    for halo in (SP_HALO, SP_FLUID_HALO):
        ip, tp = strip_inputs(dev, spatial._gather_pad(halo), imov, total)
        for contract, inc in (("inside", (torch.tanh(u) * 2.4).contiguous()), ("outside", far)):
            inc_s = spatial._split(inc, [dev] * SP_STRIPS)
            for name, fn, ref, data, dense_fn, dense_data in (
                    ("warp2d_strip", k_wf.warp2d_strip, k_wf.warp2d_strip_ref, ip, warp2d, imov),
                    ("compose_strip", k_wf.compose_strip, k_wf.compose_strip_ref, tp, compose,
                     total)):
                outs = []
                for s in strips:
                    args = (data[s], inc_s[s], s * nxl, nx, halo)
                    outs.append(fn(*args))
                    check(err, name, outs[-1], ref(*args), shape, halo=halo, contract=contract,
                          row0=s * nxl)
                if contract == "inside":
                    check_rows(name, outs, dense_fn(dense_data, inc), shape, halo=halo)


def check_shape(err: dict, dev, gen: torch.Generator, iref, imov, every: bool) -> None:
    """The kernels at the pair's shape: all of them if ``every``, else the
    fluid path's (B3, B5, B7-B9). Fields from ``gen``; each plain version's
    result is dropped after its check, so that 16384^2 fits."""
    nx, ny = shape = tuple(iref.shape)
    d = derivatives(iref, imov)
    g = stack_derivs(d.grad_i, d.it)
    del d
    u = torch.randn((2, nx, ny), generator=gen, device=dev) * 2
    if every:
        for k in (1, 5, 8):
            check(err, "diffusion_block", diffusion_block(u, g, ALPHA, k),
                  diffusion_block_ref(u, g, ALPHA, k), shape, k=k)
        check(err, "diffusion_step", diffusion_step_fused(u, g[:2], g[2], ALPHA),
              diffusion_step_ref(u, g[:2], g[2], ALPHA), shape)

    # Displacements up to +-40 px: a smooth field plus noise, so that
    # samples fall inside, on the edges and outside the grid.
    i = torch.arange(nx, device=dev, dtype=torch.float32)[:, None] / nx
    j = torch.arange(ny, device=dev, dtype=torch.float32)[None, :] / ny
    disp = torch.stack([30 * torch.sin(6 * j + 1) * torch.cos(4 * i),
                        30 * torch.cos(5 * i + 2) * torch.sin(3 * j)])
    disp += torch.rand((2, nx, ny), generator=gen, device=dev) * 20 - 10
    u_total = torch.randn((2, nx, ny), generator=gen, device=dev) * 5
    oob = float((((i * nx + disp[0]) < 0) | ((i * nx + disp[0]) >= nx)).float().mean())
    info = {"max_disp": float(disp.abs().max()), "oob_share_x": oob}
    check(err, "warp2d", warp2d(imov, disp), warp2d_ref(imov, disp), shape, **info)
    check(err, "compose", compose(u_total, disp), compose_ref(u_total, disp), shape, **info)
    small = (torch.tanh(u) * 1.5).contiguous()
    if every:
        sums = logger_norms(u_total, disp)
        sums_ref = logger_norms_ref(u_total, disp)
        torch.cuda.synchronize()
        e = rel_err(sums, sums_ref)
        emit({"phase": "kernels", "kernel": "logger_norms", "shape": list(shape),
              "sums": sums.tolist(), "max_abs_err": max_abs(sums, sums_ref),
              "sums_rel_err": e})
        require(e <= SUMS_RTOL, f"logger_norms {shape}: sums {e}")
        err["logger_norms"] = max(err["logger_norms"], max_abs(sums, sums_ref))

        # Demons: a small field (the main path's increments) and the
        # +-40 px one.
        for kw in (KW, 11):
            for name, field in (("small", small), ("oob", disp)):
                for addition in (False, True):
                    args = (imov, iref, field, 1.0, 0.25, 2.0, 1.5, kw, addition, True)
                    check(err, "demons_onepass", thirion_onepass(*args),
                          thirion_onepass_ref(*args), shape, kw=kw, u=name,
                          addition=addition)
                args = (imov, iref, field, 0.25, 1.0, 2.0, kw)
                check(err, "demons_correspondence", demons_correspondence(*args),
                      demons_correspondence_ref(*args), shape, kw=kw, u=name)
                check(err, "compose_smooth", compose_smooth(u_total, field, 2.0, kw),
                      compose_smooth_ref(u_total, field, 2.0, kw), shape, kw=kw, c=name)

        # Elastic and fluid: a field of up to 1 px (and, for fluid, a
        # nonzero velocity).
        for k in (1, 2, ELASTIC_K):
            for ref_stencil in (True, False):
                args = (small, g, *ELASTIC, ref_stencil, k)
                check(err, "elastic_block", elastic_block(*args), elastic_block_ref(*args),
                      shape, k=k, reference_stencil=ref_stencil)
    del disp, u_total
    vel = (torch.tanh(u.flip(1)) * 0.3).contiguous()
    for ref_stencil in (True, False):
        for bug in (False, True):
            args = (small, vel, g, *FLUID, ref_stencil, bug)
            v, r, m = fluid_iter(*args)
            v_ref, r_ref, m_ref = fluid_iter_ref(*args)
            check(err, "fluid_iter", v, v_ref, shape, out="vel", reference_stencil=ref_stencil,
                  maxabs_bug=bug)
            check(err, "fluid_iter", r, r_ref, shape, out="R", reference_stencil=ref_stencil,
                  maxabs_bug=bug)
            check_scalar("fluid_iter", m, m_ref, shape, out="max|R|^2",
                         reference_stencil=ref_stencil, maxabs_bug=bug)
            del r, v_ref, r_ref
            v8, m8 = fluid_sweep_max(*args)
            v8_ref, m8_ref = fluid_sweep_max_ref(*args)
            check(err, "fluid_sweep_max", v8, v8_ref, shape, out="vel",
                  reference_stencil=ref_stencil, maxabs_bug=bug)
            check_scalar("fluid_sweep_max", m8, m8_ref, shape, out="max|R|^2",
                         reference_stencil=ref_stencil, maxabs_bug=bug)
            require(torch.equal(v8, v) and torch.equal(m8, m),
                    f"fluid_sweep_max {shape}: vel' or max|R|^2 differs from fluid_iter's")
            del v, v8, v8_ref
    del g
    for gate in (0.37, 0.0):
        gate_t = torch.tensor(gate, device=dev)
        check(err, "fluid_euler", fluid_euler(small, vel, gate_t),
              fluid_euler_ref(small, vel, gate_t), shape, gate=gate)
    del vel
    # Up to 3 px of noise: the Jacobian determinant goes below 0.5.
    wide = (torch.tanh(u) * 3.0).contiguous()
    prev = (small * 0.8).contiguous()
    del u
    for name, field in (("small", small), ("wide", wide)):
        got, want = fluid_metrics(field, prev), fluid_metrics_ref(field, prev)
        torch.cuda.synchronize()
        e = rel_err(got[:2], want[:2])
        emit({"phase": "kernels", "kernel": "fluid_metrics", "shape": list(shape), "u": name,
              "sums_rel_err": e})
        require(e <= SUMS_RTOL, f"fluid_metrics {shape} {name}: sums {e}")
        check_scalar("fluid_metrics", got[2], want[2], shape, out="jac_min", u=name)
        err["fluid_metrics"] = max(err["fluid_metrics"], max_abs(got, want))
    require(float(want[2]) < 0.5, f"fluid_metrics {shape}: jac_min {float(want[2])} >= 0.5")


def check_scalar(name: str, got: torch.Tensor, want: torch.Tensor, shape, **info) -> None:
    """Hold a kernel's scalar (max |R|^2, the minimum Jacobian determinant)
    against its plain version's, relatively."""
    e = rel_err(got.reshape(1), want.reshape(1))
    emit({"phase": "kernels", "kernel": name, "shape": list(shape), **info,
          "value": float(got), "rel_err": e})
    require(e <= SCALAR_RTOL, f"{name} {shape} {info}: relative error {e}")


def host_reads(method: Method, regparams, iterations: int) -> int:
    """Device-to-host reads a (level, refinement) of a path makes: the
    blocked drivers read the Logger sums once a block (8 diffusion or 4
    elastic iterations); demons once an iteration, twice on the two-kernel
    route (the exp map's maxabs); fluid once an iteration (the Logger sums
    and the minimum Jacobian determinant together)."""
    if method == Method.DIFFUSION:
        return -(-iterations // 8)
    if method == Method.ELASTIC:
        return -(-iterations // ELASTIC_K)
    if method == Method.FLUID:
        return iterations
    route = demons_route(regparams[0], regparams[1], int(regparams[4]),
                         method == Method.DIFFEOMORPHIC_DEMONS)
    return iterations * (2 if route == "two_kernel" else 1)


def pair_on(dev, pair: str, n: int):
    if pair == "tiled":
        return tiled_pair(n, dev)
    return tuple(torch.from_numpy(x).to(dev) for x in blob_pair(n))


def run_main(dev, method: Method, regparams, nscales: int, iref, imov, **overrides):
    n = iref.shape[0]
    sess = OpticalFlow2d((n, n), niter=[NITER] * (nscales + 1),
                         nscales=nscales, regularisation=method, regparams=regparams,
                         nrefine=NREFINE, device=dev, **overrides)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sess.register(iref, imov)
    motion = sess.get_motion()
    ireg = sess.warp(imov)
    torch.cuda.synchronize()
    return sess, res, motion, ireg, time.perf_counter() - t0


def drive_main(dev, path: str, method: Method, regparams, nscales: int, iref, imov,
               **overrides):
    """One main path with the launch counts set to 0 just before it; its
    checks, and its launches read just after. Returns the launches and the
    result."""
    n = iref.shape[0]
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    sess, res, motion, ireg, wall = run_main(dev, method, regparams, nscales, iref, imov,
                                             **overrides)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    red = float(ssd_reduction(iref, imov, res.motion))
    finite = bool(torch.isfinite(motion).all()) and bool(torch.isfinite(ireg).all())
    iterations = [t.iterations for t in res.traces]
    emit({"phase": "main", "path": path, "shape": [n, n], "nscales": nscales,
          "regparams": regparams, **overrides, "wall_s": wall, "iterations": iterations,
          "regrids": [t.regrids for t in res.traces],
          "host_reads_per_level": [host_reads(method, regparams, n) for n in iterations],
          "ssd_reduction": red, "finite": finite, "motion_shape": list(motion.shape),
          "mean_motion_px": [float(res.motion[c].mean()) for c in range(2)],
          "peak_memory_gib": peak / 2 ** 30, "launches": launches})
    require(finite and tuple(motion.shape) == (n, n, 2), f"{path}: motion not finite")
    require(red >= SSD_BAR, f"{path}: SSD reduction {red} < {SSD_BAR}")
    sess.close()
    return launches, res


def phase_main(dev) -> dict:
    launches, dense = {}, {}
    for path, method, regparams, pair, nscales in PATHS:
        iref, imov = pair_on(dev, pair, N_MAIN)
        launches[path], dense[path] = drive_main(dev, path, method, regparams, nscales, iref,
                                                 imov)
        if method == Method.FLUID and not any(t.regrids for t in dense[path].traces):
            launches[f"{path}_regrid"], res = drive_main(
                dev, f"{path}_regrid", method, regparams, nscales, iref, imov,
                regrid_threshold=REGRID_FALLBACK)
            require(any(t.regrids for t in res.traces),
                    f"{path}: no regrid even at threshold {REGRID_FALLBACK}")
    launches["fluid_16k"] = drive_huge(dev)
    path, method, regparams, pair, nscales = DIFFUSION_TILED
    launches[path], dense["diffusion"] = drive_main(dev, path, method, regparams, nscales,
                                                    *pair_on(dev, pair, N_MAIN))
    for name, family, params, _, _ in SP_PATHS:
        launches[name] = drive_sp(dev, name, family, params, dense[family])
    return launches


def sp_solver(devices, family: str, params: dict, nscales: int):
    """make_register_sp at the settings of the strip paths, on SP_STRIPS
    strips over ``devices``."""
    return make_register_sp(make_mesh(x=SP_STRIPS, devices=devices), family,
                            niter=[NITER] * (nscales + 1), nscales=nscales, nrefine=NREFINE,
                            **params)


def max_floor_offset(u: torch.Tensor) -> int:
    """The largest |floor(x + u) - x| along either axis over the in-bounds
    samples of a warp by ``u``: the halo its contract needs (an
    out-of-bounds sample passes through and reads no tap)."""
    i = torch.arange(u.shape[1], device=u.device, dtype=u.dtype)[:, None]
    j = torch.arange(u.shape[2], device=u.device, dtype=u.dtype)[None, :]
    dx, dy = torch.floor(i + u[0]), torch.floor(j + u[1])
    inside = (dx >= 0) & (dx < u.shape[1]) & (dy >= 0) & (dy < u.shape[2])
    offset = torch.maximum((dx - i).abs(), (dy - j).abs())
    return int(torch.where(inside, offset, 0.0).max())


def sp_host_reads(family: str, iterations: int) -> int:
    """Device-to-host reads of a strip level solve: the summed Logger sums
    once a block (8 diffusion or 4 elastic iterations); fluid once an
    iteration (the Logger error and the minimum Jacobian determinant)."""
    if family == "fluid":
        return iterations
    return -(-iterations // (8 if family == "diffusion" else 4))


def drive_sp(dev, name: str, family: str, params: dict, dense) -> dict:
    """A strip-parallel path at 4096^2 with the launch counts set to 0 just
    before it; its checks, its launches read just after, and its
    difference from the dense run of its family on the same pair."""
    iref, imov = tiled_pair(N_MAIN, dev)
    solve = sp_solver([dev] * SP_STRIPS, family, params, TILED_NSCALES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = solve(iref, imov)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    red = float(ssd_reduction(iref, imov, res.motion))
    finite = bool(torch.isfinite(res.motion).all())
    offset = max_floor_offset(res.motion)
    used = (SP_KERNEL[family], "warp2d_strip", "compose_strip")
    reads = [sp_host_reads(family, n) for n in res.iterations]
    emit({"phase": "main", "path": name, "shape": [N_MAIN, N_MAIN], "strips": SP_STRIPS,
          "nscales": TILED_NSCALES, "params": params, "wall_s": wall,
          "iterations": list(res.iterations), "regrids": list(res.regrids),
          "host_reads_per_level": reads,
          "host_reads_per_iteration": sum(reads) / sum(res.iterations),
          "ssd_reduction": red, "finite": finite, "max_floor_offset": offset,
          "peak_memory_gib": peak / 2 ** 30, "launches": launches,
          "dense": {"max_abs_diff_px": max_abs(res.motion, dense.motion),
                    "max_floor_offset": max_floor_offset(dense.motion),
                    "iterations": [t.iterations for t in dense.traces],
                    "regrids": [t.regrids for t in dense.traces]}})
    require(finite, f"{name}: motion not finite")
    require(red >= SSD_BAR, f"{name}: SSD reduction {red} < {SSD_BAR}")
    require(offset <= params["halo"],
            f"{name}: floor offset {offset} outside the halo {params['halo']}")
    require(all(launches[k] > 0 for k in used), f"{name}: launched no {used}: {launches}")
    return launches


def drive_huge(dev) -> dict:
    """fluid_16k: the two-pass route on the 16384^2 level, through the
    session (register_phased past 8192)."""
    t0 = time.perf_counter()
    iref, imov = tiled_pair(N_HUGE, dev)
    torch.cuda.synchronize()
    emit({"phase": "main", "path": "fluid_16k", "pair_s": time.perf_counter() - t0})
    launches, res = drive_main(dev, "fluid_16k", Method.FLUID, [0.25, 0.0], TILED_NSCALES,
                               iref, imov)
    traces = res.traces
    fine = sum(t.iterations for t in traces if t.scale == 0)
    coarse = sum(t.iterations for t in traces if t.scale > 0)
    require(fine > 0 and launches["fluid_sweep_max"] == launches["fluid_euler"] == fine,
            f"fluid_16k: B8/B9 launches {launches['fluid_sweep_max']}/"
            f"{launches['fluid_euler']} against {fine} iterations at {N_HUGE}^2")
    require(launches["fluid_iter"] == coarse,
            f"fluid_16k: B7 launches {launches['fluid_iter']} against {coarse} coarse iterations")
    return launches


def profile_run(path: str, run) -> None:
    """torch.profiler over ``run() -> (iterations, regrids)`` (a warm repeat
    of a 4096^2 path): device kernel time against the wall, and the host
    syncs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iterations, regrids = run()
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    rows = prof.key_averages()
    device_us = sum(r.self_device_time_total for r in rows if r.device_type.name == "CUDA")
    top = sorted((r for r in rows if r.self_device_time_total > 0),
                 key=lambda r: -r.self_device_time_total)[:10]
    syncs = sum(r.count for r in rows if r.key in ("cudaStreamSynchronize",
                                                   "cudaDeviceSynchronize"))
    emit({"phase": "profile", "path": path, "wall_s": profiled_wall,
          "device_ms": device_us / 1e3, "busy_share": device_us / 1e6 / profiled_wall,
          "iterations": sum(iterations), "regrids": sum(regrids),
          "stream_syncs": syncs,
          "syncs_per_iteration": syncs / sum(iterations),
          "top": [{"name": r.key[:60], "ms": r.self_device_time_total / 1e3,
                   "count": r.count} for r in top]})


def phase_profile(dev, path: str) -> None:
    """A dense main path (PATHS or DIFFUSION_TILED) under the profiler."""
    _, method, regparams, pair, nscales = next(p for p in PATHS + (DIFFUSION_TILED,)
                                               if p[0] == path)
    iref, imov = pair_on(dev, pair, N_MAIN)

    def run():
        _, res, _, _, _ = run_main(dev, method, regparams, nscales, iref, imov)
        return [t.iterations for t in res.traces], [t.regrids for t in res.traces]

    profile_run(path, run)


def phase_profile_sp(dev, name: str) -> None:
    """A strip-parallel path (SP_PATHS) under the profiler."""
    _, family, params, _, _ = next(p for p in SP_PATHS if p[0] == name)
    iref, imov = tiled_pair(N_MAIN, dev)
    solve = sp_solver([dev] * SP_STRIPS, family, params, TILED_NSCALES)

    def run():
        res = solve(iref, imov)
        return res.iterations, res.regrids

    profile_run(name, run)


def phase_parity(dev) -> dict:
    launches = {}
    for path, method, regparams, pair, _ in PATHS:
        iref, imov = pair_on(torch.device("cpu"), pair, N_PARITY)
        demons = method in (Method.THIRIONS_DEMONS, Method.DIFFEOMORPHIC_DEMONS)
        niter = DEMONS_PARITY_NITER if demons else NITER
        cfg = RegConfig.from_regparams(method, [niter] * (PARITY_NSCALES + 1),
                                       PARITY_NSCALES, regparams, NREFINE)
        t0 = time.perf_counter()
        cpu = register(iref, imov, cfg, device="cpu")
        cpu_s = time.perf_counter() - t0
        kernels.reset_launches()
        gpu = register(iref.to(dev), imov.to(dev), cfg)
        torch.cuda.synchronize()
        launches[path] = dict(kernels.LAUNCHES)
        e = max_abs(gpu.motion.cpu(), cpu.motion)
        it_cpu = [t.iterations for t in cpu.traces]
        it_gpu = [t.iterations for t in gpu.traces]
        rg_cpu = [t.regrids for t in cpu.traces]
        rg_gpu = [t.regrids for t in gpu.traces]
        emit({"phase": "parity", "path": path, "shape": [N_PARITY, N_PARITY],
              "niter": niter, "max_abs_err_px": e, "iterations_cpu": it_cpu,
              "iterations_gpu": it_gpu, "regrids_cpu": rg_cpu, "regrids_gpu": rg_gpu,
              "cpu_s": cpu_s,
              "ssd_reduction_gpu": float(ssd_reduction(iref.to(dev), imov.to(dev),
                                                       gpu.motion)),
              "launches": launches[path]})
        require(e <= PARITY_TOL, f"{path}: GPU vs CPU motion differs by {e} px")
        require(it_cpu == it_gpu, f"{path}: iterations differ: {it_cpu} vs {it_gpu}")
        require(rg_cpu == rg_gpu, f"{path}: regrids differ: {rg_cpu} vs {rg_gpu}")
        if method == Method.FLUID:
            launches["fluid_two_pass"] = parity_two_pass(dev, iref, imov, cfg, gpu)
    for name, family, params, _, _ in SP_PATHS:
        launches[name] = parity_sp(dev, name, family, params)
    return launches


def parity_sp(dev, name: str, family: str, params: dict) -> dict:
    """A strip path at 512^2 in SP_STRIPS strips: the CPU strips (plain
    versions) against the GPU strips (kernels)."""
    iref, imov = tiled_pair(N_PARITY)
    solve = dict(niter=[SP_PARITY_NITER] * (PARITY_NSCALES + 1), nscales=PARITY_NSCALES,
                 nrefine=NREFINE, **params)
    t0 = time.perf_counter()
    cpu = make_register_sp(make_mesh(x=SP_STRIPS, devices=["cpu"] * SP_STRIPS), family,
                           **solve)(iref, imov)
    cpu_s = time.perf_counter() - t0
    kernels.reset_launches()
    gpu = make_register_sp(make_mesh(x=SP_STRIPS, devices=[dev] * SP_STRIPS), family,
                           **solve)(iref.to(dev), imov.to(dev))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    e = max_abs(gpu.motion.cpu(), cpu.motion)
    emit({"phase": "parity", "path": name, "shape": [N_PARITY, N_PARITY],
          "strips": SP_STRIPS, "niter": SP_PARITY_NITER, "max_abs_err_px": e,
          "iterations_cpu": list(cpu.iterations), "iterations_gpu": list(gpu.iterations),
          "regrids_cpu": list(cpu.regrids), "regrids_gpu": list(gpu.regrids), "cpu_s": cpu_s,
          "ssd_reduction_gpu": float(ssd_reduction(iref.to(dev), imov.to(dev), gpu.motion)),
          "launches": launches})
    require(e <= PARITY_TOL, f"{name}: GPU vs CPU motion differs by {e} px")
    require(cpu.iterations == gpu.iterations,
            f"{name}: iterations differ: {cpu.iterations} vs {gpu.iterations}")
    require(cpu.regrids == gpu.regrids, f"{name}: regrids differ: {cpu.regrids} vs {gpu.regrids}")
    require(launches[SP_KERNEL[family]] > 0, f"{name}: no {SP_KERNEL[family]} launch")
    return launches


def parity_two_pass(dev, iref, imov, cfg, want) -> dict:
    """The fluid run with every level on the two-pass route: the route's
    extent lowered to 0 for the call, then restored."""
    saved = registration._DERIV_BARRIER_MIN_EXTENT
    kernels.reset_launches()
    registration._DERIV_BARRIER_MIN_EXTENT = 0
    try:
        got = register(iref.to(dev), imov.to(dev), cfg)
    finally:
        registration._DERIV_BARRIER_MIN_EXTENT = saved
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    iterations = [t.iterations for t in got.traces]
    same = torch.equal(got.motion, want.motion)
    emit({"phase": "parity", "path": "fluid_two_pass", "shape": [N_PARITY, N_PARITY],
          "bit_equal_to_default": same, "iterations": iterations,
          "regrids": [t.regrids for t in got.traces], "launches": launches})
    require(same, "fluid: the two-pass route's motion differs from the default run's")
    require(iterations == [t.iterations for t in want.traces]
            and [t.regrids for t in got.traces] == [t.regrids for t in want.traces],
            "fluid: the two-pass route's counts differ from the default run's")
    require(launches["fluid_sweep_max"] == launches["fluid_euler"] == sum(iterations)
            and launches["fluid_iter"] == 0, f"fluid two-pass launches: {launches}")
    return launches


def median_ms(fn, runs: int = 20, warmup: int = 3, batch: int = 10) -> float:
    """Median over ``runs`` of the CUDA-event time of ``batch`` calls back to
    back, per call: the queue stays full, so the host's launch latency is
    not counted where the device is slower than the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return float(np.median(times))


def bound(name: str, npix: int) -> dict:
    """The least time the card could take for the kernel's work at
    ``npix`` pixels: bytes over the memory rate or operations over the
    float32 rate, whichever is larger."""
    t_bytes = PLANES[name] * 4 * npix / PEAK_BYTES_PER_S * 1e3
    t_ops = OPS[name] * npix / PEAK_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_times(dev) -> dict:
    rng = np.random.default_rng(SEED + 1)
    n = N_MAIN
    iref_np, imov_np = blob_pair(n)
    iref = torch.from_numpy(iref_np).to(dev)
    imov = torch.from_numpy(imov_np).to(dev)
    d = derivatives(iref, imov)
    g = stack_derivs(d.grad_i, d.it)
    u = torch.from_numpy(rng.normal(0, 1, (2, n, n)).astype(np.float32)).to(dev)
    v = (torch.tanh(u) * 0.4).contiguous()  # a demons increment
    k = RegConfig(method=Method.DIFFUSION, niter=(1,)).block_k
    onepass_args = (imov, iref, v, 1.0, 0.25, 2.0, 2.0, KW, False, True)
    corr_args = (imov, iref, v, 0.25, 1.0, 2.0, KW)
    elastic_args = (v, g, *ELASTIC, True, ELASTIC_K)
    fluid_args = (v, (v.flip(1) * 0.5).contiguous(), g, *FLUID, True, False)
    swept = fluid_iter(*fluid_args)[0]
    gate = torch.tensor(0.37, device=dev)
    pairs = {
        "diffusion_block": (lambda: diffusion_block(u, g, ALPHA, k),
                            lambda: diffusion_block_ref(u, g, ALPHA, k)),
        "diffusion_step": (lambda: diffusion_step_fused(u, g[:2], g[2], ALPHA),
                           lambda: diffusion_step_ref(u, g[:2], g[2], ALPHA)),
        "warp2d": (lambda: warp2d(imov, u), lambda: warp2d_ref(imov, u)),
        "compose": (lambda: compose(u, u), lambda: compose_ref(u, u)),
        "logger_norms": (lambda: logger_norms(u, v), lambda: logger_norms_ref(u, v)),
        "demons_onepass": (lambda: thirion_onepass(*onepass_args),
                           lambda: thirion_onepass_ref(*onepass_args)),
        "demons_correspondence": (lambda: demons_correspondence(*corr_args),
                                  lambda: demons_correspondence_ref(*corr_args)),
        "compose_smooth": (lambda: compose_smooth(u, v, 2.0, KW),
                           lambda: compose_smooth_ref(u, v, 2.0, KW)),
        "elastic_block": (lambda: elastic_block(*elastic_args),
                          lambda: elastic_block_ref(*elastic_args)),
        "fluid_iter": (lambda: fluid_iter(*fluid_args), lambda: fluid_iter_ref(*fluid_args)),
        "fluid_metrics": (lambda: fluid_metrics(u, v), lambda: fluid_metrics_ref(u, v)),
        "fluid_sweep_max": (lambda: fluid_sweep_max(*fluid_args),
                            lambda: fluid_sweep_max_ref(*fluid_args)),
        "fluid_euler": (lambda: fluid_euler(v, swept, gate),
                        lambda: fluid_euler_ref(v, swept, gate)),
    }
    times = {}
    for name, (kern, plain) in pairs.items():
        # No single PyTorch call computes any of these functions: grid_sample
        # has no edge renormalization and no pass-through, a conv2d no
        # renormalized border, no reduction gives both Logger sums (nor them
        # and the minimum Jacobian determinant), and none runs an SOR sweep,
        # the fused fluid iteration or the fluid Euler pass.
        t = {"ms": median_ms(kern), "plain_ms": median_ms(plain), **bound(name, n * n),
             "library_ms": None}
        times[name] = t
        emit({"phase": "times", "kernel": name, "shape": [n, n],
              **({"k": k} if name == "diffusion_block" else {}),
              **({"k": ELASTIC_K} if name == "elastic_block" else {}),
              **({"kernelwidth": KW} if name.startswith(("demons", "compose_")) else {}),
              **t})
    # One fluid iteration by each route: B7 and the plain Euler tail; B8,
    # the gate and B9 (the two routes give the same bits).
    one = make_fluid_step(*FLUID)
    two = make_fluid_two_pass_step(*FLUID)
    step_args = fluid_args[:3]
    emit({"phase": "times", "fluid_iteration": "one_pass", "shape": [n, n],
          "ms": median_ms(lambda: one(*step_args))})
    emit({"phase": "times", "fluid_iteration": "two_pass", "shape": [n, n],
          "ms": median_ms(lambda: two(*step_args))})
    times.update(strip_times(dev, imov, g, u, v))
    return times


def strip_bound(name: str, nxl: int, ny: int, pad: int) -> dict:
    """The bound of a strip kernel: its dense kernel's work on the strip's
    pixels, plus the halo rows of its padded inputs read once."""
    dense = STRIP_OF[name]
    t_bytes = ((PLANES[dense] * nxl + STRIP_PADDED[name] * 2 * pad) * ny * 4
               / PEAK_BYTES_PER_S * 1e3)
    t_ops = OPS[dense] * nxl * ny / PEAK_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def strip_times(dev, imov, g, u, v) -> dict:
    """Each strip kernel, one launch at a time on strip 1 of the 4096^2 grid
    cut into SP_STRIPS strips (1024 x 4096, padded with 8 halo rows a
    side), against its plain version."""
    n, s, pad = N_MAIN, 1, 8
    nxl = n // SP_STRIPS
    row0 = s * nxl
    up, vp, gp, ip = (x[s] for x in strip_inputs(dev, pad, u, v, g, imov))
    v_strip = spatial._split(v, [dev] * SP_STRIPS)[s]
    vel_pad = (vp.flip(1) * 0.5).contiguous()
    pairs = {
        "diffusion_block_strip": (k_diff.diffusion_block_strip, k_diff.diffusion_block_strip_ref,
                                  (up, gp, row0, n, ALPHA, 8, pad)),
        "elastic_block_strip": (k_el.elastic_block_strip, k_el.elastic_block_strip_ref,
                                (vp, gp, row0, n, *ELASTIC, True, ELASTIC_K, pad)),
        "fluid_iter_strip": (k_fl.fluid_iter_strip, k_fl.fluid_iter_strip_ref,
                             (vp, vel_pad, gp, row0, n, *FLUID, True, False, pad)),
        "warp2d_strip": (k_wf.warp2d_strip, k_wf.warp2d_strip_ref,
                         (ip, v_strip, row0, n, SP_HALO)),
        "compose_strip": (k_wf.compose_strip, k_wf.compose_strip_ref,
                          (up, v_strip, row0, n, SP_HALO)),
    }
    times = {}
    for name, (kern, plain, args) in pairs.items():
        # No PyTorch call computes these either: see phase_times.
        t = {"ms": median_ms(lambda: kern(*args)), "plain_ms": median_ms(lambda: plain(*args)),
             **strip_bound(name, nxl, n, pad), "library_ms": None}
        times[name] = t
        emit({"phase": "times", "kernel": name, "shape": [nxl, n], "row0": row0, "pad": pad,
              **t})
    return times


def main() -> None:
    seconds = {}

    def timed(phase: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = seconds.get(phase, 0.0) + time.perf_counter() - t0
        return out

    smi = phase_card()
    dev = torch.device("cuda", 0)
    timed("build", phase_build)
    err = timed("kernels", phase_kernels, dev)
    main_launches = timed("main", phase_main, dev)
    for path in ("diffeomorphic", "fluid", "elastic", "diffusion_tiled"):
        timed("profile", phase_profile, dev, path)
    for name, *_ in SP_PATHS:
        timed("profile", phase_profile_sp, dev, name)
    parity_launches = timed("parity", phase_parity, dev)
    times = timed("times", phase_times, dev)
    emit({"phase": "seconds", **seconds})
    launches = {name: sum(run[name] for run in main_launches.values()) for name in KERNELS}
    missing = [name for name in KERNELS if launches[name] == 0]
    emit({"phase": "launch_check", "main": main_launches, "parity_runs": parity_launches,
          "missing_in_main": missing})
    require(not missing, f"the main paths launched no {missing}")
    emit({"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": err[name], **times[name]}
        for name, (route, source, replaces) in KERNELS.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
