"""Build the port's CUDA kernels and drive its main paths once on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

0. Card check: fail without CUDA; print the card's name and power limit.
1. Build every kernel from ``opticalflow2d_tpu_torch/csrc`` for sm_90a
   (one ``nvcc`` per source, all started together).
2. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and a ragged one (fields <= 1e-6 max-abs, Logger sums
   <= 1e-5 relative, max |R|^2 and the minimum Jacobian determinant
   <= 1e-6 relative): the diffusion block at k = 1-8, 16 and 22 (each
   plan: 8 compiled in, 48 x 48 at run time, 32 x 32 at 22) bit for bit,
   also on 4x4 and 33x1000, the diffusion step, warp and compose with
   displacements up to +-40 px, the Logger norms, B1 (k = 8 and 5), B2
   and B4 by their pair-axis entries on a stack of one pair, as the level
   loop runs them, against their single entries too, bit for bit (B4's
   sums within 1e-5 of the plain version), the three demons kernels
   at kernelwidth 3, 5, 7, 11 and 43 (each plan of their tiles: 5 with its
   taps known, 64 x 64 tiles at run time, 32 x 32 with two staging buffers
   and with one; the one-pass kernel by composition and by addition) with
   small displacements and with ones that send samples out of bounds, also
   on 4x4 and 33x1000, whose tiles are all border tiles, the elastic block
   at k = 1, 2, 3, 4 with either stencil, bit for bit, also on 4x4 and
   33x1000, the fluid iteration with either
   stencil and either maxabs with a nonzero velocity, bit for bit, also on
   4x4 and 33x1000, and the fluid metrics on a field of up to 3 px whose
   Jacobian determinant falls below 0.5. The two-pass fluid kernels with
   either stencil and either maxabs: the sweep-and-max pass, bit for bit,
   whose vel' and max |R|^2 must also equal the fluid iteration's, and
   the Euler pass at a gate > 0 and a gate of 0. Then the fluid_16k
   path's kernels at its own shapes past 4096, on its tiled pair, with the
   same fields and checks: warp, compose, the fluid metrics and the three
   fluid kernels at 16384^2 and 8192^2. Then the motion upsample, bit for
   bit with signed zeros, from the cell's four levels to 4096^2, from
   8192^2 to 16384^2 and at odd shapes. Then the box downsample, bit for
   bit: the slide cell's 4096^2 image to levels 1-4 and its field to the
   seeds' levels 1-3, the same at 16384^2 (the fluid cell's, past 4096),
   and 1000x777 to levels 1-6. Then the strip kernels K1-K4 of the
   strip-parallel driver on 4 strips of 4096^2 and of 1000x777 (nxl 250),
   each strip padded by the strip driver's halo exchange, against their plain
   versions and, concatenated, against the dense kernel's rows: the
   diffusion strip at k = 1-8, 16 and 22 on their pads and at a rerun of 3
   on the k = 8 pad, the elastic strip at k = 1, 2, 3, 4 with either
   stencil, the fluid strip with either stencil and either maxabs, all
   three bit for bit and also on 4 strips of 1004x777, which start at the
   odd rows 251 and 753; warp and compose inside the
   displacement contract and (plain version only) far outside it; the
   demons strips K5-K7 at halo 5 and kernelwidth 3, 5, 7, 11 and 43, each on its
   exact pad, with displacements of up to 2 px (also bit for bit against
   B10-B12's rows) and of up to +-40 px (plain version only).
   Then the library routes of the spectral solvers, which have no kernel
   of their own (cuBLAS matmuls, cuFFT): the curvature solve by the matmul
   and the fft route and the periodic Navier-Lame solve at 4096^2 and
   1000x777, the Dirichlet solve at 1024^2, each against its CPU run (<=
   1e-5 of max |out|, or past that within 3 times the route's own change
   under a rounding of its input, the float32 noise of the ill-conditioned
   Dirichlet system) and run again with the caller's TF32 switches on
   (cuBLAS and cuDNN), which must give the same bits and be restored; the
   fft route against the matmul route on the card. Then B1 (k = 8 and 3),
   B2, B3 (warp and compose), B4, B5, B7 and U2 batched over 3 pairs of
   1000x777, of 1024^2 and of the 4DCT cell's 512^2 and 256^2, all listed
   and the shuffled subset (2, 0): each pair bit-equal to its own
   single-pair launch and to the plain version (B4's sums bit for bit
   against the single launch, within 1e-5 relative of the plain version;
   B5's three numbers and B7's max |R|^2 bit for bit against both; U2's
   single launches also bit-equal to the plain version), and the pairs
   left out of the subset unwritten by B7 and U2.
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
      block_k 4), sp_fluid ([0.25, 0]), sp_thirion ([1, 0.25, 2, 2, 5]:
      K5) and sp_diffeo ([0.25, 1, 2, 2, 5]: K6, the squarings on K4,
      K7): make_register_sp on make_mesh(x=4) over one card, 4096^2 in 4
      strips of 1024 rows, on the tiled pair, nscales 2, nrefine 2, halo 5
      (fluid: 32, see SP_FLUID_HALO): the strip kernels K1-K7. Each must
      stay inside its contract (the final motion's in-bounds floor offsets
      within the halo) and launch its strip kernels, the demons ones 4
      times an iteration; beside each, its difference and counts against
      the dense run of the family on the same pair (3d, 3e, and dense
      diffusion, Thirion and diffeomorphic runs on the tiled pair),
      reported, not gated.
   h. the spectral solvers: curvature [0.1, 1.0] (dct_impl "auto": the
      matmul route, RegConfig.resolved_dct_impl says why) on the tiled
      pair, 3 levels; fluid [0.25, 0] and elastic
      [0.25, 0] with the periodic Navier-Lame solve (fluid_spectral,
      elastic_spectral) and elastic [0.5, 0] with the Dirichlet solve at
      1024^2 (elastic_dirichlet) on the blob pair, 5 levels
      (SPECTRAL_PATHS says why); each launches warp, compose and the
      Logger norms (fluid: the fluid metrics) and no block or
      fluid-iteration kernel. Curvature's route is the dense transform,
      1.1 TFLOP an iteration at 4096^2, so it runs 100 iterations a
      level at most. sp_curvature: make_register_sp on 4 strips of the
      tiled pair (halo 5, the same cap; the strip warp and compose),
      beside the dense curvature run.
   i. the batch paths (parallel.register_batch, BATCH_PATHS): 16 pairs of
      the blob pair at 1024^2 (each shift's components scaled by factors
      in [0.5, 1.5] from the seed; nscales 2) by diffusion, 4 pairs of the tiled pair at
      1024^2 by elastic [0.5, 0] and curvature (matmul route, 100
      iterations a level), 4 at 512^2 by fluid (impl "auto" must resolve
      to vmap); each run by the lockstep driver (impl "vmap", B1-B4
      batched and B6 a pair; fluid B7 and B5 batched, one read an
      iteration) and by map, and a Python loop of register as
      the reference: every pair's counts equal to its register's and its
      motion bit-equal, the diffusion pairs
      stopping at two or more count vectors, each with SSD reduction >=
      0.9; wall time, registrations a second, peak memory and host reads
      of each, beside the card's name and power limit.
   Every path needs SSD reduction >= 0.9 and a finite motion; the phase
   prints iterations, regrids, wall time, host reads per level and
   launches. The tiled pair keeps its sigma = 6 px blobs at every size;
   the three-blob pair's widths scale with n, which leaves fluid's
   increment so small at 512^2 and above that every step is skipped.
   Three levels put the coarsest at 1024^2, where the blobs are 1.5 px.
4. Profiles of runs 3b, 3c, 3e and the five 3g runs (sp_thirion and
   sp_diffeo capped at DEMONS_PROFILE_NITER iterations a level), of the
   dense elastic and tiled diffusion runs, and of the dense Thirion and
   diffeomorphic runs on the tiled pair at the strip profiles' cap, and of
   curvature, fluid_spectral and sp_curvature: the device's busy share,
   the host syncs, the device time of the concatenations (the halo pads),
   of cuBLAS and cuFFT and of each of the port's kernels.
5. Slice parity at 512^2 for each path: the CPU (plain versions) against
   the GPU (kernels), motion <= 1e-5 px and equal iteration and regrid
   counts at every level; and the fluid run again with every level on the
   two-pass route (its extent lowered to 0), equal to the default GPU run
   bit for bit, with equal counts; and the six sp_* paths at 512^2 in 4
   strips, CPU against GPU, with the same gates; the spectral paths
   (curvature by each route) CPU against GPU, and the curvature fft route
   against the matmul route on the card (gated while dct_impl "auto"
   resolves to "fft", printed otherwise), with the same gates:
   fluid_spectral at 5 iterations a level (FLUID_SPECTRAL_PARITY_NITER
   says why), elastic_dirichlet at a fixed 12 a level within 3 times the
   CPU run's own change under a rounding of its input (DIRICHLET_PARITY);
   both also at 200 with the default stop, reported beside the CPU run's
   own changes under an ulp of one input pixel and a rounding of all.
6. Times at 4096^2: median of 20 CUDA-event-timed runs of 10 calls each,
   of each kernel and of its plain version, and its bound; and of one
   fluid iteration by each route (B7 and the plain Euler tail; B8, the
   gate and B9); and of each strip kernel on one 1024x4096 strip of the
   4096^2 grid (K1-K4 padded with 8 rows, K5-K7 with their exact reach at
   halo 5), its bound counting the halo rows it reads. Then the demons
   kernels' tiles, the elastic block's plan at k = 4, the diffusion
   block's at k = 8 and the fluid kernels' plan with their memory bounds,
   and each demons, elastic, diffusion-block and fluid-sweep kernel's bound
   under the instruction floor (the float32 rate without fused
   multiply-adds, which -fmad=false forbids). And one solve of each library
   route (curvature by each route and the periodic Navier-Lame solve at
   4096^2, the Dirichlet solve at 1024^2) beside its bound: operations
   over the float32 rate for the matmul routes, bytes over the memory rate
   (each pass of the transform reading and writing its planes) for the
   FFT routes. And the batched kernels on 16 pairs of 1024^2, each beside
   its plain version and 16 single-pair launches. And the motion upsample
   from 2048^2 and from 256^2 to 4096^2 beside its plain version, its
   bound and its launches a call. And the box downsample from 4096^2 and
   from 16384^2 to each level, image and field, beside its plain version,
   its bound (the input read once, the output written once) and its
   launches a call.
7. Utilities: register_resumable on the 4096^2 blob diffusion run (3a),
   stopped after scale 2 and resumed, bit-equal to register with equal
   counts; utils.kernel_timer on B1 at 4096^2 beside phase 6's median;
   debug_nans raising on an input with one NaN pixel.

The line before the last two is the ``{"kernels": [...]}`` summary; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
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
from opticalflow2d_tpu_torch.kernels import demons_fused as k_df
from opticalflow2d_tpu_torch.kernels import demons_onepass as k_op
from opticalflow2d_tpu_torch.kernels.derive import (
    derive, derive_batch, derive_batch_ref, derive_ref)
from opticalflow2d_tpu_torch.kernels.diffusion_block import (
    diffusion_block, diffusion_block_batch, diffusion_block_batch_ref, diffusion_block_ref,
    stack_derivs)
from opticalflow2d_tpu_torch.kernels.diffusion_fused import (
    diffusion_step_batch, diffusion_step_batch_ref, diffusion_step_fused, diffusion_step_ref)
from opticalflow2d_tpu_torch.kernels.downsample import (
    downsample_image, downsample_image_ref, downsample_motion, downsample_motion_ref)
from opticalflow2d_tpu_torch.kernels.elastic_block import elastic_block, elastic_block_ref
from opticalflow2d_tpu_torch.kernels.fluid_fused import (
    fluid_euler, fluid_euler_ref, fluid_iter, fluid_iter_batch, fluid_iter_batch_ref,
    fluid_iter_ref, fluid_sweep_max, fluid_sweep_max_ref)
from opticalflow2d_tpu_torch.kernels.logger_norms import (
    fluid_metrics, fluid_metrics_batch, fluid_metrics_batch_ref, fluid_metrics_ref,
    logger_norms, logger_norms_batch, logger_norms_batch_ref, logger_norms_ref)
from opticalflow2d_tpu_torch.kernels.upsample import upsample_motion, upsample_motion_ref
from opticalflow2d_tpu_torch.kernels.warp_fused import (
    compose, compose_batch, compose_batch_ref, compose_ref, warp2d, warp2d_batch,
    warp2d_batch_ref, warp2d_ref)
from opticalflow2d_tpu_torch.kernels import diffusion_block as k_diff
from opticalflow2d_tpu_torch.kernels import elastic_block as k_el
from opticalflow2d_tpu_torch.kernels import fluid_fused as k_fl
from opticalflow2d_tpu_torch.kernels import warp_fused as k_wf
from opticalflow2d_tpu_torch.metrics import ssd_reduction
from opticalflow2d_tpu_torch.ops.resample import pyramid_dims
from opticalflow2d_tpu_torch.parallel import make_mesh, make_register_sp, register_batch, spatial
from opticalflow2d_tpu_torch.parallel.batch import _resolve_impl
from opticalflow2d_tpu_torch.solvers.base import derivatives
from opticalflow2d_tpu_torch.solvers.demons import demons_route
from opticalflow2d_tpu_torch.solvers.curvature import make_curvature_solve
from opticalflow2d_tpu_torch.solvers.fluid import make_fluid_step, make_fluid_two_pass_step
from opticalflow2d_tpu_torch.solvers.navier_lame import (
    make_dirichlet_navier_lame_solver, make_spectral_navier_lame_solver)
from opticalflow2d_tpu_torch.utils import debug_nans, kernel_timer, register_resumable

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
# The cap a level of the demons profiles on the tiled pair, strip and dense:
# sp_diffeo runs 400 iterations on five of its six levels, and the
# profiler's tables of its 2014 iterations took about 200 s on an H100; 100
# keeps the steady loop in the window.
DEMONS_PROFILE_NITER = 100
SEED = 0
KERNEL_SHAPES = ((4096, 4096), (2048, 2048), (1000, 777))
# The demons kernels' widths: kw 5 with its taps known, 3 and 7 on 64 x 64
# tiles at run time, 11 on 32 x 32 with two staging buffers (B11: 64 x 64),
# 43 with one (B11: two); and shapes whose tiles are all border tiles.
DEMONS_KWS = (3, 5, 7, 11, 43)
BORDER_SHAPES = ((4, 4), (33, 1000))
# The elastic block's k: 1-4 compiled in on 48 x 48 tiles; and 4 strips of
# ODD_STRIPS (nxl 251) start at the odd rows 251 and 753.
ELASTIC_KS = (1, 2, 3, 4)
ODD_STRIPS = (1004, 777)
# The diffusion block's k: 8 compiled in on 48 x 48 tiles, the others at run
# time on them (16: bench.py's), 22 on the 32 x 32 plan.
DIFFUSION_KS = (1, 2, 3, 4, 5, 6, 7, 8, 16, 22)
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

# The spectral solvers (no kernel of their own: cuBLAS matmuls and cuFFT at
# full float32). Curvature takes examples/demo.py's [alpha, tau]. The
# Dirichlet solve's DST-I matmuls grow as n^3 (12 CG iterations of 8
# matmuls an outer iteration: 0.2 TFLOP at 1024^2, 13 at 4096^2), so its
# path runs at 1024^2.
CURVATURE = [0.1, 1.0]
N_DIRICHLET = 1024
# The curvature paths' cap a level, dense and on strips: their route is the
# dense transform, 1.1 TFLOP an iteration at 4096^2.
CURVATURE_NITER = 100
SPECTRAL_PARITY_NITER = 200
# fluid_spectral's gated parity run is this short: its trajectory moves by
# 1e-6 px on the CPU alone when one input pixel changes by an ulp, and by
# far more past tens of iterations, where a regrid moves (its timestep is
# dumax over a maximum of the field; probes/spectral_paths.py), so cuFFT's
# rounding against the CPU's FFT is gated here and reported at
# SPECTRAL_PARITY_NITER beside that sensitivity.
FLUID_SPECTRAL_PARITY_NITER = 5
# elastic_dirichlet's: its float32 solve moves by 2.8e-5 of max |v| when its
# input is rounded again (input_rounding_noise at 1024^2), which moves its
# Logger stop across devices. The gated run takes a fixed count
# (tol 0, the count its levels stop at) and holds the card to the CPU within
# NOISE_FACTOR times the CPU run's own change under a rounding of the
# moving image; the default run is reported beside it.
DIRICHLET_PARITY = dict(niter=12, convergence_tol=0.0)
LIBRARY_RTOL = 1e-5  # a library route on the card against the CPU, of max |out|
# or, past it, this many times the route's own input rounding noise
# (input_rounding_noise): the Dirichlet solve's float32 answer is that
# uncertain on any device.
NOISE_FACTOR = 3
# (name, method, regparams, pair, n, nscales, config overrides). The
# spectral Navier-Lame paths run on the blob pair, whose background is flat.
# Elastic's iteration u <- A^-1 f(u) with an exact solve diverges once mu
# times A's least eigenvalue, mu (2 pi / n)^2 (Dirichlet: mu (pi / n)^2),
# falls well below |grad I|^2, which on the tiled pair (6 px features at
# every n) happens from 256^2 up (the map is the JAX package's, which the
# port matches at 64x48); on the blob pair both scale as 1/n^2. The periodic solve zeroes the mean
# mode, so neither family registers a uniform shift of an image that is
# structure everywhere: fluid_spectral reaches an SSD reduction of 0.671
# on the tiled pair at 4096^2, where elastic's motion is not finite; on
# the blob pair elastic reaches 0.859 at [0.5, 0] and 0.942 at [0.25, 0]
# (H100; probes/spectral_paths.py).
SPECTRAL_PATHS = (
    ("curvature", Method.CURVATURE, CURVATURE, "tiled", N_MAIN, TILED_NSCALES,
     CURVATURE_NITER, dict(dct_impl="auto")),
    ("elastic_spectral", Method.ELASTIC, [0.25, 0.0], "blob", N_MAIN, MAIN_NSCALES, NITER,
     dict(navier_lame_solver="spectral")),
    ("fluid_spectral", Method.FLUID, [0.25, 0.0], "blob", N_MAIN, MAIN_NSCALES, NITER,
     dict(navier_lame_solver="spectral")),
    ("elastic_dirichlet", Method.ELASTIC, [0.5, 0.0], "blob", N_DIRICHLET, MAIN_NSCALES, NITER,
     dict(navier_lame_solver="spectral_dirichlet")),
)
# The kernels each spectral path must launch, and those it must not: it
# runs no block or fluid-iteration kernel (the spectral fluid step takes
# neither fused route, as in JAX). The level loop runs a stack of one pair,
# its Logger sums on B4's pair-axis entry.
SPECTRAL_KERNELS = {"curvature": ("warp2d", "compose", "logger_norms_batch"),
                    "elastic_spectral": ("warp2d", "compose", "logger_norms_batch"),
                    "elastic_dirichlet": ("warp2d", "compose", "logger_norms_batch"),
                    "fluid_spectral": ("warp2d", "compose", "fluid_metrics")}
NOT_ON_SPECTRAL = ("diffusion_block", "diffusion_block_batch", "diffusion_step",
                   "diffusion_step_batch", "elastic_block", "fluid_iter", "fluid_sweep_max",
                   "fluid_euler")
SP_CURVATURE = ("sp_curvature", "curvature", dict(alpha=CURVATURE[0], tau=CURVATURE[1],
                                                  halo=SP_HALO))

# The batch paths (parallel.register_batch): BATCH pairs of N_BATCH^2, the
# largest 1024^2 batch of the JAX package's serving study
# (benchmarks/r8_serving_fix.py:38-40), each pair's shift components scaled
# by factors in [0.5, 1.5] from the seed, so that the pairs stop at
# different counts (batch_stack says why both);
# (name, method, regparams, pair, n, pairs, nscales, niter, config
# overrides, impls, tolerance in px against each pair's own register: 0,
# bit for bit; the lockstep curvature solves each pair apart, since one
# cuBLAS matmul over the stack rounded apart by 7.9e-5 px, PERF.md).
N_BATCH = 1024
BATCH = 16
BATCH_PATHS = (
    ("batch_diffusion", Method.DIFFUSION, [ALPHA], "blob", N_BATCH, BATCH, 2, NITER, {},
     ("vmap", "map"), 0.0),
    ("batch_elastic", Method.ELASTIC, [0.5, 0.0], "tiled", N_BATCH, 4, TILED_NSCALES, NITER,
     {}, ("vmap", "map"), 0.0),
    ("batch_curvature", Method.CURVATURE, CURVATURE, "tiled", N_BATCH, 4, TILED_NSCALES,
     CURVATURE_NITER, {"dct_impl": "matmul"}, ("vmap", "map"), 0.0),
    ("batch_fluid", Method.FLUID, [0.25, 0.0], "tiled", N_PARITY, 4, TILED_NSCALES, NITER, {},
     ("vmap", "map"), 0.0),
)
# The batched kernels' checks: 3 pairs of these shapes, all listed and a
# shuffled subset; the last two are the 4DCT cell's levels.
BATCH_KERNEL_SHAPES = ((1000, 777), (1024, 1024), (512, 512), (256, 256))
BATCH_KERNEL_PAIRS = ([0, 1, 2], [2, 0])
BATCH_KS = (8, 3)
# B1 on a stack of one pair, as the level loop runs it for ``register``:
# the slide cell's block, and a block that the niter cap cuts short.
ONE_PAIR_KS = (8, 5)
# The batched kernels and the single-pair kernels whose work they repeat per pair.
BATCHED = {"diffusion_block_batch": "diffusion_block", "diffusion_step_batch": "diffusion_step",
           "warp2d_batch": "warp2d", "compose_batch": "compose",
           "logger_norms_batch": "logger_norms", "fluid_iter_batch": "fluid_iter",
           "fluid_metrics_batch": "fluid_metrics", "derive_batch": "derive"}

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
# The dense runs beside the strip paths, on their pair, by family.
THIRION_PARAMS = [1.0, 0.25, 2.0, 2.0, 5]  # sigma_i, sigma_x, sigma_d, sigma_f, kernelwidth
DIFFEO_PARAMS = [0.25, 1.0, 2.0, 2.0, 5]
# thirion_onepass's sigma_i, sigma_x, sigma_fluid, sigma_diffusion, kernelwidth.
ONEPASS_ARGS = (THIRION_PARAMS[0], THIRION_PARAMS[1], THIRION_PARAMS[3], THIRION_PARAMS[2],
                THIRION_PARAMS[4])
TILED_DENSE = {
    "diffusion": DIFFUSION_TILED,
    "thirions": ("thirion_tiled", Method.THIRIONS_DEMONS, THIRION_PARAMS + [0], "tiled",
                 TILED_NSCALES),
    "diffeo": ("diffeo_tiled", Method.DIFFEOMORPHIC_DEMONS, DIFFEO_PARAMS, "tiled",
               TILED_NSCALES),
}

# The strip-parallel paths: (name, family, make_register_sp parameters, the
# method and regparams of the dense run of the family on the same pair).
DEMONS_KEYS = ("sigma_i", "sigma_x", "sigma_diffusion", "sigma_fluid", "kernelwidth")
SP_PATHS = (
    ("sp_diffusion", "diffusion", dict(alpha=ALPHA, block_k=8, halo=SP_HALO), Method.DIFFUSION,
     [ALPHA]),
    ("sp_elastic", "elastic", dict(mu=0.5, lam=0.0, block_k=4, halo=SP_HALO), Method.ELASTIC,
     [0.5, 0.0]),
    ("sp_fluid", "fluid", dict(mu=0.25, lam=0.0, halo=SP_FLUID_HALO), Method.FLUID,
     [0.25, 0.0]),
    ("sp_thirion", "thirions", dict(zip(DEMONS_KEYS, THIRION_PARAMS), halo=SP_HALO),
     Method.THIRIONS_DEMONS, THIRION_PARAMS + [0]),
    ("sp_diffeo", "diffeo", dict(zip(DEMONS_KEYS, DIFFEO_PARAMS), halo=SP_HALO),
     Method.DIFFEOMORPHIC_DEMONS, DIFFEO_PARAMS),
)
# The strip kernels each strip path must launch, beside warp and compose;
# the demons launch theirs once a strip an iteration.
SP_KERNEL = {"diffusion": ("diffusion_block_strip",), "elastic": ("elastic_block_strip",),
             "fluid": ("fluid_iter_strip",), "thirions": ("demons_onepass_strip",),
             "diffeo": ("demons_correspondence_strip", "compose_smooth_strip"),
             "curvature": ()}

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
    "demons_onepass_strip": ("cuda", "opticalflow2d_tpu_torch/csrc/demons_onepass.cu",
                             "opticalflow2d_tpu/pallas_kernels/demons_onepass.py:310"),
    "demons_correspondence_strip": ("cuda", "opticalflow2d_tpu_torch/csrc/demons_fused.cu",
                                    "opticalflow2d_tpu/pallas_kernels/demons_fused.py:401"),
    "compose_smooth_strip": ("cuda", "opticalflow2d_tpu_torch/csrc/demons_fused.cu",
                             "opticalflow2d_tpu/pallas_kernels/demons_fused.py:481"),
    "diffusion_block_batch": ("cuda", "opticalflow2d_tpu_torch/csrc/diffusion_block.cu",
                              "opticalflow2d_tpu/pallas_kernels/diffusion_block.py:223"),
    "diffusion_step_batch": ("cuda", "opticalflow2d_tpu_torch/csrc/diffusion_step.cu",
                             "opticalflow2d_tpu/pallas_kernels/diffusion_fused.py:106"),
    "warp2d_batch": ("cuda", "opticalflow2d_tpu_torch/csrc/warp_gather.cu",
                     "opticalflow2d_tpu/pallas_kernels/warp_fused.py:173"),
    "compose_batch": ("cuda", "opticalflow2d_tpu_torch/csrc/warp_gather.cu",
                      "opticalflow2d_tpu/pallas_kernels/warp_fused.py:173"),
    "logger_norms_batch": ("cuda", "opticalflow2d_tpu_torch/csrc/logger_norms.cu",
                           "opticalflow2d_tpu/pallas_kernels/logger_norms.py:178"),
    "fluid_iter_batch": ("cuda", "opticalflow2d_tpu_torch/csrc/fluid_iter.cu",
                         "opticalflow2d_tpu/pallas_kernels/fluid_fused.py:188"),
    "fluid_metrics_batch": ("cuda", "opticalflow2d_tpu_torch/csrc/logger_norms.cu",
                            "opticalflow2d_tpu/pallas_kernels/logger_norms.py:129"),
    "derive": ("cuda", "opticalflow2d_tpu_torch/csrc/derive.cu",
               "none: the JAX package derives in jnp (opticalflow2d_tpu/solvers/base.py)"),
    "derive_batch": ("cuda", "opticalflow2d_tpu_torch/csrc/derive.cu",
                     "none: the JAX package derives in jnp (opticalflow2d_tpu/solvers/base.py)"),
    "upsample_motion": ("cuda", "opticalflow2d_tpu_torch/csrc/upsample.cu",
                        "none: the JAX package upsamples in jnp "
                        "(opticalflow2d_tpu/ops/resample.py:149)"),
    "downsample": ("cuda", "opticalflow2d_tpu_torch/csrc/downsample.cu",
                   "none: the JAX package downsamples in jnp "
                   "(opticalflow2d_tpu/ops/resample.py:42)"),
}

# H100 SXM peaks (NVIDIA's data sheet): device memory and float32 outside
# the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# The kernels' instruction floor: the float32 peak counts a fused
# multiply-add as two operations, and -fmad=false fuses none, so the
# kernels' operations go at most at half that rate.
PEAK_F32_NO_FMA_PER_S = PEAK_F32_PER_S / 2
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
# Logger sums and the determinant with its minimum. The derivatives read two
# images and write three planes: two central differences and a difference.
ELASTIC_K = 4
# A strip kernel does its dense kernel's work on the strip's pixels and
# also reads the halo rows of its padded inputs (STRIP_PADDED planes, 8 rows
# a side at the timed settings, the demons strips their exact reach).
# The kernels whose bound phase 6 also states under the instruction floor.
FLOOR_TIMED = ("demons_onepass", "demons_correspondence", "compose_smooth",
               "demons_onepass_strip", "demons_correspondence_strip", "compose_smooth_strip",
               "elastic_block", "elastic_block_strip", "diffusion_block", "diffusion_block_strip",
               "fluid_iter", "fluid_sweep_max", "fluid_iter_strip")
STRIP_TIMED_PAD = 8  # halo rows a side of the timed strips K1-K4
STRIP_OF = {"diffusion_block_strip": "diffusion_block", "elastic_block_strip": "elastic_block",
            "fluid_iter_strip": "fluid_iter", "warp2d_strip": "warp2d",
            "compose_strip": "compose", "demons_onepass_strip": "demons_onepass",
            "demons_correspondence_strip": "demons_correspondence",
            "compose_smooth_strip": "compose_smooth"}
# The demons strips' timed pads: at SP_HALO and kernelwidth KW, each its exact reach.
STRIP_PADS = {"demons_onepass_strip": k_op.onepass_strip_pad(SP_HALO, KW),
              "demons_correspondence_strip": k_df.correspondence_strip_pad(SP_HALO, KW),
              "compose_smooth_strip": k_df.compose_smooth_strip_pad(SP_HALO, KW)}
STRIP_PADDED = {"diffusion_block_strip": 5, "elastic_block_strip": 5, "fluid_iter_strip": 7,
                "warp2d_strip": 1, "compose_strip": 2, "demons_onepass_strip": 4,
                "demons_correspondence_strip": 4, "compose_smooth_strip": 4}
PLANES = {"diffusion_block": 7, "diffusion_step": 7, "warp2d": 4, "compose": 6,
          "logger_norms": 4, "demons_onepass": 6, "demons_correspondence": 6,
          "compose_smooth": 6, "elastic_block": 7, "fluid_iter": 11, "fluid_metrics": 4,
          "fluid_sweep_max": 9, "fluid_euler": 6, "derive": 5}
OPS = {"diffusion_block": 8 * 33, "diffusion_step": 21, "warp2d": 25, "compose": 36,
       "logger_norms": 12, "demons_onepass": 93 + 16 * KW,
       "demons_correspondence": 45 + 8 * KW, "compose_smooth": 36 + 8 * KW,
       "elastic_block": ELASTIC_K * 50, "fluid_iter": 58, "fluid_metrics": 26,
       "fluid_sweep_max": 58, "fluid_euler": 20, "derive": 5}


PLANES.update({name: PLANES[single] for name, single in BATCHED.items()})
OPS.update({name: OPS[single] for name, single in BATCHED.items()})


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def blob_pair(n: int, scale=(1.0, 1.0)):
    """Three Gaussian blobs scaled to an n x n image; the moving image is
    shifted by (1.5 * scale[0], -0.8 * scale[1]) * n / 256 px."""
    xs = np.arange(n, dtype=np.float64)[:, None]
    ys = np.arange(n, dtype=np.float64)[None, :]
    blobs = [((.4, .5), .125, 1.0), ((.65, .3), .083, .7), ((.3, .75), .104, .5)]

    def img(ox, oy):
        g = np.zeros((n, n))
        for (cx, cy), s, a in blobs:
            g += a * np.exp(-((xs - ox - cx * n) ** 2 + (ys - oy - cy * n) ** 2)
                            / (2 * (s * n) ** 2))
        return g.astype(np.float32)

    return img(0.0, 0.0), img(1.5 * scale[0] * n / 256, -0.8 * scale[1] * n / 256)


def tiled_pair(n: int, dev=torch.device("cpu"), scale=(1.0, 1.0)):
    """Gaussian blobs of sigma = 6 px on a 32 px grid, amplitudes 0.3-1.0
    from the seed; the moving image is shifted by (1.5 * scale[0], -0.8 *
    scale[1]) px. Unlike
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

    return img(0.0, 0.0), img(1.5 * scale[0], -0.8 * scale[1])


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


def check(err: dict, name: str, got, want, shape, exact: bool = False, **info) -> None:
    """Hold a kernel's field (and Logger sums, for a pair) against its
    plain version's; ``exact``: bit for bit."""
    sums_rel = None
    if isinstance(got, tuple):
        (got, sums), (want, sums_ref) = got, want
        sums_rel = rel_err(sums, sums_ref)
    torch.cuda.synchronize()
    e = max_abs(got, want)
    emit({"phase": "kernels", "kernel": name, "shape": list(shape), **info,
          "max_abs_err": e, **({} if sums_rel is None else {"sums_rel_err": sums_rel})})
    require(e <= (0.0 if exact else FIELD_TOL) and (sums_rel is None or sums_rel <= SUMS_RTOL),
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
    for nx, ny in BORDER_SHAPES:
        iref, imov = (x[:nx, :ny].contiguous() for x in pair_on(dev, "blob", max(nx, ny)))
        check_demons(err, dev, gen, iref, imov)
        g, small = elastic_inputs(dev, gen, iref, imov)
        check_elastic(err, g, small)
        check_diffusion(err, small, g)
        check_fluid(err, small, fluid_velocity(small), g)
    for n in HUGE_KERNEL_SHAPES:
        check_shape(err, dev, gen, *tiled_pair(n, dev), every=False)
        torch.cuda.empty_cache()
    check_wide_offsets(err, dev, gen)
    torch.cuda.empty_cache()
    check_upsample(err, dev, gen)
    torch.cuda.empty_cache()
    check_downsample(err, dev, gen)
    torch.cuda.empty_cache()
    for nx, ny in STRIP_SHAPES:
        iref, imov = (x[:nx, :ny].contiguous() for x in pair_on(dev, "blob", max(nx, ny)))
        check_strips(err, dev, gen, iref, imov)
    nx, ny = ODD_STRIPS
    iref, imov = (x[:nx, :ny].contiguous() for x in pair_on(dev, "blob", max(nx, ny)))
    g, small = elastic_inputs(dev, gen, iref, imov)
    check_elastic_strips(err, dev, g, small)
    check_diffusion_strips(err, dev, small, g)
    check_fluid_strips(err, dev, small, fluid_velocity(small), g)
    for nx, ny in BATCH_KERNEL_SHAPES:
        check_batch_kernels(err, dev, gen, nx, ny)
    return err


def batch_stack(dev, pair: str, n: int, count: int, nx: int | None = None,
                ny: int | None = None):
    """``count`` pairs of ``pair`` at n^2 (cropped to nx x ny), each
    shift's two components scaled by factors in [0.5, 1.5] from the seed:
    ``[count, nx, ny]`` stacks on ``dev`` and the factors. Both components
    are scaled apart: one factor for both would leave every relative
    Logger error, and so every count, as it is (the linearized problem is
    linear in the shift)."""
    factors = np.random.default_rng(SEED).uniform(0.5, 1.5, (count, 2))
    if pair == "tiled":
        pairs = [tiled_pair(n, dev, f) for f in factors]
    else:
        pairs = [tuple(torch.from_numpy(x).to(dev) for x in blob_pair(n, f)) for f in factors]
    nx, ny = nx or n, ny or n
    return (torch.stack([p[0][:nx, :ny] for p in pairs]).contiguous(),
            torch.stack([p[1][:nx, :ny] for p in pairs]).contiguous(), factors.tolist())


def check_pairs(err: dict, name: str, shape, pairs, got, single, plain, sums=None,
                **info) -> None:
    """Hold a batched launch's listed pairs against their own single-pair
    launches (fields and Logger sums bit for bit) and their plain versions
    (fields bit for bit, sums within SUMS_RTOL); ``got``, ``single`` and
    ``plain`` hold the fields, ``sums`` is ``(batched, single, plain)``, one
    entry a listed pair each. B4 has sums and no field (``got`` empty)."""
    torch.cuda.synchronize()
    e_single = max((max_abs(a, b) for a, b in zip(got, single)), default=0.0)
    e_plain = max((max_abs(a, b) for a, b in zip(got, plain)), default=0.0)
    rec = {"phase": "kernels", "kernel": name, "shape": list(shape), "pairs": pairs, **info,
           "max_abs_err": e_plain, "max_abs_err_single": e_single}
    ok = e_single == 0.0 and e_plain == 0.0
    if sums is not None:
        got_s, single_s, plain_s = sums
        rec["sums_equal_single"] = all(torch.equal(a, b) for a, b in zip(got_s, single_s))
        rec["sums_rel_err"] = max(rel_err(a, b) for a, b in zip(got_s, plain_s))
        if not got:  # the sums are the output: max_abs_err is theirs, as for B4
            e_plain = rec["max_abs_err"] = max(max_abs(a, b) for a, b in zip(got_s, plain_s))
        ok = ok and rec["sums_equal_single"] and rec["sums_rel_err"] <= SUMS_RTOL
    emit(rec)
    require(ok, f"{name} {shape} pairs {pairs} {info}: {rec}")
    err[name] = max(err[name], e_plain)


def check_batch_kernels(err: dict, dev, gen: torch.Generator, nx: int, ny: int) -> None:
    """B1 (k = 8 and 3), B2, B3 (warp, compose), B4, B5, B7 and U2 batched
    on BATCH_KERNEL_PAIRS pairs of blob pairs shifted apart: every pair,
    and a shuffled subset, each equal to its own single-pair launch and to
    the plain version (B4's sums: bit for bit against the single launch,
    within SUMS_RTOL of the plain version); B7 and U2 also leave the pairs
    they are not given unwritten."""
    count = len(BATCH_KERNEL_PAIRS[0])
    irefs, imovs, _ = batch_stack(dev, "blob", max(nx, ny), count, nx, ny)
    d = derivatives(irefs, imovs)
    g = stack_derivs(d.grad_i, d.it)
    del d
    fields = [demons_fields(dev, gen, nx, ny) for _ in range(count)]
    u = torch.stack([f[0] for f in fields])
    disp = torch.stack([f[1] for f in fields])
    u_total = torch.stack([f[2] for f in fields])
    shape = (count, nx, ny)
    for pairs in BATCH_KERNEL_PAIRS:
        for k in BATCH_KS:
            out, sums = diffusion_block_batch(u, g, ALPHA, k, pairs)
            ref, sums_ref = diffusion_block_batch_ref(u, g, ALPHA, k, pairs)
            singles = [diffusion_block(u[p], g[p], ALPHA, k) for p in pairs]
            check_pairs(err, "diffusion_block_batch", shape, pairs, [out[p] for p in pairs],
                        [s[0] for s in singles], [ref[p] for p in pairs],
                        (list(sums), [s[1] for s in singles], list(sums_ref)), k=k)
        out = diffusion_step_batch(u, g, ALPHA, pairs)
        ref = diffusion_step_batch_ref(u, g, ALPHA, pairs)
        check_pairs(err, "diffusion_step_batch", shape, pairs, [out[p] for p in pairs],
                    [diffusion_step_fused(u[p], g[p, :2], g[p, 2], ALPHA) for p in pairs],
                    [ref[p] for p in pairs])
        out = warp2d_batch(imovs, disp, pairs)
        ref = warp2d_batch_ref(imovs, disp, pairs)
        check_pairs(err, "warp2d_batch", shape, pairs, [out[p] for p in pairs],
                    [warp2d(imovs[p], disp[p]) for p in pairs], [ref[p] for p in pairs],
                    max_disp=float(disp.abs().max()))
        out = compose_batch(u_total, disp, pairs)
        ref = compose_batch_ref(u_total, disp, pairs)
        check_pairs(err, "compose_batch", shape, pairs, [out[p] for p in pairs],
                    [compose(u_total[p], disp[p]) for p in pairs], [ref[p] for p in pairs])
        sums = logger_norms_batch(u_total, disp, pairs)
        single = [logger_norms(u_total[p], disp[p]) for p in pairs]
        plain = logger_norms_batch_ref(u_total, disp, pairs)
        check_pairs(err, "logger_norms_batch", shape, pairs, [], [], [],
                    (list(sums), single, list(plain)))
        check_fluid_batch(err, shape, pairs, u, fluid_velocity(u), g)
        check_derive_batch(err, shape, pairs, irefs, imovs)


def check_derive_batch(err: dict, shape, pairs, irefs, imovs) -> None:
    """U2 batched on the listed pairs of a stack, into a NaN-filled output
    stack: pair ``p``'s ``g``, from ``irefs[p]`` and the list's ``z``-th
    warped image (``imovs[p]``), bit-equal to its single launch and to the
    plain version, each single launch bit-equal to the plain version too,
    and every pair left out of the list still NaN (unwritten)."""
    warped = imovs[list(pairs)].contiguous()  # in list order
    out = torch.full((irefs.shape[0], 3) + tuple(irefs.shape[1:]), float("nan"),
                     device=irefs.device)
    g = derive_batch(irefs, warped, pairs, out)
    plain = derive_batch_ref(irefs, warped, pairs)
    singles = [derive(irefs[p], warped[z]) for z, p in enumerate(pairs)]
    check_pairs(err, "derive_batch", shape, pairs, [g[p] for p in pairs], singles,
                [plain[p] for p in pairs])
    for z, p in enumerate(pairs):
        check(err, "derive", singles[z], derive_ref(irefs[p], warped[z]), shape[1:], exact=True)
    left = [p for p in range(irefs.shape[0]) if p not in pairs]
    require(all(bool(g[p].isnan().all()) for p in left),
            f"derive_batch {shape} pairs {pairs}: wrote a pair it was not given")


def check_fluid_batch(err: dict, shape, pairs, u, vel, g) -> None:
    """B7 and B5 batched on the listed pairs of a stack, into a NaN-filled
    velocity stack: each pair's vel', R and max |R|^2 and its three fluid
    metrics bit-equal to its single launch and to the plain version, and
    every pair left out of the list still NaN (unwritten)."""
    fill = torch.full_like(vel, float("nan"))
    for ref_stencil, bug in ((True, False), (False, True)):
        args = (u, vel, g, *FLUID, ref_stencil, bug)
        vel_out, r, maxsq = fluid_iter_batch(*args, pairs=pairs, vel_out=fill.clone())
        ref_vel, ref_r, ref_maxsq = fluid_iter_batch_ref(*args, pairs=pairs)
        singles = [fluid_iter(u[p], vel[p], g[p], *FLUID, ref_stencil, bug) for p in pairs]
        info = dict(reference_stencil=ref_stencil, maxabs_bug=bug)
        check_pairs(err, "fluid_iter_batch", shape, pairs,
                    [vel_out[p] for p in pairs] + list(r),
                    [s[0] for s in singles] + [s[1] for s in singles],
                    [ref_vel[p] for p in pairs] + list(ref_r), **info)
        require(all(torch.equal(maxsq[z], s[2]) and torch.equal(maxsq[z], ref_maxsq[z])
                    for z, s in enumerate(singles)),
                f"fluid_iter_batch {shape} pairs {pairs} {info}: max |R|^2 {maxsq} against "
                f"{[float(s[2]) for s in singles]} and {ref_maxsq}")
        left = [p for p in range(u.shape[0]) if p not in pairs]
        require(all(bool(vel_out[p].isnan().all()) for p in left),
                f"fluid_iter_batch {shape} pairs {pairs}: wrote a pair it was not given")
    metrics = fluid_metrics_batch(vel, u, pairs)
    single = [fluid_metrics(vel[p], u[p]) for p in pairs]
    plain = fluid_metrics_batch_ref(vel, u, pairs)
    check_pairs(err, "fluid_metrics_batch", shape, pairs, [], [], [],
                (list(metrics), single, list(plain)))
    require(all(torch.equal(metrics[z, 2], plain[z, 2]) for z in range(len(pairs))),
            f"fluid_metrics_batch {shape} pairs {pairs}: jac_min {metrics[:, 2]} against the "
            f"plain {plain[:, 2]}")


def check_one_pair(err: dict, u, g, u_total, disp) -> None:
    """B1 (at ONE_PAIR_KS), B2 and B4 by their pair-axis entries on a stack
    of one pair, as the level loop launches them for ``register``: into a
    given stack (NaN-filled here, so a pixel left unwritten shows), B1
    with no pair list. Each against its single entry (fields and sums bit
    for bit) and its plain version (fields bit for bit, sums within
    SUMS_RTOL)."""
    one = _build.Pairs([0], 1)
    shape = (1,) + tuple(u.shape[1:])
    u1, g1 = u[None], g[None]
    for k in ONE_PAIR_KS:
        out, sums = diffusion_block_batch(u1, g1, ALPHA, k, one,
                                          torch.full_like(u1, float("nan")))
        single, single_sums = diffusion_block(u, g, ALPHA, k)
        ref, ref_sums = diffusion_block_batch_ref(u1, g1, ALPHA, k, one)
        check_pairs(err, "diffusion_block_batch", shape, [0], [out[0]], [single], [ref[0]],
                    ([sums[0]], [single_sums], [ref_sums[0]]), k=k, one_pair=True)
        del out, single, ref
    out = diffusion_step_batch(u1, g1, ALPHA, one, torch.full_like(u1, float("nan")))
    check_pairs(err, "diffusion_step_batch", shape, [0], [out[0]],
                [diffusion_step_fused(u, g[:2], g[2], ALPHA)],
                [diffusion_step_batch_ref(u1, g1, ALPHA, one)[0]], one_pair=True)
    del out
    sums = logger_norms_batch(u_total[None], disp[None], one)
    check_pairs(err, "logger_norms_batch", shape, [0], [], [], [],
                ([sums[0]], [logger_norms(u_total, disp)],
                 [logger_norms_batch_ref(u_total[None], disp[None], one)[0]]), one_pair=True)


def batch_host_reads(method: Method, regparams, res) -> dict:
    """Host reads of a batch run: the lockstep driver reads once a block for
    all its active pairs, as many blocks as its slowest pair takes in each
    (level, refinement); map and the loop once a block a pair."""
    counts = [t.iterations.tolist() for t in res.traces]
    lockstep = sum(host_reads(method, regparams, max(c)) for c in counts)
    per_pair = sum(host_reads(method, regparams, n) for c in counts for n in c)
    return {"lockstep": lockstep, "per_pair": per_pair}


def drive_batch(dev, smi: str, name: str, method: Method, regparams, pair: str, n: int,
                count: int, nscales: int, niter: int, overrides: dict, impls, tol: float) -> dict:
    """One batch path: a Python loop of ``register`` over the pairs (the
    reference), then ``register_batch`` by each impl, each with the launch
    counts set to 0 just before it and read just after; every pair's counts
    equal to its own register's and its motion within ``tol`` px (0: bit
    for bit). Prints wall time, registrations a second, peak memory and
    host reads beside the card's name and power limit."""
    cfg = RegConfig.from_regparams(method, [niter] * (nscales + 1), nscales, regparams, NREFINE,
                                   **overrides)
    irefs, imovs, factors = batch_stack(dev, pair, n, count)

    def timed(run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(kernels.LAUNCHES)

    loop, wall, _ = timed(lambda: [register(irefs[i], imovs[i], cfg) for i in range(count)])
    want = [[t.iterations for t in r.traces] for r in loop]
    ssd = [float(ssd_reduction(irefs[i], imovs[i], loop[i].motion)) for i in range(count)]
    reads = sum(host_reads(method, regparams, c) for w in want for c in w)
    emit({"phase": "batch", "path": name, "impl": "loop", "card": smi, "pairs": count,
          "shape": [n, n], "wall_s": wall, "registrations_per_s": count / wall,
          "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
          "host_reads": reads, "pairs_per_host_read": 1.0, "iterations": want,
          "ssd_reduction": ssd, "shift_factors": factors})
    distinct = len({tuple(w) for w in want})
    if name == "batch_diffusion":
        require(distinct >= 2, f"{name}: every pair stopped at the same counts {want[0]}")
        require(min(ssd) >= SSD_BAR, f"{name}: SSD reduction {min(ssd)} < {SSD_BAR}")
    launches = {}
    for impl in impls:
        res, wall, launched = timed(lambda: register_batch(irefs, imovs, cfg, impl=impl))
        launches[f"{name}_{impl}"] = launched
        got = [[int(t.iterations[i]) for t in res.traces] for i in range(count)]
        err = max(max_abs(res.motion[i], loop[i].motion) for i in range(count))
        reads = batch_host_reads(method, regparams, res)
        lockstep = _resolve_impl(cfg, impl) == "vmap"
        emit({"phase": "batch", "path": name, "impl": impl,
              "resolved": _resolve_impl(cfg, impl), "card": smi, "pairs": count,
              "shape": [n, n], "wall_s": wall, "registrations_per_s": count / wall,
              "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
              "host_reads": reads["lockstep" if lockstep else "per_pair"],
              "pairs_per_host_read": reads["per_pair"] / reads["lockstep" if lockstep
                                                               else "per_pair"],
              "distinct_count_vectors": distinct, "max_abs_err_px": err,
              "counts_equal": got == want, "launches": launched})
        require(got == want, f"{name} {impl}: counts {got} against register's {want}")
        require(err <= tol, f"{name} {impl}: motion {err} px from register's (tol {tol})")
        require(tuple(res.motion.shape) == (count, 2, n, n)
                and bool(torch.isfinite(res.motion).all()), f"{name} {impl}: motion")
    if method == Method.FLUID:
        require(_resolve_impl(cfg, "auto", (n, n)) == "vmap", f"{name}: auto is not vmap")
    return launches


def phase_batch(dev, smi: str) -> dict:
    launches = {}
    for path in BATCH_PATHS:
        launches.update(drive_batch(dev, smi, *path))
        torch.cuda.empty_cache()
    return launches


def phase_utilities(dev, b1_ms: float) -> None:
    """register_resumable on the 4096^2 blob diffusion run, stopped after
    scale 2 and resumed, bit-equal to register with equal counts;
    kernel_timer on B1 at 4096^2 beside phase 6's median; debug_nans on an
    input with one NaN pixel."""
    iref, imov = pair_on(dev, "blob", N_MAIN)
    cfg = RegConfig.from_regparams(Method.DIFFUSION, [NITER] * (MAIN_NSCALES + 1),
                                   MAIN_NSCALES, [ALPHA], NREFINE)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resume.npz")
        require(register_resumable(iref, imov, cfg, path, _crash_after_scale=2) is None,
                "register_resumable did not stop after scale 2")
        resumed = register_resumable(iref, imov, cfg, path)
    resume_s = time.perf_counter() - t0
    straight = register(iref, imov, cfg)
    same = (torch.equal(resumed.motion, straight.motion)
            and [(t.scale, t.iterations) for t in resumed.traces]
            == [(t.scale, t.iterations) for t in straight.traces]
            and all(torch.equal(a.errors, b.errors)
                    for a, b in zip(resumed.traces, straight.traces)))
    emit({"phase": "utilities", "check": "register_resumable", "shape": [N_MAIN, N_MAIN],
          "crash_after_scale": 2, "seconds": resume_s, "bit_equal": same,
          "iterations": [t.iterations for t in resumed.traces]})
    require(same, "register_resumable differs from register")

    d = derivatives(iref, imov)
    g = stack_derivs(d.grad_i, d.it)
    u = torch.from_numpy(
        np.random.default_rng(SEED + 1).normal(0, 1, (2, N_MAIN, N_MAIN)).astype(np.float32)
    ).to(dev)
    k = RegConfig(method=Method.DIFFUSION, niter=(1,)).block_k
    per_call = kernel_timer(lambda v: diffusion_block(v, g, ALPHA, k)[0], u, 20, 100, 3)
    emit({"phase": "utilities", "check": "kernel_timer", "kernel": "diffusion_block",
          "shape": [N_MAIN, N_MAIN], "k": k, "kernel_timer_ms": per_call * 1e3,
          "phase6_median_ms": b1_ms})
    require(np.isfinite(per_call) and per_call > 0, f"kernel_timer gave {per_call}")

    iref, imov = pair_on(dev, "blob", N_BATCH)
    imov = imov.clone()
    imov[N_BATCH // 3, N_BATCH // 2] = float("nan")
    message = None
    with debug_nans():
        try:
            register(iref, imov, RegConfig.from_regparams(
                Method.DIFFUSION, [NITER] * 3, 2, [ALPHA], NREFINE))
        except FloatingPointError as e:  # the check: it must raise
            message = str(e)
    emit({"phase": "utilities", "check": "debug_nans", "raised": message})
    require(message is not None and "scale 2, refinement 0" in message,
            f"debug_nans did not name the coarsest level: {message}")


def library_solvers(nx: int, ny: int) -> dict:
    """The spectral routes at one shape, each built once: the curvature
    solve by the matmul and the fft route, the periodic Navier-Lame solve
    at fluid's parameters and the Dirichlet one at elastic's."""
    return {
        "curvature_matmul": make_curvature_solve(nx, ny, *CURVATURE, dct_impl="matmul"),
        "curvature_fft": make_curvature_solve(nx, ny, *CURVATURE, dct_impl="fft"),
        "navier_lame_periodic": make_spectral_navier_lame_solver(nx, ny, *FLUID[:2]),
        "navier_lame_dirichlet": make_dirichlet_navier_lame_solver(nx, ny, *ELASTIC[:2]),
    }


LIBRARY_SHAPES = {"curvature_matmul": ((N_MAIN, N_MAIN), KERNEL_SHAPES[-1]),
                  "curvature_fft": ((N_MAIN, N_MAIN), KERNEL_SHAPES[-1]),
                  "navier_lame_periodic": ((N_MAIN, N_MAIN), KERNEL_SHAPES[-1]),
                  "navier_lame_dirichlet": ((N_DIRICHLET, N_DIRICHLET),)}


def tf32_flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def set_tf32(flags) -> None:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def input_rounding_noise(solve, f: torch.Tensor, out: torch.Tensor) -> float:
    """How far ``solve`` on the CPU moves when its input is scaled by 1 +
    1e-7 and rounded again (each element moves by up to half an ulp): the
    float32 solve's own sensitivity to rounding, of max |out|. The
    Dirichlet system's condition grows as n^2: at 1024^2 this is 2.8e-5
    (probes/spectral_paths.py on the CPU)."""
    return rel_max(solve((f.double() * (1 + 1e-7)).float()), out)


def phase_library(dev) -> dict:
    """The spectral routes (cuBLAS, cuFFT; no kernel of their own) on the
    card at the main paths' shapes against their CPU run, each also run
    with the caller's TF32 switches on (cuBLAS and cuDNN), which must give
    the same bits and be restored after; and the fft route against the
    matmul route on the card. Returns each route's largest difference from
    the CPU."""
    rng = np.random.default_rng(SEED + 2)
    worst = {name: 0.0 for name in LIBRARY_SHAPES}
    shapes = sorted({sh for v in LIBRARY_SHAPES.values() for sh in v})
    # Does TF32 change a plain float32 matmul on this build and card? If not,
    # the invariance below holds trivially.
    a = torch.randn((1024, 1024), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    before = tf32_flags()
    set_tf32((True, True))
    try:
        tf32_mm = a @ a
    finally:
        set_tf32(before)
    emit({"phase": "library", "tf32_changes_a_plain_matmul": not torch.equal(tf32_mm, a @ a)})
    for nx, ny in shapes:
        f = torch.from_numpy(rng.standard_normal((2, nx, ny)).astype(np.float32))
        f_dev = f.to(dev)
        outs = {}
        for name, solve in library_solvers(nx, ny).items():
            if (nx, ny) not in LIBRARY_SHAPES[name]:
                continue
            t0 = time.perf_counter()
            cpu = solve(f)
            cpu_s = time.perf_counter() - t0
            outs[name] = gpu = solve(f_dev)
            set_tf32((True, True))
            try:
                tf32 = solve(f_dev)
                inside = tf32_flags()
            finally:
                set_tf32(before)
            torch.cuda.synchronize()
            e = rel_max(gpu.cpu(), cpu)
            same = torch.equal(tf32, gpu)
            noise = input_rounding_noise(solve, f, cpu) if e > LIBRARY_RTOL else None
            emit({"phase": "library", "route": name, "shape": [nx, ny], "rel_err_vs_cpu": e,
                  "input_rounding_noise": noise, "tf32_on_bit_equal": same,
                  "caller_flags_kept": inside == (True, True), "cpu_s": cpu_s})
            require(e <= LIBRARY_RTOL or e <= NOISE_FACTOR * noise,
                    f"{name} {(nx, ny)}: GPU vs CPU {e}, input rounding noise {noise}")
            require(same, f"{name} {(nx, ny)}: the caller's TF32 changed the result")
            require(inside == (True, True) and tf32_flags() == before,
                    f"{name}: the caller's TF32 switches were not restored")
            worst[name] = max(worst[name], e)
            del cpu, tf32
        if "curvature_fft" in outs:
            e = rel_max(outs["curvature_fft"], outs["curvature_matmul"])
            emit({"phase": "library", "route": "curvature_fft", "against": "curvature_matmul",
                  "shape": [nx, ny], "rel_err": e})
            require(e <= LIBRARY_RTOL, f"curvature fft vs matmul {(nx, ny)}: {e}")
        del f, f_dev, outs
        torch.cuda.empty_cache()
    return worst


def elastic_inputs(dev, gen: torch.Generator, iref, imov):
    """g of the pair and a field of up to 1.5 px from ``gen``."""
    d = derivatives(iref, imov)
    u = torch.randn((2, *iref.shape), generator=gen, device=dev) * 2
    return stack_derivs(d.grad_i, d.it), (torch.tanh(u) * 1.5).contiguous()


def check_elastic(err: dict, g, small) -> None:
    """B6 at each of ELASTIC_KS with either stencil, bit for bit."""
    for k in ELASTIC_KS:
        for ref_stencil in (True, False):
            args = (small, g, *ELASTIC, ref_stencil, k)
            check(err, "elastic_block", elastic_block(*args), elastic_block_ref(*args),
                  small.shape[1:], exact=True, k=k, reference_stencil=ref_stencil,
                  plan=k_el.elastic_plan(k))


def check_diffusion(err: dict, u, g) -> None:
    """B1 at each of DIFFUSION_KS, bit for bit."""
    for k in DIFFUSION_KS:
        check(err, "diffusion_block", diffusion_block(u, g, ALPHA, k),
              diffusion_block_ref(u, g, ALPHA, k), u.shape[1:], exact=True, k=k,
              plan=k_diff.diffusion_plan(k))


def check_diffusion_strips(err: dict, dev, u, g) -> None:
    """K1 on SP_STRIPS strips at each of DIFFUSION_KS on its pad, and at a
    rerun of 3 on the k = 8 pad (a stop inside a block): each strip against
    its plain version and the strips together against B1's rows, bit for
    bit, and their sums against B1's."""
    nx = u.shape[1]
    nxl = nx // SP_STRIPS
    shape = tuple(u.shape[1:])
    for k, pad in [(k, k_diff.required_pad(k)) for k in DIFFUSION_KS] + [(3, 8)]:
        up, gp = strip_inputs(dev, pad, u, g)
        outs = []
        for s in range(SP_STRIPS):
            args = (up[s], gp[s], s * nxl, nx, ALPHA, k, pad)
            outs.append(k_diff.diffusion_block_strip(*args))
            check(err, "diffusion_block_strip", outs[-1], k_diff.diffusion_block_strip_ref(*args),
                  shape, exact=True, k=k, pad=pad, row0=s * nxl)
        dense, dense_sums = diffusion_block(u, g, ALPHA, k)
        check_rows("diffusion_block_strip", (o[0] for o in outs), dense, shape, exact=True, k=k,
                   pad=pad)
        e = rel_err(sum(o[1] for o in outs), dense_sums)
        require(e <= SUMS_RTOL, f"diffusion_block_strip {shape} k {k}: strips' sums {e}")
        del up, gp, outs, dense


def fluid_velocity(u):
    """A nonzero velocity of up to 0.3 from a field."""
    return (torch.tanh(u.flip(1)) * 0.3).contiguous()


def check_fluid(err: dict, small, vel, g) -> None:
    """B7 and B8 with either stencil and either maxabs, bit for bit; B8's
    vel' and max |R|^2 also against B7's."""
    shape = tuple(small.shape[1:])
    for ref_stencil in (True, False):
        for bug in (False, True):
            info = dict(reference_stencil=ref_stencil, maxabs_bug=bug)
            args = (small, vel, g, *FLUID, ref_stencil, bug)
            v, r, m = fluid_iter(*args)
            v_ref, r_ref, m_ref = fluid_iter_ref(*args)
            check(err, "fluid_iter", v, v_ref, shape, exact=True, out="vel", **info)
            check(err, "fluid_iter", r, r_ref, shape, exact=True, out="R", **info)
            check_scalar("fluid_iter", m, m_ref, shape, exact=True, out="max|R|^2", **info)
            del r, v_ref, r_ref
            v8, m8 = fluid_sweep_max(*args)
            v8_ref, m8_ref = fluid_sweep_max_ref(*args)
            check(err, "fluid_sweep_max", v8, v8_ref, shape, exact=True, out="vel", **info)
            check_scalar("fluid_sweep_max", m8, m8_ref, shape, exact=True, out="max|R|^2",
                         **info)
            require(torch.equal(v8, v) and torch.equal(m8, m),
                    f"fluid_sweep_max {shape}: vel' or max|R|^2 differs from fluid_iter's")
            del v, v8, v8_ref


def check_fluid_strips(err: dict, dev, small, vel, g) -> None:
    """K3 on SP_STRIPS strips with either stencil and either maxabs: each
    strip against its plain version and the strips together against B7's
    rows, bit for bit; the strips' max |R|^2 equals B7's."""
    nx = small.shape[1]
    nxl = nx // SP_STRIPS
    shape = tuple(small.shape[1:])
    sp, vp, gp = strip_inputs(dev, k_fl.FLUID_PAD, small, vel, g)
    for ref_stencil in (True, False):
        for bug in (False, True):
            outs = []
            for s in range(SP_STRIPS):
                args = (sp[s], vp[s], gp[s], s * nxl, nx, *FLUID, ref_stencil, bug)
                outs.append(k_fl.fluid_iter_strip(*args))
                want = k_fl.fluid_iter_strip_ref(*args)
                info = dict(reference_stencil=ref_stencil, maxabs_bug=bug, row0=s * nxl)
                check(err, "fluid_iter_strip", outs[-1][0], want[0], shape, exact=True,
                      out="vel", **info)
                check(err, "fluid_iter_strip", outs[-1][1], want[1], shape, exact=True,
                      out="R", **info)
                check_scalar("fluid_iter_strip", outs[-1][2], want[2], shape, exact=True,
                             out="max|R|^2", **info)
            dense = fluid_iter(small, vel, g, *FLUID, ref_stencil, bug)
            info = dict(reference_stencil=ref_stencil, maxabs_bug=bug)
            check_rows("fluid_iter_strip", (o[0] for o in outs), dense[0], shape, exact=True,
                       out="vel", **info)
            check_rows("fluid_iter_strip", (o[1] for o in outs), dense[1], shape, exact=True,
                       out="R", **info)
            m = torch.stack([o[2] for o in outs]).max()
            require(torch.equal(m, dense[2]),
                    f"fluid_iter_strip {shape} {info}: the strips' max|R|^2 differs from B7's")


def check_elastic_strips(err: dict, dev, g, small) -> None:
    """K2 on SP_STRIPS strips at each of ELASTIC_KS with either stencil, each
    strip against its plain version and the strips together against B6's
    rows, bit for bit."""
    nx = small.shape[1]
    nxl = nx // SP_STRIPS
    shape = tuple(small.shape[1:])
    for k in ELASTIC_KS:
        sp, gp = strip_inputs(dev, k_el.required_pad(k), small, g)
        for ref_stencil in (True, False):
            outs = []
            for s in range(SP_STRIPS):
                args = (sp[s], gp[s], s * nxl, nx, *ELASTIC, ref_stencil, k)
                outs.append(k_el.elastic_block_strip(*args))
                check(err, "elastic_block_strip", outs[-1], k_el.elastic_block_strip_ref(*args),
                      shape, exact=True, k=k, reference_stencil=ref_stencil, row0=s * nxl)
            dense, _ = elastic_block(small, g, *ELASTIC, ref_stencil, k)
            check_rows("elastic_block_strip", (o[0] for o in outs), dense, shape, exact=True,
                       k=k, reference_stencil=ref_stencil)


def strip_inputs(dev, pad: int, *fields):
    """Each field cut into SP_STRIPS strips, each padded with ``pad`` halo
    rows a side by the strip driver's exchange."""
    return [spatial._halo_pad(spatial._split(f, [dev] * SP_STRIPS), pad) for f in fields]


def check_rows(name: str, strips, dense: torch.Tensor, shape, exact: bool = False,
               **info) -> None:
    """The strips' outputs, concatenated, against the dense kernel's;
    ``exact``: bit for bit."""
    got = torch.cat(list(strips), dim=-2)
    torch.cuda.synchronize()
    e = max_abs(got, dense)
    emit({"phase": "kernels", "kernel": name, "shape": list(shape), "against": "dense rows",
          **info, "max_abs_err": e, "bit_equal": bool(torch.equal(got, dense))})
    require(e <= (0.0 if exact else FIELD_TOL),
            f"{name} {shape} {info}: strips differ from the dense kernel by {e}")


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

    check_diffusion_strips(err, dev, u, g)
    check_elastic_strips(err, dev, g, small)

    check_fluid_strips(err, dev, small, fluid_velocity(u), g)
    del g

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
    del ip, tp, total
    check_demons_strips(err, dev, imov, iref, (torch.tanh(u) * 2.0).contiguous(), far)


def check_demons_strips(err: dict, dev, imov, iref, small, far) -> None:
    """K5-K7 on SP_STRIPS strips at halo SP_HALO, each kernelwidth of
    DEMONS_KWS, each padded by its exact reach: displacements of up to 2 px (inside the
    contract) against the plain versions and, concatenated, bit for bit
    against B10-B12; the +-40 px field (mostly outside it) against the plain
    versions only."""
    nx = imov.shape[0]
    shape, nxl, halo = tuple(imov.shape), nx // SP_STRIPS, SP_HALO
    c_small = (small.flip(1) * 0.5).contiguous()
    for kw in DEMONS_KWS:
        onepass = (*ONEPASS_ARGS[:4], kw)
        corr = (DIFFEO_PARAMS[0], DIFFEO_PARAMS[1], DIFFEO_PARAMS[3], kw)
        sd = DIFFEO_PARAMS[2]
        cases = (
            ("demons_onepass_strip", k_op.thirion_onepass_strip, k_op.thirion_onepass_strip_ref,
             k_op.onepass_strip_pad(halo, kw), onepass,
             lambda f: (imov, iref, f), lambda f: thirion_onepass(imov, iref, f, *onepass)),
            ("demons_correspondence_strip", k_df.demons_correspondence_strip,
             k_df.demons_correspondence_strip_ref, k_df.correspondence_strip_pad(halo, kw), corr,
             lambda f: (imov, iref, f), lambda f: demons_correspondence(imov, iref, f, *corr)),
            ("compose_smooth_strip", k_df.compose_smooth_strip, k_df.compose_smooth_strip_ref,
             k_df.compose_smooth_strip_pad(halo, kw), (sd, kw),
             lambda f: (small, f), lambda f: compose_smooth(small, f, sd, kw)),
        )
        for name, fn, ref, pad, params, fields, dense in cases:
            field_in = c_small if name == "compose_smooth_strip" else small
            for contract, f in (("inside", field_in), ("outside", far)):
                padded = strip_inputs(dev, pad, *fields(f))
                outs = []
                for s in range(SP_STRIPS):
                    args = (*(p[s] for p in padded), s * nxl, nx, *params, halo, pad)
                    outs.append(fn(*args))
                    check(err, name, outs[-1], ref(*args), shape, kw=kw, halo=halo, pad=pad,
                          contract=contract, row0=s * nxl)
                if contract == "inside":
                    dense_out = dense(f)
                    check_rows(name, outs, dense_out, shape, kw=kw, halo=halo)
                    require(torch.equal(torch.cat(outs, dim=-2), dense_out),
                            f"{name} {shape} kw {kw}: the strips are not B10-B12's rows bit "
                            f"for bit inside the contract")
                del padded, outs


def check_shape(err: dict, dev, gen: torch.Generator, iref, imov, every: bool) -> None:
    """The kernels at the pair's shape: all of them if ``every``, else the
    fluid path's (B3, B5, B7-B9). Fields from ``gen``; each plain version's
    result is dropped after its check, so that 16384^2 fits."""
    nx, ny = shape = tuple(iref.shape)
    d = derivatives(iref, imov)
    g = stack_derivs(d.grad_i, d.it)
    del d
    u, disp, u_total = demons_fields(dev, gen, nx, ny)
    if every:
        check_diffusion(err, u, g)
        check(err, "diffusion_step", diffusion_step_fused(u, g[:2], g[2], ALPHA),
              diffusion_step_ref(u, g[:2], g[2], ALPHA), shape)

    i = torch.arange(nx, device=dev, dtype=torch.float32)[:, None]
    oob = float((((i + disp[0]) < 0) | ((i + disp[0]) >= nx)).float().mean())
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

        check_one_pair(err, u, g, u_total, disp)
        check_demons(err, dev, gen, iref, imov, small, disp, u_total)

        # Elastic and fluid: a field of up to 1.5 px (and, for fluid, a
        # nonzero velocity).
        check_elastic(err, g, small)
    del disp, u_total
    vel = fluid_velocity(u)
    check_fluid(err, small, vel, g)
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


def check_wide_offsets(err: dict, dev, gen: torch.Generator) -> None:
    """B12 and K7 where twice an input plane reaches 2^31 floats, so that
    they take 64-bit tap offsets: a 16384 x 65536 field, and the same field
    as one strip of its inner rows padded by K7's reach. Each is held on 64
    rows near its end against K7's plain version on those rows, given their
    global index: inside the contract (the field is under 2 px) those are
    B12's rows, and their coordinates round as the kernel's do."""
    nx, ny, rows, sd = 16384, 65536, 64, DIFFEO_PARAMS[2]
    pad = k_df.compose_smooth_strip_pad(SP_HALO, KW)
    u = torch.zeros((2, nx, ny), device=dev)
    u[:, pad:-pad] = torch.randn((2, nx - 2 * pad, ny), generator=gen, device=dev)
    c = (torch.tanh(u.roll(1, -1)) * 1.5).contiguous()
    for name, fn, nx_img, off in (
            ("compose_smooth", lambda: compose_smooth(u, c, sd, KW), nx, 0),
            ("compose_smooth_strip",
             lambda: k_df.compose_smooth_strip(u, c, 0, nx - 2 * pad, sd, KW, SP_HALO, pad),
             nx - 2 * pad, pad)):
        got = fn()
        g0 = nx_img - 4 * rows  # the rows' global index; padded row g0 + off
        want = k_df.compose_smooth_strip_ref(
            u[:, g0 + off - pad:g0 + off + rows + pad].contiguous(),
            c[:, g0 + off - pad:g0 + off + rows + pad].contiguous(), g0, nx_img, sd, KW,
            SP_HALO, pad)
        check(err, name, got[:, g0:g0 + rows], want, (nx_img, ny), kw=KW, offsets="64-bit",
              rows=[g0, g0 + rows])
        del got


# The motion upsample's shapes: the cell's four levels to 4096^2, the
# 16384^2 path's last, and odd, non-square and one-column ones.
UPSAMPLE_SHAPES = (((256, 256), (4096, 4096)), ((512, 512), (4096, 4096)),
                   ((1024, 1024), (4096, 4096)), ((2048, 2048), (4096, 4096)),
                   ((8192, 8192), (16384, 16384)), ((21, 17), (41, 33)), ((5, 7), (64, 48)),
                   ((300, 1), (600, 7)))


def check_upsample(err: dict, dev, gen: torch.Generator) -> None:
    """The motion upsample against its plain version bit for bit, signed
    zeros included, on a field of 3 px with a tenth of its values exact
    zeros of either sign."""
    for src, dst in UPSAMPLE_SHAPES:
        u = torch.randn((2,) + src, generator=gen, device=dev) * 3
        u.view(-1)[::10] = 0.0
        u.view(-1)[5::20] = -0.0
        got, want = upsample_motion(u, dst), upsample_motion_ref(u, dst)
        check(err, "upsample_motion", got, want, dst, exact=True, source=list(src))
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"upsample_motion {src} -> {dst}: the bits differ")
        del got, want


# The box downsample's inputs and the levels of an image and of a field:
# the slide cell's 4096^2 and the fluid cell's 16384^2 to the pyramid's 4
# levels and the seeds' 3, and a ragged 1000x777 to level 6, whose 66 x 64
# patches take the direct route.
DOWNSAMPLE_SHAPES = (((4096, 4096), 4, 3), ((16384, 16384), 4, 3), ((1000, 777), 6, 6))


def check_downsample(err: dict, dev, gen: torch.Generator) -> None:
    """The box downsample against its plain version bit for bit: an image
    of values in [0, 1), and a field of 3 px with a tenth of its values
    exact zeros of either sign."""
    for shape, levels, field_levels in DOWNSAMPLE_SHAPES:
        dims = pyramid_dims(shape, levels)
        image = torch.rand(shape, generator=gen, device=dev)
        u = torch.randn((2,) + shape, generator=gen, device=dev) * 3
        u.view(-1)[::10] = 0.0
        u.view(-1)[5::20] = -0.0
        for level in range(1, levels + 1):
            cases = [("image", downsample_image, downsample_image_ref, image)]
            if level <= field_levels:
                cases.append(("motion", downsample_motion, downsample_motion_ref, u))
            for what, kern, plain, x in cases:
                got, want = kern(x, dims[level]), plain(x, dims[level])
                check(err, "downsample", got, want, dims[level], exact=True,
                      source=list(x.shape), input=what)
                require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                        f"downsample {what} {shape} -> {dims[level]}: the bits differ")
                del got, want
        del image, u


def demons_fields(dev, gen: torch.Generator, nx: int, ny: int):
    """Fields from ``gen``: noise of 2 px, a displacement of up to +-40 px
    (a smooth field plus noise, so that samples fall inside, on the edges
    and outside the grid) and a motion of 5 px noise."""
    u = torch.randn((2, nx, ny), generator=gen, device=dev) * 2
    i = torch.arange(nx, device=dev, dtype=torch.float32)[:, None] / nx
    j = torch.arange(ny, device=dev, dtype=torch.float32)[None, :] / ny
    disp = torch.stack([30 * torch.sin(6 * j + 1) * torch.cos(4 * i),
                        30 * torch.cos(5 * i + 2) * torch.sin(3 * j)])
    disp += torch.rand((2, nx, ny), generator=gen, device=dev) * 20 - 10
    u_total = torch.randn((2, nx, ny), generator=gen, device=dev) * 5
    return u, disp, u_total


def check_demons(err: dict, dev, gen: torch.Generator, iref, imov, small=None, disp=None,
                 u_total=None) -> None:
    """B10-B12 at every width of DEMONS_KWS, with a small field of up to
    1.5 px (the main path's increments) and the +-40 px one (from
    ``demons_fields`` where not given)."""
    shape = tuple(iref.shape)
    if small is None:
        u, disp, u_total = demons_fields(dev, gen, *shape)
        small = (torch.tanh(u) * 1.5).contiguous()
    for kw in DEMONS_KWS:
        for name, field in (("small", small), ("oob", disp)):
            for addition in (False, True):
                args = (imov, iref, field, 1.0, 0.25, 2.0, 1.5, kw, addition, True)
                check(err, "demons_onepass", thirion_onepass(*args), thirion_onepass_ref(*args),
                      shape, kw=kw, u=name, addition=addition)
            args = (imov, iref, field, 0.25, 1.0, 2.0, kw)
            check(err, "demons_correspondence", demons_correspondence(*args),
                  demons_correspondence_ref(*args), shape, kw=kw, u=name)
            check(err, "compose_smooth", compose_smooth(u_total, field, 2.0, kw),
                  compose_smooth_ref(u_total, field, 2.0, kw), shape, kw=kw, c=name)


def check_scalar(name: str, got: torch.Tensor, want: torch.Tensor, shape, exact: bool = False,
                 **info) -> None:
    """Hold a kernel's scalar (max |R|^2, the minimum Jacobian determinant)
    against its plain version's, relatively; ``exact``: bit for bit."""
    e = rel_err(got.reshape(1), want.reshape(1))
    emit({"phase": "kernels", "kernel": name, "shape": list(shape), **info,
          "value": float(got), "rel_err": e})
    require(e <= (0.0 if exact else SCALAR_RTOL), f"{name} {shape} {info}: relative error {e}")


def host_reads(method: Method, regparams, iterations: int, spectral: bool = False) -> int:
    """Device-to-host reads a (level, refinement) of a path makes: the
    blocked drivers read the Logger sums once a block (8 diffusion or 4
    elastic iterations); curvature and the spectral elastic solves once an
    iteration (blocks of one); demons once an iteration, twice on the
    two-kernel route (the exp map's maxabs); fluid once an iteration (the
    Logger sums and the minimum Jacobian determinant together)."""
    if method == Method.DIFFUSION:
        return -(-iterations // 8)
    if method == Method.ELASTIC and not spectral:
        return -(-iterations // ELASTIC_K)
    if method in (Method.FLUID, Method.ELASTIC, Method.CURVATURE):
        return iterations
    route = demons_route(regparams[0], regparams[1], int(regparams[4]),
                         method == Method.DIFFEOMORPHIC_DEMONS)
    return iterations * (2 if route == "two_kernel" else 1)


def pair_on(dev, pair: str, n: int):
    if pair == "tiled":
        return tiled_pair(n, dev)
    return tuple(torch.from_numpy(x).to(dev) for x in blob_pair(n))


def run_main(dev, method: Method, regparams, nscales: int, iref, imov, niter: int = NITER,
             **overrides):
    n = iref.shape[0]
    sess = OpticalFlow2d((n, n), niter=[niter] * (nscales + 1),
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
    spectral = overrides.get("navier_lame_solver", "sor") != "sor"
    emit({"phase": "main", "path": path, "shape": [n, n], "nscales": nscales,
          "regparams": regparams, **overrides, "wall_s": wall, "iterations": iterations,
          "regrids": [t.regrids for t in res.traces],
          "host_reads_per_level": [host_reads(method, regparams, n, spectral)
                                   for n in iterations],
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
    for family, (path, method, regparams, pair, nscales) in TILED_DENSE.items():
        launches[path], dense[family] = drive_main(dev, path, method, regparams, nscales,
                                                   *pair_on(dev, pair, N_MAIN))
    for name, family, params, _, _ in SP_PATHS:
        launches[name] = drive_sp(dev, name, family, params, dense[family])
    launches.update(drive_spectral(dev))
    return launches


def drive_spectral(dev) -> dict:
    """The spectral paths (SPECTRAL_PATHS) and sp_curvature, each with its
    launches read as the other main paths' are: warp, compose
    and the Logger norms (fluid: the fluid metrics) on every dense path, no
    block or fluid-iteration kernel; the strip warp and compose on
    sp_curvature. Each iteration is one solve of its library route."""
    launches = {}
    dense = {}
    for name, method, regparams, pair, n, nscales, niter, overrides in SPECTRAL_PATHS:
        launches[name], dense[name] = drive_main(dev, name, method, regparams, nscales,
                                                 *pair_on(dev, pair, n), niter=niter,
                                                 **overrides)
        check_spectral_launches(name, launches[name], dense[name])
    # Beside the dense curvature run: the same route ("auto" is the dense
    # transform) at the same cap.
    name, family, params = SP_CURVATURE
    launches[name] = drive_sp(dev, name, family, params, dense["curvature"], CURVATURE_NITER)
    return launches


def check_spectral_launches(name: str, launches: dict, res) -> None:
    want, none = SPECTRAL_KERNELS[name], NOT_ON_SPECTRAL
    emit({"phase": "main", "path": name, "library_solves": sum(t.iterations for t in res.traces),
          "must_launch": want, "must_not_launch": none})
    require(all(launches[k] > 0 for k in want), f"{name}: launched no {want}: {launches}")
    require(not any(launches[k] for k in none), f"{name}: launched one of {none}: {launches}")


def sp_solver(devices, family: str, params: dict, nscales: int, niter: int = NITER):
    """make_register_sp at the settings of the strip paths, on SP_STRIPS
    strips over ``devices``."""
    return make_register_sp(make_mesh(x=SP_STRIPS, devices=devices), family,
                            niter=[niter] * (nscales + 1), nscales=nscales, nrefine=NREFINE,
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
    iteration (the Logger error and the minimum Jacobian determinant);
    the demons once an iteration (the Logger error), diffeomorphic twice
    (and the exp map's maxabs); curvature once an iteration (the Logger
    error)."""
    if family in ("fluid", "thirions", "curvature"):
        return iterations
    if family == "diffeo":
        return 2 * iterations
    return -(-iterations // (8 if family == "diffusion" else 4))


def drive_sp(dev, name: str, family: str, params: dict, dense, niter: int = NITER) -> dict:
    """A strip-parallel path at 4096^2 with the launch counts set to 0 just
    before it; its checks, its launches read just after, and its
    difference from the dense run of its family on the same pair."""
    iref, imov = tiled_pair(N_MAIN, dev)
    solve = sp_solver([dev] * SP_STRIPS, family, params, TILED_NSCALES, niter)
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
    used = SP_KERNEL[family] + ("warp2d_strip", "compose_strip")
    reads = [sp_host_reads(family, n) for n in res.iterations]
    emit({"phase": "main", "path": name, "shape": [N_MAIN, N_MAIN], "strips": SP_STRIPS,
          "nscales": TILED_NSCALES, "params": params, "niter": niter, "wall_s": wall,
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
    if family in ("thirions", "diffeo"):
        want = SP_STRIPS * sum(res.iterations)
        require(all(launches[k] == want for k in SP_KERNEL[family]),
                f"{name}: {SP_KERNEL[family]} launches {launches} against {want} "
                f"(strips x iterations)")
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
    # Device time of the concatenations: the strips' halo pads, with the
    # pyramid's and the gathers' copies.
    cat_us = sum(r.self_device_time_total for r in rows
                 if r.device_type.name == "CUDA" and "Cat" in r.key)
    # Device time of the library routes: cuBLAS's matmul kernels and cuFFT's.
    library = {"cublas_ms": 0.0, "cufft_ms": 0.0}
    for r in rows:
        key = r.key.lower()
        if r.device_type.name != "CUDA" or r.self_device_time_total <= 0:
            continue
        if "fft" in key:
            library["cufft_ms"] += r.self_device_time_total / 1e3
        elif "gemm" in key or "xmma" in key or "cutlass" in key:
            library["cublas_ms"] += r.self_device_time_total / 1e3
    # Device time and launches of each of the port's kernels by function
    # (they live in anonymous namespaces; PyTorch's in at::native).
    ours = {}
    for r in rows:
        key = r.key.removeprefix("void ")
        if r.self_device_time_total > 0 and key.startswith("(anonymous namespace)::"):
            name = key.split("::", 1)[1].split("<")[0].split("(")[0]
            ms, count = ours.get(name, (0.0, 0))
            ours[name] = (ms + r.self_device_time_total / 1e3, count + r.count)
    emit({"phase": "profile", "path": path, "wall_s": profiled_wall,
          "device_ms": device_us / 1e3, "busy_share": device_us / 1e6 / profiled_wall,
          "iterations": sum(iterations), "regrids": sum(regrids),
          "stream_syncs": syncs,
          "syncs_per_iteration": syncs / sum(iterations),
          "cat_ms": cat_us / 1e3, "cat_share": cat_us / max(device_us, 1e-9), **library,
          "top": [{"name": r.key[:60], "ms": r.self_device_time_total / 1e3,
                   "count": r.count} for r in top],
          "port_kernels": {name: {"ms": ms, "count": count}
                           for name, (ms, count) in sorted(ours.items())}})


def phase_profile(dev, path: str, niter: int = NITER) -> None:
    """A dense main path (PATHS or TILED_DENSE) under the profiler, with
    ``niter`` iterations a level at most."""
    _, method, regparams, pair, nscales = next(p for p in PATHS + tuple(TILED_DENSE.values())
                                               if p[0] == path)
    iref, imov = pair_on(dev, pair, N_MAIN)

    def run():
        _, res, _, _, _ = run_main(dev, method, regparams, nscales, iref, imov, niter)
        return [t.iterations for t in res.traces], [t.regrids for t in res.traces]

    profile_run(path, run)


def phase_profile_spectral(dev, path: str) -> None:
    """A spectral path (SPECTRAL_PATHS) under the profiler."""
    _, method, regparams, pair, n, nscales, niter, overrides = next(p for p in SPECTRAL_PATHS
                                                                    if p[0] == path)
    iref, imov = pair_on(dev, pair, n)

    def run():
        _, res, _, _, _ = run_main(dev, method, regparams, nscales, iref, imov, niter,
                                   **overrides)
        return [t.iterations for t in res.traces], [t.regrids for t in res.traces]

    profile_run(path, run)


def phase_profile_sp(dev, name: str) -> None:
    """A strip-parallel path (SP_PATHS, SP_CURVATURE) under the profiler;
    the demons paths with DEMONS_PROFILE_NITER iterations a level at most,
    sp_curvature at its cap."""
    if name == SP_CURVATURE[0]:
        _, family, params = SP_CURVATURE
    else:
        _, family, params, _, _ = next(p for p in SP_PATHS if p[0] == name)
    iref, imov = tiled_pair(N_MAIN, dev)
    niter = {"thirions": DEMONS_PROFILE_NITER, "diffeo": DEMONS_PROFILE_NITER,
             "curvature": CURVATURE_NITER}.get(family, NITER)
    solve = sp_solver([dev] * SP_STRIPS, family, params, TILED_NSCALES, niter)

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
    for name, family, params, _, _ in SP_PATHS + (SP_CURVATURE + (None, None),):
        launches[name] = parity_sp(dev, name, family, params)
    launches.update(parity_spectral(dev))
    return launches


def parity_spectral(dev) -> dict:
    """The spectral paths at 512^2, CPU against GPU (curvature by each
    route), and the curvature fft route against the matmul route on the
    card: motion within PARITY_TOL, equal iteration and regrid counts."""
    runs = [(f"curvature_{impl}", Method.CURVATURE, CURVATURE, "tiled", dict(dct_impl=impl))
            for impl in ("matmul", "fft")]
    runs += [(name, method, regparams, pair, overrides)
             for name, method, regparams, pair, _, _, _, overrides in SPECTRAL_PATHS[1:]]
    launches, gpu_runs = {}, {}
    for name, method, regparams, pair, overrides in runs:
        extra = {"fluid_spectral": dict(niter=FLUID_SPECTRAL_PARITY_NITER),
                 "elastic_dirichlet": DIRICHLET_PARITY}.get(name, {})
        cfg, iref, imov = spectral_parity_setup(name, **extra)
        t0 = time.perf_counter()
        cpu = register(iref, imov, cfg, device="cpu")
        cpu_s = time.perf_counter() - t0
        kernels.reset_launches()
        gpu = gpu_runs[name] = register(iref.to(dev), imov.to(dev), cfg)
        torch.cuda.synchronize()
        launches[name] = dict(kernels.LAUNCHES)
        info = dict(niter=cfg.niter[0], convergence_tol=cfg.convergence_tol, cpu_s=cpu_s,
                    launches=launches[name])
        tol = PARITY_TOL
        if name == "elastic_dirichlet":
            noise = max_abs(register(iref, rounded_again(imov), cfg, device="cpu").motion,
                            cpu.motion)
            info["cpu_rounding_change_px"] = noise
            tol = max(PARITY_TOL, NOISE_FACTOR * noise)
        parity_gate(name, gpu, cpu, info, tol)
    # The gate that admits the fft route as dct_impl="auto"'s resolution:
    # while it fails, "auto" must resolve to "matmul".
    auto = RegConfig(method=Method.CURVATURE, niter=(1,)).resolved_dct_impl
    parity_gate("curvature_fft_vs_matmul", gpu_runs["curvature_fft"],
                gpu_runs["curvature_matmul"], dict(on="gpu", auto_resolves_to=auto),
                gated=auto == "fft")
    for name in ("fluid_spectral", "elastic_dirichlet"):
        report_sensitive(dev, name)
    return launches


def rounded_again(image: torch.Tensor) -> torch.Tensor:
    """``image`` scaled by 1 + 1e-7 and rounded to float32 again: every
    pixel moves by at most half an ulp."""
    return (image.double() * (1 + 1e-7)).float()


def spectral_parity_setup(name: str, niter: int = SPECTRAL_PARITY_NITER, **overrides):
    """The config and the CPU pair of a spectral parity run (curvature_matmul,
    curvature_fft or a SPECTRAL_PATHS name) at N_PARITY."""
    if name.startswith("curvature_"):
        method, regparams, pair = Method.CURVATURE, CURVATURE, "tiled"
        overrides["dct_impl"] = name.removeprefix("curvature_")
    else:
        _, method, regparams, pair, _, _, _, path_overrides = next(p for p in SPECTRAL_PATHS
                                                                   if p[0] == name)
        overrides.update(path_overrides)
    cfg = RegConfig.from_regparams(method, [niter] * (PARITY_NSCALES + 1), PARITY_NSCALES,
                                   regparams, NREFINE, **overrides)
    return (cfg, *pair_on(torch.device("cpu"), pair, N_PARITY))


def report_sensitive(dev, name: str) -> None:
    """A path whose trajectory rounding moves (fluid_spectral,
    elastic_dirichlet) at SPECTRAL_PARITY_NITER with the default stop, GPU
    against CPU, beside the CPU run's own change when one pixel of the
    moving image moves by an ulp and when every pixel is rounded again:
    reported, not gated."""
    cfg, iref, imov = spectral_parity_setup(name)
    cpu = register(iref, imov, cfg, device="cpu")
    nudged = imov.clone()
    nudged.view(torch.int32)[N_PARITY // 2, N_PARITY // 3] += 1
    cpu_ulp = register(iref, nudged, cfg, device="cpu")
    cpu_rounded = register(iref, rounded_again(imov), cfg, device="cpu")
    gpu = register(iref.to(dev), imov.to(dev), cfg)
    torch.cuda.synchronize()

    def counts(r):
        return [(t.iterations, t.regrids) for t in r.traces]

    emit({"phase": "parity", "path": name, "shape": [N_PARITY, N_PARITY],
          "niter": SPECTRAL_PARITY_NITER, "gated": False,
          "max_abs_err_px": max_abs(gpu.motion.cpu(), cpu.motion),
          "cpu_one_ulp_change_px": max_abs(cpu_ulp.motion, cpu.motion),
          "cpu_rounding_change_px": max_abs(cpu_rounded.motion, cpu.motion),
          "iterations_regrids_gpu": counts(gpu), "iterations_regrids_cpu": counts(cpu),
          "iterations_regrids_cpu_one_ulp": counts(cpu_ulp),
          "iterations_regrids_cpu_rounded": counts(cpu_rounded)})


def parity_gate(name: str, got, want, info: dict, tol: float = PARITY_TOL,
                gated: bool = True) -> None:
    """Two registrations' motion within ``tol`` and equal counts; printed
    only, when not ``gated``."""
    e = max_abs(got.motion.cpu(), want.motion.cpu())
    counts = [(t.iterations, t.regrids) for t in got.traces]
    want_counts = [(t.iterations, t.regrids) for t in want.traces]
    passed = e <= tol and counts == want_counts
    emit({"phase": "parity", "path": name, "shape": [N_PARITY, N_PARITY], **info,
          "tol_px": tol, "max_abs_err_px": e, "iterations_regrids": counts,
          "iterations_regrids_want": want_counts, "gated": gated, "passed": passed})
    require(passed or not gated, f"{name}: motion differs by {e} px (gate {tol}) or counts "
                                 f"differ: {counts} vs {want_counts}")


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
    require(all(launches[k] > 0 for k in SP_KERNEL[family]),
            f"{name}: no {SP_KERNEL[family]} launch")
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


def bound(name: str, npix: int, f32_per_s: float = PEAK_F32_PER_S) -> dict:
    """The least time the card could take for the kernel's work at
    ``npix`` pixels: bytes over the memory rate or operations over the
    float32 rate ``f32_per_s``, whichever is larger."""
    t_bytes = PLANES[name] * 4 * npix / PEAK_BYTES_PER_S * 1e3
    t_ops = OPS[name] * npix / f32_per_s * 1e3
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
        "derive": (lambda: derive(iref, imov), lambda: derive_ref(iref, imov)),
    }
    times = {}
    for name, (kern, plain) in pairs.items():
        # No single PyTorch call computes any of these functions: grid_sample
        # has no edge renormalization and no pass-through, a conv2d no
        # renormalized border, no reduction gives both Logger sums (nor them
        # and the minimum Jacobian determinant), none runs an SOR sweep, the
        # fused fluid iteration or the fluid Euler pass, and torch.gradient
        # gives the two derivatives without the difference or the pack.
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
    times.update(batch_times(dev))
    times.update(upsample_times(dev))
    times.update(downsample_times(dev))
    emit({"phase": "times", "demons_tiles": {
        "demons_onepass": k_op.onepass_plan(KW),
        "demons_correspondence": k_df.correspondence_plan(KW),
        "compose_smooth": k_df.compose_smooth_plan(KW)}, "kernelwidth": KW,
        "plan": "(tile rows, tile columns, staging buffers)"})
    emit({"phase": "times", "elastic_tiles": {"elastic_block": k_el.elastic_plan(ELASTIC_K)},
          "k": ELASTIC_K, "plan": "(tile rows, tile columns, threads)",
          "smem_bytes": k_el.elastic_smem_bytes(ELASTIC_K),
          "memory_bound": {name: times[name]["bound_ms"]
                           for name in ("elastic_block", "elastic_block_strip")}})
    emit({"phase": "times", "diffusion_tiles": {"diffusion_block": k_diff.diffusion_plan(k)},
          "k": k, "plan": "(tile rows, tile columns, threads)",
          "smem_bytes": k_diff.diffusion_smem_bytes(k),
          "memory_bound": {name: times[name]["bound_ms"]
                           for name in ("diffusion_block", "diffusion_block_strip")}})
    emit({"phase": "times", "fluid_tiles": {"fluid_iter": k_fl.FLUID_PLAN},
          "plan": "(tile rows, tile columns, threads)",
          "smem_bytes": 4 * k_fl.fluid_smem_floats(*k_fl.FLUID_PLAN),
          "memory_bound": {name: times[name]["bound_ms"]
                           for name in ("fluid_iter", "fluid_sweep_max", "fluid_iter_strip")}})
    for name in FLOOR_TIMED:
        pad = STRIP_PADS.get(name, STRIP_TIMED_PAD)
        strip = name in STRIP_OF
        floor = (strip_bound(name, n // SP_STRIPS, n, pad, PEAK_F32_NO_FMA_PER_S)
                 if strip else bound(name, n * n, PEAK_F32_NO_FMA_PER_S))
        npix = (n // SP_STRIPS if strip else n) * n
        ops_ms = OPS[STRIP_OF.get(name, name)] * npix / PEAK_F32_NO_FMA_PER_S * 1e3
        emit({"phase": "times", "kernel": name, "instruction_floor": True, **floor,
              "ops_ms": ops_ms, "ms": times[name]["ms"]})
    return times


def upsample_times(dev) -> dict:
    """The motion upsample against its plain version from the cell's finest
    and coarsest levels to 4096^2, with its launches a call; the bound
    writes the output (8 B a point) and reads the source (8 B a point) once.
    The 2048^2 row goes into the kernel table."""
    rng = np.random.default_rng(SEED + 3)
    rows = {}
    for n_in in (2048, 256):
        u = torch.from_numpy(rng.normal(0, 3, (2, n_in, n_in)).astype(np.float32)).to(dev)
        dst = (N_MAIN, N_MAIN)
        kernels.reset_launches()
        upsample_motion(u, dst)
        launches = kernels.LAUNCHES["upsample_motion"]
        row = {"ms": median_ms(lambda: upsample_motion(u, dst)),
               "plain_ms": median_ms(lambda: upsample_motion_ref(u, dst)),
               "bound_ms": 8 * (N_MAIN * N_MAIN + n_in * n_in) / PEAK_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "library_ms": None}
        emit({"phase": "times", "kernel": "upsample_motion", "shape": list(dst),
              "source": [n_in, n_in], "launches_a_call": launches, **row})
        rows.setdefault("upsample_motion", row)
    return rows


def downsample_times(dev) -> dict:
    """The box downsample against its plain version from the slide cell's
    4096^2 and the fluid cell's 16384^2 to each pyramid level, image and
    field, with its launches a call; the bound reads the input (4 B a
    point) and writes the output (4 B an output point) once. Its yardstick
    is ``avg_pool2d``, the same means in another order (without a field's
    scale). The 4096^2 image to 2048^2 goes into the kernel table."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows = {}
    for n in (N_MAIN, 16384):
        dims = pyramid_dims((n, n), 4)
        big = n > 4096
        for what, kern, plain, planes in (("image", downsample_image, downsample_image_ref, 1),
                                          ("motion", downsample_motion, downsample_motion_ref,
                                           2)):
            x = torch.rand(((2,) if planes == 2 else ()) + (n, n), generator=gen, device=dev)
            pool_input = x.view(planes, n, n)
            for level in range(1, 5):
                dst = dims[level]
                patch = (n // dst[0], n // dst[1])
                kernels.reset_launches()
                kern(x, dst)
                launches = kernels.LAUNCHES["downsample"]
                row = {"ms": median_ms(lambda: kern(x, dst)),
                       "plain_ms": median_ms(lambda: plain(x, dst), runs=5 if big else 20,
                                             warmup=1 if big else 3, batch=2 if big else 10),
                       "bound_ms": 4 * planes * (n * n + dst[0] * dst[1]) / PEAK_BYTES_PER_S
                       * 1e3, "bound_by": "bytes",
                       "library_ms": median_ms(
                           lambda: torch.nn.functional.avg_pool2d(pool_input, patch))}
                emit({"phase": "times", "kernel": "downsample", "input": what,
                      "shape": list(dst), "source": list(x.shape), "launches_a_call": launches,
                      **row})
                rows.setdefault("downsample", row)
            del x, pool_input
            torch.cuda.empty_cache()
    return rows


def batch_times(dev) -> dict:
    """The batched kernels at the batch path's shape, BATCH pairs of
    N_BATCH^2, every pair listed: each against its plain version (a loop of
    the single-pair plain version) and against BATCH single-pair launches
    of its kernel (``singles_ms``), its bound that of the single kernel on
    all the pairs' pixels."""
    irefs, imovs, _ = batch_stack(dev, "blob", N_BATCH, BATCH)
    d = derivatives(irefs, imovs)
    g = stack_derivs(d.grad_i, d.it)
    del d
    rng = np.random.default_rng(SEED + 2)
    u = torch.from_numpy(rng.normal(0, 1, (BATCH, 2, N_BATCH, N_BATCH)).astype(np.float32)).to(dev)
    v = (torch.tanh(u) * 0.4).contiguous()
    vel = (v.flip(1) * 0.5).contiguous()  # a fluid velocity, as phase_times's
    k = RegConfig(method=Method.DIFFUSION, niter=(1,)).block_k
    pairs = _build.Pairs(range(BATCH), BATCH)
    out = torch.empty_like(u)
    gout = torch.empty((BATCH, 3, N_BATCH, N_BATCH), device=dev)
    every = range(BATCH)
    runs = {
        "diffusion_block_batch": (
            lambda: diffusion_block_batch(u, g, ALPHA, k, pairs, out),
            lambda: diffusion_block_batch_ref(u, g, ALPHA, k, pairs, out),
            lambda: [diffusion_block(u[p], g[p], ALPHA, k) for p in every]),
        "diffusion_step_batch": (
            lambda: diffusion_step_batch(u, g, ALPHA, pairs, out),
            lambda: diffusion_step_batch_ref(u, g, ALPHA, pairs, out),
            lambda: [diffusion_step_fused(u[p], g[p, :2], g[p, 2], ALPHA) for p in every]),
        "warp2d_batch": (lambda: warp2d_batch(imovs, u, pairs),
                         lambda: warp2d_batch_ref(imovs, u, pairs),
                         lambda: [warp2d(imovs[p], u[p]) for p in every]),
        "compose_batch": (lambda: compose_batch(u, v, pairs, out),
                          lambda: compose_batch_ref(u, v, pairs, out),
                          lambda: [compose(u[p], v[p]) for p in every]),
        "logger_norms_batch": (lambda: logger_norms_batch(u, v, pairs),
                               lambda: logger_norms_batch_ref(u, v, pairs),
                               lambda: [logger_norms(u[p], v[p]) for p in every]),
        "fluid_iter_batch": (
            lambda: fluid_iter_batch(v, vel, g, *FLUID, True, False, pairs, out),
            lambda: fluid_iter_batch_ref(v, vel, g, *FLUID, True, False, pairs, out),
            lambda: [fluid_iter(v[p], vel[p], g[p], *FLUID, True, False) for p in every]),
        "fluid_metrics_batch": (lambda: fluid_metrics_batch(u, v, pairs),
                                lambda: fluid_metrics_batch_ref(u, v, pairs),
                                lambda: [fluid_metrics(u[p], v[p]) for p in every]),
        "derive_batch": (lambda: derive_batch(irefs, imovs, pairs, gout),
                         lambda: derive_batch_ref(irefs, imovs, pairs, gout),
                         lambda: [derive(irefs[p], imovs[p]) for p in every]),
    }
    times = {}
    for name, (kern, plain, singles) in runs.items():
        # No PyTorch call computes these functions (the footnotes of the
        # single-pair kernels above).
        t = {"ms": median_ms(kern), "plain_ms": median_ms(plain),
             **bound(name, BATCH * N_BATCH * N_BATCH), "library_ms": None}
        times[name] = t
        emit({"phase": "times", "kernel": name, "shape": [BATCH, N_BATCH, N_BATCH],
              **({"k": k} if name == "diffusion_block_batch" else {}), **t,
              "singles_ms": median_ms(singles)})
    return times


def library_bound(name: str, nx: int, ny: int) -> dict:
    """The least time of one solve of a library route on the card: for the
    matmul routes their float32 operations over 67 TFLOP/s, for the FFT
    routes their bytes over 3.35 TB/s, each pass of the transform reading
    and writing its complex64 planes once (and the input read, the output
    written, the tables read once); the larger of the two."""
    planes = 2
    if name == "curvature_matmul":
        ops = planes * 2 * (2 * nx * ny * (nx + ny))  # C2x A C2y^T and C3x . C3y^T
        nbytes = planes * 4 * nx * ny * 2 + 4 * nx * ny + 4 * 2 * (nx * nx + ny * ny)
    elif name == "curvature_fft":
        # Four 1D passes (y, x forward; y, x inverse) on complex64 planes.
        ops = planes * 4 * 5 * nx * ny * np.log2(max(nx, ny))
        nbytes = planes * nx * ny * (4 + 4 + 4 * 16) + 4 * nx * ny
    elif name == "navier_lame_periodic":
        half = nx * (ny // 2 + 1)
        ops = planes * 2 * 5 * nx * ny * np.log2(max(nx, ny)) + 14 * half
        # rfft2 and irfft2 two passes each on the half spectrum, then the
        # 2x2 multiply reading both spectra and three tables, writing two.
        nbytes = planes * (4 * nx * ny * 2 + 4 * 16 * half) + (2 * 8 + 3 * 4 + 2 * 8) * half
    else:  # navier_lame_dirichlet: 1 + 12 preconditioner applications of 8 matmuls
        mx, my = nx - 2, ny - 2
        ops = 13 * planes * 2 * (2 * mx * my * (mx + my))
        nbytes = planes * 4 * nx * ny * 2 + 4 * (mx * mx + my * my)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "ops": float(ops), "bytes": float(nbytes)}


def library_times(dev) -> None:
    """One solve of each library route, CUDA-event median as the kernels'
    (curvature by each route and the periodic Navier-Lame solve at 4096^2,
    the Dirichlet solve at 1024^2), beside its bound."""
    rng = np.random.default_rng(SEED + 3)
    for name, shapes in LIBRARY_SHAPES.items():
        nx, ny = shapes[0]
        f = torch.from_numpy(rng.standard_normal((2, nx, ny)).astype(np.float32)).to(dev)
        solve = library_solvers(nx, ny)[name]
        emit({"phase": "times", "route": name, "shape": [nx, ny], "ms": median_ms(lambda: solve(f)),
              **library_bound(name, nx, ny)})
        del f


def strip_bound(name: str, nxl: int, ny: int, pad: int,
                f32_per_s: float = PEAK_F32_PER_S) -> dict:
    """The bound of a strip kernel: its dense kernel's work on the strip's
    pixels, plus the halo rows of its padded inputs read once."""
    dense = STRIP_OF[name]
    t_bytes = ((PLANES[dense] * nxl + STRIP_PADDED[name] * 2 * pad) * ny * 4
               / PEAK_BYTES_PER_S * 1e3)
    t_ops = OPS[dense] * nxl * ny / f32_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def strip_times(dev, imov, g, u, v) -> dict:
    """Each strip kernel, one launch at a time on strip 1 of the 4096^2 grid
    cut into SP_STRIPS strips (1024 x 4096, padded with 8 halo rows a
    side; the demons strips with their exact reach), against its plain
    version."""
    n, s, pad = N_MAIN, 1, STRIP_TIMED_PAD
    nxl = n // SP_STRIPS
    row0 = s * nxl
    up, vp, gp, ip = (x[s] for x in strip_inputs(dev, pad, u, v, g, imov))
    iref = imov.flip(0).contiguous()
    ia5, ir5, v5 = (x[s] for x in strip_inputs(dev, STRIP_PADS["demons_onepass_strip"], imov,
                                                iref, v))
    ia6, ir6, v6 = (x[s] for x in strip_inputs(dev, STRIP_PADS["demons_correspondence_strip"], imov,
                                                iref, v))
    u7, c7 = (x[s] for x in strip_inputs(dev, STRIP_PADS["compose_smooth_strip"], u, v))
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
        "demons_onepass_strip": (k_op.thirion_onepass_strip, k_op.thirion_onepass_strip_ref,
                                 (ia5, ir5, v5, row0, n, *ONEPASS_ARGS, SP_HALO)),
        "demons_correspondence_strip": (
            k_df.demons_correspondence_strip, k_df.demons_correspondence_strip_ref,
            (ia6, ir6, v6, row0, n, DIFFEO_PARAMS[0], DIFFEO_PARAMS[1], DIFFEO_PARAMS[3], KW,
             SP_HALO)),
        "compose_smooth_strip": (k_df.compose_smooth_strip, k_df.compose_smooth_strip_ref,
                                 (u7, c7, row0, n, DIFFEO_PARAMS[2], KW, SP_HALO)),
    }
    times = {}
    for name, (kern, plain, args) in pairs.items():
        # No PyTorch call computes these either: see phase_times.
        p = STRIP_PADS.get(name, pad)
        t = {"ms": median_ms(lambda: kern(*args)), "plain_ms": median_ms(lambda: plain(*args)),
             **strip_bound(name, nxl, n, p), "library_ms": None}
        times[name] = t
        emit({"phase": "times", "kernel": name, "shape": [nxl, n], "row0": row0, "pad": p,
              **({"kernelwidth": KW, "halo": SP_HALO} if name in STRIP_PADS else {}), **t})
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
    timed("library", phase_library, dev)
    main_launches = timed("main", phase_main, dev)
    main_launches.update(timed("batch", phase_batch, dev, smi))
    for path in ("thirion", "diffeomorphic", "fluid", "elastic", "diffusion_tiled"):
        timed("profile", phase_profile, dev, path)
    for path in ("thirion_tiled", "diffeo_tiled"):  # beside sp_thirion and sp_diffeo
        timed("profile", phase_profile, dev, path, DEMONS_PROFILE_NITER)
    for name, *_ in SP_PATHS:
        timed("profile", phase_profile_sp, dev, name)
    for path in ("curvature", "fluid_spectral"):
        timed("profile", phase_profile_spectral, dev, path)
    timed("profile", phase_profile_sp, dev, SP_CURVATURE[0])
    parity_launches = timed("parity", phase_parity, dev)
    times = timed("times", phase_times, dev)
    timed("times", library_times, dev)
    timed("utilities", phase_utilities, dev, times["diffusion_block"]["ms"])
    emit({"phase": "seconds", **seconds})
    # A kernel's launches through its single and its pair-axis entry: the
    # level loop takes the pair-axis entry of B1, B2 and B4 for one pair.
    entries = {name: [name] + [b for b, single in BATCHED.items() if single == name]
               for name in KERNELS}
    launches = {name: sum(run[e] for run in main_launches.values() for e in entries[name])
                for name in KERNELS}
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
