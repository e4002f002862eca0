"""Build the port's CUDA kernels and drive its main path once on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

0. Card check: fail without CUDA; print the card's name and power limit.
1. Build every kernel from ``opticalflow2d_tpu_torch/csrc`` for sm_90a.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes and a ragged one (fields <= 1e-6 max-abs, Logger sums
   <= 1e-5 relative).
3. The main path through the session API: a 5-level diffusion
   registration of a 4096^2 pair (SSD reduction >= 0.9, finite motion,
   every kernel launched). Five levels put the coarsest at 256^2, where
   the 24 px shift is 1.5 px; with three levels every level of this pair
   stops at the 400-iteration cap and the SSD reduction stays near 0.87.
4. Slice parity: a 3-level run at 512^2 on the CPU (plain versions) and on
   the GPU (kernels): motion <= 1e-5 px max-abs and equal iteration counts
   at every level.
5. Times: median of 20 CUDA-event-timed runs of each kernel and of its
   plain version at the main path's shapes.

The last line is ``{"ok": true, "device": {...}}``.
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
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.kernels.diffusion_block import (
    diffusion_block, diffusion_block_ref, stack_derivs)
from opticalflow2d_tpu_torch.kernels.diffusion_fused import (
    diffusion_step_fused, diffusion_step_ref)
from opticalflow2d_tpu_torch.kernels.warp_fused import (
    compose, compose_ref, warp2d, warp2d_ref)
from opticalflow2d_tpu_torch.metrics import ssd_reduction
from opticalflow2d_tpu_torch.solvers.base import derivatives

FIELD_TOL = 1e-6      # kernel vs plain version, max-abs
SUMS_RTOL = 1e-5      # Logger sums, relative
PARITY_TOL = 1e-5     # GPU vs CPU motion, px
SSD_BAR = 0.9
N_MAIN = 4096
N_PARITY = 512
ALPHA = 0.1
NREFINE = 2
MAIN_NSCALES = 4
PARITY_NSCALES = 2
NITER = 400  # at every level
SEED = 0

KERNELS = {
    "diffusion_block": ("cuda", "opticalflow2d_tpu_torch/csrc/diffusion_block.cu",
                        "opticalflow2d_tpu/pallas_kernels/diffusion_block.py:223"),
    "diffusion_step": ("cuda", "opticalflow2d_tpu_torch/csrc/diffusion_step.cu",
                       "opticalflow2d_tpu/pallas_kernels/diffusion_fused.py:106"),
    "warp2d": ("cuda", "opticalflow2d_tpu_torch/csrc/warp_gather.cu",
               "opticalflow2d_tpu/pallas_kernels/warp_fused.py:173"),
    "compose": ("cuda", "opticalflow2d_tpu_torch/csrc/warp_gather.cu",
                "opticalflow2d_tpu/pallas_kernels/warp_fused.py:173"),
}


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


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


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
              if "Used" in line or "spill" in line or "Compiling entry" in line]
    emit({"phase": "build", "seconds": seconds, "library": path.name, "ptxas": report})


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version on the same CUDA inputs."""
    rng = np.random.default_rng(SEED)
    err = {name: 0.0 for name in KERNELS}
    for nx, ny in ((4096, 4096), (2048, 2048), (1000, 777)):
        n = max(nx, ny)
        iref, imov = blob_pair(n)
        iref = torch.from_numpy(iref[:nx, :ny].copy()).to(dev)
        imov = torch.from_numpy(imov[:nx, :ny].copy()).to(dev)
        d = derivatives(iref, imov)
        g = stack_derivs(d.grad_i, d.it)
        u = torch.from_numpy(rng.normal(0, 2, (2, nx, ny)).astype(np.float32)).to(dev)
        for k in (1, 5, 8):
            got, sums = diffusion_block(u, g, ALPHA, k)
            want, sums_ref = diffusion_block_ref(u, g, ALPHA, k)
            torch.cuda.synchronize()
            e = max_abs(got, want)
            rel = float(((sums - sums_ref).abs() / sums_ref.abs()).max())
            emit({"phase": "kernels", "kernel": "diffusion_block", "shape": [nx, ny],
                  "k": k, "max_abs_err": e, "sums_rel_err": rel})
            require(e <= FIELD_TOL and rel <= SUMS_RTOL,
                    f"diffusion_block {nx}x{ny} k={k}: err {e}, sums {rel}")
            err["diffusion_block"] = max(err["diffusion_block"], e)
        got = diffusion_step_fused(u, g[:2], g[2], ALPHA)
        want = diffusion_step_ref(u, g[:2], g[2], ALPHA)
        torch.cuda.synchronize()
        e = max_abs(got, want)
        emit({"phase": "kernels", "kernel": "diffusion_step", "shape": [nx, ny],
              "max_abs_err": e})
        require(e <= FIELD_TOL, f"diffusion_step {nx}x{ny}: err {e}")
        err["diffusion_step"] = max(err["diffusion_step"], e)

        # Displacements up to +-40 px: a smooth field plus noise, so that
        # samples fall inside, on the edges and outside the grid.
        i = torch.arange(nx, device=dev, dtype=torch.float32)[:, None] / nx
        j = torch.arange(ny, device=dev, dtype=torch.float32)[None, :] / ny
        smooth = torch.stack([30 * torch.sin(6 * j + 1) * torch.cos(4 * i),
                              30 * torch.cos(5 * i + 2) * torch.sin(3 * j)])
        noise = torch.from_numpy(rng.uniform(-10, 10, (2, nx, ny)).astype(np.float32))
        disp = (smooth + noise.to(dev)).contiguous()
        u_total = torch.from_numpy(rng.normal(0, 5, (2, nx, ny)).astype(np.float32)).to(dev)
        oob = float((((i * nx + disp[0]) < 0) | ((i * nx + disp[0]) >= nx)).float().mean())
        for name, got, want in (
            ("warp2d", warp2d(imov, disp), warp2d_ref(imov, disp)),
            ("compose", compose(u_total, disp), compose_ref(u_total, disp)),
        ):
            torch.cuda.synchronize()
            e = max_abs(got, want)
            emit({"phase": "kernels", "kernel": name, "shape": [nx, ny],
                  "max_disp": float(disp.abs().max()), "oob_share_x": oob,
                  "max_abs_err": e})
            require(e <= FIELD_TOL, f"{name} {nx}x{ny}: err {e}")
            err[name] = max(err[name], e)
    return err


def phase_main(dev) -> dict:
    iref_np, imov_np = blob_pair(N_MAIN)
    iref = torch.from_numpy(iref_np).to(dev)
    imov = torch.from_numpy(imov_np).to(dev)
    sess = OpticalFlow2d((N_MAIN, N_MAIN), niter=[NITER] * (MAIN_NSCALES + 1),
                         nscales=MAIN_NSCALES,
                         regularisation=Method.DIFFUSION, regparams=[ALPHA],
                         nrefine=NREFINE, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = sess.register(iref, imov)
    motion = sess.get_motion()
    ireg = sess.warp(imov)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    red = float(ssd_reduction(iref, imov, res.motion))
    finite = bool(torch.isfinite(motion).all()) and bool(torch.isfinite(ireg).all())
    emit({"phase": "main", "shape": [N_MAIN, N_MAIN], "wall_s": wall,
          "iterations": [t.iterations for t in res.traces], "ssd_reduction": red,
          "finite": finite, "motion_shape": list(motion.shape),
          "mean_motion_px": [float(res.motion[c].mean()) for c in range(2)],
          "launches": launches})
    require(finite and tuple(motion.shape) == (N_MAIN, N_MAIN, 2), "motion not finite")
    require(red >= SSD_BAR, f"SSD reduction {red} < {SSD_BAR}")
    sess.close()
    return launches


def phase_parity(dev) -> dict:
    iref, imov = blob_pair(N_PARITY)
    cfg = RegConfig.from_regparams(Method.DIFFUSION, [NITER] * (PARITY_NSCALES + 1),
                                   PARITY_NSCALES, [ALPHA], NREFINE)
    cpu = register(torch.from_numpy(iref), torch.from_numpy(imov), cfg)
    kernels.reset_launches()
    gpu = register(torch.from_numpy(iref).to(dev), torch.from_numpy(imov).to(dev), cfg)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    e = max_abs(gpu.motion.cpu(), cpu.motion)
    it_cpu = [t.iterations for t in cpu.traces]
    it_gpu = [t.iterations for t in gpu.traces]
    emit({"phase": "parity", "shape": [N_PARITY, N_PARITY], "max_abs_err_px": e,
          "iterations_cpu": it_cpu, "iterations_gpu": it_gpu,
          "ssd_reduction_gpu": float(ssd_reduction(gpu.motion.new_tensor(iref),
                                                   gpu.motion.new_tensor(imov),
                                                   gpu.motion)),
          "launches": launches})
    require(e <= PARITY_TOL, f"GPU vs CPU motion differs by {e} px")
    require(it_cpu == it_gpu, f"iterations differ: {it_cpu} vs {it_gpu}")
    return launches


def median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_times(dev) -> dict:
    rng = np.random.default_rng(SEED + 1)
    n = N_MAIN
    iref_np, imov_np = blob_pair(n)
    iref = torch.from_numpy(iref_np).to(dev)
    imov = torch.from_numpy(imov_np).to(dev)
    d = derivatives(iref, imov)
    g = stack_derivs(d.grad_i, d.it)
    u = torch.from_numpy(rng.normal(0, 1, (2, n, n)).astype(np.float32)).to(dev)
    k = RegConfig(method=Method.DIFFUSION, niter=(1,)).block_k
    pairs = {
        "diffusion_block": (lambda: diffusion_block(u, g, ALPHA, k),
                            lambda: diffusion_block_ref(u, g, ALPHA, k)),
        "diffusion_step": (lambda: diffusion_step_fused(u, g[:2], g[2], ALPHA),
                           lambda: diffusion_step_ref(u, g[:2], g[2], ALPHA)),
        "warp2d": (lambda: warp2d(imov, u), lambda: warp2d_ref(imov, u)),
        "compose": (lambda: compose(u, u), lambda: compose_ref(u, u)),
    }
    times = {}
    for name, (kern, plain) in pairs.items():
        t = {"ms": median_ms(kern), "plain_ms": median_ms(plain)}
        times[name] = t
        emit({"phase": "times", "kernel": name, "shape": [n, n],
              **({"k": k} if name == "diffusion_block" else {}), **t})
    return times


def main() -> None:
    smi = phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    err = phase_kernels(dev)
    launches = phase_main(dev)
    parity_launches = phase_parity(dev)
    times = phase_times(dev)
    missing = [name for name in KERNELS if launches[name] == 0]
    emit({"phase": "launch_check", "main": launches, "parity_run": parity_launches,
          "missing_in_main": missing})
    require(not missing, f"the main path launched no {missing}")
    emit({"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": err[name], **times[name]}
        for name, (route, source, replaces) in KERNELS.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
