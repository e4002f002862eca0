"""Build the port's CUDA kernels and drive its main paths once on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

0. Card check: fail without CUDA; print the card's name and power limit.
1. Build every kernel from ``opticalflow2d_tpu_torch/csrc`` for sm_90a
   (one ``nvcc`` per source, all started together).
2. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and a ragged one (fields <= 1e-6 max-abs, Logger sums
   <= 1e-5 relative): the diffusion kernels, warp and compose with
   displacements up to +-40 px, the Logger norms, and the three demons
   kernels at kernelwidth 5 and 11 (the one-pass kernel by composition and
   by addition) with small displacements and with ones that send samples
   out of bounds.
3. The main paths through the session API on a 4096^2 pair, each with the
   launch counts set to 0 just before it and read just after:
   a. diffusion, 5 levels (SSD reduction >= 0.9, finite motion). Five
      levels put the coarsest at 256^2, where the 24 px shift is 1.5 px;
      with three levels every level stops at the 400-iteration cap and the
      SSD reduction stays near 0.87;
   b. Thirion demons with the default parameters (the one-pass kernel);
   c. diffeomorphic demons with sigma_i = 0.25, sigma_x = 1.0, where the
      exp map is not the identity (correspondence kernel, squarings on the
      compose kernel, compose+smooth kernel, Logger norms).
   Demons needs SSD reduction >= 0.9 and a finite motion too; the phase
   prints iterations, wall time, host reads per level and launches.
4. Profile of run 3c: the device's busy share and the host syncs.
5. Slice parity at 512^2 for each path: the CPU (plain versions) against
   the GPU (kernels), motion <= 1e-5 px and equal iteration counts at
   every level.
6. Times at 4096^2: median of 20 CUDA-event-timed runs of 10 calls each,
   of each kernel and of its plain version, and its bound.

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
from opticalflow2d_tpu_torch.kernels import _build
from opticalflow2d_tpu_torch.kernels.demons_fused import (
    compose_smooth, compose_smooth_ref, demons_correspondence, demons_correspondence_ref)
from opticalflow2d_tpu_torch.kernels.demons_onepass import (
    thirion_onepass, thirion_onepass_ref)
from opticalflow2d_tpu_torch.kernels.diffusion_block import (
    diffusion_block, diffusion_block_ref, stack_derivs)
from opticalflow2d_tpu_torch.kernels.diffusion_fused import (
    diffusion_step_fused, diffusion_step_ref)
from opticalflow2d_tpu_torch.kernels.logger_norms import logger_norms, logger_norms_ref
from opticalflow2d_tpu_torch.kernels.warp_fused import (
    compose, compose_ref, warp2d, warp2d_ref)
from opticalflow2d_tpu_torch.metrics import ssd_reduction
from opticalflow2d_tpu_torch.solvers.base import derivatives
from opticalflow2d_tpu_torch.solvers.demons import demons_route

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
DEMONS_PARITY_NITER = 200  # at every level of the CPU-timed demons parity runs
SEED = 0
KERNEL_SHAPES = ((4096, 4096), (2048, 2048), (1000, 777))

# The main paths: (name, method, regparams).
PATHS = (
    ("diffusion", Method.DIFFUSION, [ALPHA]),
    ("thirion", Method.THIRIONS_DEMONS, [1.0, 0.25, 2.0, 2.0, 5, 0]),
    ("diffeomorphic", Method.DIFFEOMORPHIC_DEMONS, [0.25, 1.0, 2.0, 2.0, 5]),
)

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
}

# H100 SXM peaks (NVIDIA's data sheet): device memory and float32 outside
# the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
KW = 5  # the demons kernelwidth of the main paths
# Per output pixel at the main paths' settings: float32 planes each kernel
# must read and write once, and the float operations it does on them
# (interior counts, halo recomputation not included). B1 runs k = 8 steps
# of 33 operations; a k-tap separable Gaussian of two channels is 8k.
PLANES = {"diffusion_block": 7, "diffusion_step": 7, "warp2d": 4, "compose": 6,
          "logger_norms": 4, "demons_onepass": 6, "demons_correspondence": 6,
          "compose_smooth": 6}
OPS = {"diffusion_block": 8 * 33, "diffusion_step": 21, "warp2d": 25, "compose": 36,
       "logger_norms": 12, "demons_onepass": 93 + 16 * KW,
       "demons_correspondence": 45 + 8 * KW, "compose_smooth": 36 + 8 * KW}


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
    """Each kernel against its plain version on the same CUDA inputs."""
    rng = np.random.default_rng(SEED)
    err = {name: 0.0 for name in KERNELS}
    for nx, ny in KERNEL_SHAPES:
        shape = (nx, ny)
        n = max(nx, ny)
        iref, imov = blob_pair(n)
        iref = torch.from_numpy(iref[:nx, :ny].copy()).to(dev)
        imov = torch.from_numpy(imov[:nx, :ny].copy()).to(dev)
        d = derivatives(iref, imov)
        g = stack_derivs(d.grad_i, d.it)
        u = torch.from_numpy(rng.normal(0, 2, (2, nx, ny)).astype(np.float32)).to(dev)
        for k in (1, 5, 8):
            check(err, "diffusion_block", diffusion_block(u, g, ALPHA, k),
                  diffusion_block_ref(u, g, ALPHA, k), shape, k=k)
        check(err, "diffusion_step", diffusion_step_fused(u, g[:2], g[2], ALPHA),
              diffusion_step_ref(u, g[:2], g[2], ALPHA), shape)

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
        info = {"max_disp": float(disp.abs().max()), "oob_share_x": oob}
        check(err, "warp2d", warp2d(imov, disp), warp2d_ref(imov, disp), shape, **info)
        check(err, "compose", compose(u_total, disp), compose_ref(u_total, disp), shape,
              **info)
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
        small = (torch.tanh(u) * 1.5).contiguous()
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
    return err


def host_reads_per_iteration(method: Method, regparams) -> int:
    """Device-to-host reads one iteration of a path makes: the Logger sums,
    plus the exp map's maxabs on the two-kernel demons route (diffusion
    reads once a block of iterations)."""
    if method == Method.DIFFUSION:
        return 0
    route = demons_route(regparams[0], regparams[1], int(regparams[4]),
                         method == Method.DIFFEOMORPHIC_DEMONS)
    return 2 if route == "two_kernel" else 1


def run_main(dev, method: Method, regparams, iref, imov):
    sess = OpticalFlow2d((N_MAIN, N_MAIN), niter=[NITER] * (MAIN_NSCALES + 1),
                         nscales=MAIN_NSCALES, regularisation=method, regparams=regparams,
                         nrefine=NREFINE, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sess.register(iref, imov)
    motion = sess.get_motion()
    ireg = sess.warp(imov)
    torch.cuda.synchronize()
    return sess, res, motion, ireg, time.perf_counter() - t0


def phase_main(dev) -> dict:
    iref_np, imov_np = blob_pair(N_MAIN)
    iref = torch.from_numpy(iref_np).to(dev)
    imov = torch.from_numpy(imov_np).to(dev)
    launches = {}
    for path, method, regparams in PATHS:
        kernels.reset_launches()
        sess, res, motion, ireg, wall = run_main(dev, method, regparams, iref, imov)
        launches[path] = dict(kernels.LAUNCHES)
        red = float(ssd_reduction(iref, imov, res.motion))
        finite = bool(torch.isfinite(motion).all()) and bool(torch.isfinite(ireg).all())
        iterations = [t.iterations for t in res.traces]
        per_it = host_reads_per_iteration(method, regparams)
        emit({"phase": "main", "path": path, "shape": [N_MAIN, N_MAIN],
              "regparams": regparams, "wall_s": wall, "iterations": iterations,
              "host_reads_per_level": [-(-n // 8) if method == Method.DIFFUSION else
                                       n * per_it for n in iterations],
              "ssd_reduction": red, "finite": finite, "motion_shape": list(motion.shape),
              "mean_motion_px": [float(res.motion[c].mean()) for c in range(2)],
              "launches": launches[path]})
        require(finite and tuple(motion.shape) == (N_MAIN, N_MAIN, 2),
                f"{path}: motion not finite")
        require(red >= SSD_BAR, f"{path}: SSD reduction {red} < {SSD_BAR}")
        sess.close()
    return launches


def phase_profile(dev) -> None:
    """torch.profiler over the diffeomorphic 4096^2 run (a warm repeat):
    device kernel time against the wall, and the host syncs."""
    from torch.profiler import ProfilerActivity, profile

    iref_np, imov_np = blob_pair(N_MAIN)
    iref = torch.from_numpy(iref_np).to(dev)
    imov = torch.from_numpy(imov_np).to(dev)
    _, method, regparams = PATHS[2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, res, _, _, wall = run_main(dev, method, regparams, iref, imov)
        profiled_wall = time.perf_counter() - t0
    rows = prof.key_averages()
    device_us = sum(r.self_device_time_total for r in rows if r.device_type.name == "CUDA")
    top = sorted((r for r in rows if r.self_device_time_total > 0),
                 key=lambda r: -r.self_device_time_total)[:10]
    syncs = sum(r.count for r in rows if r.key in ("cudaStreamSynchronize",
                                                   "cudaDeviceSynchronize"))
    iterations = sum(t.iterations for t in res.traces)
    emit({"phase": "profile", "path": "diffeomorphic", "wall_s": profiled_wall,
          "device_ms": device_us / 1e3, "busy_share": device_us / 1e6 / profiled_wall,
          "iterations": iterations, "stream_syncs": syncs,
          "syncs_per_iteration": syncs / iterations,
          "top": [{"name": r.key[:60], "ms": r.self_device_time_total / 1e3,
                   "count": r.count} for r in top]})


def phase_parity(dev) -> dict:
    iref, imov = blob_pair(N_PARITY)
    launches = {}
    for path, method, regparams in PATHS:
        niter = NITER if method == Method.DIFFUSION else DEMONS_PARITY_NITER
        cfg = RegConfig.from_regparams(method, [niter] * (PARITY_NSCALES + 1),
                                       PARITY_NSCALES, regparams, NREFINE)
        t0 = time.perf_counter()
        cpu = register(iref, imov, cfg, device="cpu")
        cpu_s = time.perf_counter() - t0
        kernels.reset_launches()
        gpu = register(torch.from_numpy(iref).to(dev), torch.from_numpy(imov).to(dev), cfg)
        torch.cuda.synchronize()
        launches[path] = dict(kernels.LAUNCHES)
        e = max_abs(gpu.motion.cpu(), cpu.motion)
        it_cpu = [t.iterations for t in cpu.traces]
        it_gpu = [t.iterations for t in gpu.traces]
        emit({"phase": "parity", "path": path, "shape": [N_PARITY, N_PARITY],
              "niter": niter, "max_abs_err_px": e, "iterations_cpu": it_cpu,
              "iterations_gpu": it_gpu, "cpu_s": cpu_s,
              "ssd_reduction_gpu": float(ssd_reduction(gpu.motion.new_tensor(iref),
                                                       gpu.motion.new_tensor(imov),
                                                       gpu.motion)),
              "launches": launches[path]})
        require(e <= PARITY_TOL, f"{path}: GPU vs CPU motion differs by {e} px")
        require(it_cpu == it_gpu, f"{path}: iterations differ: {it_cpu} vs {it_gpu}")
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
    }
    times = {}
    for name, (kern, plain) in pairs.items():
        # No single PyTorch call computes any of these functions: grid_sample
        # has no edge renormalization and no pass-through, a conv2d no
        # renormalized border, and no reduction gives both Logger sums.
        t = {"ms": median_ms(kern), "plain_ms": median_ms(plain), **bound(name, n * n),
             "library_ms": None}
        times[name] = t
        emit({"phase": "times", "kernel": name, "shape": [n, n],
              **({"k": k} if name == "diffusion_block" else {}),
              **({"kernelwidth": KW} if name.startswith(("demons", "compose_")) else {}),
              **t})
    return times


def main() -> None:
    smi = phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    err = phase_kernels(dev)
    main_launches = phase_main(dev)
    phase_profile(dev)
    parity_launches = phase_parity(dev)
    times = phase_times(dev)
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
