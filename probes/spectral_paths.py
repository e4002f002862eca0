"""Where the spectral Navier-Lame registrations converge, and how sensitive
they are to rounding: the evidence behind chip_smoke.py's SPECTRAL_PATHS
(the blob pair for the spectral elastic and fluid paths) and its
FLUID_SPECTRAL_PARITY_NITER.

    python3 probes/spectral_paths.py [--device cpu|cuda] [--sizes 256 512 1024]
                                     [--out FILE]

Prints JSON lines:
- ``pairs``: elastic (periodic solve [0.5, 0] and [0.25, 0], Dirichlet
  solve [0.5, 0]) and fluid (periodic solve [0.25, 0]) on chip_smoke.py's
  tiled pair (3 levels) and blob pair (5 levels), 400 iterations a level,
  2 refinements: iterations, SSD reduction, finite motion, mean motion.
  The Dirichlet runs stop at 512^2 on the CPU and 1024^2 on the card (its
  matmuls grow as n^3).
- ``fluid_sensitivity``: fluid_spectral on the 512^2 blob pair at several
  caps, the motion's change when one pixel of the moving image moves by an
  ulp, with both runs' counts.
- ``dirichlet_noise``: the Dirichlet solve's change, of max |v|, when its
  input is scaled by 1 + 1e-7 and rounded again (chip_smoke.py's
  ``input_rounding_noise``).
Quality and sensitivity only: no time is measured.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from opticalflow2d_tpu_torch import Method, RegConfig, register  # noqa: E402
from opticalflow2d_tpu_torch.metrics import ssd_reduction  # noqa: E402
from opticalflow2d_tpu_torch.solvers.navier_lame import (  # noqa: E402
    make_dirichlet_navier_lame_solver)

CASES = (
    ("elastic_spectral", Method.ELASTIC, [0.5, 0.0], "spectral"),
    ("elastic_spectral", Method.ELASTIC, [0.25, 0.0], "spectral"),
    ("elastic_dirichlet", Method.ELASTIC, [0.5, 0.0], "spectral_dirichlet"),
    ("fluid_spectral", Method.FLUID, [0.25, 0.0], "spectral"),
)
NSCALES = {"tiled": cs.TILED_NSCALES, "blob": cs.MAIN_NSCALES}


def pairs(dev, sizes, emit):
    for n in sizes:
        for pair in ("tiled", "blob"):
            iref, imov = cs.pair_on(dev, pair, n)
            for name, method, regparams, solver in CASES:
                if solver == "spectral_dirichlet" and n > (512 if dev.type == "cpu" else 1024):
                    continue
                nscales = NSCALES[pair]
                cfg = RegConfig.from_regparams(method, [cs.NITER] * (nscales + 1), nscales,
                                               regparams, cs.NREFINE, navier_lame_solver=solver)
                res = register(iref, imov, cfg, device=dev)
                finite = bool(torch.isfinite(res.motion).all())
                emit({"probe": "pairs", "path": name, "pair": pair, "n": n, "nscales": nscales,
                      "regparams": regparams, "iterations": [t.iterations for t in res.traces],
                      "regrids": [t.regrids for t in res.traces], "finite": finite,
                      "ssd_reduction": float(ssd_reduction(iref, imov, torch.nan_to_num(
                          res.motion))) if finite else None,
                      "mean_motion_px": [float(res.motion[c].mean()) for c in range(2)]})


def fluid_sensitivity(dev, emit, n=512, caps=(3, 5, 10, 30, 200)):
    iref, imov = cs.pair_on(dev, "blob", n)
    nudged = imov.clone()
    nudged.view(torch.int32)[n // 2, n // 3] += 1
    for niter in caps:
        cfg = RegConfig.from_regparams(Method.FLUID, [niter] * (cs.PARITY_NSCALES + 1),
                                       cs.PARITY_NSCALES, [0.25, 0.0], cs.NREFINE,
                                       navier_lame_solver="spectral")
        a = register(iref, imov, cfg, device=dev)
        b = register(iref, nudged, cfg, device=dev)
        emit({"probe": "fluid_sensitivity", "n": n, "niter": niter,
              "one_ulp_change_px": float((a.motion - b.motion).abs().max()),
              "counts": [(t.iterations, t.regrids) for t in a.traces],
              "counts_one_ulp": [(t.iterations, t.regrids) for t in b.traces]})


def dirichlet_noise(dev, emit, shapes=((256, 256), (1000, 777), (1024, 1024))):
    rng = np.random.default_rng(cs.SEED + 2)
    for shape in shapes:
        f = torch.from_numpy(rng.standard_normal((2,) + shape).astype(np.float32)).to(dev)
        solve = make_dirichlet_navier_lame_solver(*shape, *cs.ELASTIC[:2])
        out = solve(f)
        emit({"probe": "dirichlet_noise", "shape": list(shape),
              "input_rounding_noise": cs.input_rounding_noise(solve, f, out)})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--sizes", type=int, nargs="+", default=[256, 512, 1024])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device(args.device)
    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    emit({"device": str(dev), "name": torch.cuda.get_device_name(dev) if dev.type == "cuda"
          else "cpu", "torch": torch.__version__})
    pairs(dev, args.sizes, emit)
    fluid_sensitivity(dev, emit)
    dirichlet_noise(dev, emit)


if __name__ == "__main__":
    main()
