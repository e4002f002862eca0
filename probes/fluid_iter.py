"""Measure B7, B8 and K3 (the fluid iteration, its sweep-and-max pass and its
strip mode) against the variants their design was chosen from, on one
card: the kernel as it was before its redesign, stage by stage; the
redesigned kernel stage by stage; the sweep of tile x threads x register
budget, the colour cells a thread takes down a column and the interior
route. Every full variant is held against the plain version
(``fluid_iter_ref``, ``fluid_iter_strip_ref``): vel', R and max |R|^2 bit
for bit.

    python3 probes/fluid_iter.py --out results.jsonl [--only REGEX]

Builds ``probes/fluid_iter.cuh`` with the kernels' flags into
``build/probe/``, then writes one JSON line per variant: registers, local
(spilled) bytes, resident blocks an SM, max-abs errors, and two CUDA-event
medians (ms0 in list order, ms1 in reverse) of 20 runs of 10 calls after 3
warm-ups, at 4096^2 (B7, B8) and on strip 1 of 4 of the 4096^2 grid padded
with 8 rows (K3), the reference stencil, mu 0.25, lambda 0, omega 0.66.
Needs one CUDA card.
"""
import argparse
import ctypes
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from opticalflow2d_tpu_torch.kernels import fluid_fused as k_fl  # noqa: E402
from opticalflow2d_tpu_torch.parallel import spatial  # noqa: E402
from opticalflow2d_tpu_torch.solvers.elastic import sor_scalars  # noqa: E402
import probe_tools  # noqa: E402

N, STRIPS, PAD = 4096, 4, k_fl.FLUID_PAD
FLUID = (0.25, 0.0, 0.66)  # mu, lambda, omega (chip_smoke.py's)
# The design taken: 32 x 64 tiles on 512 threads (two blocks an SM), runs of
# 2 colour cells, the interior route.
FINAL = dict(tx=32, ty=64, nt=512, mb=2, r=2, interior=1, store_r=1)
TILES = ((64, 64, 512, 1), (64, 64, 1024, 1), (64, 32, 256, 2), (64, 32, 512, 2),
         (32, 64, 256, 2), (32, 64, 512, 2), (48, 48, 256, 2), (48, 48, 512, 2),
         (32, 32, 256, 4), (32, 32, 512, 2), (32, 64, 768, 2), (32, 64, 1024, 2))


def new(strip, nhalf=2, deriv=1, **knobs):
    return ("new", strip, {**FINAL, **knobs, "nhalf": nhalf, "deriv": deriv})


def variants():
    e = [("before", False, dict(nhalf=n, deriv=0, store_r=1)) for n in (0, 1, 2)]
    e += [("before", s, dict(nhalf=2, deriv=1, store_r=1)) for s in (False, True)]
    e.append(("before", False, dict(nhalf=2, deriv=1, store_r=0)))
    e += [new(False, nhalf=n, deriv=0) for n in (0, 1, 2)]
    e += [new(False), new(True), new(False, store_r=0)]
    for strip in (False, True):
        for tx, ty, nt, mb in TILES:
            e.append(new(strip, tx=tx, ty=ty, nt=nt, mb=mb))
    for r in (1, 2, 3, 4):
        e += [new(False, r=r), new(True, r=r), new(False, r=r, tx=48, ty=48)]
    e += [new(False, interior=0), new(False, store_r=0, tx=48, ty=48)]
    e += [new(s, tx=16, ty=128, nt=nt) for s in (False, True) for nt in (256, 512)]
    names, out = set(), []
    for v in e:
        if name_of(*v) not in names:
            names.add(name_of(*v))
            out.append(v)
    return out


def name_of(kind, strip, p):
    s = "s" if strip else "d"
    if kind == "before":
        return f"before_{s}_h{p['nhalf']}_d{p['deriv']}_r{p['store_r']}"
    return (f"new_{s}_{p['tx']}x{p['ty']}_t{p['nt']}_b{p['mb']}_r{p['r']}_i{p['interior']}"
            f"_h{p['nhalf']}_d{p['deriv']}_sr{p['store_r']}")


def smem_bytes(kind, p):
    if kind == "before":
        return 4 * (9 * 36 * 36 + 8)
    return 4 * k_fl.fluid_smem_floats(p["tx"], p["ty"], p["nt"])


def source(items):
    out = ['#include "fluid_iter.cuh"']
    b = lambda x: "true" if x else "false"  # noqa: E731
    for kind, strip, p in items:
        nm = name_of(kind, strip, p)
        if kind == "before":
            targs = f"{p['nhalf']}, {b(p['deriv'])}, {b(p['store_r'])}"
            launch = f"launch_before<{targs}>"
            attr = f"attrs(before_kernel<{targs}>, 256, {smem_bytes(kind, p)}, o)"
        else:
            targs = (f"{p['tx']}, {p['ty']}, {p['nt']}, {p['mb']}, {p['r']}, "
                     f"{b(p['interior'])}, {p['nhalf']}, {b(p['deriv'])}, {b(p['store_r'])}")
            launch = f"launch_new<{targs}>"
            attr = f"attrs(new_kernel<{targs}>, {p['nt']}, {smem_bytes(kind, p)}, o)"
        out.append(
            f'extern "C" int {nm}(const float* u, const float* vel, const float* g, '
            f'float* vel_out, float* r_out, float* partials, float* maxsq, int nxl, int ny, '
            f'int pad, int row0, int nx, float mu, float mpl, float omw, float inv_diag, '
            f'cudaStream_t s) {{\n'
            f'  const Rows rows{{nxl, pad, row0, nx}};\n'
            f'  return {launch}(u, vel, g, vel_out, r_out, partials, maxsq, rows, ny, '
            f'SorScalars{{mu, mpl, omw, inv_diag}}, s);\n}}\n'
            f'extern "C" int {nm}_attrs(int* o) {{ return {attr}; }}\n')
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="JSON lines file to write")
    ap.add_argument("--only", help="regular expression on the variants' names")
    args = ap.parse_args()
    card = probe_tools.card()
    items = [v for v in variants() if not args.only or re.search(args.only, name_of(*v))]
    t0 = time.time()
    lib = probe_tools.build("fluid", source, items)
    build_s = time.time() - t0
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    u = torch.from_numpy(np.tanh(rng.normal(0, 1, (2, N, N))).astype(np.float32) * 0.6).to(dev)
    vel = torch.from_numpy(np.tanh(rng.normal(0, 1, (2, N, N))).astype(np.float32) * 0.3).to(dev)
    g = torch.from_numpy(rng.normal(0, 0.3, (3, N, N)).astype(np.float32)).to(dev)
    nxl = row0 = N // STRIPS
    up, vp, gp = (spatial._halo_pad(spatial._split(f, [dev] * STRIPS), PAD)[1]
                  for f in (u, vel, g))
    ref = k_fl.fluid_iter_ref(u, vel, g, *FLUID)
    ref_strip = k_fl.fluid_iter_strip_ref(up, vp, gp, row0, N, *FLUID, True, False, PAD)
    partials = torch.empty((N // 32) ** 2, device=dev)
    maxsq = torch.empty((), device=dev)
    scal = sor_scalars(*FLUID)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def call(fn, strip, vout, rout):
        p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        fs = [ctypes.c_float(x) for x in scal]
        if strip:
            return fn(p(up), p(vp), p(gp), p(vout), p(rout), p(partials), p(maxsq), nxl, N, PAD,
                      row0, N, *fs, stream)
        return fn(p(u), p(vel), p(g), p(vout), p(rout), p(partials), p(maxsq), N, N, 0, 0, N,
                  *fs, stream)

    rows = []
    for kind, strip, p in items:
        nm = name_of(kind, strip, p)
        fn = getattr(lib, nm)
        o3 = (ctypes.c_int * 3)()
        attr_rc = getattr(lib, nm + "_attrs")(o3)
        shape = (2, nxl, N) if strip else (2, N, N)
        vout, rout = torch.empty(shape, device=dev), torch.zeros(shape, device=dev)
        rec = {"name": nm, "kind": kind, "strip": strip, **p, "attr_rc": attr_rc,
               "regs": o3[0], "local_bytes": o3[1], "blocks_per_sm": o3[2],
               "smem_bytes": smem_bytes(kind, p)}
        rc = call(fn, strip, vout, rout)
        torch.cuda.synchronize()
        if rc:
            raise SystemExit(f"{nm}: CUDA error {rc}")
        if p["nhalf"] == 2 and p["deriv"]:
            want_v, want_r, want_m = ref_strip if strip else ref
            rec["err_vel"] = float((vout - want_v).abs().max())
            rec["err_r"] = float((rout - want_r).abs().max()) if p["store_r"] else None
            rec["bit_equal"] = bool(torch.equal(vout, want_v) and torch.equal(maxsq, want_m)
                                    and (not p["store_r"] or torch.equal(rout, want_r)))
        rows.append((fn, strip, vout, rout, rec))
    for rnd, order in enumerate((rows, rows[::-1])):
        for fn, strip, vout, rout, rec in order:
            rec[f"ms{rnd}"] = probe_tools.median_ms(lambda: call(fn, strip, vout, rout))
    with open(args.out, "w") as fh:
        fh.write(json.dumps({"card": card, "build_s": build_s, "variants": len(rows)}) + "\n")
        for *_, rec in rows:
            fh.write(json.dumps(rec) + "\n")
            print(json.dumps(rec))
    print(card)


if __name__ == "__main__":
    main()
