"""Measure B1 and K1 (the diffusion block and its strip mode) against the
variants their design was chosen from, on one card: the kernel as it was
before its redesign, stage by stage; the redesigned kernel stage by stage;
the sweep of tile x threads x register budget, the cells a thread takes down
a column, the order of the work items (the owned tile's first, or one walk
over the region), the interior route and k compiled in; and the plans of
k = 16.
Every full variant is held against the plain version (``diffusion_block_ref``,
``diffusion_block_strip_ref``): the field bit for bit, the Logger sums
relative.

    python3 probes/diffusion_block.py --out results.jsonl [--only REGEX]

Builds ``probes/diffusion_block.cuh`` with the kernels' flags into
``build/probe/``, then writes one JSON line per variant: registers, local
(spilled) bytes, resident blocks an SM, max-abs error, sums' relative
error, and two CUDA-event medians (ms0 in list order, ms1 in reverse) of 20
runs of 10 calls after 3 warm-ups, at 4096^2 (B1) and on strip 1 of 4 of the
4096^2 grid padded with 8 rows (K1), k = 8 (and 16 where named), alpha 0.1.
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
from opticalflow2d_tpu_torch.kernels import _build  # noqa: E402
from opticalflow2d_tpu_torch.kernels import diffusion_block as k_diff  # noqa: E402
from opticalflow2d_tpu_torch.parallel import spatial  # noqa: E402
import probe_tools  # noqa: E402

N, K, STRIPS, ALPHA = 4096, 8, 4, 0.1
PAD = k_diff.required_pad(K)
# The design taken: 48 x 48 tiles on 512 threads (two blocks an SM), runs of
# 2 cells in one walk over each step's region, the interior route, k = 8
# compiled in.
FINAL = dict(K=K, k=K, tx=48, ty=48, nt=512, mb=2, r=2, interior=1, split=0)
TILES = ((64, 64, 512, 1), (64, 64, 1024, 1), (64, 32, 256, 2), (64, 32, 512, 2),
         (32, 64, 512, 2), (48, 48, 256, 2), (48, 48, 384, 2), (48, 48, 512, 2),
         (56, 40, 512, 2), (40, 56, 512, 2), (32, 32, 256, 3), (32, 32, 256, 4),
         (48, 48, 768, 2), (48, 48, 1024, 2), (40, 56, 768, 2))
# bench.py's k = 16 (dense only): the first plan at one block an SM, against
# 32 x 32 at two.
K16 = ((48, 48, 512, 1), (48, 48, 512, 2), (32, 32, 256, 2), (32, 32, 512, 2))


def new(strip, nsteps=K, sums=1, **knobs):
    return ("new", strip, {**FINAL, **knobs, "nsteps": nsteps, "sums": sums})


def variants():
    e = [("before", False, dict(k=K, nsteps=n, sums=0)) for n in (0, 1, 2, 4, 8)]
    e += [("before", s, dict(k=K, nsteps=K, sums=1)) for s in (False, True)]
    e += [new(False, nsteps=n, sums=0) for n in (0, 1, 2, 4, 8)]
    e += [new(False), new(True)]
    for strip in (False, True):
        for tx, ty, nt, mb in TILES:
            e.append(new(strip, tx=tx, ty=ty, nt=nt, mb=mb))
    for r in (1, 2, 3, 4, 6, 8):
        e += [new(False, r=r), new(True, r=r)]
    for r in (2, 4):
        e += [new(False, r=r, split=1), new(True, r=r, split=1)]
        e += [new(False, r=r, split=1, nsteps=n, sums=0) for n in (0, 8)]
    e += [new(False, interior=0), new(False, K=0), new(True, K=0)]
    for tx, ty, nt, mb in K16:
        e.append(new(False, K=0, k=16, nsteps=16, tx=tx, ty=ty, nt=nt, mb=mb))
    e.append(("before", False, dict(k=16, nsteps=16, sums=1)))
    names, out = set(), []
    for v in e:
        if name_of(*v) not in names:
            names.add(name_of(*v))
            out.append(v)
    return out


def name_of(kind, strip, p):
    s = "s" if strip else "d"
    if kind == "before":
        return f"before_{s}_k{p['k']}_n{p['nsteps']}_s{p['sums']}"
    return (f"new_{s}_K{p['K']}_k{p['k']}_{p['tx']}x{p['ty']}_t{p['nt']}_b{p['mb']}_r{p['r']}"
            f"_i{p['interior']}_w{p['split']}_n{p['nsteps']}_s{p['sums']}")


def smem_bytes(kind, p):
    if kind == "before":
        return 4 * (7 * (32 + 2 * p["k"]) ** 2 + p["k"] * 8 * 2)
    return 4 * k_diff.diffusion_smem_floats(p["k"], p["tx"], p["ty"], p["nt"])


def source(items):
    out = ['#include "diffusion_block.cuh"']
    b = lambda x: "true" if x else "false"  # noqa: E731
    for kind, strip, p in items:
        nm = name_of(kind, strip, p)
        if kind == "before":
            targs = f"{p['nsteps']}, {b(p['sums'])}"
            launch = f"launch_before<{targs}>"
            attr = f"attrs(before_kernel<{targs}>, 256, {smem_bytes(kind, p)}, o)"
        else:
            targs = (f"{p['K']}, {p['tx']}, {p['ty']}, {p['nt']}, {p['mb']}, {p['r']}, "
                     f"{b(p['interior'])}, {p['nsteps']}, {b(p['sums'])}, {b(p['split'])}")
            launch = f"launch_new<{targs}>"
            attr = f"attrs(new_kernel<{targs}>, {p['nt']}, {smem_bytes(kind, p)}, o)"
        out.append(
            f'extern "C" int {nm}(const float* u, const float* g, float* out, float* partials, '
            f'float* sums, int nxl, int ny, int pad, int row0, int nx, int k, float a2, '
            f'cudaStream_t s) {{\n'
            f'  const Rows rows{{nxl, pad, row0, nx}};\n'
            f'  return {launch}(u, g, out, partials, sums, rows, ny, k, a2, s);\n}}\n'
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
    lib = probe_tools.build("diffusion", source, items)
    build_s = time.time() - t0
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    u = torch.from_numpy(rng.normal(0, 2, (2, N, N)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(0, 0.3, (3, N, N)).astype(np.float32)).to(dev)
    nxl = row0 = N // STRIPS
    up, gp = (spatial._halo_pad(spatial._split(f, [dev] * STRIPS), PAD)[1] for f in (u, g))
    refs = {}

    def ref(strip, k):
        if (strip, k) not in refs:
            refs[strip, k] = (k_diff.diffusion_block_strip_ref(up, gp, row0, N, ALPHA, k, PAD)
                              if strip else k_diff.diffusion_block_ref(u, g, ALPHA, k))
        return refs[strip, k]

    partials = torch.empty((N // 32) ** 2 * 16 * 2, device=dev)
    sums = {k: torch.empty((k, 2), device=dev) for k in (K, 16)}
    a2 = ctypes.c_float(_build.f32(ALPHA * ALPHA))
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def call(fn, strip, k, out):
        p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        if strip:
            return fn(p(up), p(gp), p(out), p(partials), p(sums[k]), nxl, N, PAD, row0, N, k,
                      a2, stream)
        return fn(p(u), p(g), p(out), p(partials), p(sums[k]), N, N, 0, 0, N, k, a2, stream)

    rows = []
    for kind, strip, p in items:
        nm = name_of(kind, strip, p)
        fn = getattr(lib, nm)
        o3 = (ctypes.c_int * 3)()
        attr_rc = getattr(lib, nm + "_attrs")(o3)
        out = torch.empty((2, nxl, N) if strip else (2, N, N), device=dev)
        rec = {"name": nm, "kind": kind, "strip": strip, **p, "attr_rc": attr_rc,
               "regs": o3[0], "local_bytes": o3[1], "blocks_per_sm": o3[2],
               "smem_bytes": smem_bytes(kind, p)}
        rc = call(fn, strip, p["k"], out)
        torch.cuda.synchronize()
        if rc:
            raise SystemExit(f"{nm}: CUDA error {rc}")
        if p["nsteps"] == p["k"] and p["sums"]:
            want, want_sums = ref(strip, p["k"])
            rec["err"] = float((out - want).abs().max())
            rec["bit_equal"] = bool(torch.equal(out, want))
            rec["sums_rel_err"] = float(((sums[p["k"]] - want_sums).abs()
                                         / want_sums.abs()).max())
        rows.append((fn, strip, p["k"], out, rec))
    for rnd, order in enumerate((rows, rows[::-1])):
        for fn, strip, k, out, rec in order:
            rec[f"ms{rnd}"] = probe_tools.median_ms(lambda: call(fn, strip, k, out))
    with open(args.out, "w") as fh:
        fh.write(json.dumps({"card": card, "build_s": build_s, "variants": len(rows)}) + "\n")
        for *_, rec in rows:
            fh.write(json.dumps(rec) + "\n")
            print(json.dumps(rec))
    print(card)


if __name__ == "__main__":
    main()
