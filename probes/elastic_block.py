"""Measure B6 and K2 (the elastic block and its strip mode) against the
variants their design was chosen from, on one card: the kernel as it was
before its redesign, stage by stage; the redesigned kernel stage by stage;
the sweep of tile x threads x register budget, the cells a thread takes down
a column, the layout (ping-pong or in place through registers), the staging
(cp.async or loads through registers), the interior route, k compiled in,
persistent grids with one or two staging areas, and a staggered start of
each SM's second block.
Every full variant is held against the plain version (``elastic_block_ref``,
``elastic_block_strip_ref``): the field bit for bit, the Logger sums
relative.

    python3 probes/elastic_block.py --out results.jsonl [--only REGEX]

Builds ``probes/elastic_block.cuh`` with the kernels' flags into
``build/probe/``, then writes one JSON line per variant: registers, local
(spilled) bytes, resident blocks an SM, max-abs error, sums' relative
error, and two CUDA-event medians (ms0 in list order, ms1 in reverse) of 20
runs of 10 calls after 3 warm-ups, at 4096^2 (B6) and on strip 1 of 4 of the
4096^2 grid padded with 8 rows (K2), k = 4, the reference stencil, mu 0.5,
lambda 0, omega 0.66. Needs one CUDA card.
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
from opticalflow2d_tpu_torch.kernels import elastic_block as k_el  # noqa: E402
from opticalflow2d_tpu_torch.parallel import spatial  # noqa: E402
from opticalflow2d_tpu_torch.solvers.elastic import sor_scalars  # noqa: E402
import probe_tools  # noqa: E402

N, K, STRIPS = 4096, 4, 4
PAD = k_el.required_pad(K)
ELASTIC = (0.5, 0.0, 0.66)  # mu, lambda, omega (chip_smoke.py's)
# The design taken: 48 x 48 tiles on 512 threads (two blocks an SM), runs of
# 4 cells, ping-pong buffers, cp.async staging, the interior route, k = 4
# compiled in. FIRST: the first design tried, 64 x 64 at one block an SM.
FINAL = dict(K=K, tx=48, ty=48, nt=512, mb=2, r=4, layout=0, stage=0, interior=1, delay=0)
FIRST = dict(tx=64, ty=64, nt=512, mb=1)
TILES = ((64, 64, 512, 1), (64, 64, 1024, 1), (64, 32, 256, 2), (64, 32, 512, 2),
         (32, 64, 256, 2), (32, 64, 512, 2), (48, 48, 256, 2), (48, 48, 384, 2),
         (48, 48, 512, 2), (56, 40, 512, 2), (40, 56, 512, 2), (32, 32, 256, 3))
# Persistent grids: tile, threads, blocks an SM, staging areas.
PERSISTENT = ((48, 48, 512, 2, 1), (48, 48, 1024, 1, 2), (48, 48, 512, 1, 2),
              (40, 40, 1024, 1, 2), (32, 32, 512, 2, 2), (32, 32, 256, 2, 2))


def new(strip, nhalf=2 * K, sums=1, **knobs):
    return ("new", strip, {**FINAL, **knobs, "nhalf": nhalf, "sums": sums})


def variants():
    e = [("before", False, dict(nhalf=n, sums=0)) for n in (0, 1, 2, 4, 8)]
    e += [("before", s, dict(nhalf=8, sums=1)) for s in (False, True)]
    for knobs in ({}, FIRST):
        e += [new(False, nhalf=n, sums=0, **knobs) for n in (0, 1, 2, 4, 8)]
        e += [new(False, **knobs), new(True, **knobs)]
    for strip in (False, True):
        for tx, ty, nt, mb in TILES:
            e.append(new(strip, tx=tx, ty=ty, nt=nt, mb=mb))
    for r in (1, 2, 3, 4, 8):
        e += [new(False, r=r), new(False, r=r, **FIRST)]
    for tx, ty, nt, mb in ((64, 64, 512, 1), (64, 64, 1024, 1), (64, 32, 512, 2),
                           (48, 48, 512, 2), (32, 32, 256, 4)):
        e.append(new(False, tx=tx, ty=ty, nt=nt, mb=mb, layout=1))
    e += [new(False, stage=1), new(False, interior=0), new(False, K=0)]
    for strip in (False, True):
        e += [new(strip, delay=d) for d in (2000, 5000, 10000)]
    for strip in (False, True):
        for tx, ty, nt, mb, nb in PERSISTENT:
            e.append(("pers", strip, {**FINAL, "tx": tx, "ty": ty, "nt": nt, "mb": mb, "nb": nb,
                                      "nhalf": 2 * K, "sums": 1}))
    names, out = set(), []
    for v in e:
        if name_of(*v) not in names:
            names.add(name_of(*v))
            out.append(v)
    return out


def name_of(kind, strip, p):
    s = "s" if strip else "d"
    if kind == "before":
        return f"before_{s}_h{p['nhalf']}_s{p['sums']}"
    if kind == "pers":
        return f"pers_{s}_K{p['K']}_{p['tx']}x{p['ty']}_t{p['nt']}_b{p['mb']}_nb{p['nb']}"
    return (f"new_{s}_K{p['K']}_{p['tx']}x{p['ty']}_t{p['nt']}_b{p['mb']}_r{p['r']}"
            f"_l{p['layout']}_st{p['stage']}_i{p['interior']}_h{p['nhalf']}_s{p['sums']}"
            + (f"_d{p['delay']}" if p["delay"] else ""))


def smem_bytes(kind, p, k=K):
    if kind == "before":
        return 4 * (7 * (32 + 4 * k) ** 2 + k * 8 * 2)
    if kind == "pers":
        return 4 * ((5 * p["nb"] + 2) * (p["tx"] + 4 * k) * (p["ty"] + 4 * k)
                    + k * (p["nt"] // 32) * 2)
    planes = 7 if p["layout"] == 0 else 5
    return 4 * (planes * (p["tx"] + 4 * k) * (p["ty"] + 4 * k) + k * (p["nt"] // 32) * 2)


def source(items):
    out = ['#include "elastic_block.cuh"']
    b = lambda x: "true" if x else "false"  # noqa: E731
    for kind, strip, p in items:
        nm = name_of(kind, strip, p)
        if kind == "before":
            targs = f"true, {p['nhalf']}, {b(p['sums'])}"
            launch = f"launch_before<{targs}>"
            attr = f"attrs(before_kernel<{targs}>, 256, {smem_bytes(kind, p)}, o)"
        elif kind == "pers":
            targs = (f"{p['K']}, {p['tx']}, {p['ty']}, {p['nt']}, {p['mb']}, {p['r']}, true, "
                     f"{p['nb']}")
            launch = f"launch_pers<{targs}>"
            attr = f"attrs(pers_kernel<{targs}>, {p['nt']}, {smem_bytes(kind, p)}, o)"
        else:
            targs = (f"{p['K']}, {p['tx']}, {p['ty']}, {p['nt']}, {p['mb']}, {p['r']}, true, "
                     f"{p['layout']}, {p['stage']}, {b(p['interior'])}, {p['nhalf']}, "
                     f"{b(p['sums'])}, {p['delay']}")
            launch = f"launch_new<{targs}>"
            attr = f"attrs(new_kernel<{targs}>, {p['nt']}, {smem_bytes(kind, p)}, o)"
        out.append(
            f'extern "C" int {nm}(const float* u, const float* g, float* out, float* partials, '
            f'float* sums, int nxl, int ny, int pad, int row0, int nx, int k, float mu, '
            f'float mpl, float omw, float inv_diag, cudaStream_t s) {{\n'
            f'  const Rows rows{{nxl, pad, row0, nx}};\n'
            f'  return {launch}(u, g, out, partials, sums, rows, ny, k, '
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
    lib = probe_tools.build("elastic", source, items)
    build_s = time.time() - t0
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    u = torch.from_numpy(np.tanh(rng.normal(0, 1, (2, N, N))).astype(np.float32) * 0.4).to(dev)
    g = torch.from_numpy(rng.normal(0, 0.3, (3, N, N)).astype(np.float32)).to(dev)
    nxl = row0 = N // STRIPS
    up, gp = (spatial._halo_pad(spatial._split(f, [dev] * STRIPS), PAD)[1] for f in (u, g))
    ref = k_el.elastic_block_ref(u, g, *ELASTIC, True, K)
    ref_strip = k_el.elastic_block_strip_ref(up, gp, row0, N, *ELASTIC, True, K, PAD)
    partials = torch.empty((N // 32) ** 2 * K * 2, device=dev)
    sums = torch.empty((K, 2), device=dev)
    scal = sor_scalars(*ELASTIC)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def call(fn, strip, out):
        p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        fs = [ctypes.c_float(x) for x in scal]
        if strip:
            return fn(p(up), p(gp), p(out), p(partials), p(sums), nxl, N, PAD, row0, N, K, *fs,
                      stream)
        return fn(p(u), p(g), p(out), p(partials), p(sums), N, N, 0, 0, N, K, *fs, stream)

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
        rc = call(fn, strip, out)
        torch.cuda.synchronize()
        if rc:
            raise SystemExit(f"{nm}: CUDA error {rc}")
        if p["nhalf"] == 2 * K and p["sums"]:
            want, want_sums = ref_strip if strip else ref
            rec["err"] = float((out - want).abs().max())
            rec["bit_equal"] = bool(torch.equal(out, want))
            rec["sums_rel_err"] = float(((sums - want_sums).abs() / want_sums.abs()).max())
        rows.append((fn, strip, out, rec))
    for rnd, order in enumerate((rows, rows[::-1])):
        for fn, strip, out, rec in order:
            rec[f"ms{rnd}"] = probe_tools.median_ms(lambda: call(fn, strip, out))
    with open(args.out, "w") as fh:
        fh.write(json.dumps({"card": card, "build_s": build_s, "variants": len(rows)}) + "\n")
        for *_, rec in rows:
            fh.write(json.dumps(rec) + "\n")
            print(json.dumps(rec))
    print(card)


if __name__ == "__main__":
    main()
