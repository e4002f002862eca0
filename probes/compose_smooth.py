"""Measure B12 and K7 (compose and smooth) against the variants their design
was chosen from, on one card: the kernel as it was before its redesign, stage
by stage; the redesigned kernel stage by stage; the sweep of tile x staging
buffers x register budget; the compose batch and 32-bit tap offsets; other
kernelwidths. Every full variant is held against the plain version
(``compose_smooth_ref``, ``compose_smooth_strip_ref``) on a field of 0.4 px
and one of 30 px.

    python3 probes/compose_smooth.py --out results.jsonl [--only REGEX]

Builds ``probes/compose_smooth.cuh`` with the kernels' flags into
``build/probe/``, then writes one JSON line per variant: registers, local
(spilled) bytes, resident blocks an SM, max-abs error, and two CUDA-event
medians (ms0 in list order, ms1 in reverse) of 20 runs of 10 calls after 3
warm-ups, at 4096^2 (B12) and on strip 1 of 4 of the 4096^2 grid padded
with 8 rows (K7), kernelwidth 5 unless named. Needs one CUDA card.
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
from opticalflow2d_tpu_torch.kernels import demons_fused as k_df  # noqa: E402
from opticalflow2d_tpu_torch.parallel import spatial  # noqa: E402
import probe_tools  # noqa: E402

N, KW, SD, HALO, STRIPS, PAD = 4096, 5, 2.0, 5, 4, 8
# The design taken: 64 x 64 tiles, one staging buffer, 64 registers (two
# blocks an SM), two compose cells in flight, 32-bit offsets.
FINAL = dict(tx=64, ty=64, nb=1, cap=64, kb=2, i32=1)


def new(strip, stop=3, kw=5, **knobs):
    return ("new", strip, {**FINAL, **knobs, "stop": stop, "kw": kw, "K": 5 if kw == 5 else 0})


def variants():
    e = [("before", False, dict(stop=s, kw=5)) for s in range(4)]
    e += [("before", True, dict(stop=3, kw=5))]
    e += [new(False, stop=s) for s in range(4)] + [new(True)]
    for strip in (False, True):
        for tx, ty in ((64, 64), (64, 32), (32, 32)):
            for nb in (1, 2):
                for cap in (128, 64):
                    e.append(new(strip, tx=tx, ty=ty, nb=nb, cap=cap, kb=1, i32=0))
        for nb in (1, 2):
            for kb in (1, 2, 4):
                for i32 in (0, 1):
                    e.append(new(strip, nb=nb, kb=kb, i32=i32))
    for kw in (7, 11, 43):
        e.append(("before", False, dict(stop=3, kw=kw)))
        tiles = [(64, 64, 1), (64, 64, 2)] + ([(32, 32, 1), (32, 32, 2)] if kw == 43 else [])
        e += [new(False, kw=kw, tx=tx, ty=ty, nb=nb) for tx, ty, nb in tiles
              if 4 * k_df.compose_smooth_smem_floats(kw, tx, ty, nb) <= k_df.MAX_SMEM_BYTES]
    names, out = set(), []
    for v in e:
        if name_of(*v) not in names:
            names.add(name_of(*v))
            out.append(v)
    return out


def name_of(kind, strip, p):
    s = "s" if strip else "d"
    if kind == "before":
        return f"before_{s}_kw{p['kw']}_stop{p['stop']}"
    return (f"new_{s}_kw{p['kw']}_{p['tx']}x{p['ty']}_nb{p['nb']}_cap{p['cap']}"
            f"_kb{p['kb']}_i{p['i32']}_stop{p['stop']}")


def threads(p):
    return 512 if p["tx"] * p["ty"] >= 2048 else 256


def source(items):
    out = ['#include "compose_smooth.cuh"']
    for kind, strip, p in items:
        nm, st = name_of(kind, strip, p), "true" if strip else "false"
        if kind == "before":
            targs = f"{st}, {p['stop']}"
            launch = f"launch_before<{targs}>(u, c, out, rows, ny, halo, k, td, s)"
            attr = f"attrs(before_kernel<{targs}>, 256, 16 * (32 + k / 2 * 2) * (32 + k / 2 * 2), o)"
        else:
            blocks = 65536 // (threads(p) * p["cap"])
            targs = (f"{p['K']}, {p['tx']}, {p['ty']}, {p['nb']}, {blocks}, {p['kb']}, "
                     f"{'true' if p['i32'] else 'false'}, {p['stop']}, {st}")
            launch = f"launch_new<{targs}>(u, c, out, rows, ny, halo, k, td, s)"
            attr = (f"attrs(new_kernel<{targs}>, {threads(p)}, "
                    f"new_smem_floats(k, {p['tx']}, {p['ty']}, {p['nb']}) * 4, o)")
        out.append(
            f'extern "C" int {nm}(const float* u, const float* c, float* out, int nxl, int ny, '
            f'int pad, int row0, int nx, int halo, int k, const float* taps, cudaStream_t s) {{\n'
            f'  Taps td;\n  if (!make_taps(taps, k, &td)) return 1;\n'
            f'  const Rows rows{{nxl, pad, row0, nx}};\n  return {launch};\n}}\n'
            f'extern "C" int {nm}_attrs(int k, int* o) {{ return {attr}; }}\n')
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="JSON lines file to write")
    ap.add_argument("--only", help="regular expression on the variants' names")
    args = ap.parse_args()
    card = probe_tools.card()
    items = [v for v in variants() if not args.only or re.search(args.only, name_of(*v))]
    t0 = time.time()
    lib = probe_tools.build("compose", source, items)
    build_s = time.time() - t0
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    u = torch.from_numpy(rng.normal(0, 1, (2, N, N)).astype(np.float32)).to(dev)
    v = (torch.tanh(u) * 0.4).contiguous()   # chip_smoke.py's timing field
    far = (torch.tanh(u.flip(2)) * 30.0).contiguous()
    nxl = row0 = N // STRIPS
    u7, v7, f7 = (spatial._halo_pad(spatial._split(f, [dev] * STRIPS), PAD)[1]
                  for f in (u, v, far))
    refs = {kw: [k_df.compose_smooth_ref(u, c, SD, kw) for c in (v, far)]
            for kw in sorted({p["kw"] for _, _, p in items})}
    refs_strip = [k_df.compose_smooth_strip_ref(u7, c, row0, N, SD, KW, HALO, PAD)
                  for c in (v7, f7)]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def call(fn, strip, c, out, kw):
        p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        taps = k_df.taps_array(SD, kw)
        if strip:
            return fn(p(u7), p(c), p(out), nxl, N, PAD, row0, N, HALO, kw, taps, stream)
        return fn(p(u), p(c), p(out), N, N, 0, 0, N, 0, kw, taps, stream)

    rows = []
    for kind, strip, p in items:
        nm = name_of(kind, strip, p)
        fn = getattr(lib, nm)
        o3 = (ctypes.c_int * 3)()
        attr_rc = getattr(lib, nm + "_attrs")(p["kw"], o3)
        out = torch.empty((2, nxl, N) if strip else (2, N, N), device=dev)
        rec = {"name": nm, "kind": kind, "strip": strip, **p, "attr_rc": attr_rc,
               "regs": o3[0], "local_bytes": o3[1], "blocks_per_sm": o3[2]}
        for i, field in enumerate(("err", "err_far")):
            rc = call(fn, strip, (v7, f7)[i] if strip else (v, far)[i], out, p["kw"])
            torch.cuda.synchronize()
            if rc:
                raise SystemExit(f"{nm}: CUDA error {rc}")
            if p["stop"] == 3:
                want = refs_strip[i] if strip else refs[p["kw"]][i]
                rec[field] = float((out - want).abs().max())
        rows.append((fn, strip, out, rec))
    for rnd, order in enumerate((rows, rows[::-1])):
        for fn, strip, out, rec in order:
            c = v7 if strip else v
            rec[f"ms{rnd}"] = probe_tools.median_ms(lambda: call(fn, strip, c, out, rec["kw"]))
    with open(args.out, "w") as fh:
        fh.write(json.dumps({"card": card, "build_s": build_s, "variants": len(rows)}) + "\n")
        for *_, rec in rows:
            fh.write(json.dumps(rec) + "\n")
            print(json.dumps(rec))
    print(card)


if __name__ == "__main__":
    main()
