"""Time the motion upsample (``csrc/upsample.cu``) against the variants its
design was chosen from, on one card.

    python3 probes/upsample_sweep.py --out results.jsonl

Builds ``probes/upsample_motion.cuh`` with the kernels' flags into
``build/probe/`` and writes one JSON line per variant and source size
(2048^2, 1024^2 and 256^2 to 4096^2): points a thread (``vec``), rows a
thread (``rows``), the block (``ty`` x ``tx`` threads), 32- or 64-bit
offsets (``i32``), the mode (0 the kernel's arithmetic, 1 stores only, 2
without the division), registers, whether mode 0 equals the plain version
bit for bit, and two CUDA-event medians (ms0 in list order, ms1 in
reverse) of 20 runs of 10 calls after 3 warm-ups, beside the kernel's own
and its bound (the output's write and the source's read over 3.35 TB/s).
Needs one CUDA card, about a minute.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from opticalflow2d_tpu_torch.kernels import _build  # noqa: E402
from opticalflow2d_tpu_torch.kernels.upsample import (  # noqa: E402
    upsample_motion, upsample_motion_ref, upsample_ratios)
import probe_tools  # noqa: E402

N = 4096
SOURCES = (2048, 1024, 256)
PEAK_BYTES_PER_S = 3.35e12
# (vec, rows, ty, tx, mode, i32); the kernel as built is (4, 4, 32, 4, 0, 0).
VARIANTS = [(4, 1, 32, 8, 0, 0), (1, 1, 32, 8, 0, 0), (2, 1, 32, 8, 0, 0),
            (8, 1, 32, 8, 0, 0), (4, 1, 64, 4, 0, 0), (4, 1, 128, 2, 0, 0),
            (4, 1, 32, 4, 0, 0), (4, 1, 32, 16, 0, 0), (4, 2, 32, 4, 0, 0),
            (4, 2, 32, 8, 0, 0), (4, 4, 32, 2, 0, 0), (2, 2, 32, 8, 0, 0),
            (8, 2, 32, 4, 0, 0), (4, 1, 32, 8, 0, 1), (4, 2, 32, 4, 0, 1),
            (8, 1, 32, 8, 0, 1), (2, 2, 32, 8, 0, 1), (4, 1, 32, 8, 1, 0),
            (4, 2, 32, 4, 1, 0), (4, 1, 32, 8, 2, 0), (4, 2, 32, 4, 2, 0),
            # Around the best of the above: more rows a thread.
            (4, 4, 32, 1, 0, 0), (4, 4, 32, 4, 0, 0), (4, 4, 64, 1, 0, 0), (4, 8, 32, 1, 0, 0),
            (4, 8, 32, 2, 0, 0), (4, 4, 32, 2, 0, 1), (4, 8, 32, 1, 0, 1), (2, 4, 32, 4, 0, 0),
            (2, 8, 32, 2, 0, 0), (4, 2, 64, 2, 0, 0), (4, 4, 32, 2, 2, 0)]


def entry(v) -> str:
    return "up_" + "_".join(map(str, v))


def source(items) -> str:
    lines = ['#include "upsample_motion.cuh"']
    for v in items:
        vec, rows, ty, tx, mode, i32 = v
        lines.append(
            f'extern "C" int {entry(v)}(const float* s, float* o, int a, int b, int c, int d, '
            f'float rx, float ry, float sx, float sy, cudaStream_t st) {{ return '
            f'launch_variant<{vec}, {rows}, {ty}, {tx}, {mode}, {"true" if i32 else "false"}>'
            f'(s, o, a, b, c, d, rx, ry, sx, sy, st); }}')
    return "\n".join(lines) + "\n"


def registers(stem: str) -> dict:
    """Registers of each variant's kernel from ptxas, keyed by template
    arguments as the mangled name carries them."""
    out = {}
    for obj in sorted(probe_tools.BUILD.glob(f"{stem}*.o")):
        text = subprocess.run(
            [str(Path(_build._nvcc()).with_name("cuobjdump")), "-res-usage", str(obj)],
            capture_output=True, text=True).stdout
        name = None
        for line in text.splitlines():
            if "Function" in line:
                name = line.split("Function")[-1].strip(" :")
            elif name and "REG:" in line:
                out[name] = int(line.split("REG:")[1].split()[0])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    card = probe_tools.card()
    lib = probe_tools.build("upsample", source, VARIANTS, parts=4)
    regs = registers("upsample")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(16)
    lines = []
    for n_in in SOURCES:
        u = torch.randn((2, n_in, n_in), generator=gen, device=dev) * 3
        u.view(-1)[::10] = 0.0
        dst = (N, N)
        ref = upsample_motion_ref(u, dst)
        ratios = upsample_ratios((n_in, n_in), dst)
        bound = 8 * (N * N + n_in * n_in) / PEAK_BYTES_PER_S * 1e3
        stream = torch.cuda.current_stream().cuda_stream
        runs = []
        for v in VARIANTS:
            fn = getattr(lib, entry(v))
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4 + [
                ctypes.c_void_p]
            out = torch.empty_like(ref)
            call = (lambda fn=fn, out=out: fn(u.data_ptr(), out.data_ptr(), n_in, n_in, N, N,
                                             *ratios, stream))
            if call() != 0:
                raise SystemExit(f"{entry(v)} failed to launch")
            torch.cuda.synchronize()
            equal = bool(torch.equal(out.view(torch.int32), ref.view(torch.int32)))
            runs.append((v, call, equal))
        runs.append(("kernel", lambda: upsample_motion(u, dst), True))
        ms = {}
        for order in (0, 1):
            for v, call, _ in (runs if order == 0 else runs[::-1]):
                ms.setdefault(str(v), []).append(probe_tools.median_ms(call))
        for v, _, equal in runs:
            vec, rows, ty, tx, mode, i32 = v if v != "kernel" else (4, 4, 32, 4, 0, 0)
            reg = [r for name, r in regs.items()
                   if f"ILi{vec}ELi{rows}ELi{ty}ELi{tx}ELi{mode}ELb{i32}E" in name]
            line = {"variant": v if v == "kernel" else dict(vec=vec, rows=rows, ty=ty, tx=tx,
                                                           mode=mode, i32=i32),
                    "source": n_in, "target": N, "regs": reg[0] if reg else None,
                    "bit_equal": equal if mode == 0 else None,
                    "ms0": ms[str(v)][0], "ms1": ms[str(v)][1], "bound_ms": bound,
                    "card": card}
            lines.append(json.dumps(line))
            print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
