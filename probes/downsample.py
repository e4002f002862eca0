"""Time the box downsample (``csrc/downsample.cu``) at the cells' own shapes
against its bound and its plain version, and check its bits, on one card.

    python3 probes/downsample.py --out results.jsonl

Writes one JSON line per case: the slide cell's 4096^2 levels (2D images to
2048^2 ... 256^2, and ``[2, nx, ny]`` fields) and the fluid cell's 16384^2
levels (8192^2 ... 1024^2), the kernel's CUDA-event median (20 runs of 10
calls after 3 warm-ups), the plain version's (5 runs of 2 calls at
16384^2), the bound (the input read once and the output written once over
3.35 TB/s) and whether the kernel's output equals the plain version's bit
for bit; then the odd shapes' bit checks (ragged crops, non-power-of-two
patches, a patch past a tile). First, how PyTorch divides a CUDA tensor by
a host scalar (the plain version's mean), against a product with the
float32 reciprocal and against a true division. About a minute and a half.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from opticalflow2d_tpu_torch import kernels  # noqa: E402
from opticalflow2d_tpu_torch.kernels.downsample import (  # noqa: E402
    downsample_image, downsample_image_ref, downsample_motion, downsample_motion_ref,
    downsample_order)
from opticalflow2d_tpu_torch.ops.resample import pyramid_dims  # noqa: E402
import probe_tools  # noqa: E402

PEAK_BYTES_PER_S = 3.35e12
CELLS = ((4096, range(1, 5)), (16384, range(1, 5)))
ODD = [((1000, 777), level) for level in range(1, 7)] + [
    ((300, 300), 5), ((100, 77), 1), ((100, 77), 3), ((4105, 33), 1), ((4105, 33), 4),
    ((8224, 32), 3)]


def same_bits(a, b) -> bool:
    torch.cuda.synchronize()
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def division(out, dev) -> None:
    x = torch.rand(1 << 20, device=dev) * 100
    for n in (6, 9, 4224, 16):
        got = x / n
        recip = x * float(np.float32(1) / np.float32(n))
        true = (x.double() / n).float()
        out({"division_by": n, "equals_reciprocal_product": same_bits(got, recip),
             "equals_true_division": same_bits(got, true)})


def case(out, dev, n: int, level: int, motion: bool) -> None:
    dims = pyramid_dims((n, n), level)[level]
    gen = torch.Generator(device=dev).manual_seed(1000 * level + n + motion)
    x = torch.rand(((2,) if motion else ()) + (n, n), generator=gen, device=dev) * 4 - 2
    kern, plain = ((downsample_motion, downsample_motion_ref) if motion
                   else (downsample_image, downsample_image_ref))
    kernels.reset_launches()
    got = kern(x, dims)
    launches = kernels.LAUNCHES["downsample"]
    equal = same_bits(got, plain(x, dims))
    del got
    big = n > 4096
    row = {"shape": list(x.shape), "to": list(dims), "order": downsample_order(x.shape, dims),
           "launches_a_call": launches, "bit_equal": equal,
           "ms": probe_tools.median_ms(lambda: kern(x, dims)),
           "plain_ms": probe_tools.median_ms(lambda: plain(x, dims), runs=5 if big else 20,
                                             warmup=1 if big else 3, batch=2 if big else 10),
           "bound_ms": 4 * (x.numel() + x.numel() // (n // dims[0]) ** 2) / PEAK_BYTES_PER_S * 1e3}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    out(row)
    torch.cuda.empty_cache()


def odd(out, dev, shape, level) -> None:
    dims = pyramid_dims(shape, level)[level]
    gen = torch.Generator(device=dev).manual_seed(level)
    x = torch.rand((2,) + shape, generator=gen, device=dev) * 4 - 2
    out({"shape": list(shape), "to": list(dims), "order": downsample_order(shape, dims),
         "image_bit_equal": same_bits(downsample_image(x[0], dims),
                                      downsample_image_ref(x[0], dims)),
         "stack_bit_equal": same_bits(downsample_image(x, dims), downsample_image_ref(x, dims)),
         "motion_bit_equal": same_bits(downsample_motion(x, dims),
                                       downsample_motion_ref(x, dims))})


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        def out(row):
            line = json.dumps(row)
            print(line, flush=True)
            f.write(line + "\n")

        out({"card": probe_tools.card()})
        division(out, dev)
        for shape, level in ODD:
            odd(out, dev, shape, level)
        for n, levels in CELLS:
            for motion in (False, True):
                for level in levels:
                    case(out, dev, n, level, motion)


if __name__ == "__main__":
    main()
