"""What the kernel probes share: building their generated CUDA sources with
the kernels' flags, timing a call with CUDA events, and naming the card.
Each probe (``probes/*.py``) writes a source per part that defines one C
entry point per variant, then loads the library built here."""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from opticalflow2d_tpu_torch.kernels import _build  # noqa: E402

BUILD = ROOT / "build" / "probe"


def build(stem: str, source, items, parts: int = 8) -> ctypes.CDLL:
    """``source(items)`` of each of ``parts`` slices of ``items`` compiled by
    one nvcc each, all started together, into ``build/probe/``; returns the
    loaded library."""
    BUILD.mkdir(parents=True, exist_ok=True)
    flags = [*_build.NVCC_FLAGS, "-I", str(Path(__file__).parent), "-I", str(_build.CSRC)]
    procs, objs = [], []
    for i in range(parts):
        src, obj = BUILD / f"{stem}{i}.cu", BUILD / f"{stem}{i}.o"
        src.write_text(source(items[i::parts]))
        objs.append(obj)
        procs.append(subprocess.Popen([_build._nvcc(), *flags, "-c", "-o", str(obj), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        raise SystemExit("nvcc failed:\n" + "\n".join(logs)[-20000:])
    lib = BUILD / f"libprobe_{stem}.so"
    subprocess.run([_build._nvcc(), "-shared", "-o", str(lib), *map(str, objs)], check=True)
    return ctypes.CDLL(str(lib))


def median_ms(fn, runs: int = 20, warmup: int = 3, batch: int = 10) -> float:
    """Median over ``runs`` of the CUDA-event time of ``batch`` calls back to
    back, per call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return float(np.median(times))


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them; raises
    without a CUDA card."""
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
