"""Build the CUDA kernels on first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``, one process per
source, all started together, and the objects are linked into one shared
library with a plain C interface, under ``build/kernels/`` at the repository
root. The file name carries a hash of the sources, headers and flags, so a
changed source builds anew and an unchanged one is loaded as it is. ``-fmad=false``
keeps each kernel rounding op for op like its plain PyTorch version on the
same device; there is no ``--use_fast_math``.

Each C entry point takes device pointers, sizes and PyTorch's current stream,
launches without synchronising and returns ``cudaGetLastError()``;
``launch`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FA = ctypes.POINTER(ctypes.c_float)  # a host array of floats (Gaussian taps)
# C signature of each entry point, the stream last for every launcher.
_SIGNATURES = {
    "of2d_error_string": ((_I,), ctypes.c_char_p),
    "of2d_max_smem_optin": ((_I,), _I),
    "of2d_diffusion_block_smem_bytes": ((_I,), _I),
    "of2d_diffusion_block_nblocks": ((_I, _I, _I), _I),
    "of2d_diffusion_block": ((_P, _P, _P, _P, _P, _I, _I, _I, _F, _P), _I),
    "of2d_diffusion_block_strip": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P), _I),
    "of2d_diffusion_block_batch": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P), _I),
    "of2d_diffusion_step": ((_P, _P, _P, _P, _P, _I, _I, _F, _P), _I),
    "of2d_diffusion_step_batch": ((_P, _P, _P, _P, _I, _I, _I, _F, _P), _I),
    "of2d_warp2d": ((_P, _P, _P, _I, _I, _P), _I),
    "of2d_compose": ((_P, _P, _P, _I, _I, _P), _I),
    "of2d_warp2d_batch": ((_P, _P, _P, _P, _I, _I, _I, _P), _I),
    "of2d_compose_batch": ((_P, _P, _P, _P, _I, _I, _I, _P), _I),
    "of2d_warp2d_strip": ((_P, _P, _P, _I, _I, _I, _I, _I, _I, _P), _I),
    "of2d_compose_strip": ((_P, _P, _P, _I, _I, _I, _I, _I, _I, _P), _I),
    "of2d_logger_norms_nblocks": ((_I, _I), _I),
    "of2d_logger_norms": ((_P, _P, _P, _P, _I, _I, _P), _I),
    "of2d_logger_norms_batch": ((_P, _P, _P, _P, _P, _I, _I, _I, _P), _I),
    "of2d_demons_nblocks": ((_I, _I, _I), _I),
    "of2d_demons_onepass_smem_bytes": ((_I,), _I),
    "of2d_demons_onepass": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _FA, _FA, _F, _F, _I, _P),
                            _I),
    "of2d_demons_onepass_batch": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _FA, _FA, _F, _F,
                                   _I, _P), _I),
    "of2d_demons_correspondence_smem_bytes": ((_I,), _I),
    "of2d_demons_correspondence": ((_P, _P, _P, _P, _I, _I, _I, _FA, _F, _F, _P), _I),
    "of2d_compose_smooth_smem_bytes": ((_I,), _I),
    "of2d_compose_smooth": ((_P, _P, _P, _I, _I, _I, _FA, _P), _I),
    "of2d_demons_onepass_strip": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _FA, _FA, _F,
                                   _F, _P), _I),
    "of2d_demons_correspondence_strip": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _FA, _F,
                                          _F, _P), _I),
    "of2d_compose_smooth_strip": ((_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _FA, _P), _I),
    "of2d_fluid_metrics": ((_P, _P, _P, _P, _I, _I, _P), _I),
    "of2d_fluid_metrics_batch": ((_P, _P, _P, _P, _P, _I, _I, _I, _P), _I),
    "of2d_sor_nblocks": ((_I, _I), _I),
    "of2d_elastic_block_smem_bytes": ((_I,), _I),
    "of2d_elastic_nblocks": ((_I, _I, _I), _I),
    "of2d_elastic_block": ((_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _I, _P), _I),
    "of2d_elastic_block_strip": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F,
                                  _I, _P), _I),
    "of2d_fluid_iter_smem_bytes": ((), _I),
    "of2d_fluid_iter": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _I, _I, _P), _I),
    "of2d_fluid_iter_batch": ((_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _I,
                               _I, _P), _I),
    "of2d_fluid_iter_strip": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F,
                               _I, _I, _P), _I),
    "of2d_fluid_sweep_max": ((_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _I, _I, _P), _I),
    "of2d_fluid_euler": ((_P, _P, _P, _P, _I, _I, _P), _I),
    "of2d_fluid_update": ((_P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P), _I),
    "of2d_upsample_motion": ((_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P), _I),
    "of2d_derive": ((_P, _P, _P, _I, _I, _P), _I),
    "of2d_derive_batch": ((_P, _P, _P, _P, _I, _I, _I, _P), _I),
    "of2d_downsample": ((_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P),
                        _I),
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; "
                           "the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libof2d_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. The
    compiler's register and shared-memory report goes beside it as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    sources = sorted(CSRC.glob("*.cu"))
    objects = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    nvcc = _nvcc()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objects)]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        logs.append(f"== {src.name}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(src.name)
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("\n".join(logs))
    os.replace(tmp, out)  # atomic: a concurrent builder never loads half a file
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def launch(entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` on ``device`` with PyTorch's current
    stream appended; raise if the launch reported an error."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = lib.of2d_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {rc} ({msg})")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU: only then does a wrapper run
    its plain version. Anything else goes to the kernel's checks."""
    return all(t.device.type == "cpu" for t in tensors)


def check_cuda(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    """Reject what the kernels do not take: another device, dtype, shape or
    a non-contiguous layout."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# The most pairs one batched launch takes (csrc/partials.cuh kMaxPairs).
MAX_PAIRS = 65535


class Pairs:
    """The pairs of a stack that a batched launch runs, in launch order: a
    tuple of distinct indices in ``[0, batch)``, and its ``int32`` copy on
    a device, made on the first launch there and kept for the next ones
    (the lockstep driver builds one when its list of active pairs
    changes, not at every launch)."""

    def __init__(self, pairs, batch: int):
        idx = tuple(int(p) for p in pairs)
        if not 1 <= len(idx) <= MAX_PAIRS:
            raise ValueError(f"a batched launch takes 1 to {MAX_PAIRS} pairs, got {len(idx)}")
        if len(set(idx)) != len(idx) or not all(0 <= p < batch for p in idx):
            raise ValueError(f"pairs must be distinct indices in [0, {batch}), got {list(idx)}")
        self.idx = idx
        self.batch = batch
        # Every pair of the batch, in stack order.
        self.whole = idx == tuple(range(batch))
        self._on = {}

    def __len__(self) -> int:
        return len(self.idx)

    def __iter__(self):
        return iter(self.idx)

    def part(self, start: int, stop: int) -> "Pairs":
        """The pairs ``start:stop`` of the list, with views of the device
        copies made so far: no upload."""
        part = Pairs(self.idx[start:stop], self.batch)
        part._on = {key: t[start:stop] for key, t in self._on.items()}
        return part

    def on(self, device: torch.device, dtype: torch.dtype = torch.int32) -> torch.Tensor:
        """The list on ``device``: ``int32`` for a kernel, ``int64`` for an
        index op (``index_select``, ``index_copy_``)."""
        t = self._on.get((device, dtype))
        if t is None:
            t = self._on[(device, dtype)] = torch.tensor(self.idx, dtype=dtype, device=device)
        return t


def as_pairs(pairs, batch: int) -> Pairs:
    """``pairs`` (a sequence of indices, or ``Pairs`` of the same batch) as
    ``Pairs``."""
    if isinstance(pairs, Pairs):
        if pairs.batch != batch:
            raise ValueError(f"pairs were made for a batch of {pairs.batch}, not {batch}")
        return pairs
    return Pairs(pairs, batch)


def check_out(out: torch.Tensor, like: torch.Tensor, *inputs: torch.Tensor) -> None:
    """Reject an output stack that does not match ``like`` or shares memory
    with an input: a batched kernel reads its neighbours' cells while
    other blocks write."""
    check_cuda("out", out, like.shape, like.device)
    for t in inputs:
        if out.untyped_storage().data_ptr() == t.untyped_storage().data_ptr():
            raise ValueError("out must not share memory with an input")


def strip_rows(t_pad: torch.Tensor, pad: int) -> int:
    """The rows a strip owns, of a tensor ``[c, nxl + 2 pad, ny]`` padded
    with ``pad`` halo rows a side."""
    nxl = t_pad.shape[-2] - 2 * pad
    if nxl < 1:
        raise ValueError(f"a strip padded with {pad} rows a side needs more than "
                         f"{2 * pad} rows, got {t_pad.shape[-2]}")
    return nxl


def check_strip(row0: int, nxl: int, nx_glob: int) -> None:
    """Raise unless a strip's rows ``row0 .. row0 + nxl`` lie in the image's
    ``nx_glob`` rows."""
    if not (row0 >= 0 and nxl >= 1 and row0 + nxl <= nx_glob):
        raise ValueError(f"strip rows {row0}..{row0 + nxl} outside an image of "
                         f"{nx_glob} rows")


def check_smem(need: int, device: torch.device, what: str) -> None:
    """Raise unless a thread block of ``need`` bytes of shared memory fits
    the card of ``device``."""
    have = load().of2d_max_smem_optin(device.index if device.index is not None
                                      else torch.cuda.current_device())
    if need > have:
        raise ValueError(f"{what} needs {need} B of shared memory per thread block; "
                         f"this card allows {have} B")


def f32(x: float) -> float:
    """``x`` rounded to float32, as JAX rounds a weakly typed Python scalar
    when it meets a float32 array."""
    return ctypes.c_float(x).value
