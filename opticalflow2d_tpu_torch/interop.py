"""Carry configuration and motion state between the JAX package and the port.

The system has no weights: what crosses is the ``RegConfig`` and the motion
state of a ``RegistrationResult`` (its ``motion`` seeds ``initial_motion``,
its ``coarse_motion`` seeds ``initial_coarse_motion``). Nothing here imports
JAX: a JAX config is read through ``dataclasses.fields``, and JAX arrays
convert through ``numpy.asarray``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opticalflow2d_tpu_torch.config import CompatFlags, Method, MotionAccumulation, RegConfig
from opticalflow2d_tpu_torch.engine.registration import (
    LevelTrace,
    RegistrationResult,
    resolve_device,
)

# Knobs of the JAX config that only the TPU needs.
_TPU_ONLY = ("use_pallas", "warp_halo", "warp_halo_outer", "warp_halo_auto", "dct_impl",
             "pallas_block_elastic", "pallas_block_k_elastic")


def config_from_jax(cfg) -> RegConfig:
    """The port's ``RegConfig`` for a JAX ``RegConfig``: the TPU-only knobs
    are dropped and ``pallas_block_k`` is renamed ``block_k``."""
    kw = {}
    for f in dataclasses.fields(cfg):
        if f.name in _TPU_ONLY:
            continue
        kw["block_k" if f.name == "pallas_block_k" else f.name] = getattr(cfg, f.name)
    kw["method"] = Method(int(kw["method"]))
    kw["accumulation"] = MotionAccumulation(int(kw["accumulation"]))
    kw["compat"] = CompatFlags(**dataclasses.asdict(kw["compat"]))
    return RegConfig(**kw)


def _np(x):
    return None if x is None else np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def result_to_numpy(result) -> RegistrationResult:
    """A ``RegistrationResult`` (of either package) with numpy arrays and
    Python ints, ready to feed the JAX package."""
    return RegistrationResult(
        motion=_np(result.motion),
        traces=tuple(
            LevelTrace(int(t.scale), _np(t.errors), int(t.iterations),
                       int(t.regrids), int(t.fallbacks))
            for t in result.traces
        ),
        coarse_motion=_np(result.coarse_motion),
    )


def result_from_numpy(result, device: torch.device | str | None = None,
                      dtype: torch.dtype = torch.float32) -> RegistrationResult:
    """The port's ``RegistrationResult`` from one with numpy (or JAX)
    arrays, with the fields on ``device`` (``None`` means CUDA, ``"cpu"``
    the CPU); trace errors stay on the CPU."""
    device = resolve_device(device)

    def field(x):
        return None if x is None else torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return RegistrationResult(
        motion=field(result.motion),
        traces=tuple(
            LevelTrace(int(t.scale), torch.tensor(np.asarray(t.errors), dtype=dtype),
                       int(t.iterations), int(t.regrids), int(t.fallbacks))
            for t in result.traces
        ),
        coarse_motion=field(result.coarse_motion),
    )
