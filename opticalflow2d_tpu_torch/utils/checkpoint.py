"""Checkpoint and resume for long registrations (PyTorch port of
``opticalflow2d_tpu.utils.checkpoint``).

The natural resume points are pyramid-level boundaries: a checkpoint is
the full-resolution motion field, the config and input fingerprints, the
last completed scale and the completed levels' traces, written as an
atomically renamed ``np.savez`` archive under the JAX package's keys, so a
checkpoint that JAX wrote loads its motion and traces here (with
``cfg=None``: the fingerprint is of the port's own ``RegConfig``, whose
fields differ).

``register_resumable`` runs the pyramid one scale per ``register`` call,
checkpoints after each, and on restart resumes from the first incomplete
scale. The port's pyramid loop is phased on the host already, so a resumed
run is bit-equal to an uninterrupted ``register`` (JAX's agrees to ~6e-8,
its compiled levels fusing the up- and downsample across a boundary).
``load_checkpoint`` with ``register(initial_motion=..., start_scale=...)``
is the manual equivalent.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch


def _cfg_fingerprint(cfg) -> str:
    d = dataclasses.asdict(cfg)
    d["method"] = int(cfg.method)
    d["accumulation"] = int(cfg.accumulation)
    # A logging-only knob does not invalidate a checkpoint.
    d.pop("verbose_stream", None)
    return json.dumps(d, sort_keys=True, default=str)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a)


def _inputs_fingerprint(iref, imov) -> str:
    """Content hash of the image pair, as float32 (what ``register`` runs
    on): a checkpoint is a resume point only for the same inputs."""
    h = hashlib.sha1()
    for a in (iref, imov):
        a = np.ascontiguousarray(_host(a), dtype=np.float32)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def save_checkpoint(path: str, motion, cfg, level: Optional[int] = None,
                    inputs_fp: str = "", traces=()) -> None:
    """Write a checkpoint atomically (a temporary file, then a rename).
    ``traces``: the completed levels' ``LevelTrace``s, kept so that a
    resumed run returns the full trace history."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    payload = dict(
        motion=_host(motion),
        config=_cfg_fingerprint(cfg),
        level=-1 if level is None else int(level),
        inputs=inputs_fp,
        n_traces=len(traces),
    )
    for i, t in enumerate(traces):
        payload[f"t{i}_scale"] = np.asarray(t.scale)
        payload[f"t{i}_errors"] = _host(t.errors)
        payload[f"t{i}_iterations"] = _host(t.iterations)
        payload[f"t{i}_regrids"] = _host(t.regrids)
        payload[f"t{i}_fallbacks"] = _host(t.fallbacks)
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_checkpoint_traces(path: str):
    """The persisted ``LevelTrace`` history of a checkpoint (empty for one
    that recorded none), with the port's types: ``errors`` a float32 CPU
    tensor, the counts ints."""
    from opticalflow2d_tpu_torch.engine.registration import LevelTrace

    traces = []
    with np.load(path, allow_pickle=False) as z:
        n = int(z["n_traces"]) if "n_traces" in z else 0
        for i in range(n):
            traces.append(LevelTrace(
                scale=int(z[f"t{i}_scale"]),
                errors=torch.from_numpy(np.array(z[f"t{i}_errors"], dtype=np.float32)),
                iterations=int(z[f"t{i}_iterations"]),
                regrids=int(z[f"t{i}_regrids"]),
                fallbacks=int(z[f"t{i}_fallbacks"]) if f"t{i}_fallbacks" in z else 0,
            ))
    return tuple(traces)


def load_checkpoint(path: str, cfg=None, inputs_fp: str = "") -> Tuple[np.ndarray, int]:
    """Load ``(motion, level)``. With ``cfg``, a checkpoint written under
    another config raises; with ``inputs_fp``, one written for another
    image pair raises (where it recorded its pair): resuming another
    registration would silently give a wrong result."""
    with np.load(path, allow_pickle=False) as z:
        motion = z["motion"]
        stored = str(z["config"])
        level = int(z["level"])
        stored_inputs = str(z["inputs"]) if "inputs" in z else ""
    if cfg is not None and stored != _cfg_fingerprint(cfg):
        raise ValueError("checkpoint was written under a different RegConfig; refusing to resume")
    if inputs_fp and stored_inputs and stored_inputs != inputs_fp:
        raise ValueError(
            "checkpoint was written for a different image pair; refusing to resume")
    return motion, level


def register_resumable(iref, imov, cfg, path: str, device=None, _crash_after_scale=None):
    """Registration with a checkpoint after each pyramid scale, and resume.

    Runs the scales coarse to fine, one ``register`` call each; after each
    the full-resolution motion is checkpointed to ``path``. If ``path``
    holds a checkpoint of this ``cfg`` and pair, the completed scales are
    skipped and the run continues from the first incomplete one. The
    result equals an uninterrupted ``register``'s bit for bit, its
    ``traces`` cover the whole pyramid (the completed levels' from the
    checkpoint); ``coarse_motion`` is None, as in the JAX package.

    ``device``: as ``register``'s (``None`` is CUDA, and raises without
    it). ``_crash_after_scale`` (tests only): return ``None`` right after
    checkpointing that scale, as a run killed there would."""
    from opticalflow2d_tpu_torch.engine.registration import (
        RegistrationResult,
        register,
        resolve_device,
    )

    device = resolve_device(device)
    inputs_fp = _inputs_fingerprint(iref, imov)
    start = cfg.nscales
    u0 = None
    traces = []
    if os.path.exists(path):
        motion, last_done = load_checkpoint(path, cfg, inputs_fp)
        traces = list(load_checkpoint_traces(path))
        if last_done == 0:
            return RegistrationResult(motion=torch.from_numpy(motion).to(device),
                                      traces=tuple(traces))
        u0 = motion
        if last_done > 0:
            start = last_done - 1
        # last_done < 0 (a checkpoint of no level): warm-start the whole pyramid.

    for s in range(start, -1, -1):
        res = register(iref, imov, cfg, initial_motion=u0, start_scale=s, stop_scale=s,
                       device=device)
        u0 = res.motion.cpu().numpy()
        traces.extend(res.traces)
        save_checkpoint(path, u0, cfg, level=s, inputs_fp=inputs_fp, traces=traces)
        if _crash_after_scale is not None and s == _crash_after_scale:
            return None
    return RegistrationResult(motion=res.motion, traces=tuple(traces))
