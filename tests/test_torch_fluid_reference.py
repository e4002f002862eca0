"""The port's fluid registration against the benchmark's plain fluid
reference (``torch_bench/reference/fluid.py``) on the CPU, on the
slide cell's nuclei texture at a small size: the one-pass route, the
two-pass route of extents past ``_DERIV_BARRIER_MIN_EXTENT`` (lowered
here), the reference's downsample past 4096 against the port's on thin
strips, its gathers by blocks of rows, and the bfloat16 control.

Tolerances: motion and warped image 1e-4, the limits of
``slide_fluid_16384.pair``; program and reference take each pixel through
the same float32 operations in the same order, and only the Logger's sums
add in another order (on the CPU in the same one), so they read 0 here.
Iteration and regrid counts equal: a stop or a regrid moved changes the
field. The downsample and the gathers bit for bit: an add in another order
is a fault there.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401 (one intra-op thread a worker)
import opticalflow2d_tpu_torch as T
from opticalflow2d_tpu_torch.engine import registration
from opticalflow2d_tpu_torch.ops.resample import downsample_image, downsample_motion
from torch_bench import correct
from torch_bench.data import nuclei_texture
from torch_bench.reference import common, fluid

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "torch_bench/configs/slide_fluid_16384.json").read_text())
LIMITS = CONFIG["limits"]
DIMS = (96, 128)
SETTINGS = dict(CONFIG["settings"], nscales=2, niter=[25, 25, 25])
CPU = torch.device("cpu")


def _pairs(peak_px, seed):
    data = dict(CONFIG["data"], displacement_peak_px=list(peak_px))
    return nuclei_texture.make_pool(data, DIMS, 2, seed, CPU)


def _port(iref, imov):
    s = SETTINGS
    sess = T.OpticalFlow2d(DIMS, s["niter"], s["nscales"], T.Method[s["regularisation"]],
                           s["regparams"], nrefine=s["nrefine"], device="cpu")
    result = sess.register(iref, imov)
    solves = [(t.scale, t.iterations, t.regrids) for t in result.traces]
    return sess.get_motion().movedim(-1, 0), sess.warp(imov), solves


def _compare(iref, imov):
    got = _port(iref, imov)
    want = correct.reference_answer({"method": "fluid", "settings": SETTINGS}, iref, imov)
    gaps = correct.gaps(got, want)
    assert got[2] == want[2]
    assert correct.judge(gaps, LIMITS), gaps
    return got[2]


@pytest.mark.parametrize("peak_px,seed", [((2.0, 8.0), 2 ** 31 + 11), ((8.0, 32.0), 2 ** 31 + 5),
                                          ((8.0, 32.0), 2 ** 32 + 3)])
def test_register_matches_the_reference(peak_px, seed):
    regrids = [sum(r for _, _, r in _compare(iref, imov)) for iref, imov in _pairs(peak_px, seed)]
    if peak_px[0] >= 8:
        # The cell's displacements fold the field: the regrid is exercised.
        assert min(regrids) > 0


def test_two_pass_route_matches_the_reference(monkeypatch):
    """Past the lowered extent the finest level takes the two-pass step
    (the sweep and max, the gate, the Euler pass), the coarser ones the
    one-pass step, as the 16384^2 cell's levels do."""
    monkeypatch.setattr(registration, "_DERIV_BARRIER_MIN_EXTENT", 64)
    routes = []
    one, two = registration.make_fluid_step, registration.make_fluid_two_pass_step
    monkeypatch.setattr(registration, "make_fluid_step",
                        lambda *a, **k: routes.append("one") or one(*a, **k))
    monkeypatch.setattr(registration, "make_fluid_two_pass_step",
                        lambda *a, **k: routes.append("two") or two(*a, **k))
    for iref, imov in _pairs((8.0, 32.0), 2 ** 31 + 5):
        routes.clear()
        solves = _compare(iref, imov)
        assert routes == ["one", "one", "two"]
        assert sum(r for _, _, r in solves) > 0


@pytest.mark.parametrize("shape", [(8224, 64), (16384, 32), (2, 8224, 64), (2, 16384, 32),
                                   (4096, 64), (2, 12288, 16)])
def test_downsample_past_4096_equals_the_ports(shape):
    """Thin strips of the sizes past 4096 the pyramid and the seeds meet:
    every level of a 4-scale pyramid, for an image and a motion stack."""
    x = torch.from_numpy(np.random.default_rng(sum(shape)).uniform(
        -1, 1, shape).astype(np.float32))
    for dims in common.pyramid_dims(shape[-2:], 4)[1:]:
        if min(dims) < 1:
            continue
        assert torch.equal(fluid.downsample(x, dims), downsample_image(x, dims)), dims
        if len(shape) == 3:
            assert torch.equal(fluid.downsample_motion(x, dims), downsample_motion(x, dims))


def test_blocked_gathers_equal_the_whole_plane(monkeypatch):
    """The reference's warp, compose and upsample by blocks of rows equal
    ``common``'s whole-plane versions (odd blocks of 7 rows here)."""
    monkeypatch.setattr(fluid, "BLOCK_PIXELS", 7 * 40)
    rng = np.random.default_rng(7)
    image = torch.from_numpy(rng.uniform(0, 1, (50, 40)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(-3, 3, (2, 50, 40)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-3, 3, (2, 50, 40)).astype(np.float32))
    assert torch.equal(fluid.warp(image, u), common.warp(image, u))
    assert torch.equal(fluid.compose(u, v), common.compose(u, v))
    assert torch.equal(fluid.upsample_motion(u[:, :25, :20], (50, 40)),
                       common.upsample_motion(u[:, :25, :20], (50, 40)))


def test_the_bfloat16_control_fails_a_limit():
    iref, imov = _pairs((8.0, 32.0), 2 ** 31 + 5)[0]
    config = {"method": "fluid", "settings": SETTINGS}
    gaps = correct.gaps(correct.reference_answer(config, iref, imov, control=True),
                        correct.reference_answer(config, iref, imov))
    assert not correct.judge(gaps, LIMITS)
    assert gaps["motion_gap_px"] > 100 * LIMITS["motion_gap_px"]


def test_the_reference_imports_neither_package():
    tree = ast.parse((ROOT / "torch_bench/reference/fluid.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not any(m.split(".")[0] in ("opticalflow2d_tpu", "opticalflow2d_tpu_torch", "jax")
                   for m in names)
