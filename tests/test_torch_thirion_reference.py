"""The port's Thirion demons registration against the benchmark's plain
reference (``torch_bench/reference/thirions_demons.py``) on the CPU, on the
4DCT cell's lung slices at a small size (96 x 128, the demo's settings:
nscales 1, niter 25 25), by composition and by addition, on three seeds;
the reference's Gaussian against the upstream's dense renormalised kernel;
the bfloat16 control; and the reference's imports.

Limits: motion and warped image 1e-4, iterations and regrids 0, the
limits of ``dirlab_thirion.volume``. Program and reference take each pixel
through the same float32 operations in the same order, and only the
Logger's sums add in another order (on the CPU in the same one), so they
read 0 here. The control, the reference storing its fields in bfloat16,
moves the motion by about a tenth of a pixel.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401 (one intra-op thread a worker)
import opticalflow2d_tpu_torch as T
from opticalflow2d_tpu_torch.ops.warp import warp2d
from torch_bench import correct
from torch_bench.data import lung_ct
from torch_bench.reference import thirions_demons

ROOT = Path(__file__).resolve().parents[1]
THIRION_CONFIG = json.loads((ROOT / "torch_bench/configs/dirlab_thirion.json").read_text())
THIRION_LIMITS = THIRION_CONFIG["limits"]
THIRION_DIMS = (96, 128)
CPU = torch.device("cpu")


def _settings(accumulation: int) -> dict:
    s = dict(THIRION_CONFIG["settings"])
    s["regparams"] = s["regparams"][:5] + [accumulation]
    return s


def _slices(seed):
    """The first slice of T10-T50 against T00's, a stack of five pairs."""
    return lung_ct.make_pool(THIRION_CONFIG["data"], THIRION_DIMS, 1, seed, CPU, 5)[0]


def _port(iref, imov, settings):
    cfg = T.RegConfig.from_regparams(T.Method[settings["regularisation"]], settings["niter"],
                                     settings["nscales"], settings["regparams"],
                                     settings["nrefine"])
    result = T.register(iref, imov, cfg, device="cpu")
    solves = [(t.scale, t.iterations, t.regrids) for t in result.traces]
    return result.motion, warp2d(imov, result.motion), solves


@pytest.mark.parametrize("seed", [2 ** 31 + 24, 2 ** 32 + 7, 2 ** 31 - 1])
@pytest.mark.parametrize("accumulation", [0, 1])
def test_thirion_register_matches_the_reference(seed, accumulation):
    settings = _settings(accumulation)
    config = {"method": THIRION_CONFIG["method"], "settings": settings}
    irefs, imovs = _slices(seed)
    for iref, imov in zip(irefs, imovs):
        got = _port(iref, imov, settings)
        want = correct.reference_answer(config, iref, imov)
        assert got[2] == want[2]
        gaps = correct.gaps(got, want)
        assert correct.judge(gaps, THIRION_LIMITS), gaps


def test_thirion_reference_gaussian_is_the_upstream_kernel():
    """The separable Gaussian over the in-image tap sums equals the
    upstream's dense normalised k x k kernel renormalised by its in-image
    weights (computed here in float64) to float32 rounding: only the order
    of the sum over taps differs."""
    rng = np.random.default_rng(5)
    f = rng.normal(0, 1, (2, 23, 17))
    for sigma, width in ((2.0, 5), (1.0, 3), (3.0, 11)):
        got = thirions_demons.gaussian(torch.from_numpy(f.astype(np.float32)), sigma, width)
        c = (width - 1) // 2
        g = np.exp(-((np.arange(width) - c) ** 2) / (2.0 * sigma * sigma))
        k = np.outer(g, g)
        k /= k.sum()
        num = np.zeros_like(f)
        den = np.zeros(f.shape[1:])
        for a in range(width):
            for b in range(width):
                src = np.zeros_like(f)
                w = np.zeros(f.shape[1:])
                xs = slice(max(0, c - a), min(23, 23 + c - a))
                ys = slice(max(0, c - b), min(17, 17 + c - b))
                xt = slice(xs.start + a - c, xs.stop + a - c)
                yt = slice(ys.start + b - c, ys.stop + b - c)
                src[:, xs, ys] = f[:, xt, yt]
                w[xs, ys] = 1.0
                num += k[a, b] * src
                den += k[a, b] * w
        np.testing.assert_allclose(got.numpy(), num / den, atol=1e-6)


def test_thirion_control_fails_a_limit():
    settings = _settings(0)
    config = {"method": THIRION_CONFIG["method"], "settings": settings}
    irefs, imovs = _slices(2 ** 31 + 24)
    gaps = correct.gaps(correct.reference_answer(config, irefs[4], imovs[4], control=True),
                        correct.reference_answer(config, irefs[4], imovs[4]))
    assert not correct.judge(gaps, THIRION_LIMITS)
    assert gaps["motion_gap_px"] > 100 * THIRION_LIMITS["motion_gap_px"]


def test_thirion_reference_imports_neither_package():
    tree = ast.parse((ROOT / "torch_bench/reference/thirions_demons.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert names <= {"__future__", "numpy", "torch", "torch_bench.reference"}
    assert not any(m.split(".")[0] in ("opticalflow2d_tpu", "opticalflow2d_tpu_torch", "jax")
                   for m in names)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
