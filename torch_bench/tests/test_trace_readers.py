"""The per-layer readers on profiles whose answers are known: a made-up
one, and a small one recorded on an H100 (``data/profile_fluid.json``:
two requests of a 278 x 256 viscous-fluid registration through the
session entry, as ``trace.Profile``'s fields), read again here by plain
loops."""

import json
from pathlib import Path

import pytest

from torch_bench import cells, trace

FIXTURE = Path(__file__).parent / "data" / "profile_fluid.json"
PEAKS = {"hbm_bytes_per_s": 3.35e12}


def _read(name, p):
    return cells.reader(name).read(p)


def made_up():
    return trace.Profile(
        device=[["void diffusion_block_kernel<8, true>(float const*, float*)", 0.1, 0.2, "kernel"],
                ["void at::native::vectorized_elementwise_kernel<4, float>(int)", 0.4, 0.1,
                 "kernel"],
                ["Memcpy DtoH (Device -> Pageable)", 0.5, 0.01, "gpu_memcpy"],
                ["Memset (Device)", 0.9, 0.05, "gpu_memset"]],
        runtime=[["cudaLaunchKernel", 0.05, 0.001], ["cudaMemcpyAsync", 0.1, 0.001],
                 ["cudaStreamSynchronize", 0.1, 0.2], ["cudaStreamSynchronize", 0.5, 0.01],
                 ["cudaDeviceSynchronize", 0.99, 0.005]],
        spans=[["bench.request", 0.0, 1.0], ["bench.register", 0.0, 0.8],
               ["bench.get_motion", 0.8, 0.01], ["bench.warp", 0.81, 0.19]],
        window=(0.0, 1.0), solves=[[[0, 16, 0]]], dims=[64, 64], nscales=0, block_k=8,
        library_kernels=["diffusion_block_kernel", "sum_partials_kernel"], peaks=PEAKS)


def test_readers_on_a_made_up_profile():
    p = made_up()
    assert _read("syncs_per_iter", p) == pytest.approx(2 / 16)
    assert _read("launches_per_iter", p) == pytest.approx(4 / 16)
    assert _read("device_idle_pct", p) == pytest.approx(64.0)
    assert _read("aten_share_pct", p) == pytest.approx(100 * 0.1 / 0.36)
    least = 2 * 28 * 64 * 64 / 3.35e12
    assert _read("diffusion_block_roofline", p) == pytest.approx(100 * least / 0.2)
    b = trace.breakdown(p)
    assert b["device_ops"][0][0].startswith("void diffusion_block_kernel")
    # Idle: 0 .. 0.1, 0.3 .. 0.4, 0.51 .. 0.9 (register to 0.8, get_motion,
    # then warp) and 0.95 .. 1.0 (warp).
    assert b["idle_gaps"][0] == ["register", pytest.approx(0.39)]
    assert trace.idle_by_span(p) == pytest.approx(
        {"register": 0.1 + 0.1 + 0.29, "get_motion": 0.01, "warp": 0.09 + 0.05})


def test_readers_find_nothing_without_their_events():
    p = made_up()
    p.device = [d for d in p.device if "diffusion_block" not in d[0]]
    assert _read("diffusion_block_roofline", p) is None
    p.library_kernels = []
    assert _read("aten_share_pct", p) is None
    p.solves = [[]]
    assert _read("syncs_per_iter", p) is None and _read("launches_per_iter", p) is None


def test_kernel_base_names():
    assert trace.kernel_base("void diffusion_block_kernel<8, true>(float const*)") == \
        "diffusion_block_kernel"
    assert trace.kernel_base("void at::native::(anonymous namespace)::f<1>(int)") == "f"
    assert trace.kernel_base("gather_kernel(float const*, int)") == "gather_kernel"


@pytest.mark.skipif(not FIXTURE.exists(), reason="no recorded profile")
def test_readers_on_a_recorded_profile():
    fields = json.loads(FIXTURE.read_text())
    p = trace.Profile(**{**fields, "window": tuple(fields["window"])})
    its = sum(it for request in p.solves for _, it, _ in request)
    register = [(s, s + d) for n, s, d in p.spans if n == "bench.register"]
    syncs = [r for r in p.runtime if r[0] in trace.SYNC_CALLS
             and any(a <= r[1] <= b for a, b in register)]
    assert its > 0 and len(register) == len(p.solves)
    assert _read("syncs_per_iter", p) == pytest.approx(len(syncs) / its)
    assert _read("launches_per_iter", p) == pytest.approx(len(p.device) / its)
    # One read a fluid iteration (the metrics), and a few per level.
    assert 1.0 <= _read("syncs_per_iter", p) < 1.5
    # The union of the device intervals, by a sweep over sorted ends.
    busy, end = 0.0, p.window[0]
    for _, s, d, _ in sorted(p.device, key=lambda r: r[1]):
        a, b = max(s, end), min(s + d, p.window[1])
        if b > a:
            busy += b - a
        end = max(end, s + d)
    window = p.window[1] - p.window[0]
    assert _read("device_idle_pct", p) == pytest.approx(100 * (1 - busy / window))
    ours = set(p.library_kernels)
    assert {"fluid_iter_kernel", "fluid_metrics_kernel", "gather_kernel"} <= ours
    total = sum(d for _, _, d, _ in p.device)
    other = sum(d for n, _, d, k in p.device if k == "kernel" and trace.kernel_base(n) not in ours)
    assert _read("aten_share_pct", p) == pytest.approx(100 * other / total)
    assert _read("diffusion_block_roofline", p) is None  # no B1 on the fluid path
