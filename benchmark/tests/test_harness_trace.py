"""Reading the traced window: the device's busy union, the host's share
of a move, the idle gaps and their labels, W0's roofline share, on a
hand-made Chrome trace; and the p95 over every call."""

import pytest

from benchmark import readers, trace
from benchmark.drive import Tally

W0 = "void walk_kernel<float, 0, false, false, false>(WalkArgs<float>)"
W0S = "void walk_kernel<float, 0, true, false, false>(WalkArgs<float>)"


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


DOC = {"traceEvents": [
    ev("bench.window", "user_annotation", 0, 1000),
    ev("bench.move", "user_annotation", 100, 300),
    ev("aten::copy_", "cpu_op", 110, 50),
    ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 150, 40),
    ev(W0, "kernel", 200, 100),
    ev(W0, "kernel", 250, 100),   # overlaps the first: union 150
    ev("bench.move", "user_annotation", 420, 480),
    ev("cudaStreamSynchronize", "cuda_runtime", 430, 460),
    ev(W0S, "kernel", 600, 200),
    ev("outside", "kernel", 2000, 10),
    {"ph": "i", "name": "marker", "ts": 5},
]}


@pytest.fixture
def tr():
    return trace.parse_chrome_trace(DOC)


def test_busy_union_and_window(tr):
    busy, window = trace.device_busy(tr)
    assert window == pytest.approx(1000e-6)
    # HtoD 150-190, kernels 200-350, 600-800.
    assert busy == pytest.approx((40 + 150 + 200) * 1e-6)


def test_host_ms_per_move(tr):
    ctx = readers.Context(setup_s=0, mesh_load_s=0, window=Tally(),
                          trace=tr)
    # Move 1: 300 us less 190 busy; move 2: 480 less 200.
    assert readers.host_ms_per_move(ctx) == pytest.approx(
        ((300 - 190) + (480 - 200)) / 2 * 1e-3)


def test_idle_gaps_are_named_by_the_host(tr):
    gaps = trace.idle_gaps(tr)
    # Busy: 150-190, 200-350, 600-800; idle: 350-600, 800-1000, 0-150,
    # 190-200, longest first.
    assert [round(s * 1e6) for _, s in gaps] == [250, 200, 150, 10]
    assert [name for name, _ in gaps] == [
        "bench.move > cudaStreamSynchronize", "bench.move",
        "between calls", "bench.move"]


def test_top_device_ops(tr):
    ops = dict(trace.top_device_ops(tr))
    assert ops["walk_kernel<float, 0, false, false, false>"] == \
        pytest.approx(200e-6)
    assert "outside" not in ops


def test_w0_names_and_share(tr):
    assert readers.w0_scored(W0) is False
    assert readers.w0_scored(W0S) is True
    assert readers.w0_scored("_Z11walk_kernelIfLi0ELb1ELb0ELb0EEv8WalkArgs"
                             "IT_E") is True
    assert readers.w0_scored("block_walk_kernel<float>") is None
    ctx = readers.Context(setup_s=0, mesh_load_s=0, window=Tally(),
                          trace=tr, launches=[
                              readers.Launch("localize", False, 0.01),
                              readers.Launch("move", True, 0.02)])
    # All of W0: 0.4 ms of kernels against 0.03 ms of bound.
    assert readers.w0_share(ctx, scored=False) == pytest.approx(7.5)
    # The scoring instantiation: 0.2 ms against 0.02.
    assert readers.w0_share(ctx, scored=True) == pytest.approx(10.0)
    ctx.trace = None
    assert readers.w0_share(ctx, scored=True) is None


def test_one_window_span_required():
    doc = {"traceEvents": DOC["traceEvents"] + [
        ev("bench.window", "user_annotation", 3000, 10)]}
    with pytest.raises(RuntimeError, match="not one"):
        trace.parse_chrome_trace(doc).window()


@pytest.mark.parametrize("n", [1, 19, 20, 21, 200, 1000])
def test_p95_over_every_call(n):
    vals = list(range(n, 0, -1))
    got = readers.p95(vals)
    assert sum(v <= got for v in vals) >= 0.95 * n
    assert sum(v < got for v in vals) < 0.95 * n


def test_short_names():
    assert trace.short_name(W0) == "walk_kernel<float, 0, false, false, " \
        "false>"
    assert trace.short_name("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD (Pinned -> Device)"
