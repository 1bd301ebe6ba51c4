"""PyTorch port, the program's spans on the profiler's timeline
(``utils.profiling.span``), on the CPU with a tiny facade on the 4x4x4
box:

- under ``torch.profiler`` (CPU activity) the exported Chrome trace
  holds each protocol call's span (``ptt.copy_initial``, ``ptt.move``,
  ``ptt.close_batch``, ``ptt.write``) and, nested inside a move or a
  ``CopyInitialPosition``, the staging (``ptt.stage.fill``,
  ``ptt.stage.upload``), the walk wrapper (``ptt.walk``), the echo
  compare (``ptt.echo``) and the waits (``ptt.sync``), for the
  monolithic, streaming and partitioned facades;
- the waits a call makes are counted exactly, with ``check_found_all``
  and ``fenced_timing`` each on and off (on the CPU there is no staging
  slot event to wait on: the card adds one a staged slot refilled);
- with no profiler running, a move enters ``record_function`` zero
  times.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pumiumtally_tpu_torch import (
    PartitionedPumiTally,
    PumiTally,
    StreamingTally,
    TallyConfig,
    build_box,
)
from pumiumtally_tpu_torch.utils import profiling

N = 40
INNER = ("ptt.stage.fill", "ptt.stage.upload", "ptt.walk", "ptt.echo",
         "ptt.sync")
CALLS = ("ptt.copy_initial", "ptt.move")


@pytest.fixture(scope="module")
def mesh():
    return build_box(1, 1, 1, 4, 4, 4, dtype=torch.float64)


def _points(seed):
    rng = np.random.default_rng(seed)
    return [np.ascontiguousarray(rng.uniform(0.05, 0.95, 3 * N))
            for _ in range(3)]


def _drive(t, origins: bool) -> None:
    """One ``CopyInitialPosition`` and two moves, every particle flying,
    unit weights passed as an array; ``origins`` passes each move's
    origins (the previous destinations: the echo)."""
    pts = _points(3)
    t.CopyInitialPosition(pts[0])
    w = np.ones(N)
    for m in (1, 2):
        t.MoveToNextLocation(pts[m - 1] if origins else None, pts[m],
                             np.ones(N, np.int8), w)


def _spans(tmp_path, fn) -> list:
    """The ``ptt.`` spans of ``fn()`` as (name, start, end, tid), from
    the exported Chrome trace of a CPU profiler window."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = []
    for ev in json.loads(path.read_text())["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation" \
                and ev["name"].startswith("ptt."):
            out.append((ev["name"], float(ev["ts"]),
                        float(ev["ts"]) + float(ev["dur"]), ev.get("tid")))
    return sorted(out, key=lambda s: s[1])


def _inside(spans, outer: str) -> list:
    """Per ``outer`` span, in order: the names of the spans within it on
    its thread."""
    return [[n for n, a, b, tid in spans
             if tid == otid and oa <= a and b <= ob and (n, a) != (on, oa)]
            for on, oa, ob, otid in spans if on == outer]


def _enclosed(spans, names) -> bool:
    """Whether every span of ``names`` lies inside a move or a
    ``CopyInitialPosition`` span on its thread."""
    calls = [s for s in spans if s[0] in CALLS]
    return all(any(c[3] == tid and c[1] <= a and b <= c[2] for c in calls)
               for n, a, b, tid in spans if n in names)


@pytest.mark.parametrize("origins", [False, True],
                         ids=["continue", "origins"])
def test_protocol_spans_nest_under_their_call(mesh, tmp_path, origins):
    t = PumiTally(mesh, N, TallyConfig(), device="cpu")
    spans = _spans(tmp_path, lambda: _drive(t, origins))
    names = {s[0] for s in spans}
    assert {"ptt.copy_initial", "ptt.move", "ptt.stage.fill",
            "ptt.stage.upload", "ptt.walk", "ptt.sync"} <= names
    assert ("ptt.echo" in names) == origins
    assert _enclosed(spans, INNER)
    (copy,) = _inside(spans, "ptt.copy_initial")
    assert copy.count("ptt.walk") == 1  # the localization
    assert {"ptt.stage.fill", "ptt.stage.upload"} <= set(copy)
    moves = _inside(spans, "ptt.move")
    assert len(moves) == 2
    for k, inner in enumerate(moves):
        # Phase A and phase B with origins, phase B alone without.
        assert inner.count("ptt.walk") == (2 if origins else 1)
        # The first move of a batch has no destinations to echo.
        assert inner.count("ptt.echo") == (1 if origins and k else 0)
    # Destinations and weights each move, and the first move's origins
    # (the second's echo); the unchanged weights are uploaded once.
    assert [m.count("ptt.stage.fill") for m in moves] == \
        ([3, 2] if origins else [2, 2])
    assert [m.count("ptt.stage.upload") for m in moves] == \
        ([3, 1] if origins else [2, 1])


@pytest.mark.parametrize("check_found_all", [True, False])
@pytest.mark.parametrize("fenced_timing", [True, False])
def test_sync_count_per_call(mesh, tmp_path, check_found_all,
                             fenced_timing):
    t = PumiTally(mesh, N, TallyConfig(check_found_all=check_found_all,
                                       fenced_timing=fenced_timing),
                  device="cpu")
    spans = _spans(tmp_path, lambda: _drive(t, origins=False))
    cf, ft = int(check_found_all), int(fenced_timing)
    # CopyInitialPosition reads found-all and the exited count; a move
    # reads found-all; each call ends at its fence.
    (copy,) = _inside(spans, "ptt.copy_initial")
    assert copy.count("ptt.sync") == 2 * cf + ft
    assert [m.count("ptt.sync") for m in _inside(spans, "ptt.move")] == \
        [cf + ft] * 2
    assert _enclosed(spans, ("ptt.sync",))


def test_close_batch_and_write_spans(mesh, tmp_path):
    t = PumiTally(mesh, N, TallyConfig(batch_stats=True), device="cpu")

    def run():
        _drive(t, origins=False)
        t.close_batch()
        t.WriteTallyResults(str(tmp_path / "out.vtk"))

    names = [s[0] for s in _spans(tmp_path, run)]
    assert names.count("ptt.close_batch") == 1
    assert names.count("ptt.write") == 1


@pytest.mark.parametrize("facade", ["streaming", "partitioned"])
def test_other_facades_open_the_same_spans(mesh, tmp_path, facade):
    if facade == "streaming":
        # Three chunks: each one's found-all flag is read.
        t = StreamingTally(mesh, N, chunk_size=16, device="cpu")
        waits = 3 + 1
    else:
        t = PartitionedPumiTally(mesh, N, TallyConfig(), device="cpu")
        waits = 1 + 1
    spans = _spans(tmp_path, lambda: _drive(t, origins=True))
    moves = _inside(spans, "ptt.move")
    assert len(moves) == 2
    for inner in moves:
        assert {"ptt.stage.fill", "ptt.stage.upload", "ptt.sync"} <= \
            set(inner)
        assert inner.count("ptt.sync") == waits
    assert "ptt.echo" in moves[1]
    assert _enclosed(spans, INNER)
    if facade == "streaming":
        assert all("ptt.walk" in m for m in moves)


def _count_record_function(monkeypatch) -> list:
    """The names ``torch.profiler.record_function`` is entered with from
    here on."""
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    return entered


def test_no_record_function_without_a_profiler(mesh, monkeypatch):
    entered = _count_record_function(monkeypatch)
    t = PumiTally(mesh, N, TallyConfig(), device="cpu")
    pts = _points(4)
    t.CopyInitialPosition(pts[0])
    t.MoveToNextLocation(None, pts[1], np.ones(N, np.int8), np.ones(N))
    t.MoveToNextLocation(pts[1], pts[2], np.ones(N, np.int8), np.ones(N))
    assert not torch.autograd._profiler_enabled()
    assert entered == []
    # The same move with the flag read as on enters every span.
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)
    t.MoveToNextLocation(None, pts[0], np.ones(N, np.int8), np.ones(N))
    assert entered[0] == "ptt.move" and "ptt.walk" in entered


def test_span_off_is_one_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("ptt.a") is profiling.span("ptt.b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(profiling.span("ptt.a"),
                          torch.profiler.record_function)


def test_streaming_check_and_chunk_spans(mesh, tmp_path):
    # Seven chunks (six of 6, one of 4): a CopyInitialPosition, a
    # two-phase move that stages its origins and one whose origins echo.
    t = StreamingTally(mesh, N, chunk_size=6, device="cpu")
    assert t.nchunks == 7
    spans = _spans(tmp_path, lambda: _drive(t, origins=True))
    calls = _inside(spans, "ptt.copy_initial") + _inside(spans, "ptt.move")
    assert len(calls) == 3
    for inner in calls:
        assert inner.count("ptt.stream.check") == 1
        assert inner.count("ptt.stream.chunk") == 7
    assert _enclosed(spans, ("ptt.stream.check", "ptt.stream.chunk"))
    # Every fill and walk lies inside a chunk step, the echo inside the
    # check.
    chunks = [s for s in spans if s[0] == "ptt.stream.chunk"]
    checks = [s for s in spans if s[0] == "ptt.stream.check"]

    def within(span, outers):
        n, a, b, tid = span
        return any(o[3] == tid and o[1] <= a and b <= o[2] for o in outers)

    for s in spans:
        if s[0] in ("ptt.stage.fill", "ptt.stage.upload", "ptt.walk"):
            assert within(s, chunks), s
        if s[0] == "ptt.echo":
            assert within(s, checks), s
    assert sum(s[0] == "ptt.echo" for s in spans) == 1
    # Phase A and phase B of each chunk, in the chunk's own step.
    for c in chunks[7:]:
        assert sum(s[0] == "ptt.walk" and within(s, [c]) for s in spans) == 2


def test_streaming_move_enters_no_record_function(mesh, monkeypatch):
    entered = _count_record_function(monkeypatch)
    t = StreamingTally(mesh, N, chunk_size=6, device="cpu")
    pts = _points(5)
    t.CopyInitialPosition(pts[0])
    t.MoveToNextLocation(pts[0], pts[1], np.ones(N, np.int8), np.ones(N))
    t.MoveToNextLocation(pts[1], pts[2], np.ones(N, np.int8), np.ones(N))
    assert not torch.autograd._profiler_enabled()
    assert entered == []
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)
    t.MoveToNextLocation(pts[2], pts[0], np.ones(N, np.int8), np.ones(N))
    assert entered.count("ptt.stream.check") == 1
    assert entered.count("ptt.stream.chunk") == 7
