"""The streaming cell's readers on hand-made Chrome traces: the
whole-batch checks less the echo nested in them, the echo, the chunk
pipeline less its waits, the copies' share under W0; spans and copies
outside the window's moves left out; None without a trace, without the
program's spans, or (the parent of the streaming spans) without the
span a reader reads."""

import importlib.util

import pytest

from benchmark import readers, trace
from benchmark.cell import metric_path
from benchmark.drive import Tally

UA = "user_annotation"
W0 = "walk_kernel<float, 0, false, false, false>"
H2D = "Memcpy HtoD (Pinned -> Device)"


def ev(name, ts, dur, cat=UA):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


DOC = {"traceEvents": [
    ev("bench.window", 0, 3000),
    # A CopyInitialPosition: its check, chunk and copy are left out.
    ev("bench.copy_initial", 50, 350),
    ev("ptt.copy_initial", 60, 330),
    ev("ptt.stream.check", 70, 40),
    ev("ptt.stream.chunk", 120, 200),
    ev(H2D, 150, 100, cat="gpu_memcpy"),
    # Move 1: the check with the echo inside it, two chunk steps (the
    # second with two waits that overlap), the fence after them.
    ev("bench.move", 500, 1000),
    ev("ptt.move", 510, 980),
    ev("ptt.stream.check", 520, 100),
    ev("ptt.echo", 540, 40),
    ev("ptt.stream.chunk", 630, 200),
    ev("ptt.sync", 640, 20),
    ev("ptt.stage.fill", 660, 60),
    ev("ptt.walk", 730, 30),
    ev("ptt.stream.chunk", 830, 200),
    ev("ptt.sync", 850, 50),
    ev("ptt.sync", 880, 40),
    ev("ptt.sync", 1400, 80),
    # A copy wholly under W0, one half under it.
    ev(H2D, 760, 40, cat="gpu_memcpy"),
    ev(W0, 740, 100, cat="kernel"),
    ev(H2D, 940, 100, cat="gpu_memcpy"),
    ev(W0, 990, 200, cat="kernel"),
    # A device-to-host read: not an upload.
    ev("Memcpy DtoH (Device -> Pinned)", 1300, 50, cat="gpu_memcpy"),
    # Move 2: a shorter echo, one chunk step with one wait, a copy under
    # another kernel only.
    ev("bench.move", 1600, 800),
    ev("ptt.move", 1610, 780),
    ev("ptt.stream.check", 1620, 80),
    ev("ptt.echo", 1630, 30),
    ev("ptt.stream.chunk", 1710, 200),
    ev("ptt.sync", 1720, 10),
    ev(H2D, 1750, 60, cat="gpu_memcpy"),
    ev("at::native::elementwise_kernel<128, 2>", 1740, 100, cat="kernel"),
    # Outside every call: left out.
    ev("ptt.stream.check", 2600, 100),
    ev("ptt.echo", 2610, 10),
    ev("ptt.stream.chunk", 2700, 100),
    ev(H2D, 2720, 50, cat="gpu_memcpy"),
]}

# (metric, value), over the two moves.
EXPECTED = [
    ("stream_check_ms_per_move", ((100 - 40) + (80 - 30)) / 2 * 1e-3),
    ("echo_ms_per_move", (40 + 30) / 2 * 1e-3),
    # 200 less 20; 200 less the waits' union 850-920; 200 less 10.
    ("stream_chunk_host_ms_per_move",
     ((200 - 20) + (200 - 70) + (200 - 10)) / 2 * 1e-3),
    # 40 + 50 of the moves' 200 us of uploads under W0.
    ("copy_overlap_share", 100.0 * (40 + 50) / (40 + 100 + 60)),
]
NAMES = [n for n, _ in EXPECTED]


def read(name, doc):
    spec = importlib.util.spec_from_file_location("m_" + name,
                                                  metric_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ctx = readers.Context(setup_s=0, mesh_load_s=0, window=Tally(),
                          trace=None if doc is None
                          else trace.parse_chrome_trace(doc))
    return mod.read(ctx)


def without(doc, drop):
    return {"traceEvents": [e for e in doc["traceEvents"] if not drop(e)]}


@pytest.mark.parametrize("name,value", EXPECTED, ids=NAMES)
def test_reader_values(name, value):
    assert read(name, DOC) == pytest.approx(value)


@pytest.mark.parametrize("kernel,share", [(W0, 50.0), (
    "at::native::elementwise_kernel<128, 2>", 0.0)], ids=["w0", "other"])
def test_copy_overlap_share_of_one_copy(kernel, share):
    doc = {"traceEvents": [
        ev("bench.window", 0, 1000),
        ev("bench.move", 0, 1000),
        ev("ptt.move", 10, 980),
        ev(H2D, 400, 200, cat="gpu_memcpy"),
        ev(kernel, 500, 300, cat="kernel"),
    ]}
    assert read("copy_overlap_share", doc) == pytest.approx(share)


@pytest.mark.parametrize("name", NAMES)
def test_reader_without_the_program_spans(name):
    assert read(name, None) is None
    assert read(name, without(DOC, lambda e: e["name"].startswith("ptt.")))\
        is None


@pytest.mark.parametrize("name,span", [
    ("stream_check_ms_per_move", "ptt.stream.check"),
    ("echo_ms_per_move", "ptt.echo"),
    ("stream_chunk_host_ms_per_move", "ptt.stream.chunk")])
def test_reader_without_its_span(name, span):
    # The program's other spans, as a program without this one has.
    assert read(name, without(DOC, lambda e: e["name"] == span)) is None


def test_copy_overlap_share_without_uploads():
    assert read("copy_overlap_share",
                without(DOC, lambda e: e["name"] == H2D)) is None
