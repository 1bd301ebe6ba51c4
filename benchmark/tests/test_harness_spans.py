"""The readers of the program's spans (``benchmark/spans.py`` and the
metrics that use it) on a hand-made Chrome trace: nested spans, a self
time whose children overlap, spans outside the calls left out, None on
a trace without the program's spans, and an idle gap named by the
program's span it falls in."""

import importlib.util

import pytest

from benchmark import readers, trace
from benchmark.cell import metric_path
from benchmark.drive import Tally

UA = "user_annotation"


def ev(name, ts, dur, cat=UA):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


DOC = {"traceEvents": [
    ev("bench.window", 0, 2000),
    ev("bench.copy_initial", 50, 350),
    ev("ptt.copy_initial", 60, 330),
    ev("ptt.stage.fill", 70, 50),
    ev("ptt.stage.upload", 120, 10),
    ev("ptt.walk", 130, 20),
    ev("ptt.sync", 300, 80),
    # Move 1: a slot wait, the fill with a wait that overlaps it and the
    # upload, the walk, the found-all read, the fence.
    ev("bench.move", 450, 550),
    ev("ptt.move", 460, 530),
    ev("ptt.sync", 470, 10),
    ev("ptt.stage.fill", 480, 120),
    ev("ptt.sync", 560, 60),
    ev("ptt.stage.upload", 600, 10),
    ev("aten::copy_", 602, 5, cat="cpu_op"),
    ev("ptt.walk", 650, 50),
    ev("ptt.sync", 700, 20),
    ev("ptt.sync", 900, 80),
    # Move 2.
    ev("bench.move", 1100, 400),
    ev("ptt.move", 1110, 380),
    ev("ptt.stage.fill", 1120, 80),
    ev("ptt.walk", 1250, 10),
    ev("ptt.sync", 1300, 180),
    # Outside every call: left out.
    ev("ptt.stage.fill", 1600, 100),
    ev("ptt.sync", 1700, 50),
    ev("walk_kernel<float, 0, false, false, false>", 660, 200,
       cat="kernel"),
]}

# (metric, value): move 1's and move 2's, over the two moves.
EXPECTED = [
    ("stage_fill_ms_per_move", (120 + 80) / 2 * 1e-3),
    ("walk_host_ms_per_move", (50 + 10) / 2 * 1e-3),
    ("sync_wait_ms_per_move", ((10 + 60 + 20 + 80) + 180) / 2 * 1e-3),
    ("syncs_per_move", (4 + 1) / 2),
    # 530 less the children's union 470-620, 650-720, 900-980 (300);
    # 380 less 80 + 10 + 180.
    ("move_self_ms_per_move", ((530 - 300) + (380 - 270)) / 2 * 1e-3),
    # 330 less its one wait (80); the fill, upload and walk stay.
    ("copy_initial_host_ms", (330 - 80) * 1e-3),
]


def read(name, doc):
    spec = importlib.util.spec_from_file_location("m_" + name,
                                                  metric_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ctx = readers.Context(setup_s=0, mesh_load_s=0, window=Tally(),
                          trace=None if doc is None
                          else trace.parse_chrome_trace(doc))
    return mod.read(ctx)


@pytest.mark.parametrize("name,value", EXPECTED,
                         ids=[n for n, _ in EXPECTED])
def test_reader_values(name, value):
    assert read(name, DOC) == pytest.approx(value)


@pytest.mark.parametrize("name", [n for n, _ in EXPECTED])
def test_reader_without_the_program_spans(name):
    bare = {"traceEvents": [e for e in DOC["traceEvents"]
                            if not e["name"].startswith("ptt.")]}
    assert read(name, bare) is None
    assert read(name, None) is None
    # Spans of the program but no move span: a program without them.
    no_move = {"traceEvents": [e for e in DOC["traceEvents"]
                               if e["name"] != "ptt.move"]}
    assert read(name, no_move) is None


def test_idle_gap_is_named_by_the_program_span():
    doc = {"traceEvents": [
        ev("bench.window", 0, 1000),
        ev("bench.move", 0, 1000),
        ev("ptt.move", 10, 980),
        ev("ptt.stage.fill", 100, 400),
        ev("walk_kernel<float, 0, false, false, false>", 600, 100,
           cat="kernel"),
    ]}
    gaps = trace.idle_gaps(trace.parse_chrome_trace(doc))
    assert [(name, round(s * 1e6)) for name, s in gaps] == [
        ("bench.move > ptt.stage.fill", 600), ("bench.move > ptt.move", 300)]
