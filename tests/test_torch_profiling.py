"""PyTorch port, ``utils/profiling.py`` on the CPU:

- ``phase_timer`` accumulates wall seconds, and fences every CUDA device
  among a tensor, a device or a (nested) list of them, once each
  (``torch.cuda.synchronize`` recorded: there is no card here), also
  when the block raises;
- ``trace(None)`` does nothing, and ``trace(dir)`` writes a Chrome trace
  of the block's operations on the CPU;
- ``build_guard`` counts builds, loads and launches at ``kernels``' own
  counting points (nvcc, the ctypes load and the stream faked), holds
  every library's builds to ``config.BUILD_BUDGET`` by default, raises
  on a breach, never while another exception unwinds, and only records
  with ``raise_on_exceed=False``;
- a ``PhaseProfile``d partitioned move times its sections through
  ``phase_timer`` fenced on the engine's devices, with the JAX
  profile's fields, and moves as an unprofiled one does (flux and
  positions bitwise).
"""

import contextlib
import dataclasses
import glob
import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

from pumiumtally_tpu.parallel.partition import PhaseProfile as JaxProfile
from pumiumtally_tpu_torch import (
    PartitionedPumiTally,
    TallyConfig,
    build_box,
    config,
    kernels,
)
from pumiumtally_tpu_torch.parallel import partition
from pumiumtally_tpu_torch.parallel.partition import PhaseProfile
from pumiumtally_tpu_torch.utils import profiling
from pumiumtally_tpu_torch.utils.profiling import (
    BuildBudgetExceeded,
    build_guard,
    phase_timer,
    trace,
)


@pytest.fixture
def synced(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    return calls


def test_phase_timer_accumulates(synced):
    sink = types.SimpleNamespace(t=0.25)
    with phase_timer(sink, "t"):
        time.sleep(0.02)
    first = sink.t
    assert first >= 0.25 + 0.02
    with phase_timer(sink, "t", fence=torch.zeros(3)):
        time.sleep(0.01)
    assert sink.t >= first + 0.01
    assert synced == []  # nothing to fence on the CPU


def test_phase_timer_fences_each_cuda_device_once(synced):
    sink = types.SimpleNamespace(t=0.0)
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    with phase_timer(sink, "t", fence=cuda1):
        pass
    assert synced == [cuda1]
    synced.clear()
    with phase_timer(sink, "t", fence=[torch.zeros(2), cuda0, "cuda:0",
                                       (cuda1, [cuda0]),
                                       torch.device("cpu")]):
        pass
    assert synced == [cuda0, cuda1]
    synced.clear()
    # A tensor fences its own device (a meta tensor has none to wait on).
    with phase_timer(sink, "t", fence=torch.empty(1, device="meta")):
        pass
    assert synced == []
    # The fence and the stamp happen when the block raises, too.
    before = sink.t
    with pytest.raises(KeyError):
        with phase_timer(sink, "t", fence=[cuda0]):
            time.sleep(0.01)
            raise KeyError("x")
    assert synced == [cuda0] and sink.t >= before + 0.01


def test_trace_none_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace(None) as t:
        torch.ones(4).sum()
    assert t is None and os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)):
        torch.arange(1000, dtype=torch.float64).cumsum(0).sum()
    files = glob.glob(str(log_dir / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::cumsum" in names and "aten::sum" in names


class _Fn:
    """A C entry point that returns 0 (no error)."""

    argtypes = restype = None

    def __call__(self, *args):
        return 0


class _FakeLib:
    """A loaded library whose every entry is an ``_Fn``."""

    def __init__(self, path):
        self._fns = {}

    def __getattr__(self, name):
        if name.startswith("pumi_"):
            return self._fns.setdefault(name, _Fn())
        raise AttributeError(name)


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """nvcc replaced by a script that writes its output file, ctypes'
    load by ``_FakeLib``, the CUDA stream and device context by stubs;
    builds go to ``tmp_path``. The counters are kernels' own."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "a = sys.argv\nopen(a[a.index('-o') + 1], 'wb')"
                    ".write(b'lib')\nprint('ptxas info: fake')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels.ctypes, "CDLL", _FakeLib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device=None: contextlib.nullcontext())
    return tmp_path


def test_build_budgets_cover_every_library(fake_toolchain):
    """With no budgets given, every library may be built
    ``config.BUILD_BUDGET`` (one) times in a block, and no more."""
    assert config.BUILD_BUDGET == 1
    for name in kernels.SOURCES:
        with build_guard(raise_on_exceed=False) as rep:
            kernels.build([name])
        assert rep.builds == {name: 1} and rep.exceeded == {}
        with build_guard(raise_on_exceed=False) as rep:
            for _ in range(2):
                kernels._library_path(name).unlink()
                kernels.build([name])
        assert rep.exceeded == {name: (2, 1)}


def test_build_guard_counts_builds_loads_and_launches(fake_toolchain):
    cuda = torch.device("cuda", 0)
    with build_guard() as rep:
        assert kernels.build(["walk", "det_commit"]) >= 0
        assert kernels.build(["walk"]) == 0.0  # cached: no nvcc
        kernels.launch("walk", torch.float32, cuda)
        kernels.reset_launch_counts()  # the launches count from here
        kernels.launch("walk", torch.float64, cuda)
        kernels.launch("block_walk", torch.float32, cuda)  # builds + loads
        kernels._lib("walk")  # loaded already
    assert rep.builds == {"walk": 1, "det_commit": 1, "block_walk": 1}
    assert rep.loads == {"walk": 1, "block_walk": 1}
    assert rep.launches == {"walk": 1, "block_walk": 1}
    assert rep.exceeded == {}
    assert "builds: block_walk=1, det_commit=1, walk=1" in rep.render()
    assert kernels.build_log("walk").strip() == "ptxas info: fake"


def _rebuild_and_reload(name: str) -> None:
    kernels._library_path(name).unlink()
    kernels.build([name])
    kernels._libs.pop(name)
    kernels._lib(name)


def test_build_guard_breach_raises(fake_toolchain):
    kernels._lib("walk")  # built and loaded before the block
    with pytest.raises(BuildBudgetExceeded,
                       match=r"walk: 2 builds > budget 1"):
        with build_guard():
            _rebuild_and_reload("walk")
            _rebuild_and_reload("walk")
    # Budgets for libraries the block never touched, or no budgets at
    # all, pass; loads are counted, never budgeted.
    with build_guard({"row_gather": 0}) as rep:
        _rebuild_and_reload("walk")
        _rebuild_and_reload("walk")
    assert rep.builds == {"walk": 2} and rep.loads == {"walk": 2}
    assert rep.exceeded == {}


def test_build_guard_never_raises_over_another_exception(fake_toolchain):
    with pytest.raises(KeyError):
        with build_guard({"walk": 0}) as rep:
            kernels._lib("walk")
            raise KeyError("the caller's own error")
    assert rep.exceeded == {"walk": (1, 0)}


def test_build_guard_records_without_raising(fake_toolchain):
    with build_guard({"walk": 0}, raise_on_exceed=False) as rep:
        kernels._lib("walk")
    assert rep.exceeded == {"walk": (1, 0)}
    assert rep.builds == {"walk": 1} and rep.loads == {"walk": 1}


def test_profiled_move_sections_go_through_phase_timer(monkeypatch):
    """The engine's sections are ``phase_timer`` calls fenced on its
    devices; the profile has the JAX fields and the move equals an
    unprofiled one bit for bit."""
    calls = []
    real = profiling.phase_timer

    def recording(sink, field, fence=None):
        calls.append((type(sink).__name__, field, fence))
        return real(sink, field, fence)

    monkeypatch.setattr(partition, "phase_timer", recording)
    mesh = build_box(1, 1, 1, 4, 4, 4, dtype=torch.float64)
    n = 300
    rng = np.random.default_rng(5)
    src, dst = rng.uniform(0.05, 0.95, (2, n, 3))

    def run(profile):
        t = PartitionedPumiTally(mesh, n, TallyConfig(
            walk_vmem_max_elems=100, walk_block_kernel="gather"),
            device="cpu")
        t.CopyInitialPosition(src.reshape(-1).copy())
        t.engine.move(None, torch.tensor(dst), torch.ones(n, dtype=torch.int8),
                      torch.ones(n, dtype=torch.float64), profile=profile)
        return t

    prof = PhaseProfile()
    t_prof = run(prof)
    assert {f for _, f, _ in calls} == {"walk_s", "migrate_s",
                                        "occupancy_s", "bookkeeping_s"}
    assert all(k == "PhaseProfile" and fence == [torch.device("cpu")]
               for k, _, fence in calls)
    assert prof.walk_s > 0 and prof.migrate_s > 0 and prof.rounds >= 2
    assert ([f.name for f in dataclasses.fields(PhaseProfile)]
            == [f.name for f in dataclasses.fields(JaxProfile)])
    assert sorted(prof.as_dict()) == sorted(JaxProfile().as_dict())
    n_calls = len(calls)
    t_plain = run(None)
    assert len(calls) == n_calls  # no profile: no timer
    assert torch.equal(t_prof.flux, t_plain.flux)
    np.testing.assert_array_equal(t_prof.positions, t_plain.positions)


def _annotations(prof, tmp_path) -> list:
    """The ``user_annotation`` names of a profiler window's Chrome trace,
    in order."""
    path = tmp_path / "spans.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in sorted(events, key=lambda e: e.get("ts", 0))
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_phase_timer_opens_its_span(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    sink = types.SimpleNamespace(walk_s=0.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with phase_timer(sink, "walk_s", fence=torch.zeros(1)):
            torch.ones(8).sum()
    assert _annotations(prof, tmp_path) == ["ptt.walk_s"]
    assert sink.walk_s > 0


def test_build_and_load_spans_leave_the_counters_alone(fake_toolchain,
                                                       tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with build_guard() as rep:
            kernels._lib("walk")  # built, then loaded
            kernels._lib("walk")  # loaded already: no span
    assert _annotations(prof, tmp_path) == ["ptt.build", "ptt.load"]
    assert rep.builds == {"walk": 1} and rep.loads == {"walk": 1}
