"""Profiling: fenced phase timers, torch.profiler trace capture, the
kernel build tripwire.

The port of ``pumiumtally_tpu/utils/profiling.py``. ``phase_timer``
fences before its closing stamp: every CUDA device among its ``fence``
arguments is synchronised (a CPU tensor or device needs nothing), as the
JAX timer's ``block_until_ready`` does. ``trace`` wraps
``torch.profiler.profile`` (CPU activity always, CUDA activity when a
CUDA device is present) and writes a Chrome trace under ``log_dir``
(``<worker>.<ms>.pt.trace.json``: TensorBoard's PyTorch profiler plugin,
chrome://tracing or Perfetto read it).

``build_guard`` is the counterpart of the JAX package's
``retrace_guard``. The JAX package compiles at run time through jit
caches, so its tripwire counts cache growth per entry point
(``register_entry_point``) and backend compiles. The port has no jit
cache: what it compiles at run time is a CUDA library. ``kernels.build``
runs nvcc, ``kernels._lib`` loads the library with ctypes and
``kernels.launch`` counts each launch; the guard reads those counters
(``kernels.build_counts``, ``load_counts``, ``launch_counts``) over a
``with`` block and holds each library's builds to a budget
(``config.BUILD_BUDGET``, one). Loads are reported, not budgeted:
``_lib`` keeps a loaded library for the life of the process. There is
no ``register_entry_point``: every kernel of the port goes through those
three functions, so the counting points are fixed and no call site has
to adopt a wrapper, and nothing else compiles at run time. A rebuild in
the middle of a run costs tens of seconds on the card, which is what
the guard catches.

``span(name)`` names a stretch of the program's host work on the
profiler's timeline: a ``torch.profiler.record_function`` range while a
profiler is on (an operator's ``trace(log_dir)``, or any other
``torch.profiler.profile`` window), one shared ``nullcontext`` when none
is, decided by a single flag check, so the spans stay in the hot path at
a fraction of a microsecond each. The facades open them at each layer
boundary of the three-call protocol, nested on the calling thread under
the call's own span:

- ``ptt.copy_initial``, ``ptt.move``, ``ptt.close_batch``, ``ptt.write``:
  a whole protocol call, entry to the fence's return;
- ``ptt.stage.fill`` / ``ptt.stage.upload``: ``HostStaging.fill``'s
  working-dtype cast into the pinned buffers with its finite checks and
  the weights' compare (one pass of ``native/host_fill.cpp``), and
  ``upload``'s device tensors and non-blocking copies;
- ``ptt.echo``: the origin-echo compare, where origins are passed;
- ``ptt.walk``: ``ops.walk.walk``'s host work through the launch;
- ``ptt.sync``: each wait of the host on the device inside a call (a
  staging slot's event, the found-all and exited reads, the fence);
- ``ptt.build`` / ``ptt.load``: ``kernels.build``'s nvcc run (and
  ``native.host_fill.build``'s compile) and ``kernels._lib``'s ctypes
  load;
- ``ptt.<field>``: each ``phase_timer`` section (the partitioned
  engine's ``PhaseProfile``: ``ptt.walk_s``, ``ptt.migrate_s``, ...).

Everything else a call does is its span's self time. The names are
fixed: the benchmark's readers key on them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Iterator, Optional

import torch

from pumiumtally_tpu_torch import kernels
from pumiumtally_tpu_torch.config import BUILD_BUDGET

_OFF = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


def span(name: str):
    """A context manager naming the block ``name`` on the profiler's
    timeline while a profiler is on, else a shared no-op."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def _cuda_devices(fence) -> list:
    """The distinct CUDA devices among ``fence``: a tensor, a device (or
    its name), or a list/tuple of them."""
    items = fence if isinstance(fence, (list, tuple)) else [fence]
    devices = []
    for item in items:
        if isinstance(item, (list, tuple)):
            devices += _cuda_devices(item)
            continue
        d = item.device if isinstance(item, torch.Tensor) else \
            torch.device(item)
        if d.type == "cuda":
            devices.append(d)
    return list(dict.fromkeys(devices))


@contextlib.contextmanager
def phase_timer(sink, field: str, fence=None) -> Iterator[None]:
    """Accumulate fenced wall seconds into ``sink.<field>``.

    ``fence`` is an optional tensor, ``torch.device`` or list of them:
    every CUDA device among them is synchronised before the closing
    timestamp. CPU work is done when the block returns.
    """
    t0 = time.perf_counter()
    try:
        with span("ptt." + field):
            yield
    finally:
        if fence is not None:
            for d in _cuda_devices(fence):
                torch.cuda.synchronize(d)
        setattr(sink, field, getattr(sink, field) + time.perf_counter() - t0)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a torch.profiler trace around the block and write it as a
    Chrome trace under ``log_dir``.

    The window keeps its device kernels while CUPTI's device timestamps
    agree with the host's: the process's first window starts CUPTI, and
    from 20-60 s after that a window can lose some of its kernels or all
    of them (torch 2.11, CUDA 12.8, H100: PERF.md, ROADMAP queue 3;
    ``experiments/profiler_windows.py`` measures it). Take a trace that
    must be whole as a process's first window. No-op when log_dir is
    None so call sites can be left in place.
    """
    if log_dir is None:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


# ---------------------------------------------------------------------------
# Kernel build tripwire
# ---------------------------------------------------------------------------

class BuildBudgetExceeded(RuntimeError):
    """A CUDA library was built more often than its budget allows."""


@dataclasses.dataclass
class BuildReport:
    """What one ``build_guard`` block built, loaded and launched.

    ``builds`` / ``loads``: per library (``kernels.SOURCES``), the nvcc
    builds and ctypes loads made in the block; ``launches``: per C entry,
    ``kernels.launch_counts`` as the block leaves them (they count from
    the last ``reset_launch_counts``). Only names with a count above 0
    appear. ``exceeded``: library -> (builds, budget) for every library
    built more often than its budget.
    """

    builds: Dict[str, int] = dataclasses.field(default_factory=dict)
    loads: Dict[str, int] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    exceeded: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    def render(self) -> str:
        def per(d):
            return ", ".join(f"{k}={v}" for k, v in sorted(d.items())) \
                or "none"

        return (f"builds: {per(self.builds)}; loads: {per(self.loads)}; "
                f"launches: {per(self.launches)}")


def _deltas(now: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v - before.get(k, 0) > 0}


@contextlib.contextmanager
def build_guard(
    budgets: Optional[Dict[str, int]] = None,
    raise_on_exceed: bool = True,
) -> Iterator[BuildReport]:
    """Count kernel library builds, loads and launches over the block;
    hold each library's builds to its budget.

    ``budgets`` maps library names to the most NEW nvcc builds allowed;
    None gives every library ``config.BUILD_BUDGET``, and a library left
    out of a mapping is counted but never fails. With ``raise_on_exceed``
    (default) a breach raises ``BuildBudgetExceeded``, but never while
    another exception is already unwinding. Pass
    ``raise_on_exceed=False`` to only record breaches in
    ``report.exceeded``.
    """
    if budgets is None:
        budgets = dict.fromkeys(kernels.SOURCES, BUILD_BUDGET)
    before_builds = dict(kernels.build_counts)
    before_loads = dict(kernels.load_counts)
    report = BuildReport()
    ok = False
    try:
        yield report
        ok = True
    finally:
        report.builds = _deltas(kernels.build_counts, before_builds)
        report.loads = _deltas(kernels.load_counts, before_loads)
        report.launches = {e: c for e, c in kernels.launch_counts.items()
                           if c}
        report.exceeded = {name: (report.builds[name], budget)
                           for name, budget in budgets.items()
                           if report.builds.get(name, 0) > budget}
        if ok and report.exceeded and raise_on_exceed:
            detail = ", ".join(f"{n}: {g} builds > budget {b}" for n, (g, b)
                               in sorted(report.exceeded.items()))
            raise BuildBudgetExceeded(
                f"kernel build budget exceeded ({detail}). A library is "
                "built once, when no cached build matches its sources; "
                "more means the build key moved under a running process "
                "(kernels.build)."
            )
