"""What the metric readers (``benchmark/metrics/<name>.py``) read: one
run's ``Context``, and the arithmetic several of them share.

A reader is a module with ``read(ctx) -> float | None``. It returns
None where the run holds nothing for it to read, and the harness then
leaves the metric out of the result line.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import List, Optional

from benchmark.drive import Tally
from benchmark.trace import Trace, busy_in

# W0, the walk kernel: ``walk_kernel<T, kLayout, kScore, kDet, kSeg>``,
# as the profiler names it (demangled, or in its mangled form).
_W0 = re.compile(r"walk_kernel<\s*(float|double)\s*,\s*(\d+)\s*,"
                 r"\s*(true|false)|walk_kernelI([fd])Li(\d+)ELb([01])")


@dataclass
class Launch:
    """One walk of the traced stretch, as the reference counts it."""

    kind: str  # "localize", "relocate" or "move"
    scored: bool
    bound_ms: float


@dataclass
class Context:
    setup_s: float
    mesh_load_s: float
    window: Tally
    traced: Optional[Tally] = None
    trace: Optional[Trace] = None
    launches: List[Launch] = field(default_factory=list)


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value with at
    least 95% of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def w0_scored(name: str) -> Optional[bool]:
    """Whether a kernel is W0's scoring instantiation; None: not W0."""
    m = _W0.search(name)
    if m is None:
        return None
    flag = m.group(3) or m.group(6)
    return flag in ("true", "1")


def w0_share(ctx: Context, scored: bool) -> Optional[float]:
    """W0's bound over its device time in the traced window, in %, over
    the scoring instantiation's launches (``scored``) or over all of
    W0's."""
    if ctx.trace is None:
        return None
    w = ctx.trace.window()
    ms = sum(e.dur for e in ctx.trace.kernels()
             if e.start >= w.start and e.end <= w.end
             and w0_scored(e.name) is not None
             and (not scored or w0_scored(e.name))) * 1e-3
    bound = sum(la.bound_ms for la in ctx.launches
                if not scored or la.scored)
    if ms <= 0 or bound <= 0:
        return None
    return 100.0 * bound / ms


def host_ms_per_move(ctx: Context) -> Optional[float]:
    if ctx.trace is None:
        return None
    moves = ctx.trace.spans("bench.move")
    if not moves:
        return None
    host = [m.dur - busy_in(ctx.trace.device, m.start, m.end)
            for m in moves]
    return sum(host) / len(host) * 1e-3
