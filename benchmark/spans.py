"""The program's own spans in the traced window, and the arithmetic the
readers of ``benchmark/metrics/`` share over them.

The port names its host work on the profiler's timeline
(``pumiumtally_tpu_torch.utils.profiling.span``): ``ptt.copy_initial``
and ``ptt.move`` around each protocol call, and inside them
``ptt.stage.fill``, ``ptt.stage.upload``, ``ptt.echo``, ``ptt.walk`` and
``ptt.sync`` (each wait of the host on the device). A reader takes the
spans that start inside one of the harness's call spans of the window
(``bench.move``, ``bench.copy_initial``) and divides by the number of
those calls. Where the trace holds no ``ptt.move`` span (a program
without the spans) every reader returns None.
"""

from __future__ import annotations

from typing import List, Optional

from benchmark.trace import Event, busy_in

PREFIX = "ptt."
MOVE = "ptt.move"


def program_spans(ctx) -> Optional[List[Event]]:
    """The program's spans in the trace, or None where it has none."""
    if ctx.trace is None:
        return None
    spans = [e for e in ctx.trace.host if e.cat == "user_annotation"
             and e.name.startswith(PREFIX)]
    if not any(e.name == MOVE for e in spans):
        return None
    return spans


def calls(ctx, call: str) -> List[Event]:
    """The harness's ``call`` spans inside the traced window."""
    w = ctx.trace.window()
    return [c for c in ctx.trace.spans(call)
            if c.start >= w.start and c.end <= w.end]


def within(spans: List[Event], call: Event, name: Optional[str] = None
           ) -> List[Event]:
    """The spans (named ``name``; None: any) that start inside
    ``call``."""
    return [e for e in spans if call.start <= e.start < call.end
            and (name is None or e.name == name)]


def _per_call(ctx, call: str, of) -> Optional[float]:
    """``of(spans, call)`` summed over the window's ``call`` spans, over
    their number; None without the program's spans or such calls."""
    spans = program_spans(ctx)
    if spans is None:
        return None
    cs = calls(ctx, call)
    if not cs:
        return None
    return sum(of(spans, c) for c in cs) / len(cs)


def ms_per_call(ctx, name: str, call: str = "bench.move"
                ) -> Optional[float]:
    """Host ms in ``name`` spans inside the window's ``call`` spans, a
    call."""
    v = _per_call(ctx, call,
                  lambda s, c: busy_in(within(s, c, name), c.start, c.end))
    return None if v is None else v * 1e-3


def count_per_call(ctx, name: str, call: str = "bench.move"
                   ) -> Optional[float]:
    """``name`` spans inside the window's ``call`` spans, a call."""
    return _per_call(ctx, call, lambda s, c: len(within(s, c, name)))


def self_ms_per_call(ctx, name: str, call: str,
                     children: Optional[str] = None) -> Optional[float]:
    """Host ms of each ``name`` span inside the window's ``call`` spans
    less the union of the program's other spans within it (only those
    named ``children``, where given), a call."""

    def own(spans, c):
        return sum(outer.dur - busy_in(
            [e for e in spans if e is not outer
             and (children is None or e.name == children)],
            outer.start, outer.end) for outer in within(spans, c, name))

    v = _per_call(ctx, call, own)
    return None if v is None else v * 1e-3
