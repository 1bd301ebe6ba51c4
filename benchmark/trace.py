"""The traced run's one profiler window and what is read from it.

``profiled`` opens a ``torch.profiler`` window (CPU and CUDA
activities), exports it as a Chrome trace into ``TMPDIR`` and reads it
back into a ``Trace``: the device's events (kernels, copies, fills)
and the host's, on one clock. Only a process's first profiler window is
sure to keep its device events (later ones lose them once CUPTI has run
for a while), so a run opens exactly one, right after warm-up, over a
short stretch of whole batches.

The harness marks its own spans in the window with
``record_function``: ``bench.window`` around the stretch, and one a
protocol call (``bench.copy_initial``, ``bench.move``,
``bench.close_batch``).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.window"


@dataclass
class Event:
    name: str
    cat: str
    start: float  # microseconds, the trace's clock
    dur: float

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclass
class Trace:
    device: List[Event] = field(default_factory=list)
    host: List[Event] = field(default_factory=list)

    def spans(self, name: str) -> List[Event]:
        return sorted((e for e in self.host
                       if e.cat == "user_annotation" and e.name == name),
                      key=lambda e: e.start)

    def window(self) -> Event:
        spans = self.spans(WINDOW_SPAN)
        if len(spans) != 1:
            raise RuntimeError(f"the trace holds {len(spans)} "
                               f"{WINDOW_SPAN} spans, not one")
        return spans[0]

    def kernels(self) -> List[Event]:
        return [e for e in self.device if e.cat == "kernel"]


def parse_chrome_trace(doc: dict) -> Trace:
    tr = Trace()
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        e = Event(ev.get("name", ""), cat, float(ev["ts"]), float(ev["dur"]))
        if cat in DEVICE_CATS:
            tr.device.append(e)
        elif cat in HOST_CATS:
            tr.host.append(e)
    return tr


@contextlib.contextmanager
def profiled(out: list):
    """Profile the block; on exit, append its ``Trace`` to ``out``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            yield
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out.append(parse_chrome_trace(json.load(f)))
    finally:
        os.unlink(path)


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_in(events: List[Event], lo: float, hi: float) -> float:
    """Microseconds in [lo, hi] during which some event ran."""
    clipped = [(max(e.start, lo), min(e.end, hi)) for e in events
               if e.end > lo and e.start < hi]
    return sum(b - a for a, b in merged([c for c in clipped if c[1] > c[0]]))


def device_busy(tr: Trace) -> Tuple[float, float]:
    """(busy, window) seconds of the traced window: the union of device
    activity in it, and its length."""
    w = tr.window()
    return busy_in(tr.device, w.start, w.end) * 1e-6, w.dur * 1e-6


def top_device_ops(tr: Trace, k: int = 10) -> list:
    w = tr.window()
    tot: dict = {}
    for e in tr.device:
        if e.end > w.start and e.start < w.end:
            tot[e.name] = tot.get(e.name, 0.0) + e.dur * 1e-6
    return sorted(([short_name(n), s] for n, s in tot.items()),
                  key=lambda p: -p[1])[:k]


def idle_gaps(tr: Trace, k: int = 10) -> list:
    """The longest stretches of the window with no device activity, each
    named by the host's innermost event at its middle (under the
    protocol call it belongs to)."""
    w = tr.window()
    busy = merged([(max(e.start, w.start), min(e.end, w.end))
                   for e in tr.device if e.end > w.start and e.start < w.end])
    gaps, t = [], w.start
    for a, b in busy + [(w.end, w.end)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:k]:
        mid = (a + b) / 2
        around = [e for e in tr.host if e.start <= mid <= e.end
                  and e.name != WINDOW_SPAN]
        calls = [e for e in around if e.name.startswith("bench.")]
        inner = min(around, key=lambda e: e.dur) if around else None
        label = (calls[0].name if calls else "between calls")
        if inner is not None and inner.name != label:
            label += " > " + short_name(inner.name)
        out.append([label, (b - a) * 1e-6])
    return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list (templates kept)."""
    name = re.sub(r"^void ", "", name)
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i and name[i - 1] != " ":
            return name[:i][:120]
    return name[:120]
