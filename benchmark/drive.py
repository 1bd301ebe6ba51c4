"""Driving the facade through the three-call protocol, as a transport
host does.

A batch is ``CopyInitialPosition(sources)``, then one
``MoveToNextLocation`` a move with float64 host arrays (the two-phase
protocol passes the origins, which echo the previous destinations; the
continue protocol passes None), every particle flying (the flying
buffer is refilled before each call: the facade zeroes it, as the
reference's protocol does), the weights, and the energies and times
where the configuration scores by them; then ``close_batch()`` where it
keeps batch statistics. Every call's wall time is taken on the host
clock from the call to its return; the facade fences its calls, so a
call returns after the device has finished its work.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, List

import numpy as np


@dataclass
class Tally:
    """What a stretch of batches did: each move call's seconds, the
    particles each handed over, and how often each pool batch ran."""

    move_s: List[float] = field(default_factory=list)
    particles: int = 0
    batches: List[int] = field(default_factory=list)
    start: float = 0.0  # perf_counter at the first call
    seconds: float = 0.0

    @property
    def moves(self) -> int:
        return len(self.move_s)


class Driver:
    def __init__(self, facade, pool, protocol: str, close_batches: bool,
                 span: Callable = None):
        self.t = facade
        self.pool = pool
        self.protocol = protocol
        self.close_batches = close_batches
        self.n = pool[0].points[0].shape[0]
        self.fly = np.ones(self.n, np.int8)
        # The traced run names each call in the profiler's timeline; an
        # untraced run adds nothing around the calls.
        self.span = span or (lambda name: contextlib.nullcontext())

    def batch(self, p: int, out: Tally) -> None:
        b = self.pool[p]
        t = self.t
        with self.span("bench.copy_initial"):
            t.CopyInitialPosition(b.points[0])
        for m in range(1, b.moves + 1):
            origins = b.points[m - 1] if self.protocol == "two_phase" \
                else None
            kw = {}
            if b.energy is not None:
                kw["energy"] = b.energy[m - 1]
            if b.time is not None:
                kw["time"] = b.time[m - 1]
            self.fly.fill(1)
            with self.span("bench.move"):
                t0 = time.perf_counter()
                t.MoveToNextLocation(origins, b.points[m], self.fly,
                                     b.weights, **kw)
                out.move_s.append(time.perf_counter() - t0)
            out.particles += self.n
        if self.close_batches:
            with self.span("bench.close_batch"):
                t.close_batch()
        out.batches.append(p)

    def cycle(self, out: Tally) -> None:
        """Every pool batch once, in order."""
        for p in range(len(self.pool)):
            self.batch(p, out)

    def window(self, seconds: float) -> Tally:
        """Whole pool cycles until ``seconds`` have passed; the window is
        from the first call to the last return."""
        out = Tally()
        t0 = out.start = time.perf_counter()
        while True:
            self.cycle(out)
            if time.perf_counter() - t0 >= seconds:
                break
        out.seconds = time.perf_counter() - t0
        return out
