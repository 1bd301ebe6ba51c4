"""Per-client session state: one facade, one queue, one lifecycle (port of
``pumiumtally_tpu/service/session.py``, the same pure Python).

A ``TallySession`` wraps ONE engine facade (any of the four kinds) on
behalf of one client. Everything campaign-scoped already lives on the
facade — flux, scoring lane banks, batch-statistics accumulators, the
sentinel's health record and quarantine stream, the autosave runner
and its generation store — so wrapping a facade per session is exactly
what keeps those PER-SESSION: two clients sharing a service share the
device and the built kernels (code, no state) and nothing
else. That is also the root of the service's determinism contract: a
session's campaign output is bitwise the solo run of the same
campaign, however its ops interleave with other sessions'.

Lifecycle: OPEN → DRAINING → CLOSED.

- OPEN accepts submissions into the bounded FIFO queue (admission
  control: ``ServiceBusyError`` when full — the client retries after
  its oldest future resolves; the refused op was never queued and the
  session's state is untouched);
- DRAINING (client close, or service-wide SIGTERM drain) rejects new
  work with ``SessionClosedError`` while queued ops finish;
- CLOSED: queue empty, drain checkpoint written (when autosave is
  armed), facade released from the scheduler ring.

The queue bound defaults to 2 — the double buffer: one op staged
ahead while one executes (staging.py). Deeper queues buy more
pipeline slack at the price of staler backpressure.
"""

from __future__ import annotations

import enum
import time
import warnings
from collections import deque
from typing import Any, Dict, Optional, Tuple

from pumiumtally_tpu_torch.service.scheduler import Priority
from pumiumtally_tpu_torch.service.staging import StagedOp

DEFAULT_QUEUE_DEPTH = 2

# Completed-op latency samples retained per session for the p50/p99
# quantiles in TallyService.stats() / the ping reply. A bounded window,
# not a full history: load telemetry should describe CURRENT service
# behaviour, and an unbounded list would grow with campaign length.
LATENCY_WINDOW = 512


class SessionState(enum.Enum):
    OPEN = "open"
    DRAINING = "draining"
    CLOSED = "closed"


class ServiceBusyError(RuntimeError):
    """The session's move queue is full (admission control): the op was
    NOT enqueued. Retry after one of the session's outstanding futures
    resolves — per-session state is untouched by the refusal."""


class SessionClosedError(RuntimeError):
    """The session is draining or closed and accepts no new work."""


class ServiceOverloadedError(RuntimeError):
    """The SERVICE-wide admission budget (total queued + in-flight
    particle cost across every session) is exhausted: the op or
    session open was NOT admitted and no state changed — like
    ``ServiceBusyError``, the refusal leaves caller buffers untouched
    (accept-then-zero contract). Unlike busy, which is one session's
    backpressure, overload is global: retry after outstanding futures
    resolve anywhere, or route to another worker. Carries the numbers
    a load balancer needs: ``budget``, ``admitted`` (cost units
    currently queued or in flight), ``cost`` (the refused op's)."""

    def __init__(self, message: str, *, budget: Optional[int] = None,
                 admitted: Optional[int] = None,
                 cost: Optional[int] = None):
        super().__init__(message)
        self.budget = budget
        self.admitted = admitted
        self.cost = cost


class TallySession:
    """One client's campaign inside the service (built by
    ``server.TallyService.open_session``; all methods are called under
    the service's lock — the session itself is not a thread-safe
    object)."""

    def __init__(self, session_id: str, tally,
                 max_queue: int = DEFAULT_QUEUE_DEPTH,
                 priority: Priority = Priority.NORMAL):
        if int(max_queue) < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue!r}")
        self.id = str(session_id)
        self.tally = tally
        self.max_queue = int(max_queue)
        self.priority = Priority(priority)
        self.state = SessionState.OPEN
        self._queue: deque = deque()
        self.ops_submitted = 0
        self.ops_completed = 0
        self.moves_completed = 0
        # Transport (source/move) cost units sitting in THIS queue —
        # the queued half of the service's admission ledger, kept as a
        # running counter so head_cost/stats stay O(1).
        self._queued_cost = 0
        self._latencies: deque = deque(maxlen=LATENCY_WINDOW)
        # The close sentinel's future, once a close is issued: a
        # second close() returns it instead of queueing a sentinel the
        # scheduler could never pick after the first one unregisters
        # the session (a hung future, not an error).
        self.close_future = None
        runner = getattr(tally, "_resilience", None)
        if runner is not None and runner.policy.handle_signals:
            # The SERVICE owns the process's drain handler (one
            # dispatcher, resilience/policy.py); a per-session runner
            # that also installed one would shadow it with a handler
            # whose drain flag nothing in the service consumes.
            warnings.warn(
                f"session {self.id!r}: its CheckpointPolicy has "
                "handle_signals=True — inside a service, pass "
                "handle_signals=False and let the service drain every "
                "session on SIGTERM"
            )

    # -- queue (service-lock context) ------------------------------------
    def submit(self, op: StagedOp) -> StagedOp:
        if self.state is not SessionState.OPEN:
            raise SessionClosedError(
                f"session {self.id!r} is {self.state.value}: it accepts "
                "no new work"
            )
        if len(self._queue) >= self.max_queue:
            raise ServiceBusyError(
                f"session {self.id!r} queue is full "
                f"({self.max_queue} staged ops): retry after an "
                "outstanding future resolves"
            )
        self._queue.append(op)
        self.ops_submitted += 1
        if op.kind != "call":
            self._queued_cost += op.cost
        return op

    def submit_final(self, op: StagedOp) -> StagedOp:
        """Enqueue past the DRAINING gate (the session-close sentinel
        op itself; the depth bound is deliberately not applied — a
        close must never be refused for backpressure)."""
        if self.state is SessionState.CLOSED:
            raise SessionClosedError(f"session {self.id!r} is closed")
        self._queue.append(op)
        self.ops_submitted += 1
        if op.kind != "call":
            self._queued_cost += op.cost
        return op

    def head_cost(self) -> Optional[int]:
        return self._queue[0].cost if self._queue else None

    def head(self) -> Optional[StagedOp]:
        """The queued head op WITHOUT popping it (the fusion window
        inspects kinds/keys under the service lock before committing
        to a group)."""
        return self._queue[0] if self._queue else None

    def pop(self) -> StagedOp:
        op = self._queue.popleft()
        if op.kind != "call":
            self._queued_cost -= op.cost
        return op

    def pending(self) -> int:
        return len(self._queue)

    def queued_cost(self) -> int:
        """Transport cost units currently queued (reads excluded —
        they carry no particle buffers and cost 1 only for DRR turn
        accounting)."""
        return self._queued_cost

    def note_completed(self, op: StagedOp) -> None:
        self.ops_completed += 1
        if op.kind == "move":
            self.moves_completed += 1
        if op.t_submit is not None:
            self._latencies.append(time.perf_counter() - op.t_submit)

    def latency_quantiles(self) -> Optional[Tuple[float, float]]:
        """(p50, p99) submit→resolve wall latency in seconds over the
        last ``LATENCY_WINDOW`` completed ops, or None before the
        first completion (nearest-rank on the sorted window — exact,
        no interpolation, cheap at 512 samples)."""
        if not self._latencies:
            return None
        a = sorted(self._latencies)
        hi = len(a) - 1

        def q(p: float) -> float:
            return a[min(hi, int(p * hi + 0.5))]

        return q(0.50), q(0.99)

    # -- lifecycle -------------------------------------------------------
    def begin_drain(self) -> None:
        if self.state is SessionState.OPEN:
            self.state = SessionState.DRAINING

    def mark_closed(self) -> None:
        self.state = SessionState.CLOSED

    # -- drain checkpoint -------------------------------------------------
    def drain_checkpoint(self, reason: str = "service_drain"
                         ) -> Optional[Tuple[int, str]]:
        """Write one generation through the session's own autosave
        runner (None when the facade has no ``TallyConfig.checkpoint``
        armed — drain then simply discards the session's device state,
        exactly like a bare facade's process exit). The generation's
        metadata carries the session id and, with a sentinel armed,
        the session's health summary — a drained fleet leaves one
        self-describing generation per session."""
        runner = getattr(self.tally, "_resilience", None)
        if runner is None:
            return None
        meta: Dict[str, Any] = {"session": self.id}
        if getattr(self.tally, "_sentinel", None) is not None:
            meta["health"] = self.tally.health_report().as_dict()
        return runner.save(self.tally, reason=reason, meta=meta)
