"""The multi-tenant campaign service: device owner + client front ends
(port of ``pumiumtally_tpu/service/server.py``: the same threads, queues,
drain and NDJSON wire, over the port's facades).

``TallyService`` owns the device on behalf of any number of concurrent
client sessions. ONE worker thread executes every facade call — the
serialization point that makes multi-tenancy deterministic:

- per-session ops run in strict FIFO order (session.py), so each
  session's campaign is the exact op sequence its client submitted;
- sessions interleave under deficit round robin (scheduler.py), which
  bounds cross-session unfairness by a constant but has NO influence
  on values — sessions share nothing but the device and the built kernels
  (code, no state), so a session's flux is bitwise the solo run of its
  campaign whatever the interleaving (on the card too: the service arms
  the deterministic commit on every session's facade,
  ``open_session``);
- reads (flux, health, statistics) ride the same FIFO as transport
  ops, so a read observes exactly the moves submitted before it.

Clients never block on device compute: ``SessionHandle`` methods
prepack + validate on the calling thread (staging.py), enqueue, and
return a ``concurrent.futures.Future``. A full queue refuses with
``ServiceBusyError`` at submit (admission control) — nothing partial
ever enters the pipeline.

Drain: the service registers with the resilience layer's process-wide
signal dispatcher (resilience.install_drain_owner — the SAME
single-owner mechanism a bare autosave-armed facade uses, so a second
SIGTERM still escalates to an immediate kill). The first SIGTERM sets
the drain flag: every session stops accepting work, in-flight and
queued ops finish, and ``shutdown(drain=True)`` writes one checkpoint
generation per autosave-armed session before the process exits 0.
Per-session ``CheckpointPolicy``s should carry
``handle_signals=False`` — the service owns the handler.

The NDJSON socket front end (``SocketFrontend`` / the ``pumiumtally
serve`` CLI verb) lets external host codes attach as independent
sessions: one JSON object per line, arrays as base64 little-endian
raw bytes (f64 positions/weights/energy/time, int8 flying). It trusts
its network: no authentication, mesh-path loading disabled unless
explicitly allowed — deploy it behind the same perimeter as the host
codes it serves.
"""

from __future__ import annotations

import base64
import itertools
import json
import os
import socket
import threading
import time
import warnings
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np

from pumiumtally_tpu_torch.service import staging
from pumiumtally_tpu_torch.service.scheduler import (
    DeficitRoundRobinScheduler,
    Priority,
)
from pumiumtally_tpu_torch.service.session import (
    ServiceBusyError,
    ServiceOverloadedError,
    SessionClosedError,
    SessionState,
    TallySession,
)


def _host(t) -> np.ndarray:
    """A snapshot of a facade tensor's values as a host array (its own
    copy: the facades update flux in place)."""
    return t.detach().to("cpu", copy=True).numpy()


class ServiceDrainingError(RuntimeError):
    """The service received a drain request (SIGTERM or shutdown) and
    accepts no new work. Distinct from ``ServiceBusyError`` on
    purpose: busy means retry, draining means finish up and detach."""


class TallyService:
    """Multi-session campaign service (in-process API).

    Args:
      handle_signals: own the process's SIGTERM/SIGINT graceful-drain
        handler via the resilience dispatcher (main thread only).
      quantum: scheduler quantum in cost units (None = auto; see
        scheduler.DeficitRoundRobinScheduler).
      autostart: start the worker thread lazily on the first submit
        (False = the caller starts it explicitly — the backpressure
        tests stage against a stopped worker deterministically).
      fuse_sessions: coalesce compatible sessions' queued moves into
        ONE device launch (service/fusion.py) —
        sessions grouped by fusion key (same mesh + facade kind +
        static walk/scoring configuration) pack one slab, run one
        walk, and scatter per-session results back bitwise-equal to
        solo runs. Default on; False reproduces the one-op-at-a-time
        one-op-at-a-time path bit for bit (and a 1-session service never
        fuses either way — a group of one runs the unfused path).
      max_fuse: the fusion window — at most this many compatible
        session heads share one launch (bounds slab size and trace
        keys).
      admission_budget: global cap on transport (source/move) cost
        units queued or in flight across ALL sessions.
        None (default) = unbounded. With a
        budget, a submit that would exceed it — or an ``open_session``
        arriving while the budget is already full — refuses with a
        structured ``ServiceOverloadedError`` BEFORE any state
        changes, so a thousand eager clients backlog at the protocol
        layer instead of OOMing the staging heap. Reads and the close
        sentinel never count against (or get refused by) the budget:
        telemetry and teardown must stay live under overload.
    """

    def __init__(self, *, handle_signals: bool = False,
                 quantum: Optional[int] = None, autostart: bool = True,
                 fuse_sessions: bool = True, max_fuse: int = 8,
                 admission_budget: Optional[int] = None):
        if int(max_fuse) < 1:
            raise ValueError(f"max_fuse must be >= 1, got {max_fuse!r}")
        if admission_budget is not None and int(admission_budget) < 1:
            raise ValueError(
                f"admission_budget must be >= 1, got {admission_budget!r}"
            )
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._sessions: Dict[str, TallySession] = {}
        self._sched = DeficitRoundRobinScheduler(quantum=quantum)
        self._seq = itertools.count(1)
        self._drain = False  # the resilience dispatcher's duck-typed flag
        self._stop = False
        self._inflight = 0
        self._autostart = bool(autostart)
        self._handle_signals = bool(handle_signals)
        self._fuse = bool(fuse_sessions)
        self._max_fuse = int(max_fuse)
        self._admission_budget = (
            None if admission_budget is None else int(admission_budget)
        )
        # Transport cost units admitted and not yet completed
        # (queued + in flight) — the admission ledger. Credited in
        # _submit under the lock, debited when the worker resolves the
        # op, so the budget bounds live staging-heap footprint.
        self._admitted_cost = 0
        self.admission_stats: Dict[str, int] = {
            "refused_ops": 0, "refused_sessions": 0,
        }
        # Serving telemetry (read by the fusion A/B): how many device
        # dispatch opportunities coalesced. "fused_groups" counts
        # shared launches, "fused_moves" the moves they carried,
        # "solo_moves"/"solo_other" the ops that ran one at a time.
        self.fusion_stats: Dict[str, int] = {
            "fused_groups": 0, "fused_moves": 0,
            "solo_moves": 0, "solo_other": 0,
        }
        # Groups whose shared launch failed and ran solo (their moves are
        # counted in "solo_moves"; a healthy service keeps this at 0).
        self.fusion_fallbacks = 0
        self._worker: Optional[threading.Thread] = None
        if self._handle_signals:
            from pumiumtally_tpu_torch.resilience import install_drain_owner

            install_drain_owner(self)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self._worker is not None or self._stop:
                return
            self._worker = threading.Thread(
                target=self._worker_loop, name="pumiumtally-service",
                daemon=True,
            )
            self._worker.start()

    def __enter__(self) -> "TallyService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(drain=exc_type is None)

    @property
    def drain_requested(self) -> bool:
        return self._drain

    def request_drain(self) -> None:
        """What the SIGTERM handler effects: stop intake everywhere;
        queued and in-flight work still completes. The controlling
        loop (CLI serve / a campaign program) observes ``drain_requested`` and
        calls ``shutdown(drain=True)``."""
        with self._cv:
            self._drain = True
            for sess in self._sessions.values():
                sess.begin_drain()
            self._cv.notify_all()

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None
                 ) -> Dict[str, Any]:
        """Stop intake, finish every queued op, optionally write one
        drain checkpoint per autosave-armed open session, stop the
        worker. Returns ``{session_id: (generation, path) | None}``
        for the sessions drained (empty when ``drain=False``)."""
        self.request_drain()
        with self._lock:
            has_pending = bool(self._inflight) or any(
                s.pending() for s in self._sessions.values()
            )
        if has_pending:
            # Queued ops always complete before the service stops —
            # even when the worker was never started (autostart=False
            # and a shutdown before start()).
            self.start()
        saved: Dict[str, Any] = {}
        with self._cv:
            quiesced = self._cv.wait_for(
                lambda: self._inflight == 0 and not any(
                    s.pending() for s in self._sessions.values()
                ),
                timeout=timeout,
            )
            sessions = list(self._sessions.values())
        if not quiesced:
            # Never checkpoint while the worker may still be mutating
            # facade state — a mid-move snapshot would break the
            # bitwise-resume guarantee. The service stays draining;
            # the caller can retry shutdown.
            raise TimeoutError(
                f"service did not quiesce within {timeout}s; no drain "
                "checkpoints written — retry shutdown()"
            )
        # Checkpoints OUTSIDE the lock: saves fetch device arrays and
        # fsync — nothing a submit (they all refuse now) can race.
        # Per-session containment: one session's failing store (ENOSPC,
        # EACCES) must not cost the OTHER sessions their generations,
        # nor skip the worker-stop/handler-release below — the drained
        # process still exits 0 for the sessions whose storage is
        # healthy.
        for sess in sessions:
            if drain and sess.state is not SessionState.CLOSED:
                try:
                    saved[sess.id] = sess.drain_checkpoint()
                except Exception as e:  # noqa: BLE001 — see above
                    warnings.warn(
                        f"session {sess.id!r}: drain checkpoint "
                        f"failed ({e!r}); its state is lost but the "
                        "drain continues"
                    )
                    saved[sess.id] = None
            sess.mark_closed()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            worker = self._worker
        if worker is not None:
            worker.join(timeout=timeout)
        if self._handle_signals:
            from pumiumtally_tpu_torch.resilience import release_drain_owner

            release_drain_owner(self)
        return saved

    # -- sessions --------------------------------------------------------
    def open_session(self, tally, *, session_id: Optional[str] = None,
                     max_queue: Optional[int] = None,
                     priority: Priority = Priority.NORMAL
                     ) -> "SessionHandle":
        """Admit one client: wrap its facade (any of the four kinds,
        built by the caller so the client picks engine/config) in a
        session and register it with the scheduler, in the lane named
        by ``priority`` (fixed for the session's lifetime). With an
        admission budget armed, an open arriving while the budget is
        already full refuses with ``ServiceOverloadedError`` — a new
        client's first submit could never be admitted anyway, and
        refusing at open lets a router place it elsewhere."""
        with self._lock:
            if self._drain or self._stop:
                raise ServiceDrainingError(
                    "service is draining: no new sessions"
                )
            if (self._admission_budget is not None
                    and self._admitted_cost >= self._admission_budget):
                self.admission_stats["refused_sessions"] += 1
                raise ServiceOverloadedError(
                    f"admission budget full ({self._admitted_cost}/"
                    f"{self._admission_budget} cost units queued or in "
                    "flight): no new sessions — retry after outstanding "
                    "work resolves, or route elsewhere",
                    budget=self._admission_budget,
                    admitted=self._admitted_cost,
                )
            sid = session_id
            if sid is None:
                # The generator must skip ids a caller claimed
                # explicitly — open_session(session_id="s1") then
                # open_session() would otherwise refuse the caller
                # who passed nothing.
                sid = f"s{next(self._seq)}"
                while sid in self._sessions:
                    sid = f"s{next(self._seq)}"
            if sid in self._sessions:
                raise ValueError(f"session id {sid!r} already open")
            kw = {} if max_queue is None else {"max_queue": max_queue}
            # Every session walks with the deterministic commit: on the
            # card the atomic one would not keep a session bitwise its
            # solo run (nor two solo runs bitwise each other).
            arm = getattr(tally, "_arm_deterministic", None)
            if arm is not None:
                arm()
            sess = TallySession(sid, tally, priority=Priority(priority),
                                **kw)
            self._sessions[sid] = sess
            self._sched.register(sid, priority=sess.priority)
        if self._handle_signals and (
            threading.current_thread() is threading.main_thread()
        ):
            # Newest owner wins in the dispatcher; re-assert ownership
            # in case a session's facade installed its own runner.
            # Main thread only: Python cannot (re)bind handlers
            # elsewhere, and a socket-thread open would otherwise
            # trigger the dispatcher's misleading not-main-thread
            # warning (the handler installed at construction stays in
            # force regardless).
            from pumiumtally_tpu_torch.resilience import install_drain_owner

            install_drain_owner(self)
        return SessionHandle(self, sess)

    def session_ids(self) -> tuple:
        with self._lock:
            return tuple(self._sessions)

    # -- telemetry --------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """One structured, JSON-serializable snapshot of serving
        telemetry — what the load generator and the router
        read instead of scraping logs. Schema (pinned by
        tests/test_traffic.py):

        - ``"sessions"``: ``{sid: {state, priority, pending,
          queued_cost, ops_completed, moves_completed, latency_p50_ms,
          latency_p99_ms}}`` — the latency quantiles are
          submit→resolve wall time over the session's last
          ``session.LATENCY_WINDOW`` completions (None before the
          first);
        - ``"fusion"``: a copy of ``fusion_stats``;
        - ``"admission"``: ``{budget, admitted_cost, queued_cost,
          inflight_cost, refused_ops, refused_sessions}`` — admitted =
          queued + inflight; budget None when unbounded.
        """
        with self._lock:
            sessions: Dict[str, Any] = {}
            queued = 0
            for sid, sess in self._sessions.items():
                q = sess.latency_quantiles()
                qc = sess.queued_cost()
                queued += qc
                sessions[sid] = {
                    "state": sess.state.value,
                    "priority": sess.priority.name.lower(),
                    "pending": sess.pending(),
                    "queued_cost": qc,
                    "ops_completed": sess.ops_completed,
                    "moves_completed": sess.moves_completed,
                    "latency_p50_ms": None if q is None else q[0] * 1e3,
                    "latency_p99_ms": None if q is None else q[1] * 1e3,
                }
            return {
                "sessions": sessions,
                "fusion": dict(self.fusion_stats),
                "admission": {
                    "budget": self._admission_budget,
                    "admitted_cost": self._admitted_cost,
                    "queued_cost": queued,
                    "inflight_cost": self._admitted_cost - queued,
                    "refused_ops": self.admission_stats["refused_ops"],
                    "refused_sessions":
                        self.admission_stats["refused_sessions"],
                },
            }

    # -- submission (called by SessionHandle) -----------------------------
    def _submit(self, sess: TallySession, op: staging.StagedOp) -> Future:
        with self._cv:
            if self._drain or self._stop:
                raise ServiceDrainingError(
                    "service is draining: no new work accepted"
                )
            transport = op.kind != "call"
            if (transport and self._admission_budget is not None
                    and self._admitted_cost + op.cost
                    > self._admission_budget):
                # Refused BEFORE sess.submit: nothing queued, no
                # accounting moved, caller buffers untouched
                # (accept-then-zero — SessionHandle.move only zeroes
                # flying after this returns).
                self.admission_stats["refused_ops"] += 1
                raise ServiceOverloadedError(
                    f"admission budget exhausted: {self._admitted_cost}"
                    f"/{self._admission_budget} cost units queued or in "
                    f"flight, op costs {op.cost} — retry after "
                    "outstanding futures resolve",
                    budget=self._admission_budget,
                    admitted=self._admitted_cost,
                    cost=op.cost,
                )
            sess.submit(op)  # may still refuse busy/closed: not admitted
            op.t_submit = time.perf_counter()
            if transport:
                self._admitted_cost += op.cost
            self._cv.notify_all()
        if self._autostart:
            self.start()
        return op.future

    def _close_session(self, sess: TallySession) -> Future:
        """Queue the session-close sentinel: runs after every already
        queued op, writes the drain checkpoint (if armed), closes the
        session, releases its scheduler slot. Idempotent while the
        sentinel is in flight: a repeated close returns the SAME
        future (a second sentinel could never run once the first one
        unregisters the session)."""
        def _finalize(tally):
            # finally: a failing session_close checkpoint still
            # CLOSES the session (the exception reaches the client
            # through the close future) — otherwise the facade would
            # leak in the scheduler ring forever behind a cached
            # failed future.
            try:
                return sess.drain_checkpoint(reason="session_close")
            finally:
                with self._cv:
                    sess.mark_closed()
                    self._sched.unregister(sess.id)
                    self._sessions.pop(sess.id, None)
                    self._cv.notify_all()

        op = staging.stage_call("close", _finalize)
        with self._cv:
            if sess.close_future is not None:
                return sess.close_future  # idempotent repeat close
            if sess.state is SessionState.CLOSED:
                raise SessionClosedError(
                    f"session {sess.id!r} is already closed"
                )
            if self._drain or self._stop:
                raise ServiceDrainingError(
                    "service is draining: it closes every session "
                    "itself at shutdown"
                )
            sess.begin_drain()
            sess.submit_final(op)
            op.t_submit = time.perf_counter()
            sess.close_future = op.future
            self._cv.notify_all()
        if self._autostart:
            self.start()
        return op.future

    # -- worker ----------------------------------------------------------
    def _head_cost(self, sid: str) -> Optional[int]:
        sess = self._sessions.get(sid)
        return None if sess is None else sess.head_cost()

    def _group_key(self, sid: str):
        """The fusion key of a session's queued head, or None when
        that head must run alone: only MOVE ops of facades that
        declare a fusion key (PumiTally._fusion_key) ever co-fuse —
        sources, reads, batch closes and the close sentinel keep the
        one-at-a-time path."""
        sess = self._sessions.get(sid)
        if sess is None:
            return None
        op = sess.head()
        if op is None or op.kind != "move":
            return None
        fkey = getattr(sess.tally, "_fusion_key", None)
        return None if fkey is None else fkey()

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                # ONE scheduler-lock round trip per dispatched GROUP:
                # the lead pick and every
                # co-fused head pop under a single acquisition, so a
                # K-way fused dispatch costs one lock round trip, not
                # K.
                if self._fuse and self._max_fuse > 1:
                    sids = self._sched.pick_group(
                        self._head_cost, self._group_key, self._max_fuse
                    )
                else:
                    one = self._sched.pick(self._head_cost)
                    sids = None if one is None else [one]
                if sids is None:
                    if self._stop:
                        return
                    # Every producer notifies this condition (_submit,
                    # _close_session, request_drain, shutdown), so the
                    # timeout is only a liveness safety net, not the
                    # wake mechanism — long enough that an idle server
                    # barely wakes, short enough that a missed notify
                    # could never hang a drain.
                    self._cv.wait(1.0)
                    continue
                items = []
                for sid in sids:
                    sess = self._sessions[sid]
                    items.append((sess, sess.pop()))
                self._inflight += len(items)
            # Execute OUTSIDE the lock: device work must never block
            # staging/submission on the client threads. A facade-level
            # drain exit (SystemExit, absorbed by run_op_contained /
            # run_group) folds into a service-wide drain instead of
            # killing the worker.
            coalesced = solo_ran = 0
            fell_back = False
            if len(items) == 1:
                sess, op = items[0]
                drain = staging.run_op_contained(sess.tally, op)
                solo_ran = 1
            else:
                # Deferred import: the fuse-off (and never-fusing)
                # service never imports it.
                from pumiumtally_tpu_torch.service import fusion

                drain, coalesced, solo_ran, fell_back = fusion.run_group(
                    items)
            if drain:
                self.request_drain()
            with self._cv:
                # Telemetry counts what actually DISPATCHED: a group
                # whose launch fell back to solo execution reports its
                # moves as solo (the A/B's dispatches-per-move is
                # computed from exactly these counters), and a staged
                # op that refused before any launch counts nowhere.
                self.fusion_fallbacks += int(fell_back)
                if coalesced:
                    self.fusion_stats["fused_groups"] += 1
                    self.fusion_stats["fused_moves"] += coalesced
                if solo_ran:
                    key = (
                        "solo_moves"
                        if items[0][1].kind == "move" else "solo_other"
                    )
                    self.fusion_stats[key] += solo_ran
                for sess, op in items:
                    self._inflight -= 1
                    if op.kind != "call":
                        self._admitted_cost -= op.cost
                    sess.note_completed(op)
                self._cv.notify_all()


class SessionHandle:
    """A client's view of its session: the three-call protocol plus
    reads, each returning a ``concurrent.futures.Future`` that resolves
    when the op executes (in submission order). Prepack + validation
    run synchronously on the caller's thread — errors raise HERE, and
    the caller's buffers are free for reuse the moment a method
    returns."""

    def __init__(self, service: TallyService, session: TallySession):
        self._service = service
        self._session = session

    @property
    def id(self) -> str:
        return self._session.id

    @property
    def state(self) -> SessionState:
        return self._session.state

    @property
    def pending(self) -> int:
        """Ops currently queued (staged but not yet executed)."""
        return self._session.pending()

    @property
    def tally(self):
        """The wrapped facade. Read-only inspection between resolved
        futures only — mutating protocol calls MUST go through the
        handle (the worker owns execution order)."""
        return self._session.tally

    # -- protocol --------------------------------------------------------
    def copy_initial_position(self, positions, size: Optional[int] = None
                              ) -> Future:
        op = staging.stage_source(self._session.tally, positions, size)
        return self._service._submit(self._session, op)

    def move(self, particle_origin, particle_destinations, flying=None,
             weights=None, size: Optional[int] = None, energy=None,
             time=None) -> Future:
        """Stage one ``MoveToNextLocation``. Flying-buffer semantics
        mirror the direct protocol as far as an async API can: a
        refusal HERE (validation error, ``ServiceBusyError``) leaves
        the caller's flying buffer untouched, so the retry stages the
        same bytes. But acceptance zeroes it immediately — submit is
        the last moment the buffer is still the caller's to write —
        so an op that later fails at EXECUTION (e.g. move before
        source, poisoned facade; surfaced on the future) differs from
        a direct call, which raises before zeroing: after an errored
        future, re-stage ``flying`` explicitly rather than re-sending
        the (now zeroed) buffer."""
        op = staging.stage_move(
            self._session.tally, particle_origin, particle_destinations,
            flying, weights, size, energy, time,
        )
        fut = self._service._submit(self._session, op)
        # The protocol's host side effect, applied only once the op is
        # ACCEPTED: a ServiceBusyError above leaves the caller's
        # buffers untouched, so the retry stages identical bytes (the
        # staged int8 copy inside the op is what transports).
        staging.zero_flying_side_effect(flying,
                                        self._session.tally.num_particles)
        return fut

    def close_batch(self, trigger=None) -> Future:
        return self._call("close_batch",
                          lambda t: t.close_batch(trigger=trigger))

    def finalize(self) -> Future:
        return self._call("finalize", lambda t: t.finalize())

    def write(self, filename: Optional[str] = None) -> Future:
        return self._call("write", lambda t: t.WriteTallyResults(filename))

    def checkpoint(self, **meta) -> Future:
        return self._call("checkpoint", lambda t: t.checkpoint_now(**meta))

    # -- reads (FIFO-consistent: they observe every prior submitted op) --
    def flux(self) -> Future:
        return self._call("flux", lambda t: _host(t.flux))

    def normalized_flux(self) -> Future:
        return self._call("normalized_flux",
                          lambda t: _host(t.normalized_flux()))

    def score_bank(self) -> Future:
        return self._call("score_bank", lambda t: _host(t.score_bank))

    def health_report(self) -> Future:
        return self._call("health", lambda t: t.health_report())

    def batch_statistics(self) -> Future:
        return self._call("batch_statistics",
                          lambda t: t.batch_statistics())

    def lost_particles(self) -> Future:
        return self._call("lost_particles", lambda t: t.lost_particles)

    def _call(self, label: str, fn) -> Future:
        return self._service._submit(
            self._session, staging.stage_call(label, fn)
        )

    # -- lifecycle -------------------------------------------------------
    def close(self) -> Future:
        """Drain this session: queued ops finish, one checkpoint
        generation is written (when autosave is armed), the session
        leaves the scheduler ring. The future resolves to the
        ``(generation, path)`` saved, or None."""
        return self._service._close_session(self._session)


# ---------------------------------------------------------------------------
# NDJSON socket front end
# ---------------------------------------------------------------------------

_WIRE_F64 = np.dtype("<f8")
_WIRE_I8 = np.dtype("<i1")


def _decode_array(payload: str, dtype) -> np.ndarray:
    return np.frombuffer(base64.b64decode(payload), dtype=dtype).copy()


def _encode_array(a: np.ndarray) -> str:
    # One conversion: ascontiguousarray handles dtype AND byte order
    # (the explicit .astype('<f8') it replaces copied a second time
    # even on little-endian hosts, where '<f8' IS float64).
    return base64.b64encode(
        np.ascontiguousarray(a, dtype=_WIRE_F64).tobytes()
    ).decode("ascii")


class SocketFrontend:
    """Newline-delimited-JSON TCP front end over a ``TallyService``.

    One request object per line, one response object per line. Ops:

    - ``{"op": "open", "facade": "mono"|"stream"|"part",
         "num_particles": n, "mesh": {"box": [lx,ly,lz,nx,ny,nz]}?,
         "chunk_size": c?, "batch_stats": bool?, "sentinel": bool?,
         "checkpoint_dir": path?, "priority": "high"|"normal"|"low"?}``
      → ``{"ok": true, "session": id}``.
      Omitted mesh = the server's default; ``{"path": ...}`` meshes
      need ``allow_mesh_paths=True`` (the CLI's --allow-mesh-paths).
      ``checkpoint_dir`` must be unique per open session (one
      generation store per session); an in-use dir refuses.
    - ``{"op": "source"|"move", "session": id, ...arrays...,
         "wait": bool?}`` — arrays base64 little-endian (f64
      positions/origins/dests/weights/energy/time, int8 flying).
      ``wait`` false acks after staging (pipelining); surface errors
      later via "sync". The direct protocol's host side effect —
      ``MoveToNextLocation`` zeroes the caller's flying buffer in
      place — cannot reach across the wire: the server zeroes only
      its decoded copy, so a remote client porting from the in-process
      API must zero its OWN flying buffer after any accepted move
      (``"ok": true`` without ``"busy"``; a busy refusal means the
      buffer is untouched and the retry resends the same bytes).
    - ``{"op": "sync", "session": id}`` — wait for every pending op of
      this connection's session, report the first failure.
    - ``{"op": "flux"|"normalized_flux"|"health"|"lost", "session": id}``
    - ``{"op": "close_batch"|"finalize"|"write"|"close", "session": id}``
      ("write" takes "filename"; refused unless ``allow_write``).
    - ``{"op": "ping"}`` → ``{"ok": true, "draining": bool,
         "load": {sessions, queued_cost, inflight_cost, admitted_cost,
         budget}, "fusion": {...fusion_stats}}`` — the aggregate the
      router's placement and the load generator poll.
    - ``{"op": "stats"}`` → ``{"ok": true, "stats":
         TallyService.stats()}`` (per-session p50/p99 latency).

    Failures answer ``{"ok": false, "error": <class>, "message": ...}``
    with ``"busy": true`` for per-session backpressure refusals (retry
    after a future resolves) and ``"overloaded": true`` for
    service-wide admission-budget refusals (back off or route to
    another worker) — in both cases the refused op was never admitted
    and the client's buffers are untouched.
    """

    def __init__(self, service: TallyService, host: str = "127.0.0.1",
                 port: int = 0, *, default_mesh=None,
                 default_particles: int = 100_000,
                 allow_mesh_paths: bool = False, allow_write: bool = False,
                 device: Any = None, dtype: Any = None):
        self.service = service
        # The facades this front end builds: on the card unless
        # ``device`` says otherwise ("cpu" for the plain versions), box
        # meshes in ``dtype`` (None: float32, the JAX package's default).
        self.device = device
        self.dtype = dtype
        self.default_mesh = default_mesh
        self.default_particles = int(default_particles)
        self.allow_mesh_paths = bool(allow_mesh_paths)
        self.allow_write = bool(allow_write)
        self._srv = socket.create_server((host, int(port)))
        # Timeout-based accept: closing a listening socket does not
        # reliably wake a blocked accept() on all platforms, so stop()
        # would otherwise hang until its join timeout. The loop wakes
        # every 250 ms to observe _closing.
        self._srv.settimeout(0.25)
        self.host, self.port = self._srv.getsockname()[:2]
        self._threads: List[threading.Thread] = []
        self._accept_thread: Optional[threading.Thread] = None
        self._closing = False
        # checkpoint_dir reservations, across ALL connections: two
        # sessions sharing a directory would share one GenerationStore
        # — keep-pruning then deletes the OTHER session's generations
        # and "one drain generation per session" silently collapses.
        # An open naming an in-use dir refuses with a structured error.
        self._ckpt_lock = threading.Lock()
        self._ckpt_reserved: set = set()  # realpaths in use
        self._ckpt_by_sid: Dict[str, str] = {}
        self._box_meshes: Dict[tuple, Any] = {}  # see _resolve_mesh

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self.service.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="pumiumtally-serve-accept",
            daemon=True,
        )
        self._accept_thread.start()

    def stop(self) -> None:
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _addr = self._srv.accept()
            except TimeoutError:
                continue  # periodic _closing check (see settimeout)
            except OSError:
                return  # socket closed
            conn.settimeout(None)  # connections block; only accept polls
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
            )
            t.start()
            # Prune finished connection threads so a long-lived server
            # handling many short connections stays bounded.
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    # -- checkpoint-dir reservations --------------------------------------
    def _reserve_ckpt_dir(self, ck) -> Optional[str]:
        """Reserve an open request's checkpoint_dir (realpath, so two
        spellings of one directory collide); None when the request has
        no checkpointing. Raises on a dir another open session holds."""
        if not ck:
            return None
        ckreal = os.path.realpath(str(ck))
        with self._ckpt_lock:
            if ckreal in self._ckpt_reserved:
                raise ValueError(
                    f"checkpoint_dir {str(ck)!r} is already in use by "
                    "an open session — give each session its own "
                    "directory (a shared dir shares one generation "
                    "store, whose pruning would delete the other "
                    "session's checkpoints)"
                )
            self._ckpt_reserved.add(ckreal)
        return ckreal

    def _release_ckpt_dir(self, sid: str) -> None:
        with self._ckpt_lock:
            d = self._ckpt_by_sid.pop(sid, None)
            if d is not None:
                self._ckpt_reserved.discard(d)

    # -- per-connection protocol -----------------------------------------
    def _serve_conn(self, conn: socket.socket) -> None:
        handles: Dict[str, SessionHandle] = {}
        pending: Dict[str, List[Future]] = {}
        dropped: Dict[str, int] = {}  # failures pruned past the cap
        try:
            with conn, conn.makefile("rwb") as f:
                for raw in f:
                    line = raw.strip()
                    if not line:
                        continue
                    try:
                        reply = self._dispatch(
                            json.loads(line.decode("utf-8")), handles,
                            pending, dropped,
                        )
                    except Exception as e:  # noqa: BLE001 — protocol
                        # boundary: EVERY malformed request (bad
                        # base64, wrong types, unknown sessions, busy
                        # queues) answers a structured error; only a
                        # dead peer drops the connection.
                        reply = {
                            "ok": False,
                            "error": type(e).__name__,
                            "message": str(e),
                            "busy": isinstance(e, ServiceBusyError),
                            "overloaded": isinstance(
                                e, ServiceOverloadedError
                            ),
                        }
                    f.write(json.dumps(reply, default=float)
                            .encode("utf-8") + b"\n")
                    f.flush()
        except (OSError, json.JSONDecodeError):
            pass  # peer went away / sent garbage: drop the connection
        finally:
            # Connection-scoped sessions: a client that vanishes
            # without close must not leak its facades (device arrays)
            # into the scheduler ring forever. Best-effort drain-close
            # each one (writes the usual session_close checkpoint when
            # autosave is armed).
            for h in list(handles.values()):
                try:
                    fut = h.close()
                except (ServiceDrainingError, SessionClosedError):
                    # shutdown owns them now / already closed — the
                    # drain (or the earlier close) writes the
                    # checkpoint, so the reservation can go now.
                    self._release_ckpt_dir(h.id)
                else:
                    # close() only QUEUES the sentinel that writes the
                    # drain checkpoint — releasing the dir here would
                    # let a new open reuse it while that write is
                    # still in flight (two GenerationStores sharing a
                    # dir = mutual keep-prune data loss). Release when
                    # the close op actually resolves, either way.
                    fut.add_done_callback(
                        lambda _f, sid=h.id: self._release_ckpt_dir(sid)
                    )

    def _dispatch(self, req: dict, handles: Dict[str, SessionHandle],
                  pending: Dict[str, List[Future]],
                  dropped: Dict[str, int]) -> dict:
        op = req.get("op")
        if op == "ping":
            # Schema-pinned (tests/test_traffic.py): "load" is what the
            # router's least-loaded placement and the load generator
            # read — live queue depth + in-flight particle cost, not
            # open-session count.
            st = self.service.stats()
            adm = st["admission"]
            return {
                "ok": True,
                "draining": self.service.drain_requested,
                "load": {
                    "sessions": len(st["sessions"]),
                    "queued_cost": adm["queued_cost"],
                    "inflight_cost": adm["inflight_cost"],
                    "admitted_cost": adm["admitted_cost"],
                    "budget": adm["budget"],
                },
                "fusion": st["fusion"],
            }
        if op == "stats":
            # The full per-session snapshot (p50/p99 latency included);
            # ping stays the cheap aggregate.
            return {"ok": True, "stats": self.service.stats()}
        if op == "open":
            pr = req.get("priority")
            try:
                priority = (Priority.NORMAL if pr is None
                            else Priority[str(pr).upper()])
            except KeyError:
                raise ValueError(
                    f"unknown priority {pr!r}: expected one of "
                    f"{[p.name.lower() for p in Priority]}"
                ) from None
            ckreal = self._reserve_ckpt_dir(req.get("checkpoint_dir"))
            try:
                h = self.service.open_session(
                    self._build_tally(req),
                    max_queue=req.get("max_queue"),
                    priority=priority,
                )
            except BaseException:
                if ckreal is not None:
                    with self._ckpt_lock:
                        self._ckpt_reserved.discard(ckreal)
                raise
            if ckreal is not None:
                with self._ckpt_lock:
                    self._ckpt_by_sid[h.id] = ckreal
            handles[h.id] = h
            pending[h.id] = []
            return {"ok": True, "session": h.id}
        if op not in ("source", "move", "sync", "flux",
                      "normalized_flux", "health", "lost", "close_batch",
                      "finalize", "write", "close"):
            raise ValueError(f"unknown op {op!r}")
        h = handles[req["session"]]  # KeyError → error reply
        waitlist = pending[h.id]
        if op == "source":
            fut = h.copy_initial_position(
                _decode_array(req["positions"], _WIRE_F64)
            )
            return self._ack(fut, waitlist, dropped, h.id, req)
        if op == "move":
            def arr(key, dtype=_WIRE_F64):
                return (
                    None if key not in req
                    else _decode_array(req[key], dtype)
                )
            fut = h.move(
                arr("origins"), _decode_array(req["dests"], _WIRE_F64),
                flying=arr("flying", _WIRE_I8), weights=arr("weights"),
                energy=arr("energy"), time=arr("time"),
            )
            return self._ack(fut, waitlist, dropped, h.id, req)
        if op == "sync":
            return self._sync(waitlist, dropped, h.id)
        if op == "flux":
            return {"ok": True, "dtype": "float64",
                    "flux": _encode_array(h.flux().result())}
        if op == "normalized_flux":
            return {"ok": True, "dtype": "float64",
                    "flux": _encode_array(h.normalized_flux().result())}
        if op == "health":
            return {"ok": True, "health": h.health_report().result()
                    .as_dict()}
        if op == "lost":
            return {"ok": True,
                    "lost_particles": h.lost_particles().result()}
        if op == "close_batch":
            r = h.close_batch().result()
            out = {"ok": True}
            if r is not None:
                out["trigger"] = {
                    "converged": bool(r.converged),
                    "value": float(r.value),
                    "batches_remaining": r.batches_remaining,
                }
            return out
        if op == "finalize":
            h.finalize().result()
            return {"ok": True}
        if op == "write":
            if not self.allow_write:
                raise RuntimeError(
                    "write is disabled on this server (start with "
                    "allow_write / --allow-write to enable VTK output)"
                )
            h.write(req.get("filename")).result()
            return {"ok": True}
        # op == "close" (the allowlist above is exhaustive)
        fut = h.close()
        try:
            saved = fut.result()
        finally:
            # The session is closed/unregistered even when its drain
            # checkpoint failed (_finalize's finally) — drop the wire
            # bookkeeping and the dir reservation either way, so a
            # retry gets an honest "unknown session" instead of the
            # cached failure forever, and the dir is reusable.
            handles.pop(h.id, None)
            pending.pop(h.id, None)
            dropped.pop(h.id, None)
            self._release_ckpt_dir(h.id)
        return {"ok": True, "checkpoint": saved}

    # Resolved failures retained for the next "sync", per session. The
    # bound matters: without it a pipeline-forever client whose session
    # persistently fails (e.g. a poisoned facade failing every move)
    # would grow the waitlist O(ops). Beyond the cap the OLDEST
    # resolved failures are dropped and counted; sync reports the
    # count. Unresolved futures are never dropped (their verdict isn't
    # known yet) and are bounded by the session queue depth anyway.
    _MAX_RETAINED_FAILURES = 32

    def _ack(self, fut: Future, waitlist: List[Future],
             dropped: Dict[str, int], sid: str, req: dict) -> dict:
        if req.get("wait", True):
            fut.result()  # raises → error reply path
            return {"ok": True}
        # Prune resolved SUCCESSFUL futures so a client that pipelines
        # forever without ever sending "sync" stays bounded; failures
        # are retained (up to the cap above) for the next sync.
        waitlist[:] = [
            x for x in waitlist
            if not (x.done() and x.exception() is None)
        ]
        resolved = [x for x in waitlist if x.done()]
        overflow = len(resolved) - self._MAX_RETAINED_FAILURES + 1
        if overflow > 0:
            drop = set(id(x) for x in resolved[:overflow])
            waitlist[:] = [x for x in waitlist if id(x) not in drop]
            dropped[sid] = dropped.get(sid, 0) + len(drop)
        waitlist.append(fut)
        return {"ok": True, "queued": True}

    def _sync(self, waitlist: List[Future], dropped: Dict[str, int],
              sid: str) -> dict:
        # Await EVERY future before clearing: raising out of the loop
        # at the first failure would clear (and so silently discard)
        # any later failures still on the list — the one thing _ack's
        # retention promise forbids. One reply surfaces them all,
        # including the count of failures dropped past the cap.
        failures: List[BaseException] = []
        for fut in waitlist:
            e = fut.exception()
            if e is not None:
                failures.append(e)
        waitlist.clear()
        ndropped = dropped.pop(sid, 0)
        if failures or ndropped:
            if len(failures) == 1 and not ndropped:
                raise failures[0]
            parts = [f"{type(e).__name__}: {e}" for e in failures]
            if ndropped:
                parts.append(
                    f"(+{ndropped} earlier failures dropped past the "
                    f"{self._MAX_RETAINED_FAILURES}-entry retention cap)"
                )
            raise RuntimeError(
                f"{len(failures) + ndropped} pipelined ops failed: "
                + "; ".join(parts)
            )
        return {"ok": True}

    # -- session construction --------------------------------------------
    def _build_tally(self, req: dict):
        from pumiumtally_tpu_torch import (
            CheckpointPolicy,
            PartitionedPumiTally,
            PumiTally,
            SentinelPolicy,
            StreamingTally,
            TallyConfig,
        )

        mesh = self._resolve_mesh(req.get("mesh"))
        n = int(req.get("num_particles", self.default_particles))
        kw: Dict[str, Any] = {
            # Serving default: no per-move convergence D2H sync (the
            # health op reports through the sentinel instead).
            "check_found_all": bool(req.get("check_found_all", False)),
        }
        if req.get("batch_stats"):
            kw["batch_stats"] = True
        if req.get("sentinel"):
            kw["sentinel"] = SentinelPolicy()
        if req.get("checkpoint_dir"):
            kw["checkpoint"] = CheckpointPolicy(
                dir=str(req["checkpoint_dir"]),
                every_n_batches=int(req.get("every_n_batches", 1)),
                keep=int(req.get("keep", 3)),
                handle_signals=False,  # the service owns the handler
            )
        facade = req.get("facade", "mono")
        if facade == "mono":
            return PumiTally(mesh, n, TallyConfig(**kw), device=self.device)
        if facade == "stream":
            return StreamingTally(
                mesh, n, chunk_size=int(req.get("chunk_size", 1 << 20)),
                config=TallyConfig(**kw), device=self.device,
            )
        if facade == "part":
            return PartitionedPumiTally(
                mesh, n,
                TallyConfig(capacity_factor=float(
                    req.get("capacity_factor", 4.0)
                ), **kw),
                device=self.device,
            )
        raise ValueError(
            f"unknown facade {facade!r} (mono/stream/part)"
        )

    def _resolve_mesh(self, spec):
        if spec is None:
            if self.default_mesh is None:
                raise ValueError(
                    "no mesh in the open request and the server has no "
                    "default mesh"
                )
            return self.default_mesh
        if "box" in spec:
            from pumiumtally_tpu_torch import build_box

            lx, ly, lz, nx, ny, nz = spec["box"]
            key = (float(lx), float(ly), float(lz),
                   int(nx), int(ny), int(nz))
            # One mesh OBJECT per box spec, not per open: fusion keys
            # include the facade mesh's identity, and facades built from
            # one caller mesh share one converted mesh (api/tally.py
            # ``shared_mesh``), so sessions opened with the same box
            # co-fuse and share the tables on the card. Meshes are
            # immutable; the cache only ever grows by distinct specs.
            with self._ckpt_lock:
                mesh = self._box_meshes.get(key)
            if mesh is None:
                built = (build_box(*key) if self.dtype is None
                         else build_box(*key, dtype=self.dtype))
                with self._ckpt_lock:
                    mesh = self._box_meshes.setdefault(key, built)
            return mesh
        if "path" in spec:
            if not self.allow_mesh_paths:
                raise ValueError(
                    "mesh-path loading is disabled on this server "
                    "(start with allow_mesh_paths / --allow-mesh-paths)"
                )
            return str(spec["path"])  # facades load .msh/.osh paths
        raise ValueError(f"unknown mesh spec {spec!r} (box/path)")


# ---------------------------------------------------------------------------
# Per-host service workers: the session router
# ---------------------------------------------------------------------------

class SessionRouter:
    """Thin NDJSON routing front end over several per-host service
    workers — the horizontal form of the service: each host (or
    process) runs its own ``TallyService`` + ``SocketFrontend`` against
    its local devices, and clients talk to ONE router address.

    Session-homing rule: a session's facade tensors live on the card of
    exactly one worker, so every op for a session must land on the
    worker that opened it. The router pins each session to a home
    worker at ``open`` — the least-LOADED worker by live queue depth
    plus in-flight particle cost read over the ping channel (
    open-session count and worker index break ties, and a worker whose
    ping fails or predates the load schema falls back to the router's
    own session count) — or the request's ``"home": <index>`` hint —
    and forwards every subsequent op for that id there verbatim.
    Router session ids are ``"<home>:<worker-sid>"`` (rewritten in
    both directions), so a client can read its session's home from the
    id and the reply's ``"home"`` field.

    The protocol is byte-identical to ``SocketFrontend``'s per line —
    the router adds no ops and removes none; ``ping`` is answered with
    the aggregate (``draining`` true when ANY worker drains, the
    worker count, and the summed worker loads plus per-backend
    breakdown). One worker connection per client connection, opened
    lazily: the workers' per-connection session cleanup then makes a
    vanished client drop its sessions on every worker it touched, with
    no router-side bookkeeping.

    Trust model: same as ``SocketFrontend`` — no authentication, deploy
    inside the perimeter. Workers are typically ``pumiumtally serve``
    processes launched one per host by the job scheduler; the router is
    ``pumiumtally route --backend host:port ...``.
    """

    def __init__(self, backends, host: str = "127.0.0.1", port: int = 0,
                 *, connect_timeout: float = 10.0):
        if not backends:
            raise ValueError("SessionRouter needs at least one backend")
        self.backends = [(str(h), int(p)) for h, p in backends]
        self.connect_timeout = float(connect_timeout)
        self._srv = socket.create_server((host, int(port)))
        self._srv.settimeout(0.25)  # periodic _closing check (see
        # SocketFrontend.__init__ — same accept-loop liveness reasoning)
        self.host, self.port = self._srv.getsockname()[:2]
        self._threads: List[threading.Thread] = []
        self._accept_thread: Optional[threading.Thread] = None
        self._closing = False
        self._count_lock = threading.Lock()
        self._open_sessions = [0] * len(self.backends)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="pumiumtally-route-accept",
            daemon=True,
        )
        self._accept_thread.start()

    def stop(self) -> None:
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _addr = self._srv.accept()
            except TimeoutError:
                continue
            except OSError:
                return
            conn.settimeout(None)
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
            )
            t.start()
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    # -- per-connection forwarding ---------------------------------------
    def _serve_conn(self, conn: socket.socket) -> None:
        files: Dict[int, Any] = {}  # backend idx -> rwb file
        socks: Dict[int, socket.socket] = {}
        owned: Dict[str, int] = {}  # router sid -> home backend idx
        try:
            with conn, conn.makefile("rwb") as f:
                for raw in f:
                    line = raw.strip()
                    if not line:
                        continue
                    try:
                        reply = self._route(
                            json.loads(line.decode("utf-8")), files,
                            socks, owned,
                        )
                    except Exception as e:  # noqa: BLE001 — protocol
                        # boundary, like SocketFrontend._serve_conn:
                        # every failure (bad session ids, dead workers,
                        # forwarded errors re-raised) answers
                        # structured; only a dead CLIENT drops the
                        # connection.
                        reply = {
                            "ok": False,
                            "error": type(e).__name__,
                            "message": str(e),
                            "busy": isinstance(e, ServiceBusyError),
                            "overloaded": isinstance(
                                e, ServiceOverloadedError
                            ),
                        }
                    f.write(json.dumps(reply, default=float)
                            .encode("utf-8") + b"\n")
                    f.flush()
        except (OSError, json.JSONDecodeError):
            pass  # peer went away / sent garbage
        finally:
            # Closing the worker connections is the whole cleanup: each
            # worker's own per-connection finally drain-closes the
            # sessions this client opened through it.
            with self._count_lock:
                for sid, b in owned.items():
                    self._open_sessions[b] -= 1
            for s in socks.values():
                try:
                    s.close()
                except OSError:
                    pass

    def _backend_file(self, idx: int, files: Dict[int, Any],
                      socks: Dict[int, socket.socket]):
        if idx not in files:
            s = socket.create_connection(
                self.backends[idx], timeout=self.connect_timeout
            )
            s.settimeout(None)  # ops block until the worker replies
            socks[idx] = s
            files[idx] = s.makefile("rwb")
        return files[idx]

    def _forward(self, idx: int, req: dict, files, socks) -> dict:
        f = self._backend_file(idx, files, socks)
        f.write(json.dumps(req, default=float).encode("utf-8") + b"\n")
        f.flush()
        line = f.readline()
        if not line:
            raise RuntimeError(
                f"worker {idx} ({self.backends[idx][0]}:"
                f"{self.backends[idx][1]}) closed the connection"
            )
        return json.loads(line.decode("utf-8"))

    def _least_loaded(self, files, socks) -> int:
        """Open-time placement by LIVE load: score each
        worker ``(queued + in-flight transport cost, open sessions,
        index)`` read over the ping channel, pick the minimum — a
        backlogged worker stops winning opens even when its session
        COUNT is lowest (sessions are cheap; queued particles are
        not). A worker whose ping fails, or an older worker whose ping
        reply has no ``"load"`` yet, falls back to the router's own
        open-session count at zero cost, so a mixed or half-down fleet
        still places (the open itself will surface a dead worker)."""
        best = None
        for i in range(len(self.backends)):
            try:
                ld = self._forward(
                    i, {"op": "ping"}, files, socks
                ).get("load") or {}
            except (OSError, RuntimeError, ValueError):
                ld = {}
            with self._count_lock:
                fallback_sessions = self._open_sessions[i]
            score = (
                int(ld.get("queued_cost", 0))
                + int(ld.get("inflight_cost", 0)),
                int(ld.get("sessions", fallback_sessions)),
                i,
            )
            if best is None or score < best:
                best = score
        return best[2]

    def _home_of(self, sid: str) -> tuple:
        b, sep, rest = str(sid).partition(":")
        if not sep or not b.isdigit() or int(b) >= len(self.backends):
            raise ValueError(
                f"unknown session {sid!r} (router ids look like "
                f"'<home>:<worker-sid>' with home < "
                f"{len(self.backends)})"
            )
        return int(b), rest

    def _route(self, req: dict, files, socks, owned: Dict[str, int]
               ) -> dict:
        op = req.get("op")
        if op == "ping":
            # Aggregate health: draining when ANY worker drains (a
            # drain anywhere means new opens may land on a draining
            # host — clients should stop submitting). Worker loads are
            # summed and returned per backend too, so a load generator
            # pointed at the router reads fleet-wide telemetry from
            # one socket.
            draining = False
            per_backend = []
            load = {"sessions": 0, "queued_cost": 0, "inflight_cost": 0}
            for i in range(len(self.backends)):
                r = self._forward(i, {"op": "ping"}, files, socks)
                draining = draining or bool(r.get("draining"))
                ld = r.get("load") or {}
                per_backend.append(ld)
                for k in load:
                    load[k] += int(ld.get(k, 0))
            return {"ok": True, "draining": draining,
                    "backends": len(self.backends),
                    "load": load, "per_backend": per_backend}
        if op == "open":
            home = req.pop("home", None)
            if home is None:
                home = self._least_loaded(files, socks)
            home = int(home)
            if not 0 <= home < len(self.backends):
                raise ValueError(
                    f"home {home} out of range (have "
                    f"{len(self.backends)} workers)"
                )
            reply = self._forward(home, req, files, socks)
            if reply.get("ok") and "session" in reply:
                sid = f"{home}:{reply['session']}"
                owned[sid] = home
                with self._count_lock:
                    self._open_sessions[home] += 1
                reply = dict(reply, session=sid, home=home)
            return reply
        # Every other op carries a session id: forward to its home.
        home, worker_sid = self._home_of(req.get("session"))
        reply = self._forward(
            home, dict(req, session=worker_sid), files, socks,
        )
        if op == "close" and reply.get("ok"):
            sid = f"{home}:{worker_sid}"
            if owned.pop(sid, None) is not None:
                with self._count_lock:
                    self._open_sessions[home] -= 1
        return reply
