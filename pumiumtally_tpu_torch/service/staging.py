"""Double-buffered host staging for the multi-session service (port of
``pumiumtally_tpu/service/staging.py``).

The three-call protocol is synchronous by construction: the caller's
buffers are validated, cast, and uploaded inside the protocol call, so
a host app serializes its own staging against the device walk. The
service breaks that coupling with a PREPACK step that runs on the
CLIENT's thread at submit time:

- every caller buffer is validated and copied into an OWNED flat f64
  host array (``StagedOp``) — the caller may recycle its buffers the
  moment ``submit`` returns, long before the device has even seen the
  move;
- validation happens HERE, before the op enters any queue: a
  malformed move (wrong shape, NaN destination, f32-overflow energy)
  raises at submit with the same argument-naming errors the facades
  produce, and never occupies a queue slot — backpressure and refusal
  both leave the session's committed state untouched;
- the narrow (working-dtype) arms reuse the staging facade's own
  machinery: streaming facades expose ``_prevalidate_narrow``
  (api/streaming.py — chunk-at-a-time casts, discarded after the
  check) and the other facades get the equivalent whole-batch cast
  check, so an f64 value that overflows f32 to inf refuses at submit
  too.

The "double buffer" is the bounded per-session queue this feeds
(session.DEFAULT_QUEUE_DEPTH = 2): one move's owned arrays sit staged
while the previous move walks, and the worker consumes the facade
call — whose own host→device staging then runs against pre-validated,
already-cast-free f64 bytes — as soon as the device frees up. With an
unfenced facade (``fenced_timing=False``) the facade call returns at
dispatch, so move k+1's prepack and protocol staging genuinely overlap
move k's device compute.

Bitwise contract: the facade receives byte-identical f64 inputs to
what a direct caller would pass (prepack only flattens, validates, and
copies — it never converts to the working dtype, so the facade's own
cast runs exactly once, exactly as in a direct call). A campaign
driven through ``StagedOp``s is therefore bitwise-identical to the
same campaign driven directly, pinned by tests/test_service.py.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import Future
from typing import Any, Callable, Optional

import numpy as np

from pumiumtally_tpu_torch.api.tally import (
    _np_dtype,
    check_finite,
    host_positions,
    host_scalar_field,
    zero_flying_side_effect,
)


class OpFuture(Future):
    """A staged op's result future: cancellation is refused (returns
    False, as the ``Future`` contract allows). A queued op always
    RUNS — the protocol has no un-submit, so a session's campaign is
    exactly its submission sequence regardless of client impatience —
    and a cancel that could land (futures start PENDING in the queue)
    would make the worker's ``set_result`` raise ``InvalidStateError``
    outside its op guard, killing the one thread that drains every
    session. Clients that stop caring simply drop the reference."""

    def cancel(self) -> bool:  # noqa: D102 — contract in class doc
        return False


@dataclasses.dataclass
class StagedOp:
    """One queued unit of session work: a prepacked protocol call plus
    the future its submitter holds. ``cost`` is the deficit-round-robin
    charge (particles touched for transport ops, 1 for reads — see
    scheduler.DeficitRoundRobinScheduler)."""

    kind: str  # "source" | "move" | "call"
    label: str
    future: Future
    cost: int = 1
    positions: Optional[np.ndarray] = None  # source payload, flat [3n] f64
    origins: Optional[np.ndarray] = None  # move payload, all owned
    dests: Optional[np.ndarray] = None
    flying: Optional[np.ndarray] = None
    weights: Optional[np.ndarray] = None
    energy: Optional[np.ndarray] = None
    time: Optional[np.ndarray] = None
    fn: Optional[Callable[[Any], Any]] = None  # "call" payload
    # Stamped by TallyService._submit at admission; session
    # note_completed turns it into a p50/p99 latency sample.
    t_submit: Optional[float] = None


def _owned_f64(a: np.ndarray) -> np.ndarray:
    """An owned f64 copy — host_positions/host_scalar_field may return
    a VIEW of the caller's buffer, and a staged op outlives the call
    that submitted it (the whole point), so it must not alias memory
    the caller is about to recycle."""
    return np.array(a, dtype=np.float64, copy=True)


def _prevalidate_narrow_generic(tally, dests_h, origins_h, w_h, e_h,
                                t_h) -> None:
    """Working-dtype finite check for facades without a chunked
    prevalidator: cast-and-check (cast discarded), so the
    f32-overflow corner refuses at submit exactly like the streaming
    facades' ``_prevalidate_narrow`` arm."""
    dt = _np_dtype(tally.dtype)
    if dt == np.float64:
        return  # cast is identity; the raw f64 check already ran
    check_finite(np.asarray(dests_h, dtype=dt), "destinations")
    if origins_h is not None:
        check_finite(np.asarray(origins_h, dtype=dt), "origins")
    if w_h is not None:
        check_finite(np.asarray(w_h, dtype=dt), "weights")
    if e_h is not None:
        check_finite(np.asarray(e_h, dtype=dt), "energy")
    if t_h is not None:
        check_finite(np.asarray(t_h, dtype=dt), "time")


def stage_source(tally, positions, size: Optional[int] = None) -> StagedOp:
    """Prepack one ``CopyInitialPosition``: flat owned f64 [3n], raw
    finite check (the localization walk has no narrow corner a clamped
    walk would miss — the facade re-checks after its own cast)."""
    n = tally.num_particles
    pos = _owned_f64(host_positions(positions, size, n))
    if tally.config.validate_inputs:
        check_finite(pos, "positions")
    return StagedOp(kind="source", label="source", future=OpFuture(),
                    cost=max(1, n), positions=pos)


def stage_move(tally, particle_origin, particle_destinations, flying=None,
               weights=None, size: Optional[int] = None, energy=None,
               time=None) -> StagedOp:
    """Prepack one ``MoveToNextLocation``.

    Validation order mirrors the facades: scoring-attribute
    combination errors first (naming the argument), then raw f64
    finite checks, then the working-dtype arms. The protocol's
    flying-zeroing side effect deliberately does NOT happen here —
    prepack may yet be refused at the queue, and a refusal must leave
    the caller's buffers untouched so the retry stages the same
    bytes; the submit path zeroes only after the op is ACCEPTED
    (server.SessionHandle.move — the load-bearing, test-pinned
    ordering).
    """
    n = tally.num_particles
    tally._score_args_check(energy, time)
    dests_h = _owned_f64(host_positions(particle_destinations, size, n))
    origins_h = (
        None if particle_origin is None
        else _owned_f64(host_positions(particle_origin, size, n))
    )
    w_h = (
        None if weights is None
        else _owned_f64(host_scalar_field(weights, n, "weights"))
    )
    e_h = (
        None if energy is None
        else _owned_f64(host_scalar_field(energy, n, "energy"))
    )
    t_h = (
        None if time is None
        else _owned_f64(host_scalar_field(time, n, "time"))
    )
    fly_h = None
    if flying is not None:
        fly_np = np.asarray(flying)
        if fly_np.size < n:
            raise ValueError(
                f"flying buffer has {fly_np.size} values, need {n}"
            )
        fly_h = fly_np.reshape(-1)[:n].astype(np.int8)  # astype copies
    if tally.config.validate_inputs:
        check_finite(dests_h, "destinations")
        if origins_h is not None:
            check_finite(origins_h, "origins")
        if w_h is not None:
            check_finite(w_h, "weights")
        if e_h is not None:
            check_finite(e_h, "energy")
        if t_h is not None:
            check_finite(t_h, "time")
        narrow = getattr(tally, "_prevalidate_narrow", None)
        if narrow is not None:
            # The streaming facades' chunk-at-a-time working-dtype
            # arms (no full-batch cast copies).
            narrow(dests_h, origins_h, w_h, e_h, t_h)
        else:
            _prevalidate_narrow_generic(tally, dests_h, origins_h, w_h,
                                        e_h, t_h)
    # The protocol's flying-zeroing side effect does NOT happen here:
    # prepack may yet be REFUSED at the queue (ServiceBusyError), and a
    # refusal must leave the caller's buffers untouched so the retry
    # stages the same bytes — the submit path applies it only after
    # the op is accepted (server.SessionHandle.move).
    return StagedOp(kind="move", label="move", future=OpFuture(),
                    cost=max(1, n), origins=origins_h, dests=dests_h,
                    flying=fly_h, weights=w_h, energy=e_h, time=t_h)


def stage_call(label: str, fn: Callable[[Any], Any],
               cost: int = 1) -> StagedOp:
    """Prepack an arbitrary facade call (flux/health reads, batch
    close, VTK write, checkpoint). Riding the SAME per-session FIFO as
    the moves is what makes reads consistent: a flux read submitted
    after move k observes exactly moves 1..k, regardless of how the
    scheduler interleaves other sessions."""
    return StagedOp(kind="call", label=label, future=OpFuture(), cost=cost,
                    fn=fn)


def execute_op(tally, op: StagedOp):
    """Run one staged op against the session's facade (worker thread).
    Returns the facade call's result (futures carry it to the
    client)."""
    if op.kind == "source":
        return tally.CopyInitialPosition(op.positions)
    if op.kind == "move":
        kw = {}
        if op.energy is not None:
            kw["energy"] = op.energy
        if op.time is not None:
            kw["time"] = op.time
        return tally.MoveToNextLocation(
            op.origins, op.dests, op.flying, op.weights, **kw
        )
    return op.fn(tally)


def run_op_contained(tally, op: StagedOp) -> bool:
    """``execute_op`` with the server's containment contract, in ONE
    place (the worker's solo path and the fusion fallback both route
    here — a policy change cannot silently diverge them): the result
    or exception lands on exactly this op's future, and the return
    says whether a facade-level drain exit (SystemExit — e.g.
    checkpoint_now with a pending runner drain) was absorbed, so the
    caller folds it into a service-wide drain instead of letting it
    kill the one worker thread that serves every session."""
    try:
        result = execute_op(tally, op)
    except SystemExit as e:
        op.future.set_exception(e)
        return True
    except BaseException as e:  # noqa: BLE001 — server boundary: one
        # client's failing op must not take the worker (and every
        # other session) down.
        op.future.set_exception(e)
        return False
    op.future.set_result(result)
    return False
