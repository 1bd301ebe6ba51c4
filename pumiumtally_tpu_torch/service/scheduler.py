"""Deficit-round-robin scheduling over ready sessions, in priority lanes
(port of ``pumiumtally_tpu/service/scheduler.py``, the same pure Python).

The service owns ONE device and many sessions; something must decide
whose staged op runs next. Plain round-robin is fair in op COUNT but
not in work: a session moving 500k particles per op would get 500k
particle-moves for every 4k a small session gets per turn. Deficit
round robin (Shreedhar & Varghese) fixes that with one counter per
session:

- sessions sit on a ring, visited in registration order;
- each visit credits the session's deficit counter with a QUANTUM of
  cost units; its head op runs iff its cost fits the accumulated
  deficit (cost = particles touched for transport ops, 1 for reads —
  staging.StagedOp.cost);
- a served op's cost is debited; the visit continues on the same
  session while further heads fit, then moves on;
- a session whose queue empties forfeits its banked CREDIT (the
  classic DRR reset — idle time banks no credit, so a bursty client
  cannot starve the ring with saved-up quantum). Owed DEBT — a
  negative deficit from ``pick_group``'s co-fused pre-payment — is
  kept: a session that rides fused launches and then empties still
  pays before its next lead service.

Priority lanes: every session registers into one of the
``Priority`` lanes (HIGH/NORMAL/LOW — paying traffic over batch
campaigns, per ROADMAP item 1). The pick is STRICT priority between
lanes — the highest lane with queued work serves, lower lanes wait —
and deficit round robin within a lane, each lane keeping its own ring
cursor and visit state over the one shared deficit ledger. A skipped
idle lane forfeits banked credit exactly like an empty ring visit
(debt stays). Single-lane services (everything registered NORMAL, the
default) behave bit-identically to the flat scheduler.

Starvation is bounded by construction, not by lane weights: a LOW
session whose head is fusion-compatible with a HIGH lead still rides
the shared launch through ``pick_group`` (co-fusion scans lanes in
priority order but never excludes one), pre-paying its own cost — so
under a saturated high lane, compatible low-lane work advances at the
fused cadence while incompatible low-lane work waits for the high
lane to drain (tests/test_traffic.py pins both halves).

Fairness contract (docs/DESIGN.md "Multi-session service"): over any
window in which a set of SAME-LANE sessions stays backlogged and
their lane serves, the cost served to any two of them differs by at
most one quantum plus one maximal op cost — O(1) unfairness,
independent of queue depths, so one hot client cannot starve its
lane. With the default AUTO quantum (the largest head cost currently
queued in the serving lane) every visited backlogged session serves
at least one op per ring pass, which also makes ``pick``
work-conserving in a single pass.

The scheduler is a plain synchronous data structure — the service
calls it under its own lock; nothing here blocks, allocates device
memory, or touches the device.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, List, Optional


class Priority(enum.IntEnum):
    """Strict-priority service lanes (lower value = more urgent). The
    lane is fixed at ``open_session``; DRR fairness applies within a
    lane, lanes preempt at op granularity (an in-flight op always
    finishes — preemption-safe by construction)."""

    HIGH = 0
    NORMAL = 1
    LOW = 2


class _Lane:
    """One priority lane's ring state (deficits live in the scheduler's
    shared ledger — a session's debt follows it across fused rides
    regardless of which lane led the launch)."""

    __slots__ = ("keys", "cursor", "visiting")

    def __init__(self) -> None:
        self.keys: List[str] = []
        self.cursor = 0
        self.visiting: Optional[str] = None


class DeficitRoundRobinScheduler:
    """Strict-priority + DRR picker over registered session keys.

    Args:
      quantum: cost units credited per visit. None (default) = auto:
        the largest head cost among the serving lane's currently
        backlogged sessions, re-derived each pick — guarantees
        one-pass work conservation while keeping service
        work-proportional when op costs differ.
    """

    def __init__(self, quantum: Optional[int] = None):
        if quantum is not None and int(quantum) < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum!r}")
        self._quantum = None if quantum is None else int(quantum)
        self._lanes = {p: _Lane() for p in Priority}
        self._lane_of: dict = {}
        self._order: List[str] = []  # overall registration order
        self._deficit: dict = {}

    # -- membership ------------------------------------------------------
    def register(self, key: str,
                 priority: Priority = Priority.NORMAL) -> None:
        if key in self._deficit:
            raise ValueError(f"session {key!r} already registered")
        pr = Priority(priority)
        self._lanes[pr].keys.append(key)
        self._lane_of[key] = pr
        self._order.append(key)
        self._deficit[key] = 0

    def unregister(self, key: str) -> None:
        pr = self._lane_of.get(key)
        if pr is None:
            raise ValueError(f"session {key!r} is not registered")
        lane = self._lanes[pr]
        idx = lane.keys.index(key)
        lane.keys.pop(idx)
        del self._lane_of[key]
        self._order.remove(key)
        del self._deficit[key]
        if lane.visiting == key:
            lane.visiting = None
        if idx < lane.cursor:
            lane.cursor -= 1
        if lane.keys:
            lane.cursor %= len(lane.keys)
        else:
            lane.cursor = 0

    @property
    def keys(self) -> tuple:
        return tuple(self._order)

    def deficit(self, key: str) -> int:
        return self._deficit[key]

    def priority(self, key: str) -> Priority:
        return self._lane_of[key]

    # -- picking ---------------------------------------------------------
    def pick(
        self, head_cost: Callable[[str], Optional[int]]
    ) -> Optional[str]:
        """The key whose head op should run next, charging its cost.

        ``head_cost(key)`` returns the session's head-op cost, or None
        when it has nothing queued. Returns None iff no session has
        work. The caller must then actually pop and run that head op —
        pick() has already debited it.
        """
        if not self._order:
            return None
        costs = {k: head_cost(k) for k in self._order}
        serving = None
        for pr in Priority:
            lane = self._lanes[pr]
            if any(costs[k] is not None for k in lane.keys):
                serving = lane
                break
        if serving is None:
            for lane in self._lanes.values():
                lane.visiting = None
            return None
        # Lanes ABOVE the serving one are idle by construction of the
        # scan: forfeit their banked credit (idle banks no credit —
        # the empty-ring-visit rule), keep co-fusion debt.
        for pr in Priority:
            lane = self._lanes[pr]
            if lane is serving:
                break
            for k in lane.keys:
                self._deficit[k] = min(0, self._deficit[k])
            lane.visiting = None
        return self._pick_in_lane(serving, costs)

    def _pick_in_lane(self, lane: _Lane, costs: dict) -> Optional[str]:
        """Classic DRR over one lane's ring (the flat pre-lane
        algorithm verbatim, scoped to the lane's keys/cursor/visit)."""
        n = len(lane.keys)
        backlogged = [
            costs[k] for k in lane.keys if costs[k] is not None
        ]
        quantum = self._quantum
        if quantum is None:
            quantum = max(1, max(backlogged))
        # Continue the in-progress visit first: classic DRR serves one
        # queue until its deficit is spent, THEN moves the ring.
        if lane.visiting is not None:
            k = lane.visiting
            c = costs.get(k)
            if c is not None and c <= self._deficit[k]:
                self._deficit[k] -= c
                return k
            if c is None and k in self._deficit:
                # Emptied: forfeit banked CREDIT only. A negative
                # deficit is debt from pick_group's co-fused
                # pre-payment — zeroing it would let a session that
                # empties between submissions ride fused launches
                # without ever being charged.
                self._deficit[k] = min(0, self._deficit[k])
            lane.visiting = None
        # Ring scan. With auto quantum the first backlogged session
        # serves immediately; with a small manual quantum the deficit
        # accumulates across passes until a head fits. An unserved
        # full pass jumps the deficit clock ARITHMETICALLY (every
        # backlogged session is about to receive the same m quanta
        # anyway, in ring order — crediting m-1 of them in bulk
        # changes nothing but skips O(cost/quantum) spin passes under
        # the service lock).
        while True:
            served_none = True
            for _ in range(n):
                k = lane.keys[lane.cursor]
                lane.cursor = (lane.cursor + 1) % n
                c = costs[k]
                if c is None:
                    # Credit forfeits on empty; co-fusion debt stays
                    # (see the visit-continuation branch above).
                    self._deficit[k] = min(0, self._deficit[k])
                    continue
                self._deficit[k] += quantum
                if c <= self._deficit[k]:
                    self._deficit[k] -= c
                    lane.visiting = k
                    return k
                served_none = False  # backlogged, not yet affordable
            if served_none:
                # Only emptied queues were seen this pass (cannot
                # happen: backlogged was non-empty and costs are
                # fixed for this pick) — guard against livelock.
                return None
            passes_needed = min(
                -(-(costs[k] - self._deficit[k]) // quantum)
                for k in lane.keys if costs[k] is not None
            )
            if passes_needed > 1:
                for k in lane.keys:
                    if costs[k] is not None:
                        self._deficit[k] += (passes_needed - 1) * quantum

    def pick_group(
        self,
        head_cost: Callable[[str], Optional[int]],
        group_key: Callable[[str], Optional[Any]],
        max_group: int,
    ) -> Optional[List[str]]:
        """The fusion window: one DRR pick, then up to
        ``max_group - 1`` more sessions whose queued heads are
        COMPATIBLE with it — ``group_key(sid)`` returns the head's
        fusion key, or None for a head that must run alone (non-move
        ops, non-fusable facades, empty queues).

        Fairness accounting is unchanged in its bounds: the lead pick
        goes through ``pick`` (quantum credits, deficit debit, visit
        continuation), and every co-fused session is charged ITS OWN
        head cost against its deficit — early service is pre-paid
        service, so over any backlogged window the cost served per
        session still tracks the deficit clock within one quantum plus
        one maximal op cost. Co-fused members are scanned lane-major
        (priority order, ring/registration order within a lane), so
        group composition is deterministic given the queue states —
        and a LOWER-lane session with a compatible head deliberately
        rides a higher lead's launch (pre-paying): that ride-along is
        the low lane's starvation bound under a saturated high lane.
        Returns None iff no session has work; the caller must pop and
        run every returned head (their costs are already debited)."""
        lead = self.pick(head_cost)
        if lead is None:
            return None
        group = [lead]
        if int(max_group) <= 1:
            return group
        key = group_key(lead)
        if key is None:
            return group
        for pr in Priority:
            for k in self._lanes[pr].keys:
                if len(group) >= int(max_group):
                    return group
                if k == lead:
                    continue
                c = head_cost(k)
                if c is None or group_key(k) != key:
                    continue
                self._deficit[k] -= int(c)
                group.append(k)
        return group
