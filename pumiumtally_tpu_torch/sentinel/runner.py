"""Per-tally sentinel engine: audit bookkeeping and anomaly dispatch
(port of ``pumiumtally_tpu/sentinel/runner.py``).

One ``SentinelRunner`` per armed tally. It carries the device scalars
(the running flux sum the conservation delta is taken against, and the
worst residual) and the cumulative ``HealthReport``. A move:

    n_unf, mask = runner.audit(x0, x1, fly, w, done, flux)
    ... the facade runs the straggler ladder when n_unf ...
    runner.note_outcome(mask, n_unf, recovered, lost, move)

``audit`` makes the move's one scalar fetch (the packed word); the
worst residual stays on the device until ``health_report``.
``note_outcome`` applies the policy AFTER the ladder, so a move whose
stragglers were all recovered does not warn (it still counts in
``unfinished_total``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from pumiumtally_tpu_torch.sentinel.audit import WIDE, audit_pack, split_packed
from pumiumtally_tpu_torch.sentinel.policy import (
    ANOMALY_UNFINISHED,
    HealthReport,
    SentinelAnomalyError,
    SentinelPolicy,
    describe_mask,
)


class SentinelRunner:
    def __init__(self, policy: SentinelPolicy, dtype: torch.dtype,
                 device: Any):
        self.policy = policy
        self.report = HealthReport()
        self._rtol = policy.resolved_rtol(dtype)
        self._flux_sum_prev = torch.zeros((), dtype=WIDE, device=device)
        self._max_resid_dev = torch.zeros((), dtype=WIDE, device=device)

    def resync(self, flux) -> None:
        """Re-baseline the conservation delta (after the ladder tallied,
        or anything else that wrote flux outside a move)."""
        self._flux_sum_prev = flux.to(WIDE).sum()

    def audit(self, x0, x1, fly, w, done, flux) -> Tuple[int, int]:
        """The audit over a move's caller-order view: the host
        ``(n_unfinished, anomaly_mask)`` (the move's one scalar
        fetch)."""
        packed, self._flux_sum_prev, self._max_resid_dev, _ = audit_pack(
            x0, x1, fly, w, done, flux, self._flux_sum_prev,
            self._max_resid_dev, self._rtol)
        return split_packed(int(packed))

    def note_outcome(self, mask: int, n_unf: int, recovered: int,
                     lost: int, move: int) -> None:
        """Fold one audited move into the report and apply
        ``on_anomaly``. ``recovered`` / ``lost``: the ladder's split of
        ``n_unf`` (0 / 0 when it did not run)."""
        self.report.moves_audited += 1
        self.report.unfinished_total += int(n_unf)
        self.report.stragglers_recovered += int(recovered)
        self.report.stragglers_lost += int(lost)
        effective = mask
        if (mask & ANOMALY_UNFINISHED) and n_unf and lost == 0 and (
            recovered == n_unf
        ):
            # Every straggler recovered: the committed state is whole.
            effective = mask & ~ANOMALY_UNFINISHED
        if effective == 0:
            return
        self.report.anomaly_moves += 1
        self.report.anomaly_mask_union |= effective
        msg = (
            f"[SENTINEL] move {move}: anomaly "
            f"{describe_mask(effective)} (mask {effective}); "
            f"{n_unf} unfinished, {recovered} recovered, {lost} lost"
        )
        if self.policy.on_anomaly == "raise":
            raise SentinelAnomalyError(msg)
        if self.policy.on_anomaly == "warn":
            print(msg)

    def note_localization(self, recovered: int, lost: int) -> None:
        """Localization stragglers (the non-tallying ladder): straggler
        counts only, no audit."""
        self.report.unfinished_total += int(recovered) + int(lost)
        self.report.stragglers_recovered += int(recovered)
        self.report.stragglers_lost += int(lost)

    def note_overflow_recovery(self, escalated: bool) -> None:
        """A partitioned capacity overflow the recovery ladder absorbed
        (``escalated``: it needed a capacity rebuild)."""
        self.report.overflow_recoveries += 1
        if escalated:
            self.report.capacity_escalations += 1

    def health_report(self) -> HealthReport:
        """The cumulative report, with the worst residual fetched."""
        return dataclasses.replace(
            self.report,
            max_conservation_residual=float(self._max_resid_dev),
        )


def build_runner(policy: Optional[SentinelPolicy], dtype: torch.dtype,
                 device: Any) -> Optional[SentinelRunner]:
    """A runner when a policy is armed, else None (sentinel-off
    constructs nothing)."""
    return None if policy is None else SentinelRunner(policy, dtype, device)
