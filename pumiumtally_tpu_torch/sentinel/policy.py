"""Sentinel policy, health report and errors (port of
``pumiumtally_tpu/sentinel/policy.py``).

``SentinelPolicy`` on ``TallyConfig.sentinel`` arms the runtime health
subsystem on a tally: per-move audit lanes on the device packed into one
scalar fetch (sentinel/audit.py), a bounded straggler-escalation ladder
in place of silent truncation (sentinel/straggler.py) and quarantine
accounting for particles nothing could recover (sentinel/quarantine.py).
Sentinel-off (the default) constructs nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Anomaly bitmask: the low _ANOMALY_BITS bits of the packed audit
# scalar; the bits above carry the unfinished-particle count
# (audit.split_packed).
ANOMALY_UNFINISHED = 1  # particles not done when the walk loop exited
ANOMALY_CONSERVATION = 2  # tallied-vs-straight-line residual over rtol
ANOMALY_NONFINITE = 4  # non-finite flux delta (poisoned accumulator)
_ANOMALY_BITS = 3

ANOMALY_NAMES = {
    ANOMALY_UNFINISHED: "unfinished",
    ANOMALY_CONSERVATION: "conservation",
    ANOMALY_NONFINITE: "nonfinite_flux",
}


def describe_mask(mask: int) -> str:
    """Human-readable anomaly mask, for warnings and reports."""
    names = [n for bit, n in ANOMALY_NAMES.items() if mask & bit]
    return "+".join(names) if names else "none"


@dataclasses.dataclass(frozen=True)
class SentinelPolicy:
    """Runtime health knobs (``TallyConfig.sentinel``), as in the JAX
    package.

    Attributes:
      audit: the per-move audit lanes (unfinished-particle count,
        tallied-length vs straight-line-length conservation residual, a
        non-finite-flux probe), packed into one scalar fetched per move.
      conservation_rtol: the residual above which the conservation bit
        fires; None: 1e-9 in float64, 1e-3 otherwise.
      straggler_retry: arm the escalation ladder: particles unfinished
        when the walk exits are re-walked at ``retry_iters_factor`` x the
        budget, two-tier engines retry once more on the full-precision
        planes, and only then is a particle declared lost.
      retry_iters_factor: the retry rungs' budget multiplier (the
        partitioned retry multiplies the round budget too).
      quarantine_dir: directory of ``quarantine.jsonl``, one record per
        unrecoverable particle; None keeps the count in the report only.
      on_anomaly: "warn" prints a line per anomalous move, "raise"
        raises ``SentinelAnomalyError`` (the move is committed), "record"
        only counts.
    """

    audit: bool = True
    conservation_rtol: Optional[float] = None
    straggler_retry: bool = True
    retry_iters_factor: int = 2
    quarantine_dir: Optional[str] = None
    on_anomaly: str = "warn"

    def __post_init__(self) -> None:
        if self.on_anomaly not in ("warn", "raise", "record"):
            raise ValueError(
                "on_anomaly must be 'warn', 'raise' or 'record', "
                f"got {self.on_anomaly!r}"
            )
        if int(self.retry_iters_factor) < 1:
            raise ValueError(
                f"retry_iters_factor must be >= 1, "
                f"got {self.retry_iters_factor!r}"
            )
        if self.conservation_rtol is not None and (
            float(self.conservation_rtol) <= 0
        ):
            raise ValueError(
                f"conservation_rtol must be > 0 or None, "
                f"got {self.conservation_rtol!r}"
            )

    def resolved_rtol(self, dtype: torch.dtype) -> float:
        if self.conservation_rtol is not None:
            return float(self.conservation_rtol)
        return 1e-9 if dtype == torch.float64 else 1e-3


class SentinelAnomalyError(RuntimeError):
    """An audited move tripped the anomaly mask under
    ``on_anomaly="raise"``. The move's state is committed (the audit
    runs after the walk)."""


class EnginePoisonedError(RuntimeError):
    """The engine state is known-corrupt (a partitioned capacity
    overflow exhausted the recovery ladder); every further protocol
    call refuses."""


POISONED_MESSAGE = (
    "engine state corrupt — a capacity overflow exhausted the recovery "
    "ladder; resume from checkpoint (resilience.resume_latest) or "
    "rebuild the tally with a larger TallyConfig.capacity_factor"
)


@dataclasses.dataclass
class HealthReport:
    """Cumulative campaign health (``tally.health_report()``), also
    written as VTK FIELD data (io/vtk.py ``health_field_data``).

    ``moves_audited`` / ``anomaly_moves``: audited moves and those with
    a non-zero anomaly mask; ``anomaly_mask_union`` ORs every mask.
    ``unfinished_total``: particle-moves that hit the step budget before
    the ladder ran; ``stragglers_recovered`` / ``stragglers_lost`` split
    them by outcome. ``max_conservation_residual``: the worst relative
    residual. ``overflow_recoveries`` / ``capacity_escalations``: the
    partitioned overflow events the recovery ladder absorbed and the
    capacity rebuilds among them.
    """

    moves_audited: int = 0
    anomaly_moves: int = 0
    anomaly_mask_union: int = 0
    max_conservation_residual: float = 0.0
    unfinished_total: int = 0
    stragglers_recovered: int = 0
    stragglers_lost: int = 0
    overflow_recoveries: int = 0
    capacity_escalations: int = 0

    def as_dict(self) -> dict:
        """Plain JSON-serializable summary (builtin ints and floats)."""
        return {
            k: (float(v) if isinstance(v, float) else int(v))
            for k, v in dataclasses.asdict(self).items()
        }

    def as_field_data(self) -> dict:
        """Scalar float64 FIELD arrays for the VTK writers."""
        fields = ("moves_audited", "anomaly_moves", "anomaly_mask",
                  "max_conservation_residual", "stragglers_recovered",
                  "stragglers_lost", "overflow_recoveries")
        values = dict(dataclasses.asdict(self),
                      anomaly_mask=self.anomaly_mask_union)
        return {f"sentinel_{k}": np.asarray([float(values[k])], np.float64)
                for k in fields}
