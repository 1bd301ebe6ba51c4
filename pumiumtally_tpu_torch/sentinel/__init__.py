"""Runtime sentinels and graceful degradation (port of
``pumiumtally_tpu/sentinel``):

- audit lanes (audit.py): per move, on the device, the unfinished
  count, the tallied-vs-straight-line conservation residual and a
  non-finite-flux probe, packed into ONE scalar fetch;
- straggler escalation (straggler.py): particles that exhaust the step
  budget are re-walked (W0 at a multiplied budget, then the
  full-precision planes on a two-tier mesh) instead of being truncated;
  the partitioned facades resume their engine's phase
  (``PartitionedEngine.retry_stragglers``);
- quarantine (quarantine.py): an append-safe JSONL record of every
  particle nothing could recover;
- ``SentinelPolicy`` on ``TallyConfig.sentinel`` arms it all, and
  ``tally.health_report()`` returns the cumulative ``HealthReport``
  (also in the VTK FIELD data). The partitioned overflow-recovery ladder
  reports into the same runner.

Sentinel-off (the default) constructs nothing and changes no path.
"""

from pumiumtally_tpu_torch.sentinel.policy import (
    ANOMALY_CONSERVATION,
    ANOMALY_NONFINITE,
    ANOMALY_UNFINISHED,
    POISONED_MESSAGE,
    EnginePoisonedError,
    HealthReport,
    SentinelAnomalyError,
    SentinelPolicy,
    describe_mask,
)
from pumiumtally_tpu_torch.sentinel.quarantine import (
    append_quarantine,
    quarantine_path,
    read_quarantine,
)
from pumiumtally_tpu_torch.sentinel.runner import SentinelRunner, build_runner

__all__ = [
    "ANOMALY_CONSERVATION",
    "ANOMALY_NONFINITE",
    "ANOMALY_UNFINISHED",
    "EnginePoisonedError",
    "HealthReport",
    "POISONED_MESSAGE",
    "SentinelAnomalyError",
    "SentinelPolicy",
    "SentinelRunner",
    "append_quarantine",
    "build_runner",
    "describe_mask",
    "quarantine_path",
    "read_quarantine",
]
