"""Fault-tolerant campaigns (port of ``pumiumtally_tpu/resilience``,
docs/DESIGN.md "Fault tolerance").

Three mechanisms over the checkpoint format (utils/checkpoint.py):

- ``GenerationStore`` / ``resume_latest``: atomic, sha256-sealed,
  keep-last-K checkpoint generations with corruption fallback
  (generations.py);
- ``CheckpointPolicy`` / ``AutosaveRunner``: the autosave cadence hooked
  into every facade at batch close and move end, and the SIGTERM/SIGINT
  graceful drain (policy.py);
- ``faults``: the deterministic fault-injection harness
  (``PUMIUMTALLY_FAULT``) that proves the first two under process kill,
  truncation, bit flips and NaN payloads (faults.py).

Everything here is host Python over numpy buffers. A facade that carries
a ``CheckpointPolicy`` also walks with the deterministic flux commit
(ops/det_commit.py), so that a resumed run equals an uninterrupted one
bit for bit on the card as on the CPU.
"""

from pumiumtally_tpu_torch.resilience.faults import (
    FAULT_ENV,
    FaultSpec,
    parse_fault,
)
from pumiumtally_tpu_torch.resilience.generations import (
    GenerationStore,
    ResumeInfo,
    resume_latest,
)
from pumiumtally_tpu_torch.resilience.policy import (
    AutosaveRunner,
    CheckpointPolicy,
    install_drain_owner,
    release_drain_owner,
)
from pumiumtally_tpu_torch.utils.checkpoint import CorruptCheckpointError

__all__ = [
    "AutosaveRunner",
    "CheckpointPolicy",
    "CorruptCheckpointError",
    "FAULT_ENV",
    "FaultSpec",
    "GenerationStore",
    "ResumeInfo",
    "install_drain_owner",
    "parse_fault",
    "release_drain_owner",
    "resume_latest",
]
