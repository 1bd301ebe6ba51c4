"""pumiumtally_tpu_torch: the PyTorch/CUDA port of pumiumtally_tpu.

Track-length tallies over a tetrahedral mesh, driven through the
reference's three-call protocol (``CopyInitialPosition`` /
``MoveToNextLocation`` / ``WriteTallyResults``), on one NVIDIA H100; ``StreamingTally`` and
``StreamingPartitionedTally`` take batches of any size in chunks.
``TallyConfig(scoring=ScoringSpec(...))`` adds energy/time-binned
scoring lanes, ``TallyConfig(batch_stats=True)`` per-batch
statistics (``TriggerSpec`` for convergence triggers) and
``TallyConfig(sentinel=SentinelPolicy())`` the runtime sentinels
(``health_report()``); ``TallyConfig(record_xpoints=True)`` enables
``PumiTally.intersection_points()``;
``TallyConfig(checkpoint=CheckpointPolicy(dir=...))`` arms autosave,
graceful drain, ``checkpoint_now()`` and ``resume_latest()`` (the
checkpoint format is the JAX package's, read and written by both).
``TallyService`` (service/) serves many client sessions on one device,
fusing compatible sessions' moves into one launch.
``TallyConfig(device_mesh=make_device_mesh(...))`` (parallel/) shards
the particles, or the partitioned engine's blocks, over several devices
or logical shards of one, and ``init_distributed`` over processes. The
device work runs in hand-written CUDA kernels (``csrc/``, built by
``kernels.py`` at first use); every kernel's plain PyTorch version runs
when the caller asks for ``device="cpu"``. The package imports torch
and numpy, never jax and nothing of ``pumiumtally_tpu``.
"""

from pumiumtally_tpu_torch.api.partitioned import PartitionedPumiTally
from pumiumtally_tpu_torch.api.streaming import (
    StreamingPartitionedTally,
    StreamingTally,
)
from pumiumtally_tpu_torch.api.tally import PumiTally, TallyTimes
from pumiumtally_tpu_torch.config import TallyConfig
from pumiumtally_tpu_torch.mesh.box import build_box
from pumiumtally_tpu_torch.mesh.pincell import build_lattice, build_pincell
from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh
from pumiumtally_tpu_torch.resilience import CheckpointPolicy, resume_latest
from pumiumtally_tpu_torch.scoring import (
    SCORES,
    EnergyFilter,
    ScoringSpec,
    TimeFilter,
)
from pumiumtally_tpu_torch.sentinel import (
    EnginePoisonedError,
    HealthReport,
    SentinelAnomalyError,
    SentinelPolicy,
)
from pumiumtally_tpu_torch.service import (
    ServiceBusyError,
    ServiceDrainingError,
    SessionClosedError,
    SessionState,
    TallyService,
)
from pumiumtally_tpu_torch.stats import (
    BatchStatistics,
    TriggerResult,
    TriggerSpec,
    evaluate_trigger,
)

__all__ = [
    "SCORES",
    "BatchStatistics",
    "CheckpointPolicy",
    "EnergyFilter",
    "EnginePoisonedError",
    "HealthReport",
    "PartitionedPumiTally",
    "PumiTally",
    "ScoringSpec",
    "SentinelAnomalyError",
    "SentinelPolicy",
    "ServiceBusyError",
    "ServiceDrainingError",
    "SessionClosedError",
    "SessionState",
    "StreamingPartitionedTally",
    "StreamingTally",
    "TallyConfig",
    "TallyService",
    "TallyTimes",
    "TetMesh",
    "TimeFilter",
    "TriggerResult",
    "TriggerSpec",
    "build_box",
    "build_lattice",
    "build_pincell",
    "evaluate_trigger",
    "resume_latest",
]
