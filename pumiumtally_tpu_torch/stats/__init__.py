"""Batch statistics: device accumulators, estimators, triggers (port of
``pumiumtally_tpu/stats``).

- ``accumulators.BatchAccumulator``: two extra ``[E]`` lanes
  (``flux_sum``, ``flux_sq_sum``) updated at batch close from the
  facade's flux, elementwise on the device;
- ``estimators``: per-element mean, sample standard deviation, relative
  error of the mean, figure of merit;
- ``triggers``: ``TriggerSpec`` evaluated at batch close as one
  reduction on the device and one scalar read.

Batch boundaries: each ``CopyInitialPosition`` closes the open batch
(if a move landed in it) and opens the next; the facade's
``close_batch()`` / ``finalize()`` close one explicitly. With statistics
off (the default) the facades construct none of this.
"""

from pumiumtally_tpu_torch.stats.accumulators import BatchAccumulator
from pumiumtally_tpu_torch.stats.estimators import BatchStatistics
from pumiumtally_tpu_torch.stats.triggers import (
    TriggerResult,
    TriggerSpec,
    evaluate_trigger,
)

__all__ = [
    "BatchAccumulator",
    "BatchStatistics",
    "TriggerResult",
    "TriggerSpec",
    "evaluate_trigger",
]
