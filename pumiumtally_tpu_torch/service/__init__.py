"""Multi-session campaign service (port of ``pumiumtally_tpu/service/``):
one device, many concurrent client sessions, over the port's facades.

- ``TallySession`` (session.py): one facade per client, so flux, scoring
  banks, statistics, sentinel health and autosave generations stay
  per session; a bounded FIFO queue with ``ServiceBusyError``
  backpressure; the OPEN -> DRAINING -> CLOSED lifecycle.
- ``DeficitRoundRobinScheduler`` and ``Priority`` (scheduler.py): fair,
  work-proportional interleaving of ready sessions in priority lanes.
- staging (staging.py): prepack and validation at submit time, on the
  client's thread.
- ``TallyService`` / ``SessionHandle`` / ``SocketFrontend`` /
  ``SessionRouter`` (server.py): the in-process API, the NDJSON socket
  front end (the JAX package's wire), the router over several workers,
  and the SIGTERM drain that checkpoints every open session through
  ``resilience.install_drain_owner``.
- cross-session fusion (fusion.py): the queued moves of sessions with one
  fusion key share one W0 launch over one slab, through the walk's
  segmented commit (``walk(tally_seg=)``).

The contract: each session's output is BITWISE its solo run, whatever
the interleaving and whichever sessions shared a fused launch. On the
card that needs the deterministic commit (ops/det_commit.py), which the
service arms on every session's facade at ``open_session``. Outside
fusion.py everything here is host Python (threads, queues, numpy).
"""

from pumiumtally_tpu_torch.service.scheduler import (
    DeficitRoundRobinScheduler,
    Priority,
)
from pumiumtally_tpu_torch.service.session import (
    DEFAULT_QUEUE_DEPTH,
    ServiceBusyError,
    ServiceOverloadedError,
    SessionClosedError,
    SessionState,
    TallySession,
)
from pumiumtally_tpu_torch.service.server import (
    ServiceDrainingError,
    SessionHandle,
    SessionRouter,
    SocketFrontend,
    TallyService,
)

__all__ = [
    "DEFAULT_QUEUE_DEPTH",
    "DeficitRoundRobinScheduler",
    "Priority",
    "ServiceBusyError",
    "ServiceDrainingError",
    "ServiceOverloadedError",
    "SessionClosedError",
    "SessionHandle",
    "SessionRouter",
    "SessionState",
    "SocketFrontend",
    "TallyService",
    "TallySession",
]
