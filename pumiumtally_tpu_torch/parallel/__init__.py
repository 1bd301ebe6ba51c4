"""Parallelism over a ``DeviceMesh`` of shards (port of
``pumiumtally_tpu/parallel``): the particle batch sharded over a ``dp``
axis with the tet mesh replicated on every device and the flux reduced
across the shards (``sharded``), the mesh partitioned into element
blocks spread over the shards with particle migration between them
(``partition``), and multi-process jobs on ``torch.distributed`` with the
collective migration (``distributed``).
"""

from pumiumtally_tpu_torch.parallel.device import (
    DeviceMesh,
    initialize_distributed,
    make_device_mesh,
)
from pumiumtally_tpu_torch.parallel.sharded import (
    sharded_localize_step,
    sharded_move_step,
    sharded_move_step_continue,
)
from pumiumtally_tpu_torch.parallel.partition import (
    MeshPartition,
    PartitionedEngine,
    build_partition,
    rcb_partition,
)
from pumiumtally_tpu_torch.parallel.distributed import (
    DistributedUnavailableError,
    assert_collectives_available,
    fetch_global,
    global_device_mesh,
    init_distributed,
    make_collective_migrate,
)

__all__ = [
    "DeviceMesh",
    "initialize_distributed",
    "make_device_mesh",
    "sharded_localize_step",
    "sharded_move_step",
    "sharded_move_step_continue",
    "MeshPartition",
    "PartitionedEngine",
    "build_partition",
    "rcb_partition",
    "DistributedUnavailableError",
    "assert_collectives_available",
    "fetch_global",
    "global_device_mesh",
    "init_distributed",
    "make_collective_migrate",
]
