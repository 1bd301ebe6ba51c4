"""Device meshes (port of ``pumiumtally_tpu/parallel/device.py``).

The JAX package shards over a 1-D ``jax.sharding.Mesh``; here a
``DeviceMesh`` is the same thing spelled out: an ordered tuple of
``torch.device`` entries under one axis name (``dp``), each entry one
shard, with the ``torch.distributed`` rank of the process that holds
it. An entry may repeat a device: several logical shards then share one
device (the tests' eight CPU shards, the card's four shards on
``cuda:0``), each with tensors of its own. Across processes every
process holds the same mesh and walks only the entries of its own rank
(``local``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """A 1-D mesh: ``devices[i]`` holds shard i, in the process of rank
    ``ranks[i]`` (all 0 in one process). ``rank`` is this process's."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("dp",)
    ranks: Optional[Tuple[int, ...]] = None
    rank: int = 0

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if not devs:
            raise ValueError("a device mesh needs at least one device")
        ranks = (0,) * len(devs) if self.ranks is None else tuple(
            int(r) for r in self.ranks)
        if len(ranks) != len(devs):
            raise ValueError(f"{len(ranks)} ranks for {len(devs)} devices")
        object.__setattr__(self, "ranks", ranks)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> Tuple[int, ...]:
        """The shard indices this process holds, in mesh order."""
        return tuple(i for i, r in enumerate(self.ranks) if r == self.rank)

    @property
    def multi_process(self) -> bool:
        return len(set(self.ranks)) > 1

    @property
    def home(self) -> torch.device:
        """Where the shards' results assemble: this process's first
        device."""
        return self.devices[self.local[0]]

    def __repr__(self) -> str:
        return (f"DeviceMesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names}, ranks={list(self.ranks)})")


def mesh_axis(device_mesh: DeviceMesh) -> str:
    """The single particle-sharding axis of a 1-D device mesh."""
    if len(device_mesh.axis_names) != 1:
        raise ValueError(
            f"expected a 1-D device mesh, got axes {device_mesh.axis_names}"
        )
    return device_mesh.axis_names[0]


def make_device_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = "dp",
    devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """A 1-D mesh over ``n_devices`` (default: every visible CUDA
    device). ``devices`` lists the entries explicitly and may repeat one
    device (logical shards). With no GPU and no ``devices`` it raises:
    a mesh never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_device_mesh: no CUDA device is available; pass "
                "devices=[...] (e.g. [torch.device('cpu')] * 8) to build "
                "a mesh of CPU shards"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return DeviceMesh(tuple(devices), (axis_name,))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    axis_name: str = "dp",
    local_devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """Multi-process setup: join the ``torch.distributed`` job and
    return the 1-D mesh over every process's devices
    (``distributed.init_distributed``)."""
    from pumiumtally_tpu_torch.parallel.distributed import init_distributed

    return init_distributed(coordinator_address, num_processes, process_id,
                            axis_name=axis_name, local_devices=local_devices)
