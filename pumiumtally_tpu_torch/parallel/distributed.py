"""Multi-process campaigns and the collective particle migration (port
of ``pumiumtally_tpu/parallel/distributed.py``), on ``torch.distributed``.

- ``init_distributed`` / ``global_device_mesh``: the front door over
  ``torch.distributed.init_process_group`` with the JAX package's checks
  (all three identifiers or none, range checks, idempotence, the
  ``PUMIUMTALLY_COORD_TIMEOUT`` handshake bound), returning the 1-D mesh
  over every process's devices in rank order.
- ``ShardComm``: how tensors cross shards. Within a process a shard's
  tensor is copied to the other shard's device; across processes it is
  ``all_gather`` and ``send``/``recv`` pairs (``batch_isend_irecv``).
  gloo has no CUDA ``send``/``recv`` and NCCL refuses two ranks on one
  card, so two processes sharing a card talk over gloo through explicit
  page-locked host copies, which ``host_copies`` / ``host_bytes`` count.
- ``make_collective_migrate`` / ``make_collective_frontier_migrate``:
  the migration as one explicit collective program, bitwise equal to the
  scatter of parallel/partition.py: an ``all_gather`` of the
  counting-rank keys (the ranks recomputed at global shape from the
  gathered keys: integer math on identical input gives identical ranks
  on every shard), then a ring that hands each shard's packed slab
  around the mesh, every shard keeping the rows whose destination slot
  it owns. Destinations are unique, so arrival order cannot matter.
- ``fetch_global``: a host copy of a result.
- ``assert_collectives_available`` raises ``DistributedUnavailableError``
  (exit code 77, the ``DISTRIBUTED-UNAVAILABLE`` marker) where no
  backend can run a cross-process collective.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pumiumtally_tpu_torch.parallel.device import DeviceMesh, mesh_axis

#: Subprocess exit code meaning "distributed backend unavailable here:
#: skip, don't fail" (the automake SKIP convention).
UNAVAILABLE_EXIT_CODE = 77

#: Stdout marker printed beside the exit code.
UNAVAILABLE_MARKER = "DISTRIBUTED-UNAVAILABLE"


class DistributedUnavailableError(RuntimeError):
    """No ``torch.distributed`` backend can run a cross-process
    collective here. Environmental, not a code bug: callers SKIP."""


def _dist():
    import torch.distributed as dist

    return dist


def global_device_mesh(axis_name: str = "dp",
                       local_devices: Optional[Sequence] = None
                       ) -> DeviceMesh:
    """1-D mesh over every process's devices (rank order) after
    ``init_distributed``; this process's devices otherwise.
    ``local_devices`` (default: every visible CUDA device) are this
    process's entries."""
    from pumiumtally_tpu_torch.parallel.device import make_device_mesh

    local = make_device_mesh(axis_name=axis_name, devices=local_devices)
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        return local
    mine = [str(d) for d in local.devices]
    everyone: List = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    devices, ranks = [], []
    for r, devs in enumerate(everyone):
        devices += devs
        ranks += [r] * len(devs)
    return DeviceMesh(tuple(devices), (axis_name,), tuple(ranks),
                      dist.get_rank())


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    axis_name: str = "dp",
    initialization_timeout: Optional[float] = None,
    local_devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """Join (or create) the ``torch.distributed`` job and return the
    global mesh. Pass all three identifiers (``coordinator_address`` as
    ``host:port``) or none of them (the ``env://`` variables then name
    the job). ``initialization_timeout`` (seconds) bounds the handshake,
    defaulting to ``PUMIUMTALLY_COORD_TIMEOUT``. The backend is NCCL
    where every process can have a card of its own and gloo otherwise
    (CPU shards, or two processes on one card). A second call in a
    joined process returns the mesh."""
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit) and None in explicit:
        missing = [
            n for n, v in zip(
                ("coordinator_address", "num_processes", "process_id"),
                explicit,
            ) if v is None
        ]
        raise ValueError(
            "init_distributed needs coordinator_address, num_processes "
            "AND process_id together (or none of them, where the env:// "
            f"variables name the job); missing {missing}"
        )
    if num_processes is not None:
        num_processes = int(num_processes)
        process_id = int(process_id)
        if num_processes < 1:
            raise ValueError(
                f"num_processes must be >= 1, got {num_processes}"
            )
        if not 0 <= process_id < num_processes:
            raise ValueError(
                f"process_id must be in [0, {num_processes}), "
                f"got {process_id}"
            )
    dist = _dist()
    if not dist.is_available():
        raise DistributedUnavailableError(
            f"{UNAVAILABLE_MARKER}: this torch has no torch.distributed")
    if dist.is_initialized():
        return global_device_mesh(axis_name, local_devices)
    if initialization_timeout is None:
        env = os.environ.get("PUMIUMTALLY_COORD_TIMEOUT")
        initialization_timeout = float(env) if env else None
    cuda = local_devices is None or all(
        torch.device(d).type == "cuda" for d in local_devices)
    world = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    own_card = (torch.cuda.is_available()
                and torch.cuda.device_count() >= world)
    backend = "nccl" if cuda and own_card and dist.is_nccl_available() \
        else "gloo"
    if backend == "gloo" and not dist.is_gloo_available():
        raise DistributedUnavailableError(
            f"{UNAVAILABLE_MARKER}: this torch has no gloo backend")
    kw = {}
    if initialization_timeout is not None:
        kw["timeout"] = datetime.timedelta(
            seconds=float(initialization_timeout))
    if coordinator_address is not None:
        kw.update(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    else:
        kw["init_method"] = "env://"
    dist.init_process_group(backend, **kw)
    return global_device_mesh(axis_name, local_devices)


def assert_collectives_available(device_mesh: DeviceMesh) -> None:
    """Probe that a cross-process collective runs on ``device_mesh``:
    one int all-reduce. One-process meshes pass trivially; a missing
    backend raises ``DistributedUnavailableError``. Any failure of the
    probe itself (a lost peer, a closed connection, a timeout) is a
    broken job, not a missing backend, and propagates as it is."""
    if not device_mesh.multi_process:
        return
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        raise DistributedUnavailableError(
            f"{UNAVAILABLE_MARKER}: the mesh spans processes but no "
            "torch.distributed job is joined (init_distributed)")
    backend = dist.get_backend()
    if (backend == "gloo" and not dist.is_gloo_available()) or (
            backend == "nccl" and not dist.is_nccl_available()):
        raise DistributedUnavailableError(
            f"{UNAVAILABLE_MARKER}: this torch has no {backend} backend")
    v = torch.ones((1,), dtype=torch.int64,
                   device="cuda" if backend == "nccl" else "cpu")
    dist.all_reduce(v)
    if int(v) != dist.get_world_size():  # a silently wrong collective
        raise RuntimeError(
            f"collective probe returned {int(v)}, expected "
            f"{dist.get_world_size()}")


def fetch_global(x) -> np.ndarray:
    """Host numpy copy of a result. The facades assemble their results
    across processes themselves (``ShardComm.gather``), so every value
    here is whole."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -- moving tensors between shards ------------------------------------------

class ShardComm:
    """The data paths between the shards of one mesh (module doc)."""

    def __init__(self, device_mesh: DeviceMesh):
        self.mesh = device_mesh
        self.local = device_mesh.local
        self.host_copies = 0
        self.host_bytes = 0
        self._gloo = False
        if device_mesh.multi_process:
            dist = _dist()
            if not dist.is_initialized():
                raise RuntimeError(
                    "the device mesh spans processes: join the job with "
                    "init_distributed first")
            self._gloo = dist.get_backend() == "gloo"
            counts = {device_mesh.ranks.count(r)
                      for r in set(device_mesh.ranks)}
            if len(counts) > 1:
                raise ValueError(
                    "every process of a device mesh must hold the same "
                    f"number of shards (ranks {list(device_mesh.ranks)})")

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """What the backend sends: a CUDA tensor crosses gloo as a
        page-locked host copy (counted)."""
        if self._gloo and t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            self.host_copies += 1
            self.host_bytes += t.numel() * t.element_size()
            return h
        return t

    def _from_wire(self, t: torch.Tensor, device) -> torch.Tensor:
        if t.device != torch.device(device):
            if self._gloo and torch.device(device).type == "cuda":
                self.host_copies += 1
                self.host_bytes += t.numel() * t.element_size()
            return t.to(device)
        return t

    def _wire_buffer(self, shape, dtype, device) -> torch.Tensor:
        if self._gloo and torch.device(device).type == "cuda":
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=device)

    def all_gather(self, parts: Dict[int, torch.Tensor]) -> List[torch.Tensor]:
        """Every shard's tensor (``parts``: this process's, by shard
        index; equal shapes), in mesh order, on this process's home
        device."""
        home = self.mesh.home
        if not self.mesh.multi_process:
            return [parts[i].to(home) for i in range(self.mesh.size)]
        dist = _dist()
        mine = torch.stack([parts[i] for i in self.local])
        wire = self._to_wire(mine)
        outs = [self._wire_buffer(tuple(mine.shape), mine.dtype, home)
                for _ in range(dist.get_world_size())]
        dist.all_gather(outs, wire)
        by_rank = [list(self._from_wire(o, home).unbind(0)) for o in outs]
        return [by_rank[r].pop(0) for r in self.mesh.ranks]

    def ring_shift(self, slabs: Dict[int, tuple]) -> Dict[int, tuple]:
        """One hop of the ring: shard i's tensors go to shard i+1 (mod
        the mesh size). Returns this process's shards' new tensors."""
        n = self.mesh.size
        devs = self.mesh.devices
        out: Dict[int, tuple] = {}
        ops, recv = [], {}
        for i in self.local:
            j = (i + 1) % n
            if j in slabs:
                out[j] = tuple(t.to(devs[j]) for t in slabs[i])
            else:
                dist = _dist()
                for tag, t in enumerate(slabs[i]):
                    ops.append(dist.P2POp(dist.isend, self._to_wire(t),
                                          self.mesh.ranks[j], tag=tag))
        for j in self.local:
            i = (j - 1) % n
            if i in slabs:
                continue
            dist = _dist()
            like = slabs[j]
            bufs = tuple(self._wire_buffer(t.shape, t.dtype, devs[j])
                         for t in like)
            recv[j] = bufs
            for tag, b in enumerate(bufs):
                ops.append(dist.P2POp(dist.irecv, b, self.mesh.ranks[i],
                                      tag=tag))
        if ops:
            for req in _dist().batch_isend_irecv(ops):
                req.wait()
        for j, bufs in recv.items():
            out[j] = tuple(self._from_wire(b, devs[j]) for b in bufs)
        return out

    def any(self, flags: Dict[int, torch.Tensor]) -> bool:
        """Whether any shard's flag is set (an int all-reduce across
        processes)."""
        v = int(sum(int(f) for f in flags.values()))
        return self.sum_int(v) > 0

    def sum_int(self, v: int) -> int:
        """An integer summed over the processes (exact, so its order
        does not matter)."""
        if not self.mesh.multi_process:
            return int(v)
        dist = _dist()
        dev = self.mesh.home if not self._gloo else "cpu"
        t = torch.tensor([int(v)], dtype=torch.int64, device=dev)
        dist.all_reduce(t)
        return int(t)

    def sum_ints(self, vals: torch.Tensor) -> torch.Tensor:
        """An int tensor summed over the processes."""
        if not self.mesh.multi_process:
            return vals
        dist = _dist()
        t = vals.to("cpu" if self._gloo else vals.device).clone()
        dist.all_reduce(t)
        return t.to(vals.device)

    def min_ints(self, vals: torch.Tensor) -> torch.Tensor:
        """An int tensor's elementwise minimum over the processes."""
        if not self.mesh.multi_process:
            return vals
        dist = _dist()
        t = vals.to("cpu" if self._gloo else vals.device).clone()
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return t.to(vals.device)


# -- byte models --------------------------------------------------------------

def state_pack_columns(state: dict) -> tuple:
    """(float_cols, int_cols) of the packed particle-state matrices: the
    row width the migration collective ships."""
    fcols = icols = 0
    for v in state.values():
        cols = 1
        for s in tuple(v.shape)[1:]:
            cols *= int(s)
        if torch.is_floating_point(v):
            fcols += cols
        else:
            icols += cols
    return fcols, icols


def modeled_migration_collective_bytes(cap: int, ndev: int, float_cols: int,
                                       int_cols: int,
                                       float_bytes: int = 8) -> int:
    """Bytes each shard SENDS per collective migration round: its
    ``cap/ndev`` int32 keys to the other ``ndev-1`` shards, then the
    ``ndev-1`` ring hops of its packed slab (float pack, int32 pack, the
    int32 destination lane)."""
    n_loc = cap // ndev
    keys = (ndev - 1) * n_loc * 4
    slab = n_loc * (float_cols * float_bytes + int_cols * 4 + 4)
    return keys + (ndev - 1) * slab


def derive_host_counts(device_mesh: DeviceMesh) -> tuple:
    """Devices per host (process), in mesh order: the host geometry
    ``placement="pod_rcb"`` aligns ownership to. A mesh whose order
    interleaves processes is refused; a one-process mesh answers
    ``(ndev,)``."""
    procs = list(device_mesh.ranks)
    counts: list = []
    order: list = []
    for p in procs:
        if order and p == order[-1]:
            counts[-1] += 1
            continue
        if p in order:
            raise ValueError(
                f"device mesh interleaves process {p}'s devices — "
                "pod_rcb placement needs hosts contiguous in mesh "
                f"device order (process sequence {procs})"
            )
        order.append(p)
        counts.append(1)
    return tuple(counts)


def modeled_cross_host_migration_bytes(remote_faces, blocks_per_chip: int,
                                       host_counts, float_cols: int,
                                       int_cols: int,
                                       float_bytes: int = 8) -> int:
    """Modeled per-round CROSS-HOST migration bytes of a partition under
    its host layout: each directed cross-part face (``MeshPartition.
    remote_faces``) is one packed row a round, paying one transfer a
    host boundary it crosses on the host ring."""
    host_counts = [int(h) for h in host_counts]
    host_of_dev = np.repeat(np.arange(len(host_counts)), host_counts)
    nhosts = len(host_counts)
    row_bytes = float_cols * float_bytes + int_cols * 4 + 4
    total = 0
    for a, b, n in np.asarray(remote_faces):
        ha = int(host_of_dev[int(a) // int(blocks_per_chip)])
        hb = int(host_of_dev[int(b) // int(blocks_per_chip)])
        total += int(n) * ((hb - ha) % nhosts) * row_bytes
    return int(total)


# -- the collective migrations -----------------------------------------------

def _ring_scatter(comm: ShardComm, n_loc: int, acc: Dict[int, list],
                  slabs: Dict[int, tuple]) -> Dict[int, list]:
    """``ndev`` ring steps: every shard keeps the visiting rows whose
    destination (the slab's last tensor, a global slot) lies in its
    range, then hands the slab on. ``acc``: each local shard's [float
    pack, int pack], written in place."""
    ndev = comm.mesh.size
    for step in range(ndev):
        for i in comm.local:
            vis_f, vis_i, vis_d = slabs[i]
            base = i * n_loc
            mine = (vis_d >= base) & (vis_d < base + n_loc)
            idx = (vis_d[mine] - base).long()
            acc[i][0][idx] = vis_f[mine]
            acc[i][1][idx] = vis_i[mine]
        if step + 1 < ndev:
            slabs = comm.ring_shift(slabs)
    return acc


def _global_keys(comm: ShardComm, parts: Dict[int, torch.Tensor]
                 ) -> Dict[int, torch.Tensor]:
    """The gathered global lane, on each local shard's device (one copy
    a device: identical input on every shard)."""
    dtype = next(iter(parts.values())).dtype
    if dtype == torch.bool:  # crosses the wire as bytes
        parts = {i: t.to(torch.uint8) for i, t in parts.items()}
    gathered = torch.cat(comm.all_gather(parts)).to(dtype)
    out, by_dev = {}, {}
    for i in comm.local:
        d = comm.mesh.devices[i]
        if d not in by_dev:
            by_dev[d] = gathered.to(d)
        out[i] = by_dev[d]
    return out


def make_collective_migrate(device_mesh: DeviceMesh, *, part_L: int,
                            nparts: int, cap_per_block: int,
                            partition_method: str = "rank",
                            comm: Optional[ShardComm] = None):
    """The collective migration: ``fn(shards) -> (new_shards,
    overflow)``, bitwise equal to ``partition.migrate(part_L, nparts,
    cap_per_block, state)`` over the assembled state. ``shards`` is the
    list (mesh order) of each shard's state dict of ``cap/ndev`` slots
    (None for another process's shard). Per shard: the counting-rank
    keys, their ``all_gather``, the ranks recomputed at global shape, the
    unique destination slots, the packed slab's ring, the arrival fixup;
    on overflow (any block past its slots) the old shards come back
    unchanged, so the recovery ladder works as with the scatter.
    ``partition_method`` ("rank" or "argsort") names the JAX package's
    two rank algorithms, which give the same stable ranks."""
    from pumiumtally_tpu_torch.ops.bucketize import counting_ranks
    from pumiumtally_tpu_torch.parallel.partition import (
        _arrive,
        _default_state,
        _pack_state,
        _shard_keys,
        _unpack_state,
    )

    mesh_axis(device_mesh)
    if partition_method not in ("rank", "argsort"):
        raise ValueError(f"partition_method must be 'rank' or 'argsort', "
                         f"got {partition_method!r}")
    comm = comm or ShardComm(device_mesh)
    ndev = device_mesh.size
    cap = nparts * cap_per_block
    if cap % ndev:
        raise ValueError(
            f"capacity {cap} is not divisible by the {ndev}-device mesh"
        )
    n_loc = cap // ndev

    def collective_migrate(shards):
        keys = {i: _shard_keys(part_L, nparts, cap_per_block, i * n_loc,
                               shards[i]) for i in comm.local}
        keys_g = _global_keys(comm, keys)
        ranks_g = {}
        for i in comm.local:
            k = keys_g[i]
            if k.device not in ranks_g:
                ranks_g[k.device] = counting_ranks(k, nparts + 1).long()
        ovf, slabs, acc, layouts = {}, {}, {}, {}
        for i in comm.local:
            key = keys[i]
            rank = ranks_g[key.device][i * n_loc:(i + 1) * n_loc]
            live = key < nparts
            ovf[i] = (live & (rank >= cap_per_block)).any()
            dest = torch.where(live, key * cap_per_block + rank,
                               torch.full_like(key, cap))
            fpack, ipack, layout = _pack_state(shards[i])
            dflt = _pack_state(_default_state(n_loc, shards[i]))
            slabs[i] = (fpack, ipack, dest)
            acc[i] = [dflt[0], dflt[1]]
            layouts[i] = layout
        if comm.any(ovf):
            return shards, True
        acc = _ring_scatter(comm, n_loc, acc, slabs)
        out = list(shards)
        for i in comm.local:
            out[i] = _unpack_state(acc[i][0], acc[i][1], layouts[i])
            _arrive(out[i], part_L)
        return out, False

    return collective_migrate


def make_collective_frontier_migrate(device_mesh: DeviceMesh, *, part_L: int,
                                     nparts: int, cap_per_block: int,
                                     cap_frontier: int,
                                     partition_method: str = "rank",
                                     comm: Optional[ShardComm] = None):
    """The frontier-slab migration as the same collective program:
    ``fn(shards) -> (new_shards, overflow, departures, arrivals,
    works)``, bitwise equal to ``partition._frontier_migrate_impl`` over
    the assembled state. Every shard gathers the [cap] ``pending``,
    ``alive`` and ``done`` lanes, replays the global bookkeeping
    (``partition._frontier_plan``: integer math on identical input, so
    identical slab, destinations and overflow on every shard), clears
    its departing slots and builds a ``cap_frontier``-row slab of the
    rows it owns, arrival fixups applied; the slab rides the ring and
    every shard keeps the rows it owns. ``works`` is each shard's next
    work list ``(ids, n_work)`` in its local slots: the global list's
    entries in its range, in the global list's order. The caller
    guarantees that the front fits the slab."""
    from pumiumtally_tpu_torch.parallel.partition import (
        _default_state,
        _frontier_plan,
        _pack_state,
        _shard_work,
        _unpack_state,
    )

    mesh_axis(device_mesh)
    comm = comm or ShardComm(device_mesh)
    ndev = device_mesh.size
    cap = nparts * cap_per_block
    if cap % ndev:
        raise ValueError(
            f"capacity {cap} is not divisible by the {ndev}-device mesh"
        )
    n_loc = cap // ndev
    cf = int(cap_frontier)
    if not 0 < cf <= cap:
        raise ValueError(
            f"cap_frontier {cf} must be in 1..{cap} for the collective "
            "slab (0 dispatches to the full-capacity collective "
            "upstream)"
        )

    def collective_frontier_migrate(shards):
        lanes = {}
        for name in ("pending", "alive", "done"):
            lanes[name] = _global_keys(
                comm, {i: shards[i][name] for i in comm.local})
        plans = {}
        for i in comm.local:
            d = lanes["pending"][i].device
            if d not in plans:
                plans[d] = _frontier_plan(
                    part_L, nparts, cap_per_block, cf,
                    lanes["pending"][i], lanes["alive"][i],
                    lanes["done"][i])
        plan = plans[next(iter(plans))]
        if plan.overflow:
            return shards, True, plan.dep, plan.arr, None
        slabs, acc, layouts = {}, {}, {}
        works: list = [None] * ndev
        for i in comm.local:
            p = plans[lanes["pending"][i].device]
            st = shards[i]
            base = i * n_loc
            fpack, ipack, layout = _pack_state(st)
            layouts[i] = layout
            own = p.valid & (p.src >= base) & (p.src < base + n_loc)
            loc = (p.src - base).clamp(0, n_loc - 1)
            slab_f = fpack[loc]
            slab_i = ipack[loc].clone()
            cols = {k: start for k, _, start, _, _, _ in layout}
            slab_i[:, cols["lelem"]] = torch.where(
                p.valid, p.pend_slab % part_L,
                slab_i[:, cols["lelem"]].long()).to(slab_i.dtype)
            slab_i[:, cols["pending"]] = torch.where(
                p.valid, torch.full_like(slab_i[:, cols["pending"]], -1),
                slab_i[:, cols["pending"]])
            slab_d = torch.where(own, p.dest_slab,
                                 torch.full_like(p.dest_slab, cap))
            # Clear before place: an arrival may take a vacated slot.
            dflt_f, dflt_i, _ = _pack_state(_default_state(1, st))
            gone = (p.src[own] - base).long()
            fpack[gone] = dflt_f
            ipack[gone] = dflt_i
            acc[i] = [fpack, ipack]
            slabs[i] = (slab_f, slab_i, slab_d)
            works[i] = _shard_work(p.work, p.n_work, base, n_loc)
        acc = _ring_scatter(comm, n_loc, acc, slabs)
        out = list(shards)
        for i in comm.local:
            out[i] = _unpack_state(acc[i][0], acc[i][1], layouts[i])
        return out, False, plan.dep, plan.arr, works

    return collective_frontier_migrate
