"""Particles sharded over a device mesh, the mesh tables replicated, the
flux reduced across the shards (port of ``pumiumtally_tpu/parallel/
sharded.py``).

The particle arrays of a call are split into ``ndev`` contiguous shards
(``ShardLayout``); each shard runs the single-device step of
api/tally.py on its own device, against the mesh's copy on that device
(one copy a distinct device, ``replicate_mesh``), with a flux delta (and
a bank delta with scoring) that starts from zeros. The deltas are
summed in FIXED shard order onto the home device, the JAX ``psum``: two
identical runs give the same bits when the commit is deterministic.
Across processes the partials are ``all_gather``-ed and summed in the
same order (``all_reduce`` leaves its order to NCCL). ``done`` and ``s``
stay sharded, for the found-all check and the sentinel.

The facades pad their capacity to a multiple of ``ndev``; padded slots
carry ``in_flight=0, dest=x`` and contribute nothing. Arrays staged on
the home device go to a shard on another device as one copy each; logical
shards on the home device take views.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh
from pumiumtally_tpu_torch.parallel.device import DeviceMesh, mesh_axis


class ShardLayout:
    """``cap`` particle slots over the shards of ``device_mesh``: shard
    i holds slots ``[i*m, (i+1)*m)`` with ``m = cap / ndev``."""

    def __init__(self, device_mesh: DeviceMesh, cap: int):
        from pumiumtally_tpu_torch.parallel.distributed import ShardComm

        mesh_axis(device_mesh)  # fail fast: must be 1-D
        self.mesh = device_mesh
        self.ndev = device_mesh.size
        if cap % self.ndev:
            raise ValueError(f"{cap} slots do not split over the "
                             f"{self.ndev}-device mesh")
        self.cap = int(cap)
        self.m = self.cap // self.ndev
        self.local = device_mesh.local
        self.devices = device_mesh.devices
        self.home = device_mesh.home
        self.comm = ShardComm(device_mesh)

    @staticmethod
    def padded(n: int, device_mesh: DeviceMesh) -> int:
        """The capacity for ``n`` particles: a multiple of the mesh."""
        ndev = device_mesh.size
        return -(-int(n) // ndev) * ndev

    def split(self, whole: Optional[torch.Tensor]) -> list:
        """This process's shards of a [cap, ...] tensor (None elsewhere):
        views on the tensor's own device, copies on another."""
        if whole is None:
            return [None] * self.ndev
        out: List[Optional[torch.Tensor]] = [None] * self.ndev
        for i in self.local:
            out[i] = whole[i * self.m:(i + 1) * self.m].to(self.devices[i])
        return out

    def gather(self, parts: list) -> torch.Tensor:
        """The whole [cap, ...] tensor on the home device, in shard
        order (across processes: an ``all_gather``)."""
        return torch.cat(self.comm.all_gather(
            {i: parts[i] for i in self.local}))

    def reduce(self, parts: list) -> torch.Tensor:
        """The sum of every shard's tensor in fixed shard order, on the
        home device."""
        allp = self.comm.all_gather({i: parts[i] for i in self.local})
        total = allp[0].clone()
        for p in allp[1:]:
            total += p
        return total

    def all(self, flags: list) -> torch.Tensor:
        """Whether every shard's bool tensor is all true (a device
        scalar; across processes, an int all-reduce)."""
        local = torch.stack([flags[i].all().to(self.home)
                             for i in self.local]).all()
        if not self.mesh.multi_process:
            return local
        bad = self.comm.sum_int(int(not bool(local)))
        return torch.tensor(bad == 0, device=self.home)


def replicate_mesh(mesh: TetMesh, layout: ShardLayout) -> list:
    """The mesh tables on each local shard's device: one copy a distinct
    device (logical shards on one device share it)."""
    copies = {mesh.device: mesh}
    out: list = [None] * layout.ndev
    for i in layout.local:
        d = layout.devices[i]
        if d not in copies:
            copies[d] = mesh.to(device=d)
        out[i] = copies[d]
    return out


def sharded_localize_step(layout: ShardLayout, meshes: list, x: list,
                          elem: list, dest: list, *, tol: float,
                          max_iters: int):
    """Non-tallying localization walk, particles sharded: each shard
    walks its slice to ``dest``. Returns per-shard lists (x, elem, done,
    exited)."""
    from pumiumtally_tpu_torch.api.tally import _localize_step

    out = [[None] * layout.ndev for _ in range(4)]
    for i in layout.local:
        r = _localize_step(meshes[i], x[i], elem[i], dest[i], tol=tol,
                           max_iters=max_iters)
        for k in range(4):
            out[k][i] = r[k]
    return tuple(out)


def sharded_locate(layout: ShardLayout, meshes: list, pts: list, *,
                   tol: float) -> list:
    """Point location with the points sharded and the face planes
    replicated: per-shard element ids, -1 where unlocated."""
    from pumiumtally_tpu_torch.ops.geometry import locate_by_planes

    out: list = [None] * layout.ndev
    for i in layout.local:
        out[i] = locate_by_planes(meshes[i].face_normals,
                                  meshes[i].face_offsets, pts[i], tol)
    return out


def _sharded_tally_step(layout: ShardLayout, step_fn, meshes: list,
                        particle_args: tuple, flux: torch.Tensor, *,
                        tol: float, max_iters: int, scoring=None,
                        deterministic=False):
    """The scaffold of the tallied moves (JAX ``_sharded_tally_step``):
    each shard runs ``step_fn`` (a single-device move of api/tally.py)
    on its slice with a zero flux delta (and, with ``scoring = (kinds,
    bank, sbin, sfac)``, sbin/sfac sharded, a zero bank delta); the
    deltas are summed in shard order onto ``flux`` (and the bank).
    Returns per-shard lists (x, elem, done, s), the new flux and the new
    bank (None without scoring)."""
    xs, es, dones, ss = ([None] * layout.ndev for _ in range(4))
    dflux: list = [None] * layout.ndev
    dbank: list = [None] * layout.ndev
    for i in layout.local:
        d = layout.devices[i]
        dflux[i] = torch.zeros(flux.shape, dtype=flux.dtype, device=d)
        sc = None
        if scoring is not None:
            kinds, bank, sbin, sfac = scoring
            dbank[i] = torch.zeros(bank.shape, dtype=bank.dtype, device=d)
            sc = (kinds, dbank[i], sbin[i], sfac[i])
        xs[i], es[i], dones[i], ss[i] = step_fn(
            meshes[i], *(a[i] for a in particle_args), dflux[i], tol=tol,
            max_iters=max_iters, scoring=sc, deterministic=deterministic)
    flux_out = flux + layout.reduce(dflux)
    bank_out = None
    if scoring is not None:
        bank_out = scoring[1] + layout.reduce(dbank)
    return xs, es, dones, ss, flux_out, bank_out


def sharded_move_step(layout: ShardLayout, meshes: list, x, elem, origins,
                      dests, flying, weights, flux, **kw):
    """One two-phase MoveToNextLocation over the shards (arguments as
    per-shard lists; ``_sharded_tally_step`` for the rest)."""
    from pumiumtally_tpu_torch.api.tally import move_step

    return _sharded_tally_step(layout, move_step, meshes,
                               (x, elem, origins, dests, flying, weights),
                               flux, **kw)


def sharded_move_step_continue(layout: ShardLayout, meshes: list, x, elem,
                               dests, flying, weights, flux, **kw):
    """The phase-B-only sharded move, from the committed sharded state
    (the ``origins=None`` fast path)."""
    from pumiumtally_tpu_torch.api.tally import move_step_continue

    return _sharded_tally_step(layout, move_step_continue, meshes,
                               (x, elem, dests, flying, weights), flux, **kw)
