"""Partitioned mesh on ONE device: element blocks + particle migration
(port of the single-device, vmem-walk subset of
``pumiumtally_tpu/parallel/partition.py``).

- **Ownership**: recursive coordinate bisection (RCB) of element
  centroids into ``nparts`` balanced blocks, the JAX package's exact
  code, so block ids and the renumbering match it element for element.
- **Block tables**: elements renumbered so each block is contiguous and
  padded to a common length L; the packed walk table is rebuilt with
  LOCAL adjacency: a local id, -1 for the domain boundary, or
  -(glid+2) for a neighbour in another block (glid = block*L + local).
- **Walk**: each round runs the block-local walk W1
  (ops/vmem_walk.py), which pauses a particle at a block face with
  ``pending = glid``.
- **Migration**: paused particles move to their target block's slot
  range by a stable rank per target (``migrate``); a round whose targets
  overflow a block's capacity keeps the old state (overflow-safe
  commit) and the engine raises.

Localization is point location against the block tables, as in the JAX
engine. Left out against the JAX engine (ROADMAP.md): the gather block
walk (``walk_local``), multi-device meshes and collectives, the
frontier-slab migrate, the overflow-recovery ladder, scoring, the
sentinel hooks and the profiled per-round programs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from pumiumtally_tpu_torch.config import ROADMAP_GATHER_BLOCKS
from pumiumtally_tpu_torch.mesh.tetmesh import (
    WALK_TABLE_ADJ,
    WALK_TABLE_NORMALS,
    WALK_TABLE_OFFSETS,
    WALK_TABLE_WIDTH,
    TetMesh,
    exact_id_limit,
)
from pumiumtally_tpu_torch.ops.bucketize import counting_ranks
from pumiumtally_tpu_torch.ops.geometry import locate_chunk_by_planes
from pumiumtally_tpu_torch.ops.vmem_walk import (
    W_TILE_DEFAULT,
    effective_vmem_bound,
    vmem_walk_local,
)

OVERFLOW_MESSAGE = (
    "partitioned-mode chip capacity exceeded during particle "
    "migration; raise TallyConfig.capacity_factor"
)


# ---------------------------------------------------------------------------
# Host-side partition build
# ---------------------------------------------------------------------------

def rcb_partition(centroids: np.ndarray, nparts: int) -> np.ndarray:
    """owner[E] via recursive coordinate bisection of element centroids:
    split along the longest axis into parts sized in proportion to the
    leaves on each side, so any nparts comes out balanced to +-1."""
    ne = centroids.shape[0]
    owner = np.zeros(ne, dtype=np.int32)

    def rec(idx: np.ndarray, first_part: int, nparts: int) -> None:
        if nparts == 1:
            owner[idx] = first_part
            return
        nl = nparts // 2
        nr = nparts - nl
        c = centroids[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        split = int(round(len(idx) * nl / nparts))
        rec(idx[order[:split]], first_part, nl)
        rec(idx[order[split:]], first_part + nl, nr)

    rec(np.arange(ne), 0, nparts)
    return owner


@dataclasses.dataclass(frozen=True)
class MeshPartition:
    """Block tables + id maps. ``ndev`` is the part count (the JAX
    package's name for it)."""

    ndev: int
    nelems: int  # original element count E
    L: int  # padded elements per part
    owner: np.ndarray  # [E] original elem -> part
    glid_of_orig: torch.Tensor  # [E] int32, original elem -> padded glid
    orig_of_glid: torch.Tensor  # [ndev*L] int32, glid -> orig elem (-1 pad)
    table: torch.Tensor  # [ndev*L, 20] packed rows, adjacency local-encoded

    def flux_to_original(self, flux_padded: torch.Tensor) -> torch.Tensor:
        """Reorder an owned [ndev*L] flux into original element order."""
        return flux_padded[self.glid_of_orig.long()]


def derive_blocks_per_chip(
    nelems: int, ndev: int, vmem_walk_max_elems: Optional[int]
) -> int:
    """The smallest k whose balanced ndev*k-way partition keeps every
    block within the bound (RCB is balanced +-1); 1 when unset."""
    if vmem_walk_max_elems is None:
        return 1
    return max(
        1, -(-int(nelems) // (int(ndev) * int(vmem_walk_max_elems)))
    )


def block_elems_bound(
    vmem_walk_max_elems: Optional[int], table_dtype: str = "float32"
) -> Optional[int]:
    """The per-block element bound the sub-split derives blocks from
    (the JAX package doubles it for the bf16 tier, which the port does
    not have yet)."""
    if vmem_walk_max_elems is None:
        return None
    if table_dtype == "bfloat16":
        return int(vmem_walk_max_elems) * 2
    return int(vmem_walk_max_elems)


def build_partition(mesh: TetMesh, ndev: int,
                    dtype: Optional[torch.dtype] = None) -> MeshPartition:
    """Partition ``mesh`` into ``ndev`` contiguous padded element blocks
    on the mesh's device."""
    dtype = mesh.dtype if dtype is None else dtype
    device = mesh.device
    coords = mesh.coords.double().cpu().numpy()
    tet2vert = mesh.tet2vert.cpu().numpy()
    face_adj = mesh.face_adj.cpu().numpy()
    normals = mesh.face_normals.double().cpu().numpy()
    offsets = mesh.face_offsets.double().cpu().numpy()
    ne = tet2vert.shape[0]
    owner = rcb_partition(coords[tet2vert].mean(axis=1), ndev)
    counts = np.bincount(owner, minlength=ndev)
    L = int(counts.max())
    if ndev * L + 2 >= exact_id_limit(dtype):
        raise NotImplementedError(
            f"{ndev}x{L} padded elements exceed the exact float-id range "
            f"of {dtype}; the int32-adjacency sidecar is not ported yet "
            f"({ROADMAP_GATHER_BLOCKS})"
        )
    # Renumber: elements of part d occupy glids [d*L, d*L+counts[d]).
    order = np.argsort(owner, kind="stable")
    rank_in_part = np.empty(ne, dtype=np.int64)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank_in_part[order] = np.arange(ne) - start[owner[order]]
    glid_of_orig = owner.astype(np.int64) * L + rank_in_part
    orig_of_glid = np.full(ndev * L, -1, dtype=np.int32)
    orig_of_glid[glid_of_orig] = np.arange(ne, dtype=np.int32)

    # Local adjacency encoding per face.
    nb = face_adj
    nb_owner = np.where(nb >= 0, owner[np.clip(nb, 0, ne - 1)], -1)
    nb_glid = np.where(nb >= 0, glid_of_orig[np.clip(nb, 0, ne - 1)], -1)
    same = nb_owner == owner[:, None]
    local_adj = np.where(
        nb < 0,
        -1,
        np.where(same, nb_glid - owner[:, None].astype(np.int64) * L,
                 -(nb_glid + 2)),
    ).astype(np.float64)
    # Padding rows have no crossing faces (zero normals) and are never
    # entered.
    table = np.zeros((ndev * L, WALK_TABLE_WIDTH), dtype=np.float64)
    table[:, WALK_TABLE_ADJ] = -1.0
    table[glid_of_orig, WALK_TABLE_NORMALS] = normals.reshape(ne, 12)
    table[glid_of_orig, WALK_TABLE_OFFSETS] = offsets
    table[glid_of_orig, WALK_TABLE_ADJ] = local_adj
    return MeshPartition(
        ndev=ndev, nelems=ne, L=L, owner=owner,
        glid_of_orig=torch.as_tensor(glid_of_orig.astype(np.int32),
                                     device=device),
        orig_of_glid=torch.as_tensor(orig_of_glid, device=device),
        table=torch.as_tensor(table, dtype=dtype, device=device),
    )


# ---------------------------------------------------------------------------
# Migration
# ---------------------------------------------------------------------------

def _default_state(cap: int, like: Dict[str, torch.Tensor]):
    """Dead-slot values of every state row."""
    d = {}
    for k, v in like.items():
        if k == "alive":
            d[k] = torch.zeros((cap,), dtype=torch.bool, device=v.device)
        elif k == "done":
            d[k] = torch.ones((cap,), dtype=torch.bool, device=v.device)
        elif k in ("pending", "pid"):
            d[k] = torch.full((cap,), -1, dtype=v.dtype, device=v.device)
        else:
            d[k] = torch.zeros((cap,) + tuple(v.shape[1:]), dtype=v.dtype,
                               device=v.device)
    return d


def migrate(part_L: int, nparts: int, cap_per_block: int,
            state: Dict[str, torch.Tensor]):
    """Ship paused particles (pending >= 0) to the block owning their
    target element; everyone else stays in its block's slot range.

    Each slot's destination is ``target * cap_per_block + rank`` with
    ``rank`` its stable rank among the slots of the same target, the
    JAX package's exact permutation. Returns ``(new_state, overflow)``;
    on overflow (some block received more particles than its slots) the
    OLD state is returned unchanged, so the caller can stop over intact
    state."""
    cap = state["pid"].shape[0]
    dev = state["pid"].device
    slot_part = torch.arange(cap, device=dev) // cap_per_block
    pending = state["pending"].long()
    alive = state["alive"]
    target = torch.where(pending >= 0, pending // part_L, slot_part)
    # Dead slots rank after every real group and are dropped.
    key = torch.where(alive, target, torch.full_like(target, nparts))
    rank = counting_ranks(key, nparts + 1).long()
    live = key < nparts
    if bool((live & (rank >= cap_per_block)).any()):
        return state, True
    src = live.nonzero().squeeze(1)
    dest_slot = (key * cap_per_block + rank)[src]
    new_state = _default_state(cap, state)
    for k, v in state.items():
        new_state[k][dest_slot] = v[src]
    # Migrated particles resume inside their new block's local mesh.
    arrived = new_state["pending"] >= 0
    new_state["lelem"] = torch.where(
        arrived, new_state["pending"] % part_L, new_state["lelem"]
    ).to(torch.int32)
    new_state["pending"] = torch.where(
        arrived, torch.full_like(new_state["pending"], -1),
        new_state["pending"],
    )
    return new_state, False


def _locate_chunk(table: torch.Tensor, valid: torch.Tensor,
                  pts: torch.Tensor, tol: float) -> torch.Tensor:
    """Local element row containing each point, or -1 (the half-space
    test over the block tables)."""
    L = table.shape[0]
    return locate_chunk_by_planes(
        table[:, WALK_TABLE_NORMALS].reshape(L * 4, 3),
        table[:, WALK_TABLE_OFFSETS], valid, pts, tol,
    )


# ---------------------------------------------------------------------------
# Round-driving engine
# ---------------------------------------------------------------------------

class PartitionedEngine:
    """Owns the partitioned particle state on one device and drives
    walk/migrate rounds. ``cap = nparts * cap_per_block`` slots; block b
    owns slots [b*cap_per_block, (b+1)*cap_per_block); ``pid`` tracks
    each slot's caller-visible particle index (-1 = dead slot)."""

    def __init__(
        self,
        mesh: TetMesh,
        num_particles: int,
        *,
        capacity_factor: float = 1.5,
        tol: float,
        max_iters: int,
        max_rounds: int = 64,
        check_found_all: bool = True,
        vmem_walk_max_elems: Optional[int] = None,
    ):
        if vmem_walk_max_elems is None:
            raise NotImplementedError(
                "the partitioned engine without walk_vmem_max_elems runs "
                f"the gather walk, which is not ported yet "
                f"({ROADMAP_GATHER_BLOCKS})"
            )
        self.check_found_all = check_found_all
        self.n = int(num_particles)
        self.device = mesh.device
        bound = effective_vmem_bound(vmem_walk_max_elems, mesh.dtype,
                                     mesh.device)
        self.part = build_partition(mesh, derive_blocks_per_chip(
            mesh.nelems, 1, block_elems_bound(bound)
        ))
        self.nparts = self.part.ndev
        cap_b = int(-(-self.n // self.nparts) * capacity_factor + 1)
        if self.nparts > 1:
            # The JAX engine rounds the per-block capacity up to whole
            # particle tiles; kept so the slot layouts agree.
            cap_b = -(-cap_b // W_TILE_DEFAULT) * W_TILE_DEFAULT
        self.cap_per_block = cap_b
        self.cap = self.nparts * cap_b
        self.tol = tol
        self.max_iters = max_iters
        self.max_rounds = max_rounds
        self.last_walk_rounds = 0
        self.n_lost = 0
        dtype, dev = mesh.dtype, mesh.device
        self.flux_padded = torch.zeros((self.nparts * self.part.L,),
                                       dtype=dtype, device=dev)
        self._valid = self.part.orig_of_glid >= 0
        pid = torch.full((self.cap,), -1, dtype=torch.int32, device=dev)
        pid[: self.n] = torch.arange(self.n, dtype=torch.int32, device=dev)
        alive = pid >= 0
        self.state = {
            "x": torch.zeros((self.cap, 3), dtype=dtype, device=dev),
            "lelem": torch.zeros((self.cap,), dtype=torch.int32, device=dev),
            "pending": torch.full((self.cap,), -1, dtype=torch.int32,
                                  device=dev),
            "pid": pid,
            "alive": alive,
            "done": ~alive,
            "exited": torch.zeros((self.cap,), dtype=torch.bool, device=dev),
            # Source point in no element: excluded from every walk.
            "lost": torch.zeros((self.cap,), dtype=torch.bool, device=dev),
            "dest": torch.zeros((self.cap, 3), dtype=dtype, device=dev),
            "fly": torch.zeros((self.cap,), dtype=torch.int8, device=dev),
            "w": torch.zeros((self.cap,), dtype=dtype, device=dev),
        }

    @property
    def blocks_per_chip(self) -> int:
        return self.nparts

    # -- staged input routing -------------------------------------------
    def _by_pid(self, arr_n: torch.Tensor, fill) -> torch.Tensor:
        """Route a caller-order [n,...] array to current slots via pid."""
        pid = self.state["pid"]
        v = arr_n[pid.long().clamp(0, self.n - 1)]
        mask = pid >= 0
        fill = torch.as_tensor(fill, dtype=v.dtype, device=v.device)
        return torch.where(mask[:, None] if v.dim() == 2 else mask, v, fill)

    def _migrate(self, st):
        st, overflow = migrate(self.part.L, self.nparts, self.cap_per_block,
                               st)
        if overflow:
            self.state = st
            raise RuntimeError(OVERFLOW_MESSAGE)
        return st

    # -- localization ----------------------------------------------------
    def _locate_points(self, pts_n: torch.Tensor) -> torch.Tensor:
        """[n] padded glid per point (``nparts*L`` = in no element)."""
        rows = self.nparts * self.part.L
        c = min(2048, max(8, (1 << 23) // max(rows, 1)), self.n)
        le = torch.cat([
            _locate_chunk(self.part.table, self._valid, pts_n[i:i + c],
                          self.tol)
            for i in range(0, self.n, c)
        ])
        return torch.where(le >= 0, le, torch.full_like(le, rows))

    def localize(self, dest_n: torch.Tensor) -> bool:
        """CopyInitialPosition: point location, then every particle is
        placed in the block owning its element. A source point in no
        element makes its particle ``lost`` (excluded from transport,
        element id -1). Returns whether every point was found."""
        glid = self._locate_points(dest_n)
        found = glid < self.nparts * self.part.L
        st = dict(self.state)
        st["x"] = self._by_pid(dest_n, 0.0)
        pend = self._by_pid(torch.where(found, glid, -1), -1)
        st["pending"] = torch.where(st["alive"], pend, st["pending"]).to(
            torch.int32
        )
        st["lost"] = st["alive"] & (st["pending"] < 0)
        st["done"] = ~st["alive"]
        st["exited"] = torch.zeros_like(st["exited"])
        st = self._migrate(st)
        st["done"] = torch.ones_like(st["done"])
        st["pending"] = torch.full_like(st["pending"], -1)
        self.state = st
        self.n_lost = int((~found).sum())
        if self.check_found_all and self.n_lost:
            print(
                f"[WARNING] {self.n_lost} source points lie in no mesh "
                "element; their particles are excluded from transport"
            )
        return self.n_lost == 0

    def _revive_lost(self, origins_n: torch.Tensor) -> None:
        """Re-locate lost particles whose resampled origin lies inside
        the mesh; they rejoin transport from that origin."""
        glid = self._locate_points(origins_n)
        st = dict(self.state)
        pend = self._by_pid(
            torch.where(glid < self.nparts * self.part.L, glid, -1), -1
        )
        revive = st["lost"] & (pend >= 0)
        st["x"] = torch.where(revive[:, None], self._by_pid(origins_n, 0.0),
                              st["x"])
        st["pending"] = torch.where(revive, pend, -1).to(torch.int32)
        st["lost"] = st["lost"] & ~revive
        st = self._migrate(st)
        st["pending"] = torch.full_like(st["pending"], -1)
        self.state = st
        self.n_lost = int(st["lost"].sum())

    # -- phases ----------------------------------------------------------
    def _round(self, st, tally: bool):
        x, lelem, done, exited, pending, _, _ = vmem_walk_local(
            self.part.table, st["x"], st["lelem"], st["dest"], st["fly"],
            st["w"], st["done"], st["exited"],
            self.flux_padded if tally else None,
            tally=tally, tol=self.tol, max_iters=self.max_iters,
            blocks=self.nparts,
        )
        return dict(st, x=x, lelem=lelem, done=done, exited=exited,
                    pending=pending)

    def _run_phase(self, tally: bool) -> bool:
        """One walk/migrate phase: a walk round, then migrate->walk
        rounds while particles are paused, at most ``max_rounds`` walk
        rounds in all. Returns whether every particle finished."""
        st = dict(self.state)
        st["done"] = ~st["alive"] | (st["fly"] == 0)
        # Per-walk flag: a particle that left the domain last move but
        # flies again must not carry a stale True.
        st["exited"] = torch.zeros_like(st["exited"])
        # Non-flying particles hold position: dest <- x.
        st["dest"] = torch.where((st["fly"] == 1)[:, None], st["dest"],
                                 st["x"])
        st = self._round(st, tally)
        rounds = 1
        while rounds < self.max_rounds and bool((st["pending"] >= 0).any()):
            st = self._round(self._migrate(st), tally)
            rounds += 1
        self.state = st
        self.last_walk_rounds = rounds
        return not bool((~st["done"]).any())

    def move(self, origins_n: Optional[torch.Tensor], dests_n: torch.Tensor,
             fly_n: torch.Tensor, w_n: torch.Tensor) -> bool:
        """Full (origins given) or continue-mode (None) tallied move.
        Returns whether every particle finished both phases."""
        if origins_n is not None and self.n_lost:
            self._revive_lost(origins_n)
        st = self.state
        st["fly"] = self._by_pid(fly_n, 0).to(torch.int8)
        # Lost particles never fly: an undefined start element must not
        # produce tallies.
        st["fly"] = torch.where(st["lost"], torch.zeros_like(st["fly"]),
                                st["fly"])
        st["w"] = self._by_pid(w_n, 0.0)
        ok_a = True
        if origins_n is not None:
            # Phase A: relocate to origins, weights zeroed (cpp:105).
            st["dest"] = self._by_pid(origins_n, 0.0)
            st["w"] = torch.zeros_like(st["w"])
            self.state = st
            ok_a = self._run_phase(tally=False)
            st = self.state
            # Re-route the real weights by pid: phase-A migrations may
            # have moved every slot.
            st["w"] = self._by_pid(w_n, 0.0)
        st["dest"] = self._by_pid(dests_n, 0.0)
        self.state = st
        ok_b = self._run_phase(tally=True)
        return ok_a and ok_b

    # -- outputs ---------------------------------------------------------
    def _order(self) -> torch.Tensor:
        """Slot order returning caller-visible particle order."""
        pid = self.state["pid"].long()
        key = torch.where(pid >= 0, pid, torch.full_like(pid, self.cap + 1))
        return torch.sort(key, stable=True).indices[: self.n]

    def positions(self) -> np.ndarray:
        return self.state["x"][self._order()].cpu().numpy()

    def elem_ids(self) -> np.ndarray:
        """Original element id per particle; -1 for lost particles."""
        o = self._order()
        slot = torch.arange(self.cap, device=self.device)
        glid = (slot // self.cap_per_block) * self.part.L \
            + self.state["lelem"].long()
        orig = self.part.orig_of_glid[glid[o]]
        return torch.where(self.state["lost"][o], -1, orig).cpu().numpy()

    def flux_original(self) -> torch.Tensor:
        return self.part.flux_to_original(self.flux_padded)
