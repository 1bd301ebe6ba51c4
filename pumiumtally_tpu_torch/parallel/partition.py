"""Partitioned mesh: element blocks + particle migration, on one device
or across a ``DeviceMesh`` (port of ``pumiumtally_tpu/parallel/partition.py``).

- **Ownership**: recursive coordinate bisection (RCB) of element
  centroids into ``nparts`` balanced blocks, the JAX package's exact
  code, so block ids and the renumbering match it element for element;
  ``placement="pod_rcb"`` bisects across hosts first
  (``pod_rcb_partition``).
- **Block tables**: elements renumbered so each block is contiguous and
  padded to a common length L; the packed walk table is rebuilt with
  LOCAL adjacency: a local id, -1 for the domain boundary, or
  -(glid+2) for a neighbour in another block (glid = block*L + local).
  Past the float dtype's exact-id range (or with ``force_split_adj``)
  the adjacency moves to an int32 sidecar ``adj_int [nparts*L, 4]`` and
  the table's adjacency lanes stay 0. With ``table_dtype="bfloat16"``
  the blocks carry the two-tier tables instead: ``table`` is the bf16
  select tier and ``table_hi`` the per-face refinement tier, whose adj
  lane holds the local encoding (never a sidecar).
- **Devices**: with a ``device_mesh`` of ``ndev`` shards there are
  ``ndev * blocks_per_chip`` blocks; shard d owns slots
  ``[d*cap_per_chip, (d+1)*cap_per_chip)`` and holds only its blocks'
  rows of the tables, the flux, the bank and the sidecar, on its own
  device (logical shards on one device hold views of one copy). Without
  a mesh the engine is one shard on the mesh's device.
- **Walk**: each round runs, on each shard, a block walk that pauses a
  particle at a block face with ``pending = glid``: W1
  (ops/vmem_walk.py) where every block fits ``walk_vmem_max_elems`` on
  the packed tables, W2 (ops/pallas_walk.py, ``walk_kernel="pallas"``)
  on the two-tier tables, and otherwise the gather block walk (kernel
  W4, csrc/gather_block_walk.cu): one block a shard when no bound is
  set (the default configuration), or the gather sub-split. The engine
  walks in place only the not-done slots (``walk_local_list``): a later
  round over a work list that the migrate hands it, so a round costs
  its front, not its blocks' capacity; ``walk_local`` keeps the JAX
  function's contract. The occupied-block list (kept per block from
  round to round) counts the blocks dispatched.
- **Migration**: paused particles move to their target block's slot
  range by a stable rank per target (``migrate``), or, with
  ``cap_frontier``, only the paused rows move through a slab of that
  many slots (``_frontier_migrate_impl``: stayers keep their slots); a
  front larger than the slab falls back to the full migrate. Across
  the shards of one process the rows are explicit copies from one
  shard's tensor to another's (``migrate_shards``,
  ``frontier_migrate_shards``); a mesh that spans processes migrates
  through the collective of parallel/distributed.py (the gathered keys
  and a ring of packed slabs, bitwise the same), its only path there.
  The engine picks by the mesh, not by ``migrate_collective``: within
  one process the row copies are the faster of the two on the card
  (PERF.md, PR 18), so the JAX package's knob is accepted and changes
  nothing. A round whose targets overflow a block's
  slots keeps the old state (overflow-safe commit) and the recovery
  ladder takes over (``PartitionedEngine._recover_overflow``): a
  full-migrate retry, a capacity escalation sized by demand, the
  terminal escalation, then the engine is poisoned.

Localization is point location against the block tables (the
full-precision refinement tier when two-tier), as in the JAX engine:
each shard locates against its own blocks and the lowest claiming glid
wins across shards. Scoring (``scoring=`` a ``ScoringSpec``): the
engine owns a padded lane bank ``score_padded [nparts*L*B*S]`` beside
``flux_padded``, and two state rows per slot, the bin offset ``sbin``
and the factor row ``sfac``, staged each move through ``move(sbin_n=,
sfac_n=)`` and migrated with their particles. Tallying rounds thread
the bank through W2's or W4's scoring lanes (the float32 tables score
through W4, as the JAX engine scores them through ``walk_local``);
localization and phase A never score.

The round loop runs on the host: it reads each round's paused and
not-done counts (and, for the gather sub-split, the occupied-block
list) before it decides what to launch, so the engine checks a round's
overflow on the host and runs the ladder itself.

With ``deterministic=True`` (the facades' ``CheckpointPolicy``, or a
service session) the tallying rounds of W4, W1 and W2 commit flux and
lanes through the deterministic commit (ops/det_commit.py), so a
campaign's flux is the same bits from run to run on the card.

The sentinel's straggler rung (``retry_stragglers``: the interrupted
tallying phase resumed at multiplied step and round budgets;
``declare_lost_stragglers``; ``caller_order_view`` for the audit) is the
JAX engine's.

Left out against the JAX engine (ROADMAP.md): the compaction cascade
(each particle walks to completion or to a pause; TallyConfig's cascade
knobs are accepted and inert).
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from pumiumtally_tpu_torch import kernels
from pumiumtally_tpu_torch.mesh.tetmesh import (
    WALK_PLANE_WIDTH,
    WALK_TABLE_ADJ,
    WALK_TABLE_LO_NORMALS,
    WALK_TABLE_LO_OFFSETS,
    WALK_TABLE_LO_WIDTH,
    WALK_TABLE_NORMALS,
    WALK_TABLE_OFFSETS,
    WALK_TABLE_WIDTH,
    TetMesh,
    exact_id_limit,
)
from pumiumtally_tpu_torch.ops.bucketize import counting_ranks, partition_perm
from pumiumtally_tpu_torch.ops.geometry import locate_chunk_by_planes
from pumiumtally_tpu_torch.ops.pallas_walk import pallas_walk_local
from pumiumtally_tpu_torch.ops.vmem_walk import (
    W_TILE_DEFAULT,
    effective_vmem_bound,
    vmem_walk_local,
)
from pumiumtally_tpu_torch.ops.det_commit import walk_and_commit, workspace
from pumiumtally_tpu_torch.parallel.device import mesh_axis
from pumiumtally_tpu_torch.parallel.distributed import (
    ShardComm,
    derive_host_counts,
)
from pumiumtally_tpu_torch.ops.walk import (
    PlainRecords,
    check_scoring,
    count_mask,
    eff_weight,
    refine_face_hi,
    score_pair,
    select_faces_lo,
)
from pumiumtally_tpu_torch.utils.profiling import phase_timer

OVERFLOW_MESSAGE = (
    "partitioned-mode chip capacity exceeded during particle "
    "migration; raise TallyConfig.capacity_factor"
)

LADDER_EXHAUSTED_MESSAGE = (
    "partitioned-mode chip capacity exceeded during particle migration "
    "and the recovery ladder (full-capacity retry, one host-side "
    "capacity escalation) could not place the particles; the engine is "
    "poisoned — resume from checkpoint with a larger "
    "TallyConfig.capacity_factor"
)

_N0 = WALK_TABLE_NORMALS.start
_O0 = WALK_TABLE_OFFSETS.start
_A0 = WALK_TABLE_ADJ.start


# ---------------------------------------------------------------------------
# Host-side partition build
# ---------------------------------------------------------------------------

PLACEMENTS = ("linear", "pod_rcb")


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


def pod_rcb_partition(centroids: np.ndarray, nparts: int,
                      host_parts) -> np.ndarray:
    """owner[E] via HIERARCHICAL recursive coordinate bisection: across
    the hosts first (``host_parts``: each host's part count, in device
    order), each cut sized in proportion to the parts on either side,
    then flat RCB within each host's region, so cross-host adjacency is
    confined to where the host geometry cuts the mesh. The split
    arithmetic is ``rcb_partition``'s; where every host boundary aligns
    with the flat recursion (two equal hosts) the two are equal."""
    host_parts = [int(h) for h in host_parts]
    if any(h < 1 for h in host_parts) or sum(host_parts) != nparts:
        raise ValueError(
            f"host_parts {host_parts} must be positive and sum to the "
            f"{nparts}-part partition"
        )
    ne = centroids.shape[0]
    owner = np.zeros(ne, dtype=np.int32)

    def split(idx: np.ndarray, nl: int, nr: int):
        c = centroids[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        at = int(round(len(idx) * nl / (nl + nr)))
        return idx[order[:at]], idx[order[at:]]

    def rec_parts(idx: np.ndarray, first_part: int, np_h: int) -> None:
        if np_h == 1:
            owner[idx] = first_part
            return
        nl = np_h // 2
        li, ri = split(idx, nl, np_h - nl)
        rec_parts(li, first_part, nl)
        rec_parts(ri, first_part + nl, np_h - nl)

    def rec_hosts(idx: np.ndarray, hosts, first_part: int) -> None:
        if len(hosts) == 1:
            rec_parts(idx, first_part, hosts[0])
            return
        nh = len(hosts) // 2
        left, right = hosts[:nh], hosts[nh:]
        li, ri = split(idx, sum(left), sum(right))
        rec_hosts(li, left, first_part)
        rec_hosts(ri, right, first_part + sum(left))

    rec_hosts(np.arange(ne), host_parts, 0)
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
    # [ndev*L, 20] packed rows, adjacency local-encoded (or 0 when the
    # sidecar holds it); or, two-tier, the [ndev*L, 16] bf16 select
    # rows (adjacency then rides table_hi).
    table: torch.Tensor
    # Two-tier refinement tier: [ndev*L*4, 5] (plane, local-encoded adj)
    # rows, row glid*4 + f; None for the packed layout.
    table_hi: Optional[torch.Tensor] = None
    # [ndev*L, 4] int32 local-encoded adjacency when the padded ids do
    # not fit the float dtype (or forced); None otherwise.
    adj_int: Optional[torch.Tensor] = None
    # Directed cross-part face census [K, 3] (part a, part b, faces a
    # exposes to b): the input of the cross-host byte model.
    remote_faces: Optional[np.ndarray] = None

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


def resolve_block_kernel(block_kernel: str, table_dtype: str) -> str:
    """The block kernel a partition runs: "vmem" (W1, packed tables),
    "gather" (W4) or "pallas" (W2, two-tier only). bf16 tables with the
    vmem kernel reroute to the gather block walk, logged, as in the JAX
    package (W1 has no two-tier form)."""
    if block_kernel == "pallas":
        if table_dtype != "bfloat16":
            raise ValueError(
                "block_kernel='pallas' needs the bf16 two-tier tables "
                f"(got table_dtype={table_dtype!r}); build the "
                "partition with table_dtype='bfloat16'"
            )
        return block_kernel
    if table_dtype == "bfloat16" and block_kernel == "vmem":
        from pumiumtally_tpu_torch.utils.logging import get_logger

        get_logger().info(
            "bfloat16 tables with block_kernel='vmem': the vmem "
            "kernel has no two-tier lowering — rerouting blocked "
            "walks to the gather kernel (set walk_kernel='pallas' "
            "for the two-tier one-kernel walk, ops/pallas_walk.py)"
        )
        return "gather"
    return block_kernel


def block_elems_bound(
    vmem_walk_max_elems: Optional[int], table_dtype: str = "float32"
) -> Optional[int]:
    """The per-block element bound the sub-split derives blocks from:
    the knob counts f32-table bytes (80 B/elem), so the 32 B/elem bf16
    select tier gets twice the elements, as in the JAX package."""
    if vmem_walk_max_elems is None:
        return None
    if table_dtype == "bfloat16":
        return int(vmem_walk_max_elems) * 2
    return int(vmem_walk_max_elems)


def build_partition(mesh: TetMesh, ndev: int,
                    dtype: Optional[torch.dtype] = None,
                    force_split_adj: bool = False,
                    table_dtype: str = "float32",
                    placement: str = "linear",
                    hosts=None) -> MeshPartition:
    """Partition ``mesh`` into ``ndev`` contiguous padded element blocks
    on the mesh's device. ``table_dtype="bfloat16"`` builds the two-tier
    block tables. ``force_split_adj`` stores the adjacency in the int32
    sidecar even where the float dtype holds the ids exactly (the
    automatic choice past that range). ``placement``: "linear" (flat
    RCB) or "pod_rcb" (``pod_rcb_partition`` over ``hosts``, the
    per-host part counts in device order)."""
    if placement not in PLACEMENTS:
        raise ValueError(
            f"placement must be one of {PLACEMENTS}, got {placement!r}"
        )
    dtype = mesh.dtype if dtype is None else dtype
    two_tier = table_dtype == "bfloat16"
    if two_tier and force_split_adj:
        raise ValueError(
            "force_split_adj is incompatible with table_dtype="
            "'bfloat16': two-tier partitions carry adjacency in the "
            "refinement rows' float lane, never in an int32 sidecar"
        )
    device = mesh.device
    coords = mesh.coords.double().cpu().numpy()
    tet2vert = mesh.tet2vert.cpu().numpy()
    face_adj = mesh.face_adj.cpu().numpy()
    normals = mesh.face_normals.double().cpu().numpy()
    offsets = mesh.face_offsets.double().cpu().numpy()
    ne = tet2vert.shape[0]
    centroids = coords[tet2vert].mean(axis=1)
    if placement == "pod_rcb":
        if hosts is None:
            raise ValueError(
                "placement='pod_rcb' needs hosts= (per-host part "
                "counts in device order)"
            )
        owner = pod_rcb_partition(centroids, ndev, hosts)
    else:
        owner = rcb_partition(centroids, ndev)
    counts = np.bincount(owner, minlength=ndev)
    L = int(counts.max())
    # Remote faces encode -(glid+2) with glid < ndev*L: that magnitude
    # must survive the float table; past it the sidecar holds the ids.
    ids_fit = ndev * L + 2 < exact_id_limit(dtype)
    if two_tier and not ids_fit:
        raise ValueError(
            f"two-tier partition tables store local-encoded neighbor "
            f"ids in {str(dtype).removeprefix('torch.')} refinement rows; "
            f"{ndev}x{L} padded elements exceed the exact-id range "
            "(use walk_table_dtype='float32', whose int32 adjacency "
            "sidecar has no ceiling)"
        )
    split_adj = force_split_adj or not ids_fit
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
    # Directed cross-part face census: how many element faces part a
    # exposes to part b.
    cross = (nb >= 0) & (nb_owner != owner[:, None])
    pair_key = owner[:, None].astype(np.int64) * ndev + nb_owner
    pair, nfaces = np.unique(pair_key[cross], return_counts=True)
    remote_faces = np.stack([pair // ndev, pair % ndev, nfaces], axis=1)
    same = nb_owner == owner[:, None]
    local_adj = np.where(
        nb < 0,
        -1,
        np.where(same, nb_glid - owner[:, None].astype(np.int64) * L,
                 -(nb_glid + 2)),
    ).astype(np.float64)
    # Padding rows have no crossing faces (zero normals), adjacency -1,
    # and are never entered.
    adj_full = np.full((ndev * L, 4), -1.0)
    adj_full[glid_of_orig] = local_adj
    table_hi = adj_int = None
    if two_tier:
        lo = np.zeros((ndev * L, WALK_TABLE_LO_WIDTH), dtype=np.float64)
        lo[glid_of_orig, WALK_TABLE_LO_NORMALS] = normals.reshape(ne, 12)
        lo[glid_of_orig, WALK_TABLE_LO_OFFSETS] = offsets
        hi = np.zeros((ndev * L, 4, WALK_PLANE_WIDTH), dtype=np.float64)
        hi[:, :, 4] = adj_full
        hi[glid_of_orig, :, 0:3] = normals
        hi[glid_of_orig, :, 3] = offsets
        table = torch.as_tensor(lo).to(device=device, dtype=torch.bfloat16)
        table_hi = torch.as_tensor(
            hi.reshape(ndev * L * 4, WALK_PLANE_WIDTH), dtype=dtype,
            device=device,
        )
    else:
        packed = np.zeros((ndev * L, WALK_TABLE_WIDTH), dtype=np.float64)
        packed[glid_of_orig, WALK_TABLE_NORMALS] = normals.reshape(ne, 12)
        packed[glid_of_orig, WALK_TABLE_OFFSETS] = offsets
        if split_adj:
            adj_int = torch.as_tensor(adj_full.astype(np.int32),
                                      device=device)
        else:
            packed[:, WALK_TABLE_ADJ] = adj_full
        table = torch.as_tensor(packed, dtype=dtype, device=device)
    return MeshPartition(
        ndev=ndev, nelems=ne, L=L, owner=owner,
        glid_of_orig=torch.as_tensor(glid_of_orig.astype(np.int32),
                                     device=device),
        orig_of_glid=torch.as_tensor(orig_of_glid, device=device),
        table=table, table_hi=table_hi, adj_int=adj_int,
        remote_faces=remote_faces,
    )


# ---------------------------------------------------------------------------
# The gather block walk W4
# ---------------------------------------------------------------------------

def exit_cols_x0(row, s, x0, d0, tol, adj=None):
    """One packed crossing for every row of a lock-step batch, the JAX
    ``walk_local`` form: ``b = off - n.x0`` against the round's start
    ``x0`` (W0's and W1's ``advance_cols`` use ``off - n.dest + a``,
    which rounds differently). ``row`` is [N,20]; ``adj`` the [N,4]
    int32 sidecar rows, or None to read the row's adjacency lanes.
    Returns (s_exit, next_elem), s_exit not yet clamped to 1; the
    operation order of csrc/gather_block_walk.cu."""
    one = torch.ones((), dtype=s.dtype, device=s.device)
    inf = torch.full((), float("inf"), dtype=s.dtype, device=s.device)
    s_exit = nxt = None
    for f in range(4):
        nx, ny, nz = (row[:, _N0 + 3 * f + c] for c in range(3))
        a = nx * d0[:, 0] + ny * d0[:, 1] + nz * d0[:, 2]
        n_x0 = nx * x0[:, 0] + ny * x0[:, 1] + nz * x0[:, 2]
        b = row[:, _O0 + f] - n_x0
        crossing = a * (one - s) > tol
        s_f = torch.where(crossing, b / torch.where(crossing, a, one), inf)
        s_f = torch.maximum(s_f, s)
        nb = adj[:, f] if adj is not None else row[:, _A0 + f].to(torch.int32)
        if f == 0:
            s_exit, nxt = s_f, nb
        else:
            better = s_f < s_exit  # strict: the first minimal face wins
            s_exit = torch.where(better, s_f, s_exit)
            nxt = torch.where(better, nb, nxt)
    return s_exit, nxt


def walk_local_plain(table, x, lelem, dest, flying, weight, done, exited,
                     flux, *, tally: bool, tol: float, max_iters: int,
                     adj_int=None, table_hi=None, scoring=None,
                     deterministic=False):
    """W4's plain PyTorch version: the JAX ``walk_local`` on ONE block
    (its no-cascade form), a masked lock-step loop.

    ``table`` is the block's [L,20] packed rows, or its [L,16] bf16
    select rows when ``table_hi`` (its [L*4,5] refinement rows) is
    given; ``adj_int`` the block's [L,4] int32 sidecar rows (packed
    only). A crossing into another block (adjacency <= -2) pauses the
    particle with ``pending = -nxt-2`` and ``lelem`` unchanged; -1 ends
    it as exited. ``flux`` ([L], None when not tallying) and the scoring
    bank are updated IN PLACE. ``iters`` is the most steps any particle
    took (the JAX value may exceed it by up to ``cond_every``). Returns
    ``(x, lelem, done, exited, pending, flux, iters)``, plus the bank
    when ``scoring = (kinds, bank [L*stride], bin_off, fac)``.
    ``deterministic``: flux and lanes committed as the deterministic
    commit's records (ops/det_commit.py), the same values in the same
    order as ``index_add_``."""
    return _walk_loop(table, x, lelem, dest, flying, weight, done, exited,
                      flux, tally=tally, tol=tol, max_iters=max_iters,
                      adj_int=adj_int, table_hi=table_hi, scoring=scoring,
                      deterministic=deterministic)


def _walk_loop(table, x, lelem, dest, flying, weight, done, exited, flux, *,
               tally, tol, max_iters, adj_int, table_hi, scoring, base=None,
               lane_end=None, deterministic=False):
    """``walk_local_plain``'s loop. ``base`` (int64 [n], None: 0) offsets
    each slot's rows into stacked blocks, so that one lock-step loop
    walks the slots of several blocks (each slot's steps are its own,
    and so is the order of the additions into each element's flux);
    ``lane_end`` ([n], None: the bank's size) is each slot's DROP limit,
    the end of its block's bank slice."""
    n = x.shape[0]
    if tally and flux is None:
        raise ValueError("a tallying walk needs a flux tensor")
    if scoring is not None:
        stride = check_scoring("walk_local_plain", scoring,
                               flux if tally else None, n)
        kinds, bank, bin_off, fac = scoring
        limit = (torch.full((n,), bank.numel(), device=x.device)
                 if lane_end is None else lane_end)
        limit = limit.repeat_interleave(len(kinds))
    x0 = x
    d0 = dest - x0
    eff_w = eff_weight(d0, flying, weight) if tally else None
    tol_t = torch.tensor(tol, dtype=x.dtype, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    # Two-tier: the ray's destination rebuilt from the invariants, as the
    # JAX walk hands it to the tier helpers.
    dest_c = x0 + d0 if table_hi is not None else None
    s = torch.zeros((n,), dtype=x.dtype, device=x.device)
    lelem = lelem.to(torch.int32).clone()
    done = done.clone()
    exited = exited.clone()
    pending = torch.full((n,), -1, dtype=torch.int32, device=x.device)
    # The deterministic commit's records: keyed (row or lane, step, the
    # slot's place in this call), W4's kDet order.
    recs = (PlainRecords(), PlainRecords()) if deterministic and tally \
        else None
    pid = torch.arange(n, device=x.device)
    iters = 0
    while iters < max_iters:
        active = ~done & (pending < 0)
        if not bool(active.any()):
            break
        rows = lelem.long() if base is None else base + lelem.long()
        if table_hi is not None:
            s_sel, f_exit = select_faces_lo(table, s, rows, dest_c, d0, tol_t)
            s_exit, nxt = refine_face_hi(table_hi, s, rows, f_exit, s_sel,
                                         dest_c, d0, tol_t)
        else:
            s_exit, nxt = exit_cols_x0(
                table[rows], s, x0, d0, tol_t,
                None if adj_int is None else adj_int[rows])
        reached = s_exit >= one
        s_new = torch.where(reached, one, s_exit)
        hit_boundary = ~reached & (nxt == -1)
        goes_remote = ~reached & (nxt <= -2)
        if tally:
            contrib = torch.where(active, (s_new - s) * eff_w,
                                  torch.zeros_like(s))
            if recs is None:
                flux.index_add_(0, rows, contrib)
            else:
                recs[0].add(rows, iters, pid, contrib)
            if scoring is not None:
                # A pause at a block face commits its crossing: counted
                # once across the migration.
                crossed = (active & ~reached).to(contrib.dtype)
                sidx, sval = score_pair(kinds, stride, rows, bin_off, fac,
                                        contrib, crossed)
                keep = sidx < limit
                if recs is None:
                    bank.index_add_(0, sidx[keep], sval[keep])
                else:
                    recs[1].add(sidx, iters,
                                pid.repeat_interleave(len(kinds)), sval,
                                keep)
        moving = active & ~reached & ~hit_boundary & ~goes_remote
        lelem = torch.where(moving, nxt, lelem)
        s = torch.where(active, s_new, s)
        pending = torch.where(active & goes_remote, -nxt - 2, pending)
        done = done | (active & (reached | hit_boundary))
        exited = exited | (active & hit_boundary)
        iters += 1
    if recs is not None:
        recs[0].commit(flux)
        if scoring is not None:
            recs[1].commit(bank)
    # A particle that reached its destination commits dest bit-exactly;
    # everyone else commits x0 + s*d0 from the round's start x0.
    x_fin = torch.where((done & ~exited)[:, None], dest,
                        x0 + s[:, None] * d0)
    out = (x_fin, lelem, done, exited, pending, flux,
           torch.tensor(iters, dtype=torch.int32, device=x.device))
    return out + (bank,) if scoring is not None else out


def _block_layout(table, table_hi, adj_int, n: int, blocks: int):
    """Validate the stacked-block layout; returns (L, slots a block)."""
    rows = table.shape[0]
    if n % blocks or rows % blocks:
        raise ValueError(
            f"blocked walk needs slots and table rows divisible into "
            f"{blocks} blocks, got S={n}, rows={rows}"
        )
    if table_hi is not None:
        if adj_int is not None:
            raise ValueError("a two-tier walk carries its adjacency in the "
                             "refinement rows: no int32 sidecar")
        if tuple(table_hi.shape) != (rows * 4, WALK_PLANE_WIDTH):
            raise ValueError(
                f"table_hi has shape {tuple(table_hi.shape)}, needs "
                f"{(rows * 4, WALK_PLANE_WIDTH)}"
            )
    return rows // blocks, n // blocks


# The slot rows W4 writes in place (``walk_local_list``).
WALKED_ROWS = ("x", "lelem", "done", "exited")
# Slots a CUDA block of W4's list build covers (csrc/gather_block_walk.cu
# LIST_CHUNK): the chunk counts' scratch holds one int32 a chunk.
WORK_CHUNK = 4096


def work_list_plain(done: torch.Tensor,
                    walked: Optional[torch.Tensor] = None):
    """``work_list`` in plain PyTorch."""
    todo = ~done
    if walked is not None:
        todo = (todo.view(walked.numel(), -1) & walked[:, None]).view(-1)
    order = torch.sort((~todo).to(torch.uint8), stable=True).indices
    return order.to(torch.int32), todo.sum(dtype=torch.int32).view(1)


def work_list(done: torch.Tensor, walked: Optional[torch.Tensor] = None):
    """A later round's work list built from ``done`` (after a full
    migrate): ``(work, n_work)``, the int32 [S] slot ids with the
    not-done slots (of the blocks that ``walked``, bool [blocks],
    marks; None: every block) first, in slot order, and their count as
    an int32 [1] tensor on the same device. No host sync: the length
    stays on the device.

    CUDA tensors launch W4's list build (``gather_work_list``, two
    passes over the flags); CPU tensors run ``work_list_plain``."""
    if not done.is_cuda:
        return work_list_plain(done, walked)
    n = done.shape[0]
    cb = n // walked.numel() if walked is not None else max(n, 1)
    kernels.check_aligned("work_list", [("done", done)], 4)
    kernels.check_cuda_args("work_list", done.device, [
        ("done", done, torch.bool, (n,)),
        ("walked", walked, torch.bool, (None,)),
    ])
    if walked is not None and n % walked.numel():
        raise ValueError(f"work_list: {n} slots do not split into "
                         f"{walked.numel()} blocks")
    # The list, its length, then the chunk counts, in one buffer.
    buf = torch.empty((n + 1 + -(-n // WORK_CHUNK),), dtype=torch.int32,
                      device=done.device)
    work, n_work = buf[:n], buf[n:n + 1]
    if n:
        p = kernels.ptr
        kernels.launch("gather_work_list", torch.float32, done.device,
                       p(done), p(walked), p(buf[n + 1:]), p(work),
                       p(n_work), n, cb)
    else:
        n_work.zero_()
    return work, n_work


def _walk_list_cuda(table, x, lelem, dest, flying, weight, done, exited,
                    flux, work, *, tally, tol, max_iters, adj_int,
                    table_hi, scoring, blocks, counts, deterministic=False):
    dev, dt = x.device, x.dtype
    n = x.shape[0]
    L, cb = _block_layout(table, table_hi, adj_int, n, blocks)
    two_tier = table_hi is not None
    if two_tier:
        entry = "gather_block_walk_twotier"
        tables = [("table_lo", table, torch.bfloat16,
                   (blocks * L, WALK_TABLE_LO_WIDTH)),
                  ("table_hi", table_hi, dt, (blocks * L * 4,
                                              WALK_PLANE_WIDTH))]
    else:
        entry = "gather_block_walk"
        tables = [("table", table, dt, (blocks * L, WALK_TABLE_WIDTH)),
                  ("adj_int", adj_int, torch.int32, (blocks * L, 4))]
    ids, n_work = work if work is not None else (None, None)
    kernels.check_aligned("walk_local", [tables[0][:2], tables[1][:2]])
    kernels.check_cuda_args("walk_local", dev, tables + [
        ("x", x, dt, (n, 3)),
        ("lelem", lelem, torch.int32, (n,)),
        ("dest", dest, dt, (n, 3)),
        ("flying", flying, torch.int8, (n,)),
        ("weight", weight, dt, (n,)),
        ("done", done, torch.bool, (n,)),
        ("exited", exited, torch.bool, (n,)),
        ("flux", flux if tally else None, dt, (blocks * L,)),
        ("work", ids, torch.int32, (None,)),
        ("n_work", n_work, torch.int32, (1,)),
        ("counts", counts, torch.int32, (1,)),
    ])
    score_args = ()
    if scoring is not None:
        stride = check_scoring("walk_local", scoring,
                               flux if tally else None, n)
        kinds, bank, bin_off, fac = scoring
        kernels.check_cuda_args("walk_local", dev, [
            ("bank", bank, dt, (blocks * L * stride,)),
            ("bin_off", bin_off, torch.int32, (n,)),
            ("fac", fac, dt, (n, len(kinds))),
        ])
        if L * stride >= 2**31:
            raise ValueError("walk_local: a block's bank of 2**31 lanes or "
                             "more does not fit the kernel's int32 lanes")
        entry += "_scored"
        score_args = (kernels.ptr(bank), kernels.ptr(bin_off),
                      kernels.ptr(fac), stride, len(kinds),
                      count_mask(kinds))
    # Slots the walk does not take keep their carries and get pending -1.
    pending = torch.full((n,), -1, dtype=torch.int32, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    cap = n if ids is None else ids.numel()
    if cap and cb:
        p = kernels.ptr

        def launch(det=None):
            kernels.launch(
                entry, dt, dev, *score_args,
                *(p(t) for _, t, _, _ in tables),
                p(x), p(lelem), p(dest), p(flying), p(weight), p(done),
                p(exited), p(flux if tally else None), p(pending), p(iters),
                p(counts), p(ids), p(n_work), cap, L, cb, float(tol),
                int(max_iters), int(bool(tally)), det,
            )

        if deterministic and tally:
            # W4 walks the slot rows in place: they (and pending, iters,
            # counts) are put back for a redo.
            walk_and_commit("walk_local", launch, cap, flux, scoring,
                            (x, lelem, done, exited, pending, iters,
                             counts), workspace(deterministic))
        else:
            launch()
    res = (x, lelem, done, exited, pending, flux, iters)
    return res + (scoring[1],) if scoring is not None else res


def walk_local_list(table, x, lelem, dest, flying, weight, done, exited,
                    flux, work=None, *, tally: bool, tol: float,
                    max_iters: int, adj_int=None, table_hi=None,
                    scoring=None, blocks: int = 1,
                    counts: Optional[torch.Tensor] = None,
                    deterministic=False):
    """The gather block walk, IN PLACE, over a work list: ``x``,
    ``lelem``, ``done`` and ``exited`` of the slots it walks are written
    into those tensors, and a slot it does not walk is not written.
    ``work`` is ``(ids, n_work)``: int32 slot ids, each at most once, of
    which the first ``n_work`` (an int32 [1] tensor, read on the device)
    walk as ``walk_local`` walks them, done or not (a slot off the list
    is not read either); None walks every slot that is not done (a
    round's first walk, whose front is every such slot). Returns
    ``walk_local``'s tuple: the four tensors, a new ``pending`` (-1
    where not walked), ``flux``, ``iters`` (the most steps of a walked
    slot), plus the bank when scoring. ``counts`` (int32 [1], optional)
    gets the number of slots walked added to it.

    The engine's round walk: a phase's first round walks without a
    list; a later round takes the frontier migrate's arrivals' list, or
    ``work_list`` after a full migrate. CUDA tensors launch kernel W4
    (csrc/gather_block_walk.cu); CPU tensors run
    ``walk_local_list_plain``. ``deterministic``: the deterministic
    commit (ops/det_commit.py: W4's kDet instantiation and DC), for a
    tallying walk: True, or the ``DetWorkspace`` whose record streams it
    reuses; its records are ordered by step, then by the slot's place in
    the list (its slot without one)."""
    blocks = int(blocks)
    if tally and flux is None:
        raise ValueError("a tallying walk needs a flux tensor")
    fn = walk_local_list_plain
    if x.is_cuda:
        fn = _walk_list_cuda
    elif x.device.type != "cpu":
        raise ValueError(
            f"walk_local runs on CUDA or CPU tensors, not {x.device}")
    return fn(table, x, lelem, dest, flying, weight, done, exited, flux,
              work, tally=tally, tol=tol, max_iters=max_iters,
              adj_int=adj_int, table_hi=table_hi, scoring=scoring,
              blocks=blocks, counts=counts, deterministic=deterministic)


def walk_local_list_plain(table, x, lelem, dest, flying, weight, done,
                          exited, flux, work=None, *, tally: bool,
                          tol: float, max_iters: int, adj_int=None,
                          table_hi=None, scoring=None, blocks: int = 1,
                          counts: Optional[torch.Tensor] = None,
                          deterministic=False):
    """``walk_local_list`` in plain PyTorch: the walked slots walk as
    ``walk_local_blocks_plain`` walks a block's slots (one lock-step
    loop, rows offset to their blocks, scoring lanes dropped at their
    block's bank slice end) and are written back in place."""
    n = x.shape[0]
    L, cb = _block_layout(table, table_hi, adj_int, n, blocks)
    if work is None:
        sel = (~done).nonzero().squeeze(1)
    else:
        sel = work[0][: int(work[1])].long()
    slot_block = sel // max(cb, 1)
    sc = lane_end = None
    if scoring is not None:
        kinds, bank, bin_off, fac = scoring
        stride = bank.numel() // (blocks * L)
        sc = (kinds, bank, bin_off[sel], fac[sel])
        lane_end = (slot_block + 1) * L * stride
    r = _walk_loop(table, x[sel], lelem[sel], dest[sel], flying[sel],
                   weight[sel], done[sel], exited[sel], flux, tally=tally,
                   tol=tol, max_iters=max_iters, adj_int=adj_int,
                   table_hi=table_hi, scoring=sc, base=slot_block * L,
                   lane_end=lane_end, deterministic=deterministic)
    pending = torch.full((n,), -1, dtype=torch.int32, device=x.device)
    for t, v in zip((x, lelem, done, exited, pending), r):
        t[sel] = v
    if counts is not None:
        counts += sel.numel()
    out = (x, lelem, done, exited, pending, flux, r[6])
    return out + (scoring[1],) if scoring is not None else out


def _walk_local_cuda(table, x, lelem, dest, flying, weight, done, exited,
                     flux, *, adj_int, table_hi, blocks, block_ids, **kw):
    """``walk_local`` on the card: W4 in place on the outputs, over every
    not-done slot, or with ``block_ids`` over the work list of the
    listed blocks' not-done slots; a walked block's done slots are
    written back as the plain walk writes them (``dest`` unless
    exited), every other slot keeps its carries."""
    _, cb = _block_layout(table, table_hi, adj_int, x.shape[0], blocks)
    keep = done & ~exited
    work = None
    if block_ids is not None:
        walked = torch.zeros((blocks,), dtype=torch.bool, device=x.device)
        walked[block_ids.long()] = True
        keep = (keep.view(blocks, cb) & walked[:, None]).view(-1)
        work = work_list(done, walked)
    return _walk_list_cuda(
        table, torch.where(keep[:, None], dest, x),
        lelem.to(torch.int32).clone(), dest, flying, weight, done.clone(),
        exited.clone(), flux, work, adj_int=adj_int, table_hi=table_hi,
        blocks=blocks, counts=None, **kw)


def walk_local(table, x, lelem, dest, flying, weight, done, exited, flux,
               *, tally: bool, tol: float, max_iters: int, adj_int=None,
               table_hi=None, scoring=None, blocks: int = 1,
               block_ids: Optional[torch.Tensor] = None,
               deterministic=False):
    """The gather block walk over ``blocks`` stacked blocks: returns
    ``(x, lelem, done, exited, pending, flux, iters)``, plus the bank
    when scoring (the JAX ``walk_local``'s tuple).

    ``table`` (and ``adj_int`` / ``table_hi``) stack ``blocks`` blocks
    of L rows (``table_hi``: 4L rows); the S slots are grouped by block
    (``S // blocks`` each) with block-local ``lelem``; ``flux`` is
    [blocks*L] and ``scoring``'s bank [blocks*L*stride], both updated IN
    PLACE (``walk_local_plain`` states the walk). ``block_ids`` (int32,
    on the slots' device) lists the blocks to walk, the occupied-block
    list of the gather sub-split; None walks all. A block not listed
    keeps its slots' x, lelem, done and exited and gets pending -1, and
    its flux is untouched. ``iters`` is the largest over the walked
    blocks. There is no compaction cascade: each particle walks to
    completion or to a pause.

    CUDA tensors launch kernel W4 (csrc/gather_block_walk.cu; counted
    as ``gather_block_walk``, ``gather_block_walk_twotier`` and their
    ``_scored`` instantiations) once, over the work list of the listed
    blocks' not-done slots (``work_list``), into new tensors; CPU
    tensors run ``walk_local_plain`` block by block.
    ``deterministic``: the deterministic commit (``walk_local_list``)."""
    blocks = int(blocks)
    if tally and flux is None:
        raise ValueError("a tallying walk needs a flux tensor")
    if x.is_cuda:
        return _walk_local_cuda(
            table, x, lelem, dest, flying, weight, done, exited, flux,
            tally=tally, tol=tol, max_iters=max_iters, adj_int=adj_int,
            table_hi=table_hi, scoring=scoring, blocks=blocks,
            block_ids=block_ids, deterministic=deterministic)
    if x.device.type != "cpu":
        raise ValueError(
            f"walk_local runs on CUDA or CPU tensors, not {x.device}")
    if blocks == 1 and block_ids is None:
        return walk_local_plain(table, x, lelem, dest, flying, weight, done,
                                exited, flux, tally=tally, tol=tol,
                                max_iters=max_iters, adj_int=adj_int,
                                table_hi=table_hi, scoring=scoring,
                                deterministic=deterministic)
    return walk_local_blocks_plain(
        table, x, lelem, dest, flying, weight, done, exited, flux,
        tally=tally, tol=tol, max_iters=max_iters, adj_int=adj_int,
        table_hi=table_hi, scoring=scoring, blocks=blocks,
        block_ids=block_ids, deterministic=deterministic)


def walk_local_blocks_plain(table, x, lelem, dest, flying, weight, done,
                            exited, flux, *, tally: bool, tol: float,
                            max_iters: int, adj_int=None, table_hi=None,
                            scoring=None, blocks: int = 1,
                            block_ids: Optional[torch.Tensor] = None,
                            deterministic=False):
    """``walk_local``'s stacked-block contract in plain PyTorch: the
    slots of the listed blocks walk as ``walk_local_plain`` walks each
    block's slice (in one lock-step loop, rows offset to their block,
    scoring lanes dropped at their block's bank slice end); the other
    slots are kept with pending -1. The wrapper's CPU path, and W4's
    plain version on the card."""
    n = x.shape[0]
    L, cb = _block_layout(table, table_hi, adj_int, n, blocks)
    slot_block = torch.arange(n, device=x.device) // max(cb, 1)
    if block_ids is None:
        sel = torch.arange(n, device=x.device)
    else:
        walked = torch.zeros((blocks,), dtype=torch.bool, device=x.device)
        walked[block_ids.long()] = True
        sel = walked[slot_block].nonzero().squeeze(1)
    sc = lane_end = None
    if scoring is not None:
        kinds, bank, bin_off, fac = scoring
        stride = bank.numel() // (blocks * L)
        sc = (kinds, bank, bin_off[sel], fac[sel])
        lane_end = (slot_block[sel] + 1) * L * stride
    r = _walk_loop(table, x[sel], lelem[sel], dest[sel], flying[sel],
                   weight[sel], done[sel], exited[sel], flux, tally=tally,
                   tol=tol, max_iters=max_iters, adj_int=adj_int,
                   table_hi=table_hi, scoring=sc, base=slot_block[sel] * L,
                   lane_end=lane_end, deterministic=deterministic)
    res = [x.clone(), lelem.to(torch.int32).clone(), done.clone(),
           exited.clone(),
           torch.full((n,), -1, dtype=torch.int32, device=x.device)]
    for k in range(5):
        res[k][sel] = r[k]
    out = (*res, flux, r[6])
    return out + (scoring[1],) if scoring is not None else out


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
    OLD state is returned unchanged, so the caller recovers from intact
    state."""
    cap = state["pid"].shape[0]
    # Dead slots rank after every real group and are dropped.
    key = _shard_keys(part_L, nparts, cap_per_block, 0, state)
    rank = counting_ranks(key, nparts + 1).long()
    live = key < nparts
    if bool((live & (rank >= cap_per_block)).any()):
        return state, True
    src = live.nonzero().squeeze(1)
    dest_slot = (key * cap_per_block + rank)[src]
    new_state = _default_state(cap, state)
    for k, v in state.items():
        new_state[k][dest_slot] = v[src]
    _arrive(new_state, part_L)
    return new_state, False


def _occupancy_counts(done: torch.Tensor, nparts: int) -> torch.Tensor:
    """[nparts] int32 count of not-done slots per block: the
    occupied-block list's ground truth, one full scan."""
    return (~done).view(nparts, -1).sum(dim=1, dtype=torch.int32)


@dataclasses.dataclass
class _FrontierPlan:
    """The frontier migrate's bookkeeping over the [cap] lanes: the slab
    (its global source slots, the valid prefix, the rows' pending glids
    and destination slots, ``cap`` where not valid), the overflow, the
    [nparts] departure/arrival counts and the next round's work list."""

    src: torch.Tensor
    valid: torch.Tensor
    pend_slab: torch.Tensor
    dest_slab: Optional[torch.Tensor]
    overflow: bool
    dep: torch.Tensor
    arr: torch.Tensor
    work: Optional[torch.Tensor]
    n_work: Optional[torch.Tensor]


def _frontier_plan(part_L: int, nparts: int, cap_per_block: int,
                   cap_frontier: int, pending: torch.Tensor,
                   alive: torch.Tensor, done: torch.Tensor) -> _FrontierPlan:
    """``_frontier_migrate_impl``'s placement from the [cap] pending,
    alive and done lanes alone (the collective replays it on every shard
    from the gathered lanes)."""
    cap = pending.shape[0]
    dev = pending.device
    pending = pending.long()
    moving = pending >= 0
    iota = torch.arange(cap, device=dev)
    slot_part = iota // cap_per_block
    # Stable slab compaction: pending rows front-packed in slot order,
    # then the not-done stayers (the work list's tail), then the rest.
    order = torch.where(moving, 0, torch.where(done, 2, 1))
    perm, counts, _ = partition_perm(order, 3)
    src = perm[:cap_frontier]
    valid = torch.arange(src.shape[0], device=dev) < counts[0]
    # Free slots: never occupied, plus those the departures vacate.
    fint = ((~alive) | moving).long()
    excl = torch.cumsum(fint, 0) - fint
    part_base = excl.view(nparts, cap_per_block)[:, 0]
    free_rank = excl - part_base[slot_part]
    n_free = fint.view(nparts, cap_per_block).sum(dim=1)
    free_list = torch.full((cap,), cap, dtype=torch.long, device=dev)
    is_free = fint == 1
    free_list[(slot_part * cap_per_block + free_rank)[is_free]] = \
        iota[is_free]
    # Arrival destinations: stable within-target rank over the slab.
    pend_slab = pending[src]
    tgt = torch.clamp(pend_slab // part_L, 0, nparts - 1)
    key = torch.where(valid, tgt, torch.full_like(tgt, nparts))
    rank = counting_ranks(key, nparts + 1).long()
    overflow = bool((valid & (rank >= n_free[tgt])).any())
    dep = torch.bincount(torch.where(valid, src // cap_per_block,
                                     torch.full_like(src, nparts)),
                         minlength=nparts + 1)[:nparts].to(torch.int32)
    arr = torch.bincount(key, minlength=nparts + 1)[:nparts].to(torch.int32)
    if overflow:
        return _FrontierPlan(src, valid, pend_slab, None, True, dep, arr,
                             None, None)
    dest_slab = torch.where(
        valid, free_list[tgt * cap_per_block
                         + torch.clamp(rank, max=cap_per_block - 1)],
        torch.full_like(src, cap))
    work = perm.to(torch.int32)
    n_move = int(valid.sum())
    work[:n_move] = dest_slab[:n_move].to(torch.int32)
    n_work = (counts[:1] + counts[1:2]).to(torch.int32)
    return _FrontierPlan(src, valid, pend_slab, dest_slab, False, dep, arr,
                         work, n_work)


def _frontier_migrate_impl(part_L: int, nparts: int, cap_per_block: int,
                           cap_frontier: int,
                           state: Dict[str, torch.Tensor]):
    """Frontier-slab migration (the JAX function's placement, row for
    row): the pending rows are compacted, in slot order, into a slab of
    ``cap_frontier`` rows, and only they move. Stayer-fixed placement:
    non-pending slots keep their slots, departing slots reset to the
    dead-slot defaults, and arrivals take their target block's free
    slots in ascending slot order, arrivals ordered by source slot.
    The overflow condition is ``migrate``'s: a block overflows iff its
    stayers and arrivals exceed its slots. The caller guarantees that
    the front fits the slab (``_migrate_round``).

    Returns ``(state, overflow, departures, arrivals, work)``: the
    [nparts] int32 counts feeding ``_update_occupancy``, and the next
    round's work list ``(work, n_work)`` (``walk_local_list``): the
    arrivals' slots, in slab order, then the stayers that are not done
    (slots a walk stopped at ``max_iters``), in slot order; its length
    stays on the device. On overflow the OLD state comes back unchanged,
    with no list."""
    p = _frontier_plan(part_L, nparts, cap_per_block, cap_frontier,
                       state["pending"], state["alive"], state["done"])
    if p.overflow:
        return state, True, p.dep, p.arr, None
    dest = p.dest_slab[p.valid]
    src_v = p.src[p.valid]
    defaults = _default_state(int(src_v.shape[0]), state)
    new_state = {}
    for k, v in state.items():
        rows = v[src_v]
        if k == "lelem":
            # Arrivals resume inside their new block's local mesh.
            rows = (p.pend_slab[p.valid] % part_L).to(v.dtype)
        elif k == "pending":
            rows = torch.full_like(rows, -1)
        # Clear before place: an arrival may take a vacated slot.
        nv = v.clone()
        nv[src_v] = defaults[k]
        nv[dest] = rows
        new_state[k] = nv
    return new_state, False, p.dep, p.arr, (p.work, p.n_work)


# ---------------------------------------------------------------------------
# Migration across the shards of a device mesh
# ---------------------------------------------------------------------------

def _pack_state(state: Dict[str, torch.Tensor]):
    """The state as one float matrix (the working-dtype rows) and one
    int32 matrix (every other row, widened), the rows a migration
    collective ships; ``layout`` unpacks them (``_unpack_state``)."""
    fl, il, layout = [], [], []
    fcols = icols = 0
    for k, v in state.items():
        tail = tuple(v.shape[1:])
        ncols = int(np.prod(tail)) if tail else 1
        rows = v.reshape(v.shape[0], ncols)
        if torch.is_floating_point(v):
            layout.append((k, "f", fcols, ncols, v.dtype, tail))
            fl.append(rows)
            fcols += ncols
        else:
            layout.append((k, "i", icols, ncols, v.dtype, tail))
            il.append(rows.to(torch.int32))
            icols += ncols
    return torch.cat(fl, dim=1), torch.cat(il, dim=1), layout


def _unpack_state(fpack: torch.Tensor, ipack: torch.Tensor, layout):
    """``_pack_state``'s inverse: every row in its own dtype and shape
    (bit for bit: the int32 widening is exact)."""
    out = {}
    for k, kind, start, ncols, dtype, tail in layout:
        src = fpack if kind == "f" else ipack
        out[k] = src[:, start:start + ncols].to(dtype).reshape(
            (src.shape[0],) + tail).contiguous()
    return out


def split_state(state: Dict[str, torch.Tensor], devices) -> list:
    """A [cap] state dict as ``len(devices)`` shard dicts of consecutive
    slots, each on its device (own copies)."""
    ndev = len(devices)
    out = []
    for i, d in enumerate(devices):
        out.append({k: torch.chunk(v, ndev)[i].to(d, copy=True)
                    for k, v in state.items()})
    return out


def assemble_state(shards: list, device) -> Dict[str, torch.Tensor]:
    """The shard dicts of one process as one [cap] state on ``device``."""
    return {k: torch.cat([s[k].to(device) for s in shards])
            for k in shards[0]}


def _shard_work(work: torch.Tensor, n_work: torch.Tensor, base: int,
                n_loc: int):
    """One shard's part of a global work list: the entries in its slot
    range, in the list's order, as local ``(ids, n_work)``."""
    w = work[: int(n_work)].long()
    ids = (w[(w >= base) & (w < base + n_loc)] - base).to(torch.int32)
    return ids, torch.tensor([ids.numel()], dtype=torch.int32,
                             device=ids.device)


def _shard_keys(part_L: int, nparts: int, cap_per_block: int, base: int,
                st: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A shard's counting-rank keys: each live slot's target block
    (``nparts``: a dead slot)."""
    n = st["pid"].shape[0]
    slot_part = (base + torch.arange(n, device=st["pid"].device)) \
        // cap_per_block
    pending = st["pending"].long()
    target = torch.where(pending >= 0, pending // part_L, slot_part)
    return torch.where(st["alive"], target, torch.full_like(target, nparts))


def _arrive(st: Dict[str, torch.Tensor], part_L: int) -> None:
    """Migrated particles resume inside their new block's local mesh."""
    arrived = st["pending"] >= 0
    st["lelem"] = torch.where(arrived, st["pending"] % part_L,
                              st["lelem"]).to(torch.int32)
    st["pending"] = torch.where(arrived, torch.full_like(st["pending"], -1),
                                st["pending"])


def migrate_shards(part_L: int, nparts: int, cap_per_block: int,
                   shards: list):
    """``migrate`` over the shards of one process: the keys gathered on
    the first shard's device, the global stable ranks, then each moving
    row copied from its shard's tensor into its destination shard's (one
    copy a key and shard pair). Returns ``(shards, overflow)``, the old
    shards on overflow."""
    ndev = len(shards)
    n_loc = shards[0]["pid"].shape[0]
    cap = ndev * n_loc
    home = shards[0]["pid"].device
    keys = torch.cat([_shard_keys(part_L, nparts, cap_per_block, i * n_loc,
                                  st).to(home)
                      for i, st in enumerate(shards)])
    rank = counting_ranks(keys, nparts + 1).long()
    live = keys < nparts
    if bool((live & (rank >= cap_per_block)).any()):
        return shards, True
    dest = torch.where(live, keys * cap_per_block + rank,
                       torch.full_like(keys, cap))
    out = [_default_state(n_loc, st) for st in shards]
    for s, st in enumerate(shards):
        d_s = dest[s * n_loc:(s + 1) * n_loc]
        t_s = d_s // n_loc
        for t in range(ndev):
            sel = (t_s == t).nonzero().squeeze(1)
            if sel.numel() == 0:
                continue
            dev_t = out[t]["pid"].device
            dst = (d_s[sel] - t * n_loc).to(dev_t)
            src = sel.to(st["pid"].device)
            for k, v in st.items():
                out[t][k][dst] = v[src].to(dev_t)
    for st in out:
        _arrive(st, part_L)
    return out, False


def frontier_migrate_shards(part_L: int, nparts: int, cap_per_block: int,
                            cap_frontier: int, shards: list):
    """``_frontier_migrate_impl`` over the shards of one process: the
    plan from the lanes gathered on the first shard's device, each
    shard's departures cleared, then each arrival copied from its source
    shard's tensor into its destination shard's. Returns ``(shards,
    overflow, departures, arrivals, works)``, ``works`` each shard's next
    work list (``_shard_work``)."""
    ndev = len(shards)
    n_loc = shards[0]["pid"].shape[0]
    home = shards[0]["pid"].device
    lanes = {k: torch.cat([st[k].to(home) for st in shards])
             for k in ("pending", "alive", "done")}
    p = _frontier_plan(part_L, nparts, cap_per_block, cap_frontier,
                       lanes["pending"], lanes["alive"], lanes["done"])
    if p.overflow:
        return shards, True, p.dep, p.arr, None
    src = p.src[p.valid]
    dest = p.dest_slab[p.valid]
    lelem_new = p.pend_slab[p.valid] % part_L
    out = []
    for t, st in enumerate(shards):
        dev_t = st["pid"].device
        base = t * n_loc
        gone = src[(src >= base) & (src < base + n_loc)] - base
        defaults = _default_state(int(gone.numel()), st)
        gone = gone.to(dev_t)
        nv = {}
        for k, v in st.items():
            nv[k] = v.clone()
            nv[k][gone] = defaults[k]
        into = (dest >= base) & (dest < base + n_loc)
        for s, ss in enumerate(shards):
            sb = s * n_loc
            m = into & (src >= sb) & (src < sb + n_loc)
            if not bool(m.any()):
                continue
            dst = (dest[m] - base).to(dev_t)
            rows_src = (src[m] - sb).to(ss["pid"].device)
            for k, v in ss.items():
                rows = v[rows_src]
                if k == "lelem":
                    rows = lelem_new[m].to(v.dtype)
                elif k == "pending":
                    rows = torch.full_like(rows, -1)
                nv[k][dst] = rows.to(dev_t)
        out.append(nv)
    works = [_shard_work(p.work.to(st["pid"].device), p.n_work, i * n_loc,
                         n_loc) for i, st in enumerate(shards)]
    return out, False, p.dep, p.arr, works


def _migrate_round(part_L: int, nparts: int, cap_per_block: int,
                   cap_frontier: Optional[int],
                   state: Dict[str, torch.Tensor], n_pending: int):
    """One in-loop migration round: the frontier slab when the front
    fits ``cap_frontier``, else the full ``migrate``. None keeps the
    full migrate every round, 0 forces it (the testing hook). Returns
    ``(state, overflow, departures, arrivals, fellback, work)``, zero
    counts on full-migrate rounds; ``work`` is the next round's work
    list (``walk_local_list``): the frontier migrate's, or after a full
    migrate ``work_list`` of the new state; None on overflow."""
    z = torch.zeros((nparts,), dtype=torch.int32,
                    device=state["pid"].device)
    fellback = cap_frontier is None or n_pending > cap_frontier
    if fellback:
        st, ovf = migrate(part_L, nparts, cap_per_block, state)
        return st, ovf, z, z, True, None if ovf else work_list(st["done"])
    st, ovf, dep, arr, work = _frontier_migrate_impl(
        part_L, nparts, cap_per_block, cap_frontier, state)
    return st, ovf, dep, arr, False, work


def _update_occupancy(nparts: int, cap_frontier: Optional[int],
                      state: Dict[str, torch.Tensor], n_act: torch.Tensor,
                      dep: torch.Tensor, arr: torch.Tensor,
                      fellback: bool) -> torch.Tensor:
    """Next round's per-block not-done counts: departure/arrival deltas
    after a frontier round, a full recount after a full migrate (which
    re-compacts every block)."""
    if not cap_frontier or fellback:
        return _occupancy_counts(state["done"], nparts)
    return n_act - dep + arr


def _grow_state(state: Dict[str, torch.Tensor], old_cb: int, new_cb: int,
                nparts: int) -> Dict[str, torch.Tensor]:
    """Re-home every slot of an ``nparts``-block state into a larger
    per-block capacity: block d's slot r moves from ``d*old_cb + r`` to
    ``d*new_cb + r``, the new tail slots take the dead-slot defaults. A
    relabeling only: every particle keeps its state bitwise."""
    dev = state["pid"].device
    iota = torch.arange(nparts * old_cb, device=dev)
    new_slot = (iota // old_cb) * new_cb + iota % old_cb
    out = _default_state(nparts * new_cb, state)
    for k, v in state.items():
        out[k][new_slot] = v
    return out


@dataclasses.dataclass
class PhaseProfile:
    """Component budget of profiled walk/migrate phases
    (``PartitionedEngine.move(..., profile=...)``).

    Sections are fenced wall seconds (the device is synchronised before
    each section's closing stamp): ``walk_s`` the per-round block walks,
    ``migrate_s`` the frontier/full migration, ``occupancy_s`` the
    occupied-block bookkeeping, ``bookkeeping_s`` the phase's set-up and
    commit. ``frontier_sizes`` records each migration round's crossing
    front; ``fallback_rounds`` counts rounds whose front overflowed
    ``cap_frontier`` into the full migrate (0 when it is unset). A
    profiled phase runs the rounds of a plain one; only the fences
    differ."""

    walk_s: float = 0.0
    migrate_s: float = 0.0
    occupancy_s: float = 0.0
    bookkeeping_s: float = 0.0
    rounds: int = 0
    dispatches: int = 0
    fallback_rounds: int = 0
    cap_frontier: Optional[int] = None
    frontier_sizes: list = dataclasses.field(default_factory=list)

    @property
    def frontier_max(self) -> int:
        return max(self.frontier_sizes, default=0)

    @property
    def frontier_mean(self) -> float:
        if not self.frontier_sizes:
            return 0.0
        return float(sum(self.frontier_sizes) / len(self.frontier_sizes))

    def as_dict(self) -> dict:
        """Per-phase totals in ms plus per-round means and the frontier
        stats (the JAX package's keys)."""
        r = max(self.rounds, 1)
        return {
            "walk_ms": self.walk_s * 1e3,
            "migrate_ms": self.migrate_s * 1e3,
            "occupancy_ms": self.occupancy_s * 1e3,
            "bookkeeping_ms": self.bookkeeping_s * 1e3,
            "walk_ms_per_round": self.walk_s * 1e3 / r,
            "migrate_ms_per_round": self.migrate_s * 1e3 / r,
            "occupancy_ms_per_round": self.occupancy_s * 1e3 / r,
            "rounds": self.rounds,
            "dispatches": self.dispatches,
            "fallback_rounds": self.fallback_rounds,
            "cap_frontier": self.cap_frontier,
            "frontier_max": self.frontier_max,
            "frontier_mean": self.frontier_mean,
        }


def _locate_chunk(table: torch.Tensor, valid: torch.Tensor,
                  pts: torch.Tensor, tol: float) -> torch.Tensor:
    """Local element row containing each point, or -1 (the half-space
    test over the block tables)."""
    L = table.shape[0]
    return locate_chunk_by_planes(
        table[:, WALK_TABLE_NORMALS].reshape(L * 4, 3),
        table[:, WALK_TABLE_OFFSETS], valid, pts, tol,
    )


def _locate_chunk_hi(table_hi: torch.Tensor, valid: torch.Tensor,
                     pts: torch.Tensor, tol: float) -> torch.Tensor:
    """``_locate_chunk`` over the two-tier refinement tier: point
    location reads the full-precision planes (bf16 planes would misplace
    points near faces), whose per-face rows are the layout the
    half-space test wants."""
    L = table_hi.shape[0] // 4
    return locate_chunk_by_planes(
        table_hi[:, 0:3], table_hi[:, 3].reshape(L, 4), valid, pts, tol,
    )


# ---------------------------------------------------------------------------
# Round-driving engine
# ---------------------------------------------------------------------------

def engine_block_bound(mesh: TetMesh, vmem_walk_max_elems: Optional[int],
                       block_kernel: str, table_dtype: str,
                       scoring: bool = False):
    """(block kernel, block element bound) of an engine: "vmem" (W1) on
    the packed tables, its bound clamped to what W1's shared memory
    holds; "gather" (W4), also for bf16 tables with "vmem" and for a
    scoring engine with "vmem", and "pallas" (W2, two-tier), whose bound
    only sizes the blocks and is not clamped. No bound: one block."""
    if block_kernel not in ("vmem", "gather", "pallas"):
        raise ValueError(
            f"block_kernel must be 'vmem', 'gather' or 'pallas', "
            f"got {block_kernel!r}"
        )
    block_kernel = resolve_block_kernel(block_kernel, table_dtype)
    if scoring and block_kernel == "vmem":
        # W1 has no scoring lanes: the JAX engine scores through the
        # gather walk.
        block_kernel = "gather"
    if block_kernel != "vmem":
        return block_kernel, vmem_walk_max_elems
    return block_kernel, effective_vmem_bound(vmem_walk_max_elems,
                                              mesh.dtype, mesh.device)


def engine_partition(mesh: TetMesh, vmem_walk_max_elems: Optional[int],
                     block_kernel: str, table_dtype: str,
                     scoring: bool = False, ndev: int = 1,
                     placement: str = "linear",
                     host_chips=None) -> MeshPartition:
    """The partition an engine with these knobs builds for itself over
    ``ndev`` shards; the partitioned streaming facade builds it once for
    all its chunk engines (``PartitionedEngine(part=...)``).
    ``host_chips``: the per-host shard counts "pod_rcb" places over."""
    _, bound = engine_block_bound(mesh, vmem_walk_max_elems, block_kernel,
                                  table_dtype, scoring)
    bpc = derive_blocks_per_chip(mesh.nelems, ndev,
                                 block_elems_bound(bound, table_dtype))
    hosts = None
    if placement != "linear":
        hosts = [int(h) * bpc for h in (host_chips or (ndev,))]
    return build_partition(mesh, ndev * bpc, table_dtype=table_dtype,
                           placement=placement, hosts=hosts)


def _section(prof: Optional[PhaseProfile], field: str, devices):
    """``phase_timer`` into ``prof.<field>``, fenced on the engine's
    ``devices``; nothing without a profile."""
    if prof is None:
        return contextlib.nullcontext()
    return phase_timer(prof, field, fence=devices)


@dataclasses.dataclass
class _ShardTables:
    """One shard's rows of the partition, on its device."""

    table: torch.Tensor
    table_hi: Optional[torch.Tensor]
    adj_int: Optional[torch.Tensor]
    valid: torch.Tensor


def _on(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    """``t`` on ``device``: itself (a view) where it already is there."""
    if t is None or t.device == device:
        return t
    return t.to(device)


class PartitionedEngine:
    """Owns the partitioned particle state and drives walk/migrate
    rounds. ``cap = nparts * cap_per_block`` slots; block b owns slots
    [b*cap_per_block, (b+1)*cap_per_block); shard d of the device mesh
    (one shard on the mesh's device without one) owns its
    ``blocks_per_chip`` blocks, slots [d*cap_per_chip, (d+1)*cap_per_chip);
    ``pid`` tracks each slot's caller-visible particle index (-1 = dead
    slot)."""

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
        block_kernel: str = "vmem",
        table_dtype: str = "float32",
        part: Optional[MeshPartition] = None,
        scoring=None,
        cap_frontier: Optional[int] = None,
        deterministic=None,
        device_mesh=None,
        migrate_collective: bool = False,
        placement: str = "linear",
        placement_hosts=None,
    ):
        """``block_kernel`` and ``vmem_walk_max_elems`` as in
        ``engine_block_bound``. ``part``: a prebuilt partition (shared
        by several engines) whose tables fix the tier, as in the JAX
        engine; by default the engine builds its own
        (``engine_partition``). ``scoring``: a ``ScoringSpec`` (module
        docstring). ``cap_frontier``: the frontier slab's rows (clamped
        to the capacity; None: the full migrate every round, 0: the
        fallback every round). ``deterministic``: a ``DetWorkspace`` (the
        facades' with a ``CheckpointPolicy``) or True: the tallying
        rounds (W4, W1 or W2) commit through the deterministic commit
        (ops/det_commit.py). ``device_mesh``: a ``DeviceMesh`` whose
        shards each own ``blocks_per_chip`` blocks (JAX :1264-1352);
        ``migrate_collective``: the JAX package's knob, kept for its
        configurations; the migration path follows the mesh (module
        doc); ``placement`` / ``placement_hosts``:
        the ownership strategy ("linear" or "pod_rcb") and the per-host
        shard counts (default: the mesh's process boundaries)."""
        if device_mesh is not None:
            mesh_axis(device_mesh)  # fail fast: must be 1-D
        self.device_mesh = device_mesh
        self.ndev = 1 if device_mesh is None else device_mesh.size
        if part is not None:
            table_dtype = ("bfloat16" if part.table_hi is not None
                           else "float32")
        block_kernel, bound = engine_block_bound(
            mesh, vmem_walk_max_elems, block_kernel, table_dtype,
            scoring is not None)
        if placement not in PLACEMENTS:
            raise ValueError(
                f"placement must be one of {PLACEMENTS}, "
                f"got {placement!r}"
            )
        self.placement = placement
        if placement_hosts is not None:
            self.host_chips = tuple(int(h) for h in placement_hosts)
            if (any(h < 1 for h in self.host_chips)
                    or sum(self.host_chips) != self.ndev):
                raise ValueError(
                    f"placement_hosts {self.host_chips} must be "
                    f"positive chip counts summing to the "
                    f"{self.ndev}-device mesh"
                )
        elif device_mesh is not None:
            self.host_chips = derive_host_counts(device_mesh)
        else:
            self.host_chips = (1,)
        if part is None:
            part = engine_partition(mesh, vmem_walk_max_elems, block_kernel,
                                    table_dtype, scoring is not None,
                                    ndev=self.ndev, placement=placement,
                                    host_chips=self.host_chips)
        if part.ndev % self.ndev:
            raise ValueError(
                f"partition has {part.ndev} parts, not a multiple of the "
                f"{self.ndev}-device mesh"
            )
        self.part = part
        self.two_tier = part.table_hi is not None
        self.nparts = part.ndev
        self.blocks_per_chip = self.nparts // self.ndev
        bpc = self.blocks_per_chip
        self.block_kernel = block_kernel
        self.use_vmem_walk = (
            block_kernel == "vmem"  # bf16/scoring never resolve to vmem
            and bound is not None
            and part.L <= int(bound)
            and part.adj_int is None
            and not self.two_tier
        )
        if block_kernel == "pallas" and part.adj_int is not None:
            raise ValueError(
                "block_kernel='pallas' needs row-resident adjacency "
                "(the refinement tier's adj lane), but this partition "
                "carries the int-adjacency sidecar — rebuild without "
                "force_split_adj or use walk_kernel='gather'"
            )
        self.use_pallas_walk = block_kernel == "pallas"
        if bpc > 1 and not (
            self.use_vmem_walk or self.use_pallas_walk
        ) and block_kernel != "gather":
            raise ValueError(
                "sub-split partitions (blocks_per_chip > 1) with "
                "block_kernel='vmem' need the VMEM walk, but this "
                "configuration cannot use it (walk_vmem_max_elems "
                "unset/exceeded, or the mesh needs the int-adjacency "
                "sidecar). Set a satisfiable walk_vmem_max_elems, use "
                "walk_block_kernel='gather', or pass a partition with "
                "one part per device"
            )
        self.scoring = scoring
        self.deterministic = (None if not deterministic
                              else workspace(deterministic))
        self.score_stride = (0 if scoring is None
                             else scoring.n_bins * scoring.n_scores)
        self.check_found_all = check_found_all
        self.n = int(num_particles)
        self.device = mesh.device
        cap_b = int(-(-self.n // self.nparts) * capacity_factor + 1)
        if bpc > 1 and block_kernel in ("vmem", "pallas"):
            # The JAX engine rounds the per-block capacity of W1's and
            # W2's counterparts up to whole particle tiles (not the
            # gather sub-split's); kept so the slot layouts agree.
            cap_b = -(-cap_b // W_TILE_DEFAULT) * W_TILE_DEFAULT
        self.cap_per_block = cap_b
        self.cap_per_chip = bpc * cap_b
        self.cap = self.nparts * cap_b
        # A slab of cap rows is the full-capacity frontier migrate.
        self.cap_frontier = (None if cap_frontier is None
                             else max(0, min(int(cap_frontier), self.cap)))
        self.tol = tol
        self.max_iters = max_iters
        self.max_rounds = max_rounds
        # The overflow-recovery ladder's record and hooks: ``poisoned``
        # latches when the ladder is exhausted (the facades then refuse
        # every call); ``on_overflow_recovered(escalated)`` and
        # ``on_poisoned()`` are optional callbacks (the JAX facades'
        # sentinel record and safety save; the port's facades set the
        # first when a sentinel is armed).
        self.capacity_factor = float(capacity_factor)
        self.poisoned = False
        self.overflow_recoveries = 0
        self.capacity_escalations = 0
        self.on_overflow_recovered = None
        self.on_poisoned = None
        # Diagnostics of the most recent phase (``_set_diagnostics``).
        self.last_walk_rounds = 0
        self.last_block_dispatches = 0
        self.last_frontier_max = 0
        self.last_fallback_rounds = 0
        self._last_frontier_sum = 0
        self.n_lost = 0
        # The shards: their devices, this process's shard indices, and
        # each local shard's tables, flux, bank and slot state (None in
        # another process's places).
        if device_mesh is None:
            self.devices, self.local = (mesh.device,), (0,)
        else:
            self.devices, self.local = device_mesh.devices, device_mesh.local
        self.comm = None if device_mesh is None else ShardComm(device_mesh)
        # Kernel launches each shard's walks made, by entry
        # (``kernels.launch_counts`` differenced around each call).
        self.shard_launches = [dict() for _ in range(self.ndev)]
        dtype = mesh.dtype
        self._valid = self.part.orig_of_glid >= 0
        rows = bpc * part.L
        n_loc = self.cap_per_chip
        self._tables: List[Optional[_ShardTables]] = [None] * self.ndev
        self._flux: List[Optional[torch.Tensor]] = [None] * self.ndev
        self._bank: List[Optional[torch.Tensor]] = [None] * self.ndev
        self._st: List[Optional[Dict[str, torch.Tensor]]] = [None] * self.ndev
        for i in self.local:
            d = self.devices[i]
            sl = slice(i * rows, (i + 1) * rows)
            self._tables[i] = _ShardTables(
                table=_on(part.table[sl], d),
                table_hi=(None if part.table_hi is None else
                          _on(part.table_hi[4 * i * rows:4 * (i + 1) * rows],
                              d)),
                adj_int=None if part.adj_int is None else _on(
                    part.adj_int[sl], d),
                valid=_on(self._valid[sl], d))
            self._flux[i] = torch.zeros((rows,), dtype=dtype, device=d)
            # The owned scoring bank, in the padded-glid layout of the
            # flux; None with scoring off.
            if scoring is not None:
                self._bank[i] = torch.zeros((rows * self.score_stride,),
                                            dtype=dtype, device=d)
            slot = i * n_loc + torch.arange(n_loc, device=d)
            pid = torch.where(slot < self.n, slot,
                              torch.full_like(slot, -1)).to(torch.int32)
            alive = pid >= 0
            st = {
                "x": torch.zeros((n_loc, 3), dtype=dtype, device=d),
                "lelem": torch.zeros((n_loc,), dtype=torch.int32, device=d),
                "pending": torch.full((n_loc,), -1, dtype=torch.int32,
                                      device=d),
                "pid": pid,
                "alive": alive,
                "done": ~alive,
                "exited": torch.zeros((n_loc,), dtype=torch.bool, device=d),
                # Source point in no element: excluded from every walk.
                "lost": torch.zeros((n_loc,), dtype=torch.bool, device=d),
                "dest": torch.zeros((n_loc, 3), dtype=dtype, device=d),
                "fly": torch.zeros((n_loc,), dtype=torch.int8, device=d),
                "w": torch.zeros((n_loc,), dtype=dtype, device=d),
            }
            if scoring is not None:
                # Per-slot scoring rows migrate with their particles;
                # scoring-off engines never carry these keys.
                st["sbin"] = torch.zeros((n_loc,), dtype=torch.int32,
                                         device=d)
                st["sfac"] = torch.zeros((n_loc, scoring.n_scores),
                                         dtype=dtype, device=d)
            self._st[i] = st
        self.migrate_collective = bool(migrate_collective)
        self._build_collective_fns()

    # -- the shards ------------------------------------------------------
    @property
    def _w1_w2(self) -> bool:
        """Whether the rounds run W1 or W2 (else W4)."""
        return self.use_vmem_walk or self.use_pallas_walk

    @property
    def _multi(self) -> bool:
        return self.ndev > 1

    def _gather(self, parts: List[Optional[torch.Tensor]]) -> torch.Tensor:
        """The shards' tensors as one on the home device (mesh order)."""
        if not self._multi:
            return parts[0]
        return torch.cat(self.comm.all_gather(
            {i: parts[i] for i in self.local}))

    def _split(self, whole: torch.Tensor) -> list:
        out = [None] * self.ndev
        for i in self.local:
            out[i] = torch.chunk(whole, self.ndev)[i].to(self.devices[i],
                                                         copy=True)
        return out

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        """The [cap] slot state (assembled from the shards on the home
        device; with one shard, its own dict)."""
        if not self._multi:
            return self._st[0]
        first = self._st[self.local[0]]
        return {k: self._gather([None if s is None else s[k]
                                 for s in self._st]) for k in first}

    @state.setter
    def state(self, st: Dict[str, torch.Tensor]) -> None:
        if not self._multi:
            self._st[0] = st
            return
        parts = {k: self._split(v) for k, v in st.items()}
        self._st = [None if i not in self.local else
                    {k: parts[k][i] for k in st} for i in range(self.ndev)]

    @property
    def flux_padded(self) -> torch.Tensor:
        """The owned [nparts*L] flux (assembled across shards)."""
        return self._gather(self._flux)

    @flux_padded.setter
    def flux_padded(self, v: torch.Tensor) -> None:
        self._flux = [v] if not self._multi else self._split(v)

    @property
    def score_padded(self) -> Optional[torch.Tensor]:
        """The owned scoring bank in the padded-glid layout of the flux
        (assembled across shards); None with scoring off."""
        if self.scoring is None:
            return None
        return self._gather(self._bank)

    @score_padded.setter
    def score_padded(self, v: torch.Tensor) -> None:
        self._bank = [v] if not self._multi else self._split(v)

    @property
    def last_frontier_mean(self) -> float:
        """Mean crossing front over the most recent phase's migration
        rounds (0.0 with none)."""
        migrations = self.last_walk_rounds - 1
        if migrations <= 0:
            return 0.0
        return self._last_frontier_sum / migrations

    # The collective within one process: off, as the engine runs; set
    # on an instance (then ``_build_collective_fns()``) to hold the
    # collective's engine path against the row copies without a second
    # process (tests, chip_smoke.py).
    _ring_in_process = False

    def _build_collective_fns(self) -> None:
        """(Re)build the collective migrations from the CURRENT capacity
        geometry (at construction and after a capacity escalation: they
        bake ``cap_per_block`` and ``cap_frontier``), for a mesh that
        spans processes: it has no other migration."""
        self._collective_migrate = self._collective_frontier = None
        if not self._multi or not (self.device_mesh.multi_process
                                   or self._ring_in_process):
            return
        from pumiumtally_tpu_torch.parallel.distributed import (
            make_collective_frontier_migrate,
            make_collective_migrate,
        )

        kw = dict(part_L=self.part.L, nparts=self.nparts,
                  cap_per_block=self.cap_per_block, comm=self.comm)
        self._collective_migrate = make_collective_migrate(
            self.device_mesh, **kw)
        # cap_frontier 0 (forced fallback) and None migrate at full
        # capacity every round: no slab collective.
        if self.cap_frontier:
            self._collective_frontier = make_collective_frontier_migrate(
                self.device_mesh, cap_frontier=self.cap_frontier, **kw)

    def modeled_cross_host_bytes(self) -> int:
        """Modeled per-migration-round CROSS-HOST bytes of this engine's
        placement under its host layout (deterministic, nothing runs;
        ``distributed.modeled_cross_host_migration_bytes``); 0 on one
        host and on partitions without a face census."""
        if self.part.remote_faces is None or len(self.host_chips) < 2:
            return 0
        from pumiumtally_tpu_torch.parallel.distributed import (
            modeled_cross_host_migration_bytes,
            state_pack_columns,
        )

        fcols, icols = state_pack_columns(self._st[self.local[0]])
        return modeled_cross_host_migration_bytes(
            self.part.remote_faces, self.blocks_per_chip, self.host_chips,
            fcols, icols)

    # -- staged input routing -------------------------------------------
    def _by_pid(self, arr_n: torch.Tensor, fill,
                st: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Route a caller-order [n,...] array to a shard's slots via pid
        (``st``: the shard's state; None: a one-shard engine's)."""
        pid = (self._st[0] if st is None else st)["pid"]
        v = arr_n.to(pid.device)[pid.long().clamp(0, self.n - 1)]
        mask = pid >= 0
        fill = torch.as_tensor(fill, dtype=v.dtype, device=v.device)
        return torch.where(mask[:, None] if v.dim() == 2 else mask, v, fill)

    def _migrate(self, st):
        """A full migrate of a one-shard engine's [cap] state outside the
        round loop (tools): raises the JAX message on overflow, with the
        engine's state left at the intact snapshot."""
        st, overflow = migrate(self.part.L, self.nparts, self.cap_per_block,
                               st)
        if overflow:
            self.state = st
            raise RuntimeError(OVERFLOW_MESSAGE)
        return st

    def _full_migrate(self, sts: list, in_loop: bool):
        """The full migrate over the shards: one shard's ``migrate``; the
        collective across processes (in the round loop when run in one
        process); else ``migrate_shards``. Returns ``(shards,
        overflow)``, the old shards on overflow."""
        if not self._multi:
            st, ovf = migrate(self.part.L, self.nparts, self.cap_per_block,
                              sts[0])
            return [st], ovf
        if self._collective_migrate is not None and (
                in_loop or self.device_mesh.multi_process):
            return self._collective_migrate(sts)
        return migrate_shards(self.part.L, self.nparts, self.cap_per_block,
                              sts)

    # -- localization ----------------------------------------------------
    def _locate_points(self, pts_n: torch.Tensor) -> torch.Tensor:
        """[n] padded glid per point (``nparts*L`` = in no element):
        each shard locates against its own blocks' rows, and the lowest
        claiming glid wins across shards."""
        none = self.nparts * self.part.L
        rows = self.blocks_per_chip * self.part.L
        c = min(2048, max(8, (1 << 23) // max(rows, 1)), self.n)
        chunk = _locate_chunk_hi if self.two_tier else _locate_chunk
        claims = []
        for i in self.local:
            tb = self._tables[i]
            table = tb.table_hi if self.two_tier else tb.table
            pts = pts_n.to(table.device)
            le = torch.cat([
                chunk(table, tb.valid, pts[j:j + c], self.tol)
                for j in range(0, self.n, c)
            ])
            claims.append(torch.where(le >= 0, i * rows + le,
                                      torch.full_like(le, none))
                          .to(self.device))
        glid = claims[0] if len(claims) == 1 else \
            torch.stack(claims).min(dim=0).values
        return glid if self.comm is None else self.comm.min_ints(glid)

    def _finalize_localize(self) -> None:
        """Every particle's localization phase is finished."""
        for st in self._local_states():
            st["done"] = torch.ones_like(st["done"])
            st["pending"] = torch.full_like(st["pending"], -1)

    def _local_states(self) -> list:
        return [self._st[i] for i in self.local]

    def _sum_int(self, v: int) -> int:
        return v if self.comm is None else self.comm.sum_int(v)

    def _place_located(self, sts: list) -> None:
        """Migrate located (or revived) particles to their blocks: the
        full migrate (the front is the whole population). An overflow
        escalates the capacity once, by demand, over the intact snapshot
        and retries; a second overflow poisons the engine."""
        self._st, overflow = self._full_migrate(sts, in_loop=False)
        if overflow:
            self._recover_localize_overflow()

    def localize(self, dest_n: torch.Tensor) -> bool:
        """CopyInitialPosition: point location, then every particle is
        placed in the block owning its element. A source point in no
        element makes its particle ``lost`` (excluded from transport,
        element id -1). Returns whether every point was found."""
        glid = self._locate_points(dest_n)
        found = glid < self.nparts * self.part.L
        pend_n = torch.where(found, glid, -1)
        sts = list(self._st)
        for i in self.local:
            st = dict(self._st[i])
            st["x"] = self._by_pid(dest_n, 0.0, st)
            pend = self._by_pid(pend_n, -1, st)
            st["pending"] = torch.where(st["alive"], pend,
                                        st["pending"]).to(torch.int32)
            st["lost"] = st["alive"] & (st["pending"] < 0)
            st["done"] = ~st["alive"]
            st["exited"] = torch.zeros_like(st["exited"])
            sts[i] = st
        self.n_lost = int((~found).sum())
        self._place_located(sts)
        self._finalize_localize()
        if self.check_found_all and self.n_lost:
            print(
                f"[WARNING] {self.n_lost} source points lie in no mesh "
                "element; their particles are excluded from transport"
            )
        return self.n_lost == 0

    def _recover_localize_overflow(self) -> None:
        """Localization/revival placement overflowed (those paths use
        the full migrate already): escalate the capacity to the demand
        the intact snapshot shows, retry the placement, poison on a
        second failure."""
        self._escalate_capacity(self._needed_capacity_growth())
        self._st, overflow = self._full_migrate(self._st, in_loop=False)
        if overflow:
            self._poison()
        self._note_recovery(escalated=True)

    def _revive_lost(self, origins_n: torch.Tensor) -> None:
        """Re-locate lost particles whose resampled origin lies inside
        the mesh; they rejoin transport from that origin."""
        glid = self._locate_points(origins_n)
        pend_n = torch.where(glid < self.nparts * self.part.L, glid, -1)
        sts = list(self._st)
        for i in self.local:
            st = dict(self._st[i])
            pend = self._by_pid(pend_n, -1, st)
            revive = st["lost"] & (pend >= 0)
            st["x"] = torch.where(revive[:, None],
                                  self._by_pid(origins_n, 0.0, st), st["x"])
            st["pending"] = torch.where(revive, pend, -1).to(torch.int32)
            st["lost"] = st["lost"] & ~revive
            sts[i] = st
        self._place_located(sts)
        n_lost = 0
        for st in self._local_states():
            st["pending"] = torch.full_like(st["pending"], -1)
            n_lost += int(st["lost"].sum())
        self.n_lost = self._sum_int(n_lost)

    # -- phases ----------------------------------------------------------
    def _writable(self, st, i: int = 0):
        """Shard ``i``'s ``st`` with its own copies of the rows W4 writes
        in place (``WALKED_ROWS``) where they are the committed state's:
        a phase's first round works on copies, and later rounds on the
        migrate's new rows. W1 and W2 write new tensors."""
        if self._w1_w2:
            return st
        return dict(st, **{k: st[k].clone() for k in WALKED_ROWS
                           if st[k] is self._st[i][k]})

    def _walk_shard(self, i: int, st, tally: bool, n_act, work,
                    max_iters: int):
        """One shard's walk of a round (W2, W1 or W4); returns the
        kernel's tuple, the shard's per-block not-done counts and its
        block dispatches."""
        tb = self._tables[i]
        bpc = self.blocks_per_chip
        args = (st["x"], st["lelem"], st["dest"], st["fly"], st["w"],
                st["done"], st["exited"], self._flux[i] if tally else None)
        kw = dict(tally=tally, tol=self.tol, max_iters=max_iters,
                  blocks=bpc)
        if tally and self.scoring is not None:
            # Tallying rounds only: phase A and localization never score.
            kw["scoring"] = (self.scoring.kinds, self._bank[i],
                             st["sbin"], st["sfac"])
        if self._w1_w2:
            if self.use_pallas_walk:
                res = pallas_walk_local(tb.table, tb.table_hi, *args,
                                        deterministic=self.deterministic,
                                        **kw)
            else:
                res = vmem_walk_local(tb.table, *args,
                                      deterministic=self.deterministic, **kw)
            # These kernels sweep every block.
            return res, _occupancy_counts(res[2], bpc), bpc
        ids = None
        if bpc > 1:
            # The occupied-block list: blocks holding a not-done slot.
            ids = (n_act > 0).nonzero().squeeze(1).to(torch.int32)
        # The not-done slots lie in exactly those blocks.
        res = walk_local_list(tb.table, *args, work, adj_int=tb.adj_int,
                              table_hi=tb.table_hi,
                              deterministic=self.deterministic, **kw)
        if ids is None:
            return res, _occupancy_counts(res[2], 1), 1
        # Walked blocks recount themselves; the others hold 0.
        n_act = n_act.clone()
        n_act[ids.long()] = _occupancy_counts(res[2], bpc)[ids.long()]
        return res, n_act, int(ids.numel())

    def _round(self, sts: list, tally: bool, n_act: list, works=None,
               max_iters: Optional[int] = None):
        """One walk round over every local shard (each shard's work list
        from ``works``, None: every not-done slot), at the engine's step
        budget unless ``max_iters`` says otherwise. Returns the new
        shards, their per-block not-done counts, the paused and not-done
        totals and the block dispatches."""
        max_iters = self.max_iters if max_iters is None else max_iters
        out, acts, counts = list(sts), list(n_act), []
        disp = 0
        for i in self.local:
            before = dict(kernels.launch_counts)
            res, acts[i], d = self._walk_shard(
                i, sts[i], tally, n_act[i],
                None if works is None else works[i], max_iters)
            for k, v in kernels.launch_counts.items():
                if v != before[k]:
                    self.shard_launches[i][k] = (
                        self.shard_launches[i].get(k, 0) + v - before[k])
            disp += d
            x, lelem, done, exited, pending = res[:5]
            out[i] = dict(sts[i], x=x, lelem=lelem, done=done, exited=exited,
                          pending=pending)
            counts.append(torch.stack([(pending >= 0).sum(),
                                       (~done).sum()]).to(self.device))
        tot = counts[0] if len(counts) == 1 else torch.stack(counts).sum(0)
        if self.comm is not None and self.device_mesh.multi_process:
            tot = self.comm.sum_ints(tot)
            disp = self.comm.sum_int(disp)
        n_p, n_nd = tot.tolist()
        return out, acts, n_p, n_nd, disp

    def _migrate_round(self, cap_frontier: Optional[int], sts: list,
                       n_p: int):
        """One in-loop migration round over the shards (the module's
        ``_migrate_round`` on one shard): the frontier slab when the
        front fits, else the full migrate. Returns ``(shards, overflow,
        departures, arrivals, fellback, works)``."""
        if not self._multi:
            st, ovf, dep, arr, fb, work = _migrate_round(
                self.part.L, self.nparts, self.cap_per_block, cap_frontier,
                sts[0], n_p)
            return [st], ovf, dep, arr, fb, [work]
        if cap_frontier is None or n_p > cap_frontier:
            st2, ovf = self._full_migrate(sts, in_loop=True)
            z = torch.zeros((self.nparts,), dtype=torch.int32,
                            device=self.device)
            works = None if ovf else [
                None if s is None else work_list(s["done"]) for s in st2]
            return st2, ovf, z, z, True, works
        if self._collective_frontier is not None:
            st2, ovf, dep, arr, works = self._collective_frontier(sts)
        else:
            st2, ovf, dep, arr, works = frontier_migrate_shards(
                self.part.L, self.nparts, self.cap_per_block, cap_frontier,
                sts)
        return st2, ovf, dep, arr, False, works

    def _phase_loop(self, tally: bool, resume: bool = False,
                    force_full_migrate: bool = False,
                    prof: Optional[PhaseProfile] = None,
                    iters_mult: int = 1, rounds_mult: int = 1):
        """One walk/migrate phase: a walk round, then migrate->walk
        rounds while particles are paused, at most ``max_rounds`` walk
        rounds in all. ``resume`` continues the committed mid-phase
        state (done particles never walk again, paused rows re-derive
        their crossing); ``force_full_migrate`` bypasses the frontier
        slab; ``iters_mult`` / ``rounds_mult`` multiply the step and
        round budgets (the straggler retry). Commits the state (on
        overflow: the intact pre-migrate snapshot) and returns
        ``(found_all, overflow, rounds, dispatches, fronts,
        fallbacks)``."""
        devs = [self.devices[i] for i in self.local]
        bpc = self.blocks_per_chip
        max_iters = self.max_iters * int(iters_mult)
        max_rounds = self.max_rounds * int(rounds_mult)
        cap_frontier = None if force_full_migrate else self.cap_frontier
        if prof is not None:
            prof.cap_frontier = self.cap_frontier
        with _section(prof, "bookkeeping_s", devs):
            sts = list(self._st)
            for i in self.local:
                st = dict(self._st[i])
                if not resume:
                    st["done"] = ~st["alive"] | (st["fly"] == 0)
                    # Per-walk flag: a particle that left the domain last
                    # move but flies again must not carry a stale True.
                    st["exited"] = torch.zeros_like(st["exited"])
                    # Non-flying particles hold position: dest <- x.
                    st["dest"] = torch.where((st["fly"] == 1)[:, None],
                                             st["dest"], st["x"])
                sts[i] = st
        with _section(prof, "occupancy_s", devs):
            n_act = [None if s is None else _occupancy_counts(s["done"], bpc)
                     for s in sts]
        with _section(prof, "walk_s", devs):
            sts = [None if st is None else self._writable(st, i)
                   for i, st in enumerate(sts)]
            sts, n_act, n_p, n_nd, disp = self._round(
                sts, tally, n_act, max_iters=max_iters)
        rounds, disp_total, fronts, fallbacks = 1, disp, [], 0
        overflow = False
        if prof is not None:
            prof.rounds += 1
            prof.dispatches += disp
        while n_p > 0 and rounds < max_rounds:
            fronts.append(n_p)
            if prof is not None:
                prof.frontier_sizes.append(n_p)
            with _section(prof, "migrate_s", devs):
                st2, overflow, dep, arr, fb, works = self._migrate_round(
                    cap_frontier, sts, n_p)
            if cap_frontier is not None and fb:
                fallbacks += 1
                if prof is not None:
                    prof.fallback_rounds += 1
            rounds += 1
            if overflow:
                # st2 is the intact snapshot: nothing walks from it.
                break
            with _section(prof, "occupancy_s", devs):
                for i in self.local:
                    b = slice(i * bpc, (i + 1) * bpc)
                    d = self.devices[i]
                    n_act[i] = _update_occupancy(
                        bpc, cap_frontier, st2[i], n_act[i],
                        dep[b].to(d), arr[b].to(d), fb)
            with _section(prof, "walk_s", devs):
                sts, n_act, n_p, n_nd, disp = self._round(
                    st2, tally, n_act, works, max_iters=max_iters)
            disp_total += disp
            if prof is not None:
                prof.rounds += 1
                prof.dispatches += disp
        with _section(prof, "bookkeeping_s", devs):
            self._st = sts
        found = n_nd == 0 and n_p == 0 and not overflow
        return found, overflow, rounds, disp_total, fronts, fallbacks

    def _run_phase(self, tally: bool,
                   profile: Optional[PhaseProfile] = None) -> bool:
        """One phase (``_phase_loop``) with its diagnostics recorded;
        an overflow hands the committed snapshot to the recovery ladder.
        Returns whether every particle finished."""
        found, overflow, rounds, disp, fronts, fallbacks = self._phase_loop(
            tally, prof=profile)
        self.last_walk_rounds = rounds
        self.last_block_dispatches = disp
        self.last_frontier_max = max(fronts, default=0)
        self._last_frontier_sum = sum(fronts)
        self.last_fallback_rounds = fallbacks
        if overflow:
            return self._recover_overflow(tally)
        return found

    # -- overflow recovery ------------------------------------------------
    def _resume_phase(self, tally: bool, iters_mult: int = 1,
                      rounds_mult: int = 1,
                      force_full_migrate: bool = False):
        """Continue the interrupted phase over the COMMITTED mid-phase
        state: particles already done never walk again; the step and
        round budgets are multiplied by ``iters_mult`` / ``rounds_mult``.
        Returns ``(found_all, overflowed)``."""
        found, overflow, rounds, disp, _, _ = self._phase_loop(
            tally, resume=True, force_full_migrate=force_full_migrate,
            iters_mult=iters_mult, rounds_mult=rounds_mult)
        self.last_walk_rounds = rounds
        self.last_block_dispatches = disp
        return found, overflow

    def _note_recovery(self, escalated: bool) -> None:
        self.overflow_recoveries += 1
        if self.on_overflow_recovered is not None:
            self.on_overflow_recovered(escalated)

    def _poison(self) -> None:
        """Latch ``poisoned``, fire the ``on_poisoned`` hook, raise."""
        self.poisoned = True
        if self.on_poisoned is not None:
            try:
                self.on_poisoned()
            except Exception as e:  # noqa: BLE001 — best effort
                warnings.warn(f"overflow safety save failed: {e}")
        raise RuntimeError(LADDER_EXHAUSTED_MESSAGE)

    def _recover_overflow(self, tally: bool) -> bool:
        """The overflow-recovery ladder, from the committed intact
        mid-phase snapshot:

        1. resume the phase through the full migrate (it re-compacts
           every block, and bypasses the frontier slab);
        2. escalate once to the demand the snapshot shows
           (``_needed_capacity_growth``, ``_grow_state``) and resume;
        3. escalate to the bound at which no block can overflow (every
           block can host the whole population) and resume once more;
        4. then poison and raise."""
        ok, overflow = self._resume_phase(tally, force_full_migrate=True)
        if not overflow:
            self._note_recovery(escalated=False)
            return ok
        self._escalate_capacity(self._needed_capacity_growth())
        ok, overflow = self._resume_phase(tally, force_full_migrate=True)
        if not overflow:
            self._note_recovery(escalated=True)
            return ok
        terminal = 1.05 * (self.n + 2) / max(self.cap_per_block, 1)
        if terminal > 1.0:
            self._escalate_capacity(terminal)
            ok, overflow = self._resume_phase(tally,
                                              force_full_migrate=True)
            if not overflow:
                self._note_recovery(escalated=True)
                return ok
        self._poison()
        return False  # unreachable: _poison raises

    def _needed_capacity_growth(self) -> float:
        """The escalation factor the committed snapshot asks for: the
        worst block's stayers plus pending arrivals, with 10% room, at
        least 2x."""
        state = self.state
        pending = state["pending"].cpu().numpy()
        alive = state["alive"].cpu().numpy()
        slot_part = np.arange(self.cap) // self.cap_per_block
        target = np.where(pending >= 0, pending // self.part.L, slot_part)
        counts = np.bincount(target[alive], minlength=self.nparts)
        needed = int(counts.max()) + 1
        return max(2.0, 1.1 * needed / max(self.cap_per_block, 1))

    def _escalate_capacity(self, factor: float = 2.0) -> None:
        """Grow every block's slot capacity (``_grow_state``, shard by
        shard: a relabeling, particle state bitwise kept); the flux, the
        bank and the partition are untouched."""
        old_cb = self.cap_per_block
        new_cb = int(old_cb * float(factor)) + 1
        if self.blocks_per_chip > 1 and self.block_kernel in ("vmem",
                                                              "pallas"):
            new_cb = -(-new_cb // W_TILE_DEFAULT) * W_TILE_DEFAULT
        self.capacity_factor *= float(factor)
        self.capacity_escalations += 1
        self._st = [None if st is None else
                    _grow_state(st, old_cb, new_cb, self.blocks_per_chip)
                    for st in self._st]
        self.cap_per_block = new_cb
        self.cap_per_chip = self.blocks_per_chip * new_cb
        self.cap = self.nparts * new_cb
        if self.cap_frontier is not None:
            self.cap_frontier = min(self.cap_frontier, self.cap)
        self._build_collective_fns()

    def move(self, origins_n: Optional[torch.Tensor], dests_n: torch.Tensor,
             fly_n: torch.Tensor, w_n: torch.Tensor,
             sbin_n: Optional[torch.Tensor] = None,
             sfac_n: Optional[torch.Tensor] = None,
             profile: Optional[PhaseProfile] = None) -> bool:
        """Full (origins given) or continue-mode (None) tallied move.
        Returns whether every particle finished both phases.
        ``sbin_n``/``sfac_n`` (scoring engines): the move's caller-order
        bin offsets and factor rows (``ScoringRuntime.resolve``), routed
        to slots by pid and migrated with their particles. ``profile``:
        a ``PhaseProfile`` that accumulates every phase's fenced
        sections (the rounds are a plain move's)."""
        if self.scoring is not None and (sbin_n is None or sfac_n is None):
            raise ValueError(
                "scoring-armed engine needs sbin_n/sfac_n each move "
                "(scoring.ScoringRuntime.resolve)"
            )
        if origins_n is not None and self.n_lost:
            self._revive_lost(origins_n)
        for st in self._local_states():
            st["fly"] = self._by_pid(fly_n, 0, st).to(torch.int8)
            # Lost particles never fly: an undefined start element must
            # not produce tallies.
            st["fly"] = torch.where(st["lost"], torch.zeros_like(st["fly"]),
                                    st["fly"])
            st["w"] = self._by_pid(w_n, 0.0, st)
            if self.scoring is not None:
                # Dead slots never cross, so their fill never scores.
                st["sbin"] = self._by_pid(sbin_n.to(torch.int32), 0, st)
                st["sfac"] = self._by_pid(sfac_n, 0.0, st)
        ok_a = True
        if origins_n is not None:
            # Phase A: relocate to origins, weights zeroed (cpp:105).
            for st in self._local_states():
                st["dest"] = self._by_pid(origins_n, 0.0, st)
                st["w"] = torch.zeros_like(st["w"])
            ok_a = self._run_phase(tally=False, profile=profile)
            # Re-route the real weights by pid: phase-A migrations may
            # have moved every slot.
            for st in self._local_states():
                st["w"] = self._by_pid(w_n, 0.0, st)
        for st in self._local_states():
            st["dest"] = self._by_pid(dests_n, 0.0, st)
        ok_b = self._run_phase(tally=True, profile=profile)
        return ok_a and ok_b

    # -- the sentinel's straggler rung -----------------------------------
    def retry_stragglers(self, iters_factor: int = 2) -> bool:
        """The straggler rung (the JAX engine's): resume the interrupted
        tallying phase over the committed state with the step AND round
        budgets multiplied, each floored at its safe bound (64 + L steps,
        64 rounds) so a deliberately tiny budget does not starve its own
        cure. Done particles never walk again, so the retry walks only
        the residue (W4 over the not-done slots). Returns found_all; an
        overflow goes through the recovery ladder."""
        f = int(iters_factor)
        need_iters = max(self.max_iters * f, 64 + self.part.L)
        need_rounds = max(self.max_rounds * f, 64)
        ok, overflow = self._resume_phase(
            True, iters_mult=-(-need_iters // self.max_iters),
            rounds_mult=-(-need_rounds // self.max_rounds))
        if overflow:
            return self._recover_overflow(True)
        return ok

    def declare_lost_stragglers(self) -> int:
        """The ladder is exhausted: the still-unfinished particles become
        ``lost`` (excluded from transport, counted by the facade's
        ``lost_particles``, revived by a re-located source like a
        localization loss). Returns how many (a host fetch)."""
        strags = {i: st["alive"] & ~st["done"] & ~st["lost"]
                  for i, st in zip(self.local, self._local_states())}
        n = self._sum_int(sum(int(v.sum()) for v in strags.values()))
        if n == 0:
            return 0
        for i, strag in strags.items():
            st = dict(self._st[i])
            st["lost"] = st["lost"] | strag
            st["fly"] = torch.where(strag, torch.zeros_like(st["fly"]),
                                    st["fly"])
            st["done"] = st["done"] | strag
            st["pending"] = torch.where(strag, -1,
                                        st["pending"]).to(torch.int32)
            self._st[i] = st
        self.n_lost = self._sum_int(
            sum(int(st["lost"].sum()) for st in self._local_states()))
        return n

    def caller_order_view(self, keys=("x", "lelem", "done")) -> dict:
        """Caller-order device rows of the slot state ([n], particle
        order; the sentinel audit and quarantine read them). ``elem_orig``
        is each particle's original element id, -1 for a lost one."""
        state = self.state
        o = self._order(state)
        out = {}
        for k in keys:
            if k == "elem_orig":
                slot = torch.arange(self.cap, device=self.device)
                glid = (slot // self.cap_per_block) * self.part.L \
                    + state["lelem"].long()
                out[k] = torch.where(state["lost"][o], -1,
                                     self.part.orig_of_glid[glid[o]])
            else:
                out[k] = state[k][o]
        return out

    # -- outputs ---------------------------------------------------------
    def _order(self, state=None) -> torch.Tensor:
        """Slot order returning caller-visible particle order."""
        pid = (self.state if state is None else state)["pid"].long()
        key = torch.where(pid >= 0, pid, torch.full_like(pid, self.cap + 1))
        return torch.sort(key, stable=True).indices[: self.n]

    def positions(self) -> np.ndarray:
        return self.caller_order_view(("x",))["x"].cpu().numpy()

    def elem_ids(self) -> np.ndarray:
        """Original element id per particle; -1 for lost particles."""
        return self.caller_order_view(("elem_orig",))["elem_orig"] \
            .cpu().numpy()

    def flux_original(self) -> torch.Tensor:
        return self.part.flux_to_original(self.flux_padded)

    def score_original(self) -> torch.Tensor:
        """The owned scoring lanes in the canonical flattened [E*B*S]
        layout (original element order): ``flux_to_original``'s row
        gather over ``B*S`` lanes per element."""
        if self.score_padded is None:
            raise RuntimeError("engine has no scoring lanes configured")
        rows = self.score_padded.reshape(self.nparts * self.part.L,
                                         self.score_stride)
        return rows[self.part.glid_of_orig.long()].reshape(-1)
