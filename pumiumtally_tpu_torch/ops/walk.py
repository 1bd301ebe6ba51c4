"""The tallied tet walk (port of ``pumiumtally_tpu/ops/walk.py`` ``walk``),
as kernel W0 (csrc/walk.cu) with its plain PyTorch version beside it.

Each particle walks the FIXED segment x0 -> dest (d0 = dest - x0),
parametrised by the ray coordinate s in [0,1]. Per crossing it reads its
tet's packed walk row, takes the first face ahead of s (csrc/walk_step.cuh
states the arithmetic), tallies (s_new - s) * flying * weight * |d0| into
flux[elem], stops on a boundary face (vacuum BC: the position clamps to
the boundary point) and otherwise steps into the neighbour. Positions
are materialised once from s at the end; a particle that reached its
destination commits ``dest`` bit-exactly.

A two-tier mesh (``TetMesh.with_lowp_tables``) walks the JAX walk's
``lo_select`` path instead: the exit face is selected from the tet's
bf16 row, then the winning face's one full-precision refinement row
re-solves the crossing and names the neighbour (csrc/twotier_step.cuh;
the row helpers below are its column-wise form). Select in bf16, commit
in the working dtype; not bitwise against the packed table (a face tie
below bf16 precision may pick the adjacent face), and conserving.

An unpacked mesh (``TetMesh.unpacked``: past the float lanes' exact ids,
or a two-tier mesh walked at the float32 tier through
``with_plane_views``) walks the JAX ``_gather_walk_row`` fallback: the
same crossing on the planes read as one row of a ROW16 buffer (the
neighbour from the int32 ``face_adj``) or of the refinement tier in
place (ROW20, the neighbour from its adj lanes), W0's unpacked
instantiations (launch counters ``walk_unpacked`` and
``walk_unpacked_scored``; ``check_plane_layout`` refuses any other
layout on the card), bitwise the packed walk's on the same planes.

``scoring=(kinds, bank, bin_off, fac)`` (tallying walks only) is the JAX
walk's scoring hook: at every crossing each score adds into lane
``elem*stride + bin_off + k`` of the flattened ``bank`` (``score_pair``;
``stride = bank.numel() // flux.numel()``), in place, with lanes at or
past the bank's end dropped (the DROP sentinel). On the card it is W0's
scoring instantiation (separate launch counters ``walk_scored`` and
``walk_twotier_scored``); positions, elements, ``s`` and the flags are
those of the walk without scoring, and so is the flux.

``tally_seg`` (tallying walks only) is the JAX walk's segmented commit
(the service's cross-session fusion): an int32 [n] offset a particle,
added to its flux index, so a slab packing K sessions' particles tallies
each into its own ``[E]`` segment of a concatenated ``[K*E]`` flux
bank; an index at or past the bank's end (a padding row's ``K*E``) is
dropped. On the card it is W0's kSeg instantiation, counted under the
same entries. The scoring lanes keep ``elem*stride + bin_off``: the
caller shifts ``bin_off``.

Left out against the JAX walk: the compaction cascade (a thread that
walks its particle to completion has no lock-step waste to bound) and
``perm_mode``. ``max_iters`` is a per-particle step budget; the JAX walk
checks it every ``cond_every`` (4) steps, so it may take up to 3 more.

``deterministic=True`` (tallying walks) commits flux and lanes through
the deterministic commit (ops/det_commit.py): on the card W0's kDet
instantiation writes a record a contribution and DC adds them in the
order of ``walk_plain``'s serial ``index_add_`` (step, then particle), so
the flux and the lanes equal the plain version's bitwise; ``walk_plain``
builds the same records and commits them with ``det_commit_plain``.
Without it the atomic commit runs, as before.

``walk_xpoints`` replays a move and records each particle's last
face-crossing point (the reference's ``getIntersectionPoints()``); it is
an inspection path, plain PyTorch on any device.

``walk`` launches W0 for CUDA tensors and runs ``walk_plain`` only for
CPU tensors. Flux is accumulated IN PLACE into the ``flux`` argument
(the JAX walk returns a new array). ``skip``, a 0-d bool tensor, is the
JAX move's device-side phase-A skip (``lax.cond(trivial, skip_a,
run_a)``, api/tally.py:326): when true the walk returns its inputs and
walks nothing, and on the card W0 reads the flag itself, so the host
never waits for it.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

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
    plane_layout,
)
from pumiumtally_tpu_torch.ops.det_commit import (
    det_commit_plain,
    det_ord,
    walk_and_commit,
    workspace,
)
from pumiumtally_tpu_torch.scoring.scores import MAX_SCORES
from pumiumtally_tpu_torch.utils.profiling import span

_LN0 = WALK_TABLE_LO_NORMALS.start
_LO0 = WALK_TABLE_LO_OFFSETS.start

# Walk-table precision tiers: "float32" is the packed single-tier table
# (in the working dtype), "bfloat16" the two-tier tables.
TABLE_DTYPES = ("float32", "bfloat16")
TABLE_DTYPE_DEFAULT = "float32"


def resolve_table_dtype(dtype: str) -> str:
    """Resolve "auto" through the PUMIUMTALLY_WALK_TABLE_DTYPE
    environment variable, as the JAX package does."""
    if dtype == "auto":
        dtype = os.environ.get(
            "PUMIUMTALLY_WALK_TABLE_DTYPE", TABLE_DTYPE_DEFAULT
        )
    if dtype not in TABLE_DTYPES:
        raise ValueError(
            f"walk_table_dtype must be one of {TABLE_DTYPES} or 'auto', "
            f"got {dtype!r}"
        )
    return dtype


def mesh_for_tier(mesh: TetMesh, table_dtype: Optional[str]) -> TetMesh:
    """The mesh a walk at tier ``table_dtype`` reads (None: the mesh's
    own): "bfloat16" needs the two-tier tables, "float32" walks a
    two-tier mesh's full-precision planes in place
    (``TetMesh.with_plane_views``). Shared by ``walk`` and
    ``walk_xpoints``, so a replay walks the tier of the move."""
    if table_dtype is None:
        return mesh
    if resolve_table_dtype(table_dtype) == "float32":
        return mesh.with_plane_views()
    if not mesh.two_tier:
        raise ValueError(
            "table_dtype='bfloat16' needs the two-tier walk tables — "
            "build the mesh with table_dtype='bfloat16' or convert it "
            "with TetMesh.with_lowp_tables()"
        )
    return mesh


class WalkResult(NamedTuple):
    """Post-walk particle state (fields as in the JAX package)."""

    x: torch.Tensor  # [N,3] committed position
    elem: torch.Tensor  # [N] int32 final element
    done: torch.Tensor  # [N] bool (False = step budget ran out)
    exited: torch.Tensor  # [N] bool: finished by leaving the domain
    flux: Optional[torch.Tensor]  # [E], the input tensor, updated in place
    iters: torch.Tensor  # [] int32: most steps any particle took
    s: torch.Tensor  # [N] final ray coordinate along x0 -> dest


def _crossing(nx, ny, nz, off, s, d0, dest, one, tol):
    """One face's ray projections and forward-crossing test, in the
    kernels' operation order: (a, b, crossing)."""
    a = nx * d0[:, 0] + ny * d0[:, 1] + nz * d0[:, 2]
    n_dest = nx * dest[:, 0] + ny * dest[:, 1] + nz * dest[:, 2]
    b = off - n_dest + a
    return a, b, a * (one - s) > tol


def advance_planes(nrm, off, adj, s, d0, dest, tol):
    """One crossing for every row of a lock-step batch, column-wise —
    the operation order of csrc/walk_step.cuh, so that on the card the
    kernels match this bitwise. ``nrm`` [N,12] holds each tet's four
    normals, ``off`` [N,4] its plane offsets, ``adj`` [N,4] its int32
    neighbour ids; ``tol`` is a 0-dim tensor in the working dtype.
    Returns (s_new, next_elem, reached)."""
    one = torch.ones((), dtype=s.dtype, device=s.device)
    inf = torch.full((), float("inf"), dtype=s.dtype, device=s.device)
    s_exit = nxt = None
    for f in range(4):
        a, b, crossing = _crossing(
            nrm[:, 3 * f], nrm[:, 3 * f + 1], nrm[:, 3 * f + 2], off[:, f],
            s, d0, dest, one, tol,
        )
        s_f = torch.where(crossing, b / torch.where(crossing, a, one), inf)
        s_f = torch.maximum(s_f, s)
        if f == 0:
            s_exit, nxt = s_f, adj[:, f]
        else:
            better = s_f < s_exit  # strict: the first minimal face wins
            s_exit = torch.where(better, s_f, s_exit)
            nxt = torch.where(better, adj[:, f], nxt)
    reached = s_exit >= one
    return torch.where(reached, one, s_exit), nxt, reached


def advance_cols(row, s, d0, dest, tol):
    """``advance_planes`` on packed table rows ``row`` [N,20] (the ids
    read from the row's float lanes)."""
    return advance_planes(row[:, WALK_TABLE_NORMALS],
                          row[:, WALK_TABLE_OFFSETS],
                          row[:, WALK_TABLE_ADJ].to(torch.int32), s, d0,
                          dest, tol)


def advance_mesh(mesh: TetMesh, rows, s, d0, dest, tol):
    """One crossing of every row through the mesh's own layout, as W0
    reads it: the packed row, the two tiers, or the unpacked planes and
    ``face_adj`` (the JAX ``_gather_walk_row`` fallback). ``rows``: the
    particles' elements, int64."""
    if mesh.two_tier:
        return advance_twotier(mesh.walk_table_lo, mesh.walk_table_hi, rows,
                               s, d0, dest, tol)
    if mesh.unpacked:
        return advance_planes(mesh.face_normals[rows].reshape(-1, 12),
                              mesh.face_offsets[rows], mesh.face_adj[rows],
                              s, d0, dest, tol)
    return advance_cols(mesh.walk_table[rows], s, d0, dest, tol)


def lift_bf16(lo: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """bf16 -> working dtype, exact (bf16 is truncated f32; the kernels
    shift the 16 bits up, csrc/twotier_step.cuh)."""
    return lo.to(torch.float32).to(dtype)


def select_rows_lo(row, s, dest, d0, tol):
    """SELECT tier on fetched, lifted [N,16] rows: every face's
    candidate crossing, clamped to s, and the FIRST minimal face (the
    JAX clamp-then-argmin rule; a candidate rounded behind s clamps to
    s and wins, and the refinement then recomputes its true crossing).
    Returns (s_sel, f_exit)."""
    one = torch.ones((), dtype=s.dtype, device=s.device)
    inf = torch.full((), float("inf"), dtype=s.dtype, device=s.device)
    s_sel = f_exit = None
    for f in range(4):
        a, b, crossing = _crossing(
            row[:, _LN0 + 3 * f], row[:, _LN0 + 3 * f + 1],
            row[:, _LN0 + 3 * f + 2], row[:, _LO0 + f], s, d0, dest, one,
            tol,
        )
        s_f = torch.where(crossing, b / torch.where(crossing, a, one), inf)
        s_f = torch.maximum(s_f, s)
        if f == 0:
            s_sel = s_f
            f_exit = torch.zeros(s.shape, dtype=torch.int64,
                                 device=s.device)
        else:
            better = s_f < s_sel  # strict: the first minimal face wins
            s_sel = torch.where(better, s_f, s_sel)
            f_exit = torch.where(better, f, f_exit)
    return s_sel, f_exit


def select_faces_lo(table_lo, s, rows, dest, d0, tol):
    """``select_rows_lo`` on the bf16 rows ``table_lo[rows]`` (one
    32 B row per crossing)."""
    return select_rows_lo(lift_bf16(table_lo[rows], s.dtype), s, dest, d0,
                          tol)


def refine_plane_hi(plane, s, s_sel, dest, d0, tol):
    """REFINEMENT tier on the winning face's [N,5] plane rows: re-solve
    its crossing in the working dtype. A face that is no longer a
    genuine forward crossing keeps the bf16 candidate; an infinite
    candidate (no face ahead: the destination is in this tet) stays
    infinite so that "reached" fires. Returns (s_exit, next_elem) with
    the neighbour from the row's adj lane."""
    one = torch.ones((), dtype=s.dtype, device=s.device)
    a, b, genuine = _crossing(plane[:, 0], plane[:, 1], plane[:, 2],
                              plane[:, 3], s, d0, dest, one, tol)
    s_ref = torch.where(genuine, b / torch.where(genuine, a, one), s_sel)
    s_ref = torch.maximum(s_ref, s)
    s_exit = torch.where(torch.isinf(s_sel), s_sel, s_ref)
    return s_exit, plane[:, 4].to(torch.int32)


def refine_face_hi(table_hi, s, rows, f_exit, s_sel, dest, d0, tol):
    """``refine_plane_hi`` on the one row ``table_hi[rows*4 + f_exit]``
    (20 B in f32)."""
    return refine_plane_hi(table_hi[rows * 4 + f_exit], s, s_sel, dest, d0,
                           tol)


def advance_twotier(table_lo, table_hi, rows, s, d0, dest, tol):
    """One two-tier crossing for every row of a lock-step batch (the
    counterpart of ``advance_cols``): select, refine, then the walk's
    reached rule. ``rows`` indexes the tier tables (int64). Returns
    (s_new, next_elem, reached)."""
    s_sel, f_exit = select_faces_lo(table_lo, s, rows, dest, d0, tol)
    s_exit, nxt = refine_face_hi(table_hi, s, rows, f_exit, s_sel, dest, d0,
                                 tol)
    one = torch.ones((), dtype=s.dtype, device=s.device)
    reached = s_exit >= one
    return torch.where(reached, one, s_exit), nxt, reached


def ieee_sqrt(a: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root on any device: torch's CPU
    kernel misses the IEEE rounding of some values, the card's does not,
    so the CPU goes through numpy's."""
    if a.device.type == "cpu":
        return torch.from_numpy(np.sqrt(a.numpy()))
    return torch.sqrt(a)


def eff_weight(d0, in_flight, weight):
    """eff_w = flying * weight * |d0|, in the kernels' operation order
    (the square root correctly rounded, as the kernels' is)."""
    seg = ieee_sqrt(d0[:, 0] * d0[:, 0] + d0[:, 1] * d0[:, 1]
                    + d0[:, 2] * d0[:, 2])
    return torch.where(in_flight != 0, weight * seg, torch.zeros_like(seg))


def score_pair(kinds, stride: int, elem, bin_off, fac, contrib, crossed):
    """One crossing's scoring-lane updates (the JAX ``score_pair``):
    ``sidx[w, k] = elem*stride + bin_off + k``, particle-major and
    score-minor, and the values ``contrib * fac[:, k]`` for a "track"
    score (``contrib`` is the flux lane's own update, so a factor-1
    track score's lanes sum to the flux lane) or ``crossed * fac[:, k]``
    for a "count" score. Returns flat (sidx int64, sval)."""
    base = elem.long() * stride + bin_off.long()
    sidx = base[:, None] + torch.arange(len(kinds), device=elem.device)
    cols = [contrib if k == "track" else crossed for k in kinds]
    return sidx.reshape(-1), (torch.stack(cols, dim=1) * fac).reshape(-1)


def add_lanes(bank, sidx, sval, limit: int) -> None:
    """``bank[sidx] += sval`` in order, dropping every index at or past
    ``limit`` (the JAX scatter's ``mode="drop"``)."""
    keep = sidx < limit
    bank.index_add_(0, sidx[keep], sval[keep])


class PlainRecords:
    """The deterministic commit's records of a plain walk, one lock-step
    iteration at a time: the non-zero contributions, keyed (bank index,
    step, particle), committed at the end in that order
    (``det_commit_plain``), as W0's and W4's kDet instantiations write
    them."""

    def __init__(self):
        self.parts = []

    def add(self, key, step: int, pid, val, keep=None) -> None:
        keep = val != 0 if keep is None else keep & (val != 0)
        self.parts.append((key[keep], det_ord(step, pid[keep]), val[keep]))

    def commit(self, target) -> None:
        if self.parts:
            key, ord_, val = (torch.cat(c) for c in zip(*self.parts))
            det_commit_plain(target, key, ord_, val)


def count_mask(kinds) -> int:
    """The kernels' ``kinds`` argument: bit k set for a "count" score."""
    return sum(1 << k for k, kind in enumerate(kinds) if kind == "count")


def check_scoring(where: str, scoring, flux, n: int) -> int:
    """Validate a ``(kinds, bank, bin_off, fac)`` bundle against the
    walk's flux (the bank holds a whole number of lanes per flux lane)
    and its n particles; returns the stride."""
    kinds, bank, bin_off, fac = scoring
    if flux is None:
        raise ValueError(f"{where}: scoring requires a tallying walk")
    if not 1 <= len(kinds) <= MAX_SCORES or any(
            k not in ("track", "count") for k in kinds):
        raise ValueError(f"{where}: kinds must be 1 to {MAX_SCORES} of "
                         f"'track'/'count', got {kinds!r}")
    if bank.numel() % flux.numel():
        raise ValueError(f"{where}: a bank of {bank.numel()} lanes is no "
                         f"whole multiple of {flux.numel()} flux lanes")
    if tuple(bin_off.shape) != (n,) or tuple(fac.shape) != (n, len(kinds)):
        raise ValueError(
            f"{where}: bin_off {tuple(bin_off.shape)} and fac "
            f"{tuple(fac.shape)} need ({n},) and ({n}, {len(kinds)})")
    return bank.numel() // flux.numel()


def check_tally_seg(tally_seg, tally: bool, n: int) -> None:
    """A walk's ``tally_seg``: None, or int32 [n] on a tallying walk
    (the JAX walk's refusal otherwise)."""
    if tally_seg is None:
        return
    if not tally:
        raise ValueError("tally_seg requires a tallying walk (tally=True)")
    if tally_seg.dtype != torch.int32 or tuple(tally_seg.shape) != (n,):
        raise ValueError(f"tally_seg must be int32 ({n},), got "
                         f"{tally_seg.dtype} {tuple(tally_seg.shape)}")


def _skipped(x, elem, s_init) -> WalkResult:
    """A walk that walked nothing: every output is its input."""
    n = x.shape[0]
    s = (torch.zeros((n,), dtype=x.dtype, device=x.device) if s_init is None
         else s_init.to(x.dtype).clone())
    return WalkResult(
        x=x.clone(), elem=elem.to(torch.int32).clone(),
        done=torch.ones((n,), dtype=torch.bool, device=x.device),
        exited=torch.zeros((n,), dtype=torch.bool, device=x.device),
        flux=None, iters=torch.tensor(0, dtype=torch.int32, device=x.device),
        s=s,
    )


def walk_plain(
    mesh: TetMesh, x, elem, dest, in_flight, weight, flux, *,
    tally: bool, tol: float, max_iters: int, s_init=None, skip=None,
    scoring=None, deterministic=False, tally_seg=None,
) -> WalkResult:
    """W0's plain PyTorch version: a masked lock-step loop, one crossing
    of every unfinished particle per iteration, through the mesh's
    layout (``advance_mesh``). ``skip`` true: nothing is walked.
    ``scoring``: see the module docstring; the bank is updated in
    place. ``deterministic``: the flux and lanes are committed as the
    deterministic commit's records (``PlainRecords``) instead of by
    ``index_add_`` each iteration: the same values in the same order.
    ``tally_seg``: the segmented commit (module docstring)."""
    n = x.shape[0]
    check_tally_seg(tally_seg, tally, n)
    if scoring is not None:
        stride = check_scoring("walk_plain", scoring,
                               flux if tally else None, n)
        kinds, bank, bin_off, fac = scoring
    if skip is not None and bool(skip):
        return _skipped(x, elem, s_init)._replace(flux=flux)
    d0 = dest - x
    eff_w = eff_weight(d0, in_flight, weight) if tally else None
    tol_t = torch.tensor(tol, dtype=x.dtype, device=x.device)
    s = (torch.zeros((n,), dtype=x.dtype, device=x.device) if s_init is None
         else s_init.to(x.dtype).clone())
    elem = elem.to(torch.int32).clone()
    done = torch.zeros((n,), dtype=torch.bool, device=x.device)
    recs = (PlainRecords(), PlainRecords()) if deterministic and tally \
        else None
    pid = torch.arange(n, device=x.device)
    iters = 0
    while iters < max_iters and not bool(done.all()):
        active = ~done
        s_new, nxt, reached = advance_mesh(mesh, elem.long(), s, d0, dest,
                                           tol_t)
        hit_boundary = ~reached & (nxt == -1)
        if tally:
            contrib = torch.where(active, (s_new - s) * eff_w,
                                  torch.zeros_like(s))
            if tally_seg is None:
                if recs is None:
                    flux.index_add_(0, elem.long(), contrib)
                else:
                    recs[0].add(elem, iters, pid, contrib)
            else:
                # The segmented commit: past the bank's end is dropped.
                fidx = elem.long() + tally_seg.long()
                if recs is None:
                    add_lanes(flux, fidx, contrib, flux.numel())
                else:
                    recs[0].add(fidx, iters, pid, contrib,
                                fidx < flux.numel())
            if scoring is not None:
                crossed = (active & ~reached).to(contrib.dtype)
                sidx, sval = score_pair(kinds, stride, elem, bin_off, fac,
                                        contrib, crossed)
                if recs is None:
                    add_lanes(bank, sidx, sval, bank.numel())
                else:
                    recs[1].add(sidx, iters,
                                pid.repeat_interleave(len(kinds)), sval,
                                sidx < bank.numel())
        moving = active & ~reached & ~hit_boundary
        elem = torch.where(moving, nxt, elem)
        s = torch.where(active, s_new, s)
        done = done | reached | hit_boundary
        iters += 1
    if recs is not None:
        recs[0].commit(flux)
        if scoring is not None:
            recs[1].commit(bank)
    exited = done & (s < 1)
    at_dest = (done & ~exited)[:, None]
    x_fin = torch.where(at_dest, dest, dest + (s - 1)[:, None] * d0)
    return WalkResult(
        x=x_fin, elem=elem, done=done, exited=exited, flux=flux,
        iters=torch.tensor(iters, dtype=torch.int32, device=x.device), s=s,
    )


def check_plane_layout(mesh: TetMesh, device, dtype) -> int:
    """The unpacked planes' row width as W0 reads them: 16 for a ROW16
    buffer (``TetMesh.with_unpacked_planes``), 20 for a two-tier mesh's
    refinement tier in place (``with_plane_views``). Raises unless the
    normals are [E,4,3] and the offsets [E,4] in ``dtype`` on
    ``device``, in one of those layouts, their row base on a 16-byte
    boundary (the kernel reads whole 16-byte words): no other layout
    walks on the card."""
    nrm, off = mesh.face_normals, mesh.face_offsets
    ne = mesh.nelems
    for name, t, shape in (("face_normals", nrm, (ne, 4, 3)),
                           ("face_offsets", off, (ne, 4))):
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"walk: {name} must be {dtype} {shape} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    row = plane_layout(nrm, off)
    if row is None:
        raise ValueError(
            f"walk: the planes' strides {nrm.stride()} / {off.stride()}, "
            f"{nrm.data_ptr() % 16} B past a 16-byte boundary, are not a "
            "layout the unpacked walk reads: give the mesh its planes in "
            "one ROW16 buffer with TetMesh.with_unpacked_planes() (or "
            "TetMesh.to()), or walk a two-tier mesh's refinement tier in "
            "place through TetMesh.with_plane_views()")
    return row


def _walk_cuda(mesh, x, elem, dest, in_flight, weight, flux, *, tally, tol,
               max_iters, s_init, counts, skip=None, scoring=None,
               deterministic=False, tally_seg=None):
    dev, dt = x.device, x.dtype
    n, ne = x.shape[0], mesh.nelems
    table_args = None
    if mesh.two_tier:
        entry = "walk_twotier"
        tables = [
            ("walk_table_lo", mesh.walk_table_lo, torch.bfloat16,
             (ne, WALK_TABLE_LO_WIDTH)),
            ("walk_table_hi", mesh.walk_table_hi, dt,
             (ne * 4, WALK_PLANE_WIDTH)),
        ]
    elif mesh.unpacked:
        entry = "walk_unpacked"
        tables = [("face_adj", mesh.face_adj, torch.int32, (ne, 4))]
        row = check_plane_layout(mesh, dev, dt)
        table_args = (kernels.ptr(mesh.face_normals),
                      kernels.ptr(mesh.face_adj), row)
    else:
        entry = "walk"
        tables = [("walk_table", mesh.walk_table, dt,
                   (ne, WALK_TABLE_WIDTH))]
    kernels.check_cuda_args("walk", dev, tables + [
        ("x", x, dt, (n, 3)),
        ("elem", elem, torch.int32, (n,)),
        ("dest", dest, dt, (n, 3)),
        ("in_flight", in_flight, torch.int8, (n,)),
        ("weight", weight, dt, (n,)),
        ("s_init", s_init, dt, (n,)),
        # A segmented commit's flux is the sessions' concatenated banks.
        ("flux", flux if tally else None, dt,
         (ne,) if tally_seg is None else (None,)),
        ("counts", counts, torch.int32, (1,)),
        ("skip", skip, torch.bool, ()),
        ("tally_seg", tally_seg, torch.int32, (n,)),
    ])
    flux_size = flux.numel() if tally else 0
    if tally_seg is not None and flux_size >= 2**31:
        raise ValueError("walk: a segmented flux bank of 2**31 entries or "
                         "more does not fit the kernel's int32 indices")
    score_args = ()
    if scoring is not None:
        stride = check_scoring("walk", scoring, flux if tally else None, n)
        kinds, bank, bin_off, fac = scoring
        kernels.check_cuda_args("walk", dev, [
            ("bank", bank, dt, (bank.numel(),)),
            ("bin_off", bin_off, torch.int32, (n,)),
            ("fac", fac, dt, (n, len(kinds))),
        ])
        if bank.numel() >= 2**31:
            raise ValueError("walk: a bank of 2**31 lanes or more does not "
                             "fit the kernel's int32 lane count")
        entry += "_scored"
        score_args = (kernels.ptr(bank), kernels.ptr(bin_off),
                      kernels.ptr(fac), stride, len(kinds),
                      count_mask(kinds), bank.numel())
    # The kernel reads the packed row, the select row or the ids in
    # 16-byte words.
    kernels.check_aligned("walk", [tables[0][:2]])
    if table_args is None:
        table_args = tuple(kernels.ptr(t) for _, t, _, _ in tables)
    x_out = torch.empty((n, 3), dtype=dt, device=dev)
    elem_out = torch.empty((n,), dtype=torch.int32, device=dev)
    done = torch.empty((n,), dtype=torch.bool, device=dev)
    exited = torch.empty((n,), dtype=torch.bool, device=dev)
    s = torch.empty((n,), dtype=dt, device=dev)
    # iters and the kernel's particle counter, zeroed in one fill.
    scratch = torch.zeros((2,), dtype=torch.int32, device=dev)
    # The kernel reads the flag as an int32 (held until after launch).
    skip_i = None if skip is None else skip.to(torch.int32)
    p = kernels.ptr

    def launch(det=None):
        kernels.launch(
            entry, dt, dev, *score_args, *table_args, p(x), p(elem),
            p(dest), p(in_flight), p(weight), p(s_init),
            p(flux if tally else None),
            p(x_out), p(elem_out), p(done), p(exited), p(s), p(scratch),
            p(scratch[1:]), p(counts), p(skip_i), n, float(tol),
            int(max_iters), int(bool(tally)), p(tally_seg), int(flux_size),
            det,
        )

    if not (deterministic and tally):
        launch()
    else:
        # W0 writes new outputs; its counters are put back for a redo.
        walk_and_commit("walk", launch, n, flux, scoring, (scratch, counts),
                        workspace(deterministic))
    return WalkResult(x=x_out, elem=elem_out, done=done, exited=exited,
                      flux=flux, iters=scratch[0], s=s)


def walk(
    mesh: TetMesh, x, elem, dest, in_flight, weight, flux, *,
    tally: bool, tol: float, max_iters: int, s_init=None,
    table_dtype: Optional[str] = None, counts=None, skip=None, scoring=None,
    deterministic=False, tally_seg=None,
) -> WalkResult:
    """Walk every particle from ``x`` (inside ``elem``) toward ``dest``.

    Particles with ``in_flight == 0`` must be given ``dest == x`` by the
    caller (hold position); they finish on their first step with zero
    tally. ``flux`` may be None when ``tally`` is False. ``s_init``
    continues an interrupted walk's exact parametrisation (pass the
    previous ``s`` with the ORIGINAL x/dest).

    The tier is the mesh's: two-tier tables walk the two-tier path.
    ``table_dtype`` ("bfloat16", "float32" or "auto") asks for a tier,
    as the JAX walk's does: "bfloat16" refuses a mesh without the
    two-tier tables, "float32" walks a two-tier mesh's full-precision
    planes in place (``TetMesh.with_plane_views``).

    CUDA tensors launch kernel W0 (its two-tier variant on a two-tier
    mesh, its unpacked one on the unpacked planes); CPU tensors run
    ``walk_plain``. ``counts`` (CUDA only: an
    int32 [1] tensor) gets the number of particles the kernel walked
    added to it. ``skip`` (a 0-d bool tensor on the particles' device):
    when true, nothing is walked and the inputs come back (x, elem, s
    = ``s_init`` or 0, done, not exited). ``scoring``: ``(kinds, bank,
    bin_off, fac)``, see the module docstring. ``deterministic``: the
    deterministic commit (module docstring; W0's kDet instantiation and
    DC on the card), for a tallying walk: True, or the
    ``det_commit.DetWorkspace`` whose record streams it reuses.
    ``tally_seg``: the segmented commit (module docstring; int32 [n],
    tallying walks only), ``flux`` then the concatenated bank.

    On the profiler's timeline the call is a ``ptt.walk`` span: the
    wrapper's host work through the launch's return (on the CPU, the
    whole plain walk)."""
    with span("ptt.walk"):
        check_tally_seg(tally_seg, tally, x.shape[0])
        if tally and flux is None:
            raise ValueError("a tallying walk needs a flux tensor")
        if counts is not None and not x.is_cuda:
            raise ValueError("walk: counts are counted by the CUDA kernel; "
                             "the plain version has no schedule")
        mesh = mesh_for_tier(mesh, table_dtype)
        if x.is_cuda:
            return _walk_cuda(mesh, x, elem, dest, in_flight, weight, flux,
                              tally=tally, tol=tol, max_iters=max_iters,
                              s_init=s_init, counts=counts, skip=skip,
                              scoring=scoring, deterministic=deterministic,
                              tally_seg=tally_seg)
        if x.device.type != "cpu":
            raise ValueError(
                f"walk runs on CUDA or CPU tensors, not {x.device}")
        return walk_plain(mesh, x, elem, dest, in_flight, weight, flux,
                          tally=tally, tol=tol, max_iters=max_iters,
                          s_init=s_init, skip=skip, scoring=scoring,
                          deterministic=deterministic, tally_seg=tally_seg)


def walk_xpoints(mesh: TetMesh, x, elem, dest, in_flight, *, tol: float,
                 max_iters: int, table_dtype: Optional[str] = None):
    """Replay a transport and return each particle's LAST
    face-intersection point [N,3] (the JAX ``walk_xpoints``, the
    reference's ``getIntersectionPoints()``, PumiTallyImpl.h:177-178): a
    particle's starting position until it crosses a face, then the point
    of every crossing it makes, the boundary exit included. Particles
    with ``in_flight != 1`` hold. No tally, a masked lock-step loop over
    every particle: an inspection path, plain PyTorch on any device.
    ``table_dtype`` picks the tier as ``walk`` does (None: the mesh's),
    so the replay walks the tier and layout of the move it
    reconstructs."""
    mesh = mesh_for_tier(mesh, table_dtype)
    n = x.shape[0]
    dest = torch.where((in_flight == 1)[:, None], dest, x)  # stopped: hold
    d0 = dest - x
    tol_t = torch.tensor(tol, dtype=x.dtype, device=x.device)
    s = torch.zeros((n,), dtype=x.dtype, device=x.device)
    s_cross = torch.zeros_like(s)
    elem = elem.to(torch.int32)
    done = torch.zeros((n,), dtype=torch.bool, device=x.device)
    iters = 0
    while iters < max_iters and not bool(done.all()):
        active = ~done
        s_new, nxt, reached = advance_mesh(mesh, elem.long(), s, d0, dest,
                                           tol_t)
        hit_boundary = ~reached & (nxt == -1)
        # A face was crossed this step (interior or the boundary exit).
        s_cross = torch.where(active & ~reached, s_new, s_cross)
        elem = torch.where(active & ~reached & ~hit_boundary, nxt, elem)
        s = torch.where(active, s_new, s)
        done = done | reached | hit_boundary
        iters += 1
    return x + s_cross[:, None] * d0
