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

Left out against the JAX walk: the compaction cascade (a thread that
walks its particle to completion has no lock-step waste to bound),
``perm_mode``, ``scoring`` and ``tally_seg``. ``max_iters`` is a
per-particle step budget; the JAX walk checks it every ``cond_every``
(4) steps, so it may take up to 3 more.

``walk`` launches W0 for CUDA tensors and runs ``walk_plain`` only for
CPU tensors. Flux is accumulated IN PLACE into the ``flux`` argument
(the JAX walk returns a new array).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

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
)

_N0 = WALK_TABLE_NORMALS.start
_O0 = WALK_TABLE_OFFSETS.start
_A0 = WALK_TABLE_ADJ.start
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


def advance_cols(row, s, d0, dest, tol):
    """One crossing for every row of a lock-step batch, column-wise —
    the operation order of csrc/walk_step.cuh, so that on the card the
    kernels match this bitwise. ``row`` is [N,20] (the gathered table
    rows), ``tol`` a 0-dim tensor in the working dtype. Returns
    (s_new, next_elem, reached)."""
    one = torch.ones((), dtype=s.dtype, device=s.device)
    inf = torch.full((), float("inf"), dtype=s.dtype, device=s.device)
    s_exit = nxt = None
    for f in range(4):
        a, b, crossing = _crossing(
            row[:, _N0 + 3 * f], row[:, _N0 + 3 * f + 1],
            row[:, _N0 + 3 * f + 2], row[:, _O0 + f], s, d0, dest, one, tol,
        )
        s_f = torch.where(crossing, b / torch.where(crossing, a, one), inf)
        s_f = torch.maximum(s_f, s)
        adj = row[:, _A0 + f].to(torch.int32)
        if f == 0:
            s_exit, nxt = s_f, adj
        else:
            better = s_f < s_exit  # strict: the first minimal face wins
            s_exit = torch.where(better, s_f, s_exit)
            nxt = torch.where(better, adj, nxt)
    reached = s_exit >= one
    return torch.where(reached, one, s_exit), nxt, reached


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


def eff_weight(d0, in_flight, weight):
    """eff_w = flying * weight * |d0|, in the kernels' operation order."""
    seg = torch.sqrt(d0[:, 0] * d0[:, 0] + d0[:, 1] * d0[:, 1]
                     + d0[:, 2] * d0[:, 2])
    return torch.where(in_flight != 0, weight * seg, torch.zeros_like(seg))


def walk_plain(
    mesh: TetMesh, x, elem, dest, in_flight, weight, flux, *,
    tally: bool, tol: float, max_iters: int, s_init=None,
) -> WalkResult:
    """W0's plain PyTorch version: a masked lock-step loop, one crossing
    of every unfinished particle per iteration (two-tier when the mesh
    carries the two-tier tables)."""
    n = x.shape[0]
    d0 = dest - x
    eff_w = eff_weight(d0, in_flight, weight) if tally else None
    tol_t = torch.tensor(tol, dtype=x.dtype, device=x.device)
    s = (torch.zeros((n,), dtype=x.dtype, device=x.device) if s_init is None
         else s_init.to(x.dtype).clone())
    elem = elem.to(torch.int32).clone()
    done = torch.zeros((n,), dtype=torch.bool, device=x.device)
    iters = 0
    while iters < max_iters and not bool(done.all()):
        active = ~done
        if mesh.two_tier:
            s_new, nxt, reached = advance_twotier(
                mesh.walk_table_lo, mesh.walk_table_hi, elem.long(), s, d0,
                dest, tol_t,
            )
        else:
            s_new, nxt, reached = advance_cols(
                mesh.walk_table[elem.long()], s, d0, dest, tol_t
            )
        hit_boundary = ~reached & (nxt == -1)
        if tally:
            contrib = torch.where(active, (s_new - s) * eff_w,
                                  torch.zeros_like(s))
            flux.index_add_(0, elem.long(), contrib)
        moving = active & ~reached & ~hit_boundary
        elem = torch.where(moving, nxt, elem)
        s = torch.where(active, s_new, s)
        done = done | reached | hit_boundary
        iters += 1
    exited = done & (s < 1)
    at_dest = (done & ~exited)[:, None]
    x_fin = torch.where(at_dest, dest, dest + (s - 1)[:, None] * d0)
    return WalkResult(
        x=x_fin, elem=elem, done=done, exited=exited, flux=flux,
        iters=torch.tensor(iters, dtype=torch.int32, device=x.device), s=s,
    )


def _walk_cuda(mesh, x, elem, dest, in_flight, weight, flux, *, tally, tol,
               max_iters, s_init, counts):
    dev, dt = x.device, x.dtype
    n, ne = x.shape[0], mesh.nelems
    if mesh.two_tier:
        entry = "walk_twotier"
        tables = [
            ("walk_table_lo", mesh.walk_table_lo, torch.bfloat16,
             (ne, WALK_TABLE_LO_WIDTH)),
            ("walk_table_hi", mesh.walk_table_hi, dt,
             (ne * 4, WALK_PLANE_WIDTH)),
        ]
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
        ("flux", flux if tally else None, dt, (ne,)),
        ("counts", counts, torch.int32, (1,)),
    ])
    # The kernel reads the packed row or the select row in 16-byte words.
    kernels.check_aligned("walk", [tables[0][:2]])
    x_out = torch.empty((n, 3), dtype=dt, device=dev)
    elem_out = torch.empty((n,), dtype=torch.int32, device=dev)
    done = torch.empty((n,), dtype=torch.bool, device=dev)
    exited = torch.empty((n,), dtype=torch.bool, device=dev)
    s = torch.empty((n,), dtype=dt, device=dev)
    # iters and the kernel's particle counter, zeroed in one fill.
    scratch = torch.zeros((2,), dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch(
        entry, dt, dev, *(p(t) for _, t, _, _ in tables), p(x), p(elem),
        p(dest), p(in_flight), p(weight), p(s_init),
        p(flux if tally else None),
        p(x_out), p(elem_out), p(done), p(exited), p(s), p(scratch),
        p(scratch[1:]), p(counts), n, float(tol), int(max_iters),
        int(bool(tally)),
    )
    return WalkResult(x=x_out, elem=elem_out, done=done, exited=exited,
                      flux=flux, iters=scratch[0], s=s)


def walk(
    mesh: TetMesh, x, elem, dest, in_flight, weight, flux, *,
    tally: bool, tol: float, max_iters: int, s_init=None,
    table_dtype: Optional[str] = None, counts=None,
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
    planes.

    CUDA tensors launch kernel W0 (its two-tier variant on a two-tier
    mesh); CPU tensors run ``walk_plain``. ``counts`` (CUDA only: an
    int32 [1] tensor) gets the number of particles the kernel walked
    added to it."""
    if tally and flux is None:
        raise ValueError("a tallying walk needs a flux tensor")
    if counts is not None and not x.is_cuda:
        raise ValueError("walk: counts are counted by the CUDA kernel; the "
                         "plain version has no schedule")
    if table_dtype is not None:
        lo_select = resolve_table_dtype(table_dtype) == "bfloat16"
        if lo_select and not mesh.two_tier:
            raise ValueError(
                "table_dtype='bfloat16' needs the two-tier walk tables — "
                "build the mesh with table_dtype='bfloat16' or convert it "
                "with TetMesh.with_lowp_tables()"
            )
        if not lo_select:
            mesh = mesh.with_packed_table()
    if x.is_cuda:
        return _walk_cuda(mesh, x, elem, dest, in_flight, weight, flux,
                          tally=tally, tol=tol, max_iters=max_iters,
                          s_init=s_init, counts=counts)
    if x.device.type != "cpu":
        raise ValueError(f"walk runs on CUDA or CPU tensors, not {x.device}")
    return walk_plain(mesh, x, elem, dest, in_flight, weight, flux,
                      tally=tally, tol=tol, max_iters=max_iters,
                      s_init=s_init)
