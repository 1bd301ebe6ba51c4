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

Left out against the JAX walk: the compaction cascade (a thread that
walks its particle to completion has no lock-step waste to bound),
``perm_mode``, the two-tier ``lo_select`` path, ``scoring`` and
``tally_seg``. ``max_iters`` is a per-particle step budget; the JAX
walk checks it every ``cond_every`` (4) steps, so it may take up to 3
more.

``walk`` launches W0 for CUDA tensors and runs ``walk_plain`` only for
CPU tensors. Flux is accumulated IN PLACE into the ``flux`` argument
(the JAX walk returns a new array).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pumiumtally_tpu_torch import kernels
from pumiumtally_tpu_torch.mesh.tetmesh import (
    WALK_TABLE_ADJ,
    WALK_TABLE_NORMALS,
    WALK_TABLE_OFFSETS,
    WALK_TABLE_WIDTH,
    TetMesh,
)

_N0 = WALK_TABLE_NORMALS.start
_O0 = WALK_TABLE_OFFSETS.start
_A0 = WALK_TABLE_ADJ.start


class WalkResult(NamedTuple):
    """Post-walk particle state (fields as in the JAX package)."""

    x: torch.Tensor  # [N,3] committed position
    elem: torch.Tensor  # [N] int32 final element
    done: torch.Tensor  # [N] bool (False = step budget ran out)
    exited: torch.Tensor  # [N] bool: finished by leaving the domain
    flux: Optional[torch.Tensor]  # [E], the input tensor, updated in place
    iters: torch.Tensor  # [] int32: most steps any particle took
    s: torch.Tensor  # [N] final ray coordinate along x0 -> dest


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
        nx = row[:, _N0 + 3 * f]
        ny = row[:, _N0 + 3 * f + 1]
        nz = row[:, _N0 + 3 * f + 2]
        a = nx * d0[:, 0] + ny * d0[:, 1] + nz * d0[:, 2]
        n_dest = nx * dest[:, 0] + ny * dest[:, 1] + nz * dest[:, 2]
        b = row[:, _O0 + f] - n_dest + a
        crossing = a * (one - s) > tol
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
    of every unfinished particle per iteration."""
    n = x.shape[0]
    d0 = dest - x
    eff_w = eff_weight(d0, in_flight, weight) if tally else None
    tol_t = torch.tensor(tol, dtype=x.dtype, device=x.device)
    s = (torch.zeros((n,), dtype=x.dtype, device=x.device) if s_init is None
         else s_init.to(x.dtype).clone())
    elem = elem.to(torch.int32).clone()
    done = torch.zeros((n,), dtype=torch.bool, device=x.device)
    table = mesh.walk_table
    iters = 0
    while iters < max_iters and not bool(done.all()):
        active = ~done
        s_new, nxt, reached = advance_cols(
            table[elem.long()], s, d0, dest, tol_t
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
               max_iters, s_init):
    dev, dt = x.device, x.dtype
    n, ne = x.shape[0], mesh.nelems
    kernels.check_cuda_args("walk", dev, [
        ("walk_table", mesh.walk_table, dt, (ne, WALK_TABLE_WIDTH)),
        ("x", x, dt, (n, 3)),
        ("elem", elem, torch.int32, (n,)),
        ("dest", dest, dt, (n, 3)),
        ("in_flight", in_flight, torch.int8, (n,)),
        ("weight", weight, dt, (n,)),
        ("s_init", s_init, dt, (n,)),
        ("flux", flux if tally else None, dt, (ne,)),
    ])
    x_out = torch.empty((n, 3), dtype=dt, device=dev)
    elem_out = torch.empty((n,), dtype=torch.int32, device=dev)
    done = torch.empty((n,), dtype=torch.bool, device=dev)
    exited = torch.empty((n,), dtype=torch.bool, device=dev)
    s = torch.empty((n,), dtype=dt, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch(
        "walk", dt, dev, p(mesh.walk_table), p(x), p(elem), p(dest),
        p(in_flight), p(weight), p(s_init), p(flux if tally else None),
        p(x_out), p(elem_out), p(done), p(exited), p(s), p(iters), n,
        float(tol), int(max_iters), int(bool(tally)),
    )
    return WalkResult(x=x_out, elem=elem_out, done=done, exited=exited,
                      flux=flux, iters=iters, s=s)


def walk(
    mesh: TetMesh, x, elem, dest, in_flight, weight, flux, *,
    tally: bool, tol: float, max_iters: int, s_init=None,
) -> WalkResult:
    """Walk every particle from ``x`` (inside ``elem``) toward ``dest``.

    Particles with ``in_flight == 0`` must be given ``dest == x`` by the
    caller (hold position); they finish on their first step with zero
    tally. ``flux`` may be None when ``tally`` is False. ``s_init``
    continues an interrupted walk's exact parametrisation (pass the
    previous ``s`` with the ORIGINAL x/dest).

    CUDA tensors launch kernel W0; CPU tensors run ``walk_plain``."""
    if tally and flux is None:
        raise ValueError("a tallying walk needs a flux tensor")
    if x.is_cuda:
        return _walk_cuda(mesh, x, elem, dest, in_flight, weight, flux,
                          tally=tally, tol=tol, max_iters=max_iters,
                          s_init=s_init)
    if x.device.type != "cpu":
        raise ValueError(f"walk runs on CUDA or CPU tensors, not {x.device}")
    return walk_plain(mesh, x, elem, dest, in_flight, weight, flux,
                      tally=tally, tol=tol, max_iters=max_iters,
                      s_init=s_init)
