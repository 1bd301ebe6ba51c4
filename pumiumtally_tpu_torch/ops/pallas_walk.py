"""Two-tier block walk of the partitioned engine's sub-split mesh (port of
``pumiumtally_tpu/ops/pallas_walk.py`` ``pallas_walk_local``, kernel K2),
as kernel W2 (csrc/twotier_block_walk.cu) with its plain PyTorch version
beside it.

The name is kept so a reader finds the counterpart. The contract is K2's,
not its mechanism: the bf16 SELECT row picks each crossing's exit face,
ONE full-precision refinement row of the winning face re-solves the
crossing and names the neighbour (ops/walk.py ``select_faces_lo`` /
``refine_face_hi``), a crossing into another block parks the particle
with ``pending = -nxt-2``, boundary exits clamp and finish. The TPU
mechanics are gone: the one-hot MXU row fetch (an indexed load here),
the ``Lp``/TILE_1D block padding (``pack_hi_blocks``, ``pad_lo_blocks``:
W2 reads ``table_hi`` in its ``[blocks*L*4,5]`` layout directly), the
particle tiles and the grid's double-buffered streaming. On the card W2
runs W1's schedule (csrc/block_walk_sched.cuh, ops/vmem_walk.py): a CUDA
block whose work list holds a particle copies its partition block's
bf16 rows into shared memory if they fit with a flux partial and the
list (``w2_uses_shared``); a larger block reads them from global
memory.

``scoring=(kinds, bank, bin_off, fac)`` is K2's in-kernel scoring
lowering: ``bank`` is the engine's padded ``[blocks*L*stride]`` bank,
block b's lanes the ``[L*stride]`` slice at ``b*L*stride``; each
crossing adds ``score_pair``'s values (ops/walk.py) into lane
``lelem*stride + bin_off + k`` of its block's slice, and a lane with
``bin_off + k >= stride`` (the DROP sentinel's) is dropped, as K2's
column match drops it. K2 sums a per-tile matmul partial, W2 adds per
crossing (atomics on the card): only the order of the additions
differs. ``flux`` and ``bank`` are updated IN PLACE; on the card the
scoring walk counts as ``twotier_block_walk_scored``.

``deterministic`` (tallying walks; the facades' ``CheckpointPolicy``)
commits flux and lanes through the deterministic commit
(ops/det_commit.py), as W1 does (ops/vmem_walk.py): W2's kDet
instantiations write one record a contribution, keyed (block-padded row
or lane, step, slot), in place of the partial and the atomics, and DC
adds them in the order of the plain version's serial ``index_add_``.
"""

from __future__ import annotations

from typing import Optional

import torch

from pumiumtally_tpu_torch import kernels
from pumiumtally_tpu_torch.mesh.tetmesh import (
    WALK_PLANE_WIDTH,
    WALK_TABLE_LO_WIDTH,
    WALK_TABLE_WIDTH,
)
from pumiumtally_tpu_torch.ops.det_commit import walk_and_commit, workspace
from pumiumtally_tpu_torch.ops.vmem_walk import (
    check_sched_counts,
    sched_smem_layout,
)
from pumiumtally_tpu_torch.ops.walk import (
    PlainRecords,
    add_lanes,
    check_scoring,
    count_mask,
    eff_weight,
    refine_face_hi,
    score_pair,
    select_faces_lo,
)


def modeled_walk_bytes(kernel: str, table_dtype: str = "float32") -> int:
    """Modeled table bytes per crossing, from the layout constants (the
    JAX package's model): 80 for the packed f32 row, 52 for the two-tier
    bf16 select row plus one f32 refinement row, 0 for a table resident
    in fast memory (the "vmem" kernel)."""
    if kernel == "vmem":
        if table_dtype != "float32":
            raise ValueError(
                "the vmem kernel has no two-tier lowering "
                "(ops/vmem_walk.py); use kernel='pallas' for bfloat16"
            )
        return 0
    if kernel not in ("gather", "pallas"):
        raise ValueError(
            f"kernel must be 'gather', 'vmem' or 'pallas', got {kernel!r}"
        )
    if table_dtype == "float32":
        if kernel == "pallas":
            raise ValueError(
                "the pallas walk kernel is two-tier only "
                "(walk_table_dtype='bfloat16')"
            )
        return WALK_TABLE_WIDTH * 4  # 80 B: one packed f32 row
    if table_dtype == "bfloat16":
        # 52 B: bf16 select row + ONE f32 refinement plane.
        return WALK_TABLE_LO_WIDTH * 2 + WALK_PLANE_WIDTH * 4
    raise ValueError(
        f"table_dtype must be 'float32' or 'bfloat16', got {table_dtype!r}"
    )


def w2_uses_shared(L: int, dtype: torch.dtype) -> bool:
    """Whether W2 may stage a block of L elements in shared memory (its
    [L,16] bf16 select rows, an [L] flux partial and one pass of work
    list: L <= 6,399 in f32, 5,759 in f64) or always reads it from
    global memory."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return sched_smem_layout(L * WALK_TABLE_LO_WIDTH * 2,
                             L * itemsize) is not None


def _check_layout(table_lo, table_hi, n: int, blocks: int) -> int:
    """Validate the stacked-block layout; returns L."""
    if table_lo.dtype != torch.bfloat16:
        raise ValueError(
            "pallas_walk_local needs the bf16 SELECT tier "
            f"(got {table_lo.dtype}); build the partition with "
            "table_dtype='bfloat16'"
        )
    rows = table_lo.shape[0]
    if n % blocks or rows % blocks:
        raise ValueError(
            f"blocked walk needs slots and table rows divisible into "
            f"{blocks} blocks, got S={n}, rows={rows}"
        )
    if tuple(table_hi.shape) != (rows * 4, WALK_PLANE_WIDTH):
        raise ValueError(
            f"table_hi has shape {tuple(table_hi.shape)}, needs "
            f"{(rows * 4, WALK_PLANE_WIDTH)}"
        )
    return rows // blocks


def pallas_walk_local_plain(
    table_lo, table_hi, x, lelem, dest, flying, weight, done, exited, flux,
    *, tally: bool, tol: float, max_iters: int, blocks: int = 1,
    scoring=None, deterministic=False,
):
    """W2's plain PyTorch version: every slot of every block in one
    masked lock-step loop over the stacked tiers. ``deterministic``:
    flux and lanes committed as the deterministic commit's records
    (keyed by padded row or lane, step, slot), the same values in the
    same order as the serial ``index_add_``."""
    n = x.shape[0]
    blocks = int(blocks)
    L = _check_layout(table_lo, table_hi, n, blocks)
    if scoring is not None:
        stride = check_scoring("pallas_walk_local_plain", scoring,
                               flux if tally else None, n)
        kinds, bank, bin_off, fac = scoring
        # K2's column match: a lane past its element's stride is dropped.
        lane_ok = (bin_off.long()[:, None]
                   + torch.arange(len(kinds), device=x.device)
                   < stride).reshape(-1)
    pending = torch.full((n,), -1, dtype=torch.int32, device=x.device)
    if n == 0:
        return (x, lelem, done, exited, pending, flux,
                torch.tensor(0, dtype=torch.int32, device=x.device))
    base = (torch.arange(n, device=x.device) // (n // blocks)) * L
    d0 = dest - x
    # The ray's destination rebuilt from the invariants, as K2 does.
    dest_c = x + d0
    eff_w = eff_weight(d0, flying, weight) if tally else None
    tol_t = torch.tensor(tol, dtype=x.dtype, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    s = torch.zeros((n,), dtype=x.dtype, device=x.device)
    lelem = lelem.to(torch.int32).clone()
    done = done.clone()
    exited = exited.clone()
    recs = (PlainRecords(), PlainRecords()) if deterministic and tally \
        else None
    pid = torch.arange(n, device=x.device)
    iters = 0
    while iters < max_iters:
        active = ~done & (pending < 0)
        if not bool(active.any()):
            break
        rows = base + lelem.long()
        s_sel, f_exit = select_faces_lo(table_lo, s, rows, dest_c, d0, tol_t)
        s_exit, nxt = refine_face_hi(table_hi, s, rows, f_exit, s_sel, dest_c,
                                     d0, tol_t)
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
                crossed = (active & ~reached).to(contrib.dtype)
                sidx, sval = score_pair(kinds, stride, rows, bin_off, fac,
                                        contrib, crossed)
                if recs is None:
                    add_lanes(bank, sidx[lane_ok], sval[lane_ok],
                              bank.numel())
                else:
                    recs[1].add(sidx, iters,
                                pid.repeat_interleave(len(kinds)), sval,
                                lane_ok)
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
    # everyone else commits x0 + s*d0 from the ORIGINAL x0 (K2's rule).
    at_dest = (done & ~exited)[:, None]
    x_fin = torch.where(at_dest, dest, x + s[:, None] * d0)
    return (x_fin, lelem, done, exited, pending, flux,
            torch.tensor(iters, dtype=torch.int32, device=x.device))


def _pallas_walk_cuda(table_lo, table_hi, x, lelem, dest, flying, weight,
                      done, exited, flux, *, tally, tol, max_iters, blocks,
                      sched_counts=None, scoring=None, deterministic=False):
    dev, dt = x.device, x.dtype
    n = x.shape[0]
    L = _check_layout(table_lo, table_hi, n, blocks)
    kernels.check_aligned("pallas_walk_local", [("table_lo", table_lo)])
    kernels.check_cuda_args("pallas_walk_local", dev, [
        ("table_lo", table_lo, torch.bfloat16,
         (blocks * L, WALK_TABLE_LO_WIDTH)),
        ("table_hi", table_hi, dt, (blocks * L * 4, WALK_PLANE_WIDTH)),
        ("x", x, dt, (n, 3)),
        ("lelem", lelem, torch.int32, (n,)),
        ("dest", dest, dt, (n, 3)),
        ("flying", flying, torch.int8, (n,)),
        ("weight", weight, dt, (n,)),
        ("done", done, torch.bool, (n,)),
        ("exited", exited, torch.bool, (n,)),
        ("flux", flux if tally else None, dt, (blocks * L,)),
    ])
    entry, score_args = "twotier_block_walk", ()
    if scoring is not None:
        stride = check_scoring("pallas_walk_local", scoring,
                               flux if tally else None, n)
        kinds, bank, bin_off, fac = scoring
        kernels.check_cuda_args("pallas_walk_local", dev, [
            ("bank", bank, dt, (blocks * L * stride,)),
            ("bin_off", bin_off, torch.int32, (n,)),
            ("fac", fac, dt, (n, len(kinds))),
        ])
        entry = "twotier_block_walk_scored"
        score_args = (kernels.ptr(bank), kernels.ptr(bin_off),
                      kernels.ptr(fac), stride, len(kinds),
                      count_mask(kinds))
    x_out = torch.empty((n, 3), dtype=dt, device=dev)
    lelem_out = torch.empty((n,), dtype=torch.int32, device=dev)
    done_out = torch.empty((n,), dtype=torch.bool, device=dev)
    exited_out = torch.empty((n,), dtype=torch.bool, device=dev)
    pending = torch.empty((n,), dtype=torch.int32, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    p = kernels.ptr

    def launch(det=None):
        kernels.launch(
            entry, dt, dev, *score_args, p(table_lo), p(table_hi), p(x),
            p(lelem), p(dest), p(flying), p(weight), p(done), p(exited),
            p(flux if tally else None), p(x_out), p(lelem_out), p(done_out),
            p(exited_out), p(pending), p(iters), p(sched_counts), blocks, L,
            n // blocks, float(tol), int(max_iters), int(bool(tally)),
            int(w2_uses_shared(L, dt)), det,
        )

    if deterministic and tally:
        walk_and_commit("pallas_walk_local", launch, n, flux, scoring,
                        (iters, sched_counts), workspace(deterministic))
    else:
        launch()
    return x_out, lelem_out, done_out, exited_out, pending, flux, iters


def pallas_walk_local(
    table_lo, table_hi, x, lelem, dest, flying, weight, done, exited, flux,
    *, tally: bool, tol: float, max_iters: int, blocks: int = 1,
    sched_counts: Optional[torch.Tensor] = None, scoring=None,
    deterministic=False,
):
    """Two-tier block walk: returns ``(x, lelem, done, exited, pending,
    flux, iters)``, the JAX function's tuple.

    ``table_lo`` is ``blocks`` stacked [L,16] bf16 select tables,
    ``table_hi`` the matching [blocks*L*4,5] refinement rows; the S
    slots are grouped by block (``S // blocks`` each) with block-local
    ``lelem``; ``flux`` is [blocks*L] and is updated in place (None when
    not tallying). CUDA tensors launch kernel W2; CPU tensors run
    ``pallas_walk_local_plain``. ``sched_counts`` (CUDA only,
    ops/vmem_walk.py ``check_sched_counts``) collects what the kernel's
    CUDA blocks did. ``scoring``: ``(kinds, bank, bin_off, fac)``, see
    the module docstring. ``deterministic``: the deterministic commit
    (module docstring), for a tallying walk: True, or the
    ``det_commit.DetWorkspace`` whose record streams it reuses."""
    blocks = int(blocks)
    if tally and flux is None:
        raise ValueError("a tallying walk needs a flux tensor")
    check_sched_counts("pallas_walk_local", sched_counts, x.device)
    if x.is_cuda:
        return _pallas_walk_cuda(table_lo, table_hi, x, lelem, dest, flying,
                                 weight, done, exited, flux, tally=tally,
                                 tol=tol, max_iters=max_iters, blocks=blocks,
                                 sched_counts=sched_counts, scoring=scoring,
                                 deterministic=deterministic)
    if x.device.type != "cpu":
        raise ValueError(
            f"pallas_walk_local runs on CUDA or CPU tensors, not {x.device}"
        )
    return pallas_walk_local_plain(
        table_lo, table_hi, x, lelem, dest, flying, weight, done, exited,
        flux, tally=tally, tol=tol, max_iters=max_iters, blocks=blocks,
        scoring=scoring, deterministic=deterministic,
    )
