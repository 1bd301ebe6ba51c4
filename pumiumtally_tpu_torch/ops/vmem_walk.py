"""Block-local walk of the partitioned engine's sub-split mesh (port of
``pumiumtally_tpu/ops/vmem_walk.py`` ``vmem_walk_local``), as kernel W1
(csrc/block_walk.cu) with its plain PyTorch version beside it.

The name is kept so a reader finds the counterpart; on the card a CUDA
block's dynamic SHARED MEMORY plays the role VMEM plays on the TPU: it
holds one partition block's [L,20] walk table and an [L] flux partial
while the block's particles walk. The TPU-only mechanics of the JAX
kernel are gone: the one-hot MXU row fetch (an indexed load here), the
[Lp,32] table padding, TILE_1D tiles and the scoped-VMEM ceiling and its
env override. In their place stands this card's own ceiling,
``smem_ceiling_elems``.

W1 and W2 share one schedule (csrc/block_walk_sched.cuh), whose
arithmetic is mirrored here for the CPU tests: a persistent grid of
(blocks, k) CUDA blocks (``sched_blocks_per_part``), each owning every
k-th chunk of ``SCHED_THREADS`` slots of its partition block
(``sched_chunks``), compacting those chunks' active slots into a shared
work list, a batch of chunks at a time (``sched_smem_layout``,
``sched_batches``), and staging the table once the list holds a
particle.

Semantics are the JAX kernel's: a crossing whose neighbour lives in
another block (adjacency <= -2, encoded -(glid+2)) parks the particle
with ``pending = glid`` for migration; boundary exits clamp and finish;
``iters`` is the most steps any particle took (the JAX per-tile loop
count, max-reduced). ``flux`` is updated IN PLACE.

``deterministic`` (tallying walks; the facades' ``CheckpointPolicy``)
commits flux through the deterministic commit (ops/det_commit.py): on
the card W1's kDet instantiation writes one record a contribution, keyed
(block-padded row, step, slot), in place of the shared-memory partial
and its atomics, and DC adds them in the order of the plain version's
serial ``index_add_``; the plain version builds the same records and
commits them with ``det_commit_plain``. W1 writes new output tensors and
leaves flux alone until DC, so a record stream that ran out of room is
grown and the walk made again from its untouched inputs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from pumiumtally_tpu_torch import kernels
from pumiumtally_tpu_torch.mesh.tetmesh import WALK_TABLE_WIDTH
from pumiumtally_tpu_torch.ops.det_commit import walk_and_commit, workspace
from pumiumtally_tpu_torch.ops.walk import (
    PlainRecords,
    advance_cols,
    eff_weight,
)

# Dynamic shared memory one CUDA block may use on an H100 (227 KB).
SMEM_BYTES_PER_BLOCK = 232_448

# The block walks' schedule (csrc/block_walk_sched.cuh): CUDA blocks of
# SCHED_THREADS threads; in shared memory a header, then the staged table
# and flux partial, then a work list of at most SCHED_LIST_MAX slot ids
# and at least one pass of SCHED_THREADS.
SCHED_THREADS = 512
SCHED_LIST_MAX = 4096
SCHED_HEADER_BYTES = 32

# The kernels' optional count output (csrc/block_walk_sched.cuh): CUDA
# blocks with no active slot, that read rows from global memory, that
# staged the table in shared memory; active slots walked; idle slots
# written out.
SCHED_COUNTS = ("no active slot", "global rows", "TMA-staged", "walked",
                "idle")

# The JAX engine rounds each block's slot capacity up to whole particle
# tiles of this width; the port keeps the same slot layout so engine
# state compares slot by slot (ops/vmem_walk.py W_TILE_DEFAULT).
W_TILE_DEFAULT = 1024


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def sched_smem_layout(table_bytes: int,
                      part_bytes: int) -> Optional[Tuple[int, int]]:
    """``(bytes, list_cap)``: the dynamic shared memory of a block walk's
    CUDA block that may stage a table of ``table_bytes`` and a flux
    partial of ``part_bytes`` (both 0: it never stages), and its work
    list's capacity in slots (whole passes of ``SCHED_THREADS``, at most
    ``SCHED_LIST_MAX``). None when not even one pass of list fits."""
    list_off = SCHED_HEADER_BYTES + _round16(table_bytes) \
        + _round16(part_bytes)
    room = (SMEM_BYTES_PER_BLOCK - list_off) // 4
    cap = min(SCHED_LIST_MAX, room // SCHED_THREADS * SCHED_THREADS)
    if cap < SCHED_THREADS:
        return None
    return list_off + 4 * cap, cap


def sched_blocks_per_part(nparts: int, resident: int) -> int:
    """k, the CUDA blocks per partition block: ``resident`` (SMs times the
    blocks the occupancy query fits on one) shared out so that the whole
    (nparts, k) grid is resident at once, at least 1."""
    return max(1, int(resident) // int(nparts))


def sched_chunks(cap_b: int, k: int, j: int) -> List[Tuple[int, int]]:
    """The slots of its partition block that CUDA block j of k owns:
    chunks ``[lo, hi)`` of ``SCHED_THREADS`` consecutive slots, every k-th
    one from chunk j. Interleaved, not contiguous: the engine's migration
    ranks a round's arrivals by their source block, so active slots come
    in runs that one contiguous share would hold alone."""
    n = -(-int(cap_b) // SCHED_THREADS)
    return [(c * SCHED_THREADS, min((c + 1) * SCHED_THREADS, cap_b))
            for c in range(j, n, k)]


def sched_batches(chunks: List[Tuple[int, int]],
                  list_cap: int) -> List[List[Tuple[int, int]]]:
    """The batches a CUDA block walks its chunks in: ``list_cap //
    SCHED_THREADS`` chunks each, so a batch's active slots always fit the
    work list."""
    per = list_cap // SCHED_THREADS
    return [chunks[a:a + per] for a in range(0, len(chunks), per)]


def smem_ceiling_elems(dtype: torch.dtype) -> int:
    """Largest block length L whose [L,20] table, [L] flux partial and
    one pass of work list fit one CUDA block's shared memory in
    ``dtype``: 2742 rows in f32, 1371 in f64."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    L = SMEM_BYTES_PER_BLOCK // ((WALK_TABLE_WIDTH + 1) * itemsize)
    while sched_smem_layout(L * WALK_TABLE_WIDTH * itemsize,
                            L * itemsize) is None:
        L -= 1
    return L


def effective_vmem_bound(bound: Optional[int], dtype: torch.dtype,
                         device: torch.device) -> Optional[int]:
    """The walk_vmem_max_elems value an engine may use: clamped to
    ``smem_ceiling_elems`` on the card (with the JAX package's logged
    warning), untouched on the CPU, exactly as JAX's interpret mode
    clamps nothing — so CPU tests build the same blocks in both
    packages."""
    if bound is None:
        return None
    bound = int(bound)
    if device.type != "cuda":
        return bound
    ceiling = smem_ceiling_elems(dtype)
    if bound > ceiling:
        from pumiumtally_tpu_torch.utils.logging import get_logger

        get_logger().warning(
            "walk_vmem_max_elems=%d exceeds the shared-memory "
            "feasibility ceiling (%d) on this backend; clamping",
            bound, ceiling,
        )
        return ceiling
    return bound


def vmem_walk_local_plain(
    table, x, lelem, dest, flying, weight, done, exited, flux, *,
    tally: bool, tol: float, max_iters: int, blocks: int = 1,
    deterministic=False,
):
    """W1's plain PyTorch version: every slot of every block in one
    masked lock-step loop over the stacked tables. ``deterministic``:
    flux committed as the deterministic commit's records (keyed by
    padded row, step, slot), the same values in the same order as the
    serial ``index_add_``."""
    n = x.shape[0]
    blocks = int(blocks)
    L = table.shape[0] // blocks
    if n % blocks:
        raise ValueError(f"{n} slots do not divide into {blocks} blocks")
    base = (torch.arange(n, device=x.device) // (n // blocks)) * L
    d0 = dest - x
    eff_w = eff_weight(d0, flying, weight) if tally else None
    tol_t = torch.tensor(tol, dtype=x.dtype, device=x.device)
    s = torch.zeros((n,), dtype=x.dtype, device=x.device)
    lelem = lelem.to(torch.int32).clone()
    done = done.clone()
    exited = exited.clone()
    pending = torch.full((n,), -1, dtype=torch.int32, device=x.device)
    rec = PlainRecords() if deterministic and tally else None
    pid = torch.arange(n, device=x.device)
    iters = 0
    while iters < max_iters:
        active = ~done & (pending < 0)
        if not bool(active.any()):
            break
        rows = base + lelem.long()
        s_new, nxt, reached = advance_cols(table[rows], s, d0, dest, tol_t)
        hit_boundary = ~reached & (nxt == -1)
        goes_remote = ~reached & (nxt <= -2)
        if tally:
            contrib = torch.where(active, (s_new - s) * eff_w,
                                  torch.zeros_like(s))
            if rec is None:
                flux.index_add_(0, rows, contrib)
            else:
                rec.add(rows, iters, pid, contrib)
        moving = active & ~reached & ~hit_boundary & ~goes_remote
        lelem = torch.where(moving, nxt, lelem)
        s = torch.where(active, s_new, s)
        pending = torch.where(active & goes_remote, -nxt - 2, pending)
        done = done | (active & (reached | hit_boundary))
        exited = exited | (active & hit_boundary)
        iters += 1
    if rec is not None:
        rec.commit(flux)
    # A particle that reached its destination commits dest bit-exactly;
    # everyone else (boundary leavers, paused and idle slots) commits
    # x0 + s*d0 with x0 = dest - d0, as the JAX kernel materialises it.
    at_dest = (done & ~exited)[:, None]
    x_fin = torch.where(at_dest, dest, (dest - d0) + s[:, None] * d0)
    return (x_fin, lelem, done, exited, pending, flux,
            torch.tensor(iters, dtype=torch.int32, device=x.device))


def check_sched_counts(where: str, counts, device: torch.device) -> None:
    """A block walk's optional count output: an int32 tensor on the
    walk's CUDA device, one entry per ``SCHED_COUNTS`` name, to which the
    kernel adds what its CUDA blocks did."""
    if counts is None:
        return
    if device.type != "cuda":
        raise ValueError(f"{where}: sched_counts are counted by the CUDA "
                         "kernel; the plain version has no schedule")
    kernels.check_cuda_args(where, device, [
        ("sched_counts", counts, torch.int32, (len(SCHED_COUNTS),)),
    ])


def _vmem_walk_cuda(table, x, lelem, dest, flying, weight, done, exited,
                    flux, *, tally, tol, max_iters, blocks, sched_counts,
                    deterministic=False):
    dev, dt = x.device, x.dtype
    n = x.shape[0]
    L = table.shape[0] // blocks
    if n % blocks or table.shape[0] % blocks:
        raise ValueError(
            f"blocked walk needs slots and table rows divisible into "
            f"{blocks} blocks, got S={n}, rows={table.shape[0]}"
        )
    if L > smem_ceiling_elems(dt):
        raise ValueError(
            f"block length {L} exceeds the shared-memory ceiling "
            f"{smem_ceiling_elems(dt)} for {dt}"
        )
    kernels.check_aligned("vmem_walk_local", [("table", table)])
    kernels.check_cuda_args("vmem_walk_local", dev, [
        ("table", table, dt, (blocks * L, WALK_TABLE_WIDTH)),
        ("x", x, dt, (n, 3)),
        ("lelem", lelem, torch.int32, (n,)),
        ("dest", dest, dt, (n, 3)),
        ("flying", flying, torch.int8, (n,)),
        ("weight", weight, dt, (n,)),
        ("done", done, torch.bool, (n,)),
        ("exited", exited, torch.bool, (n,)),
        ("flux", flux if tally else None, dt, (blocks * L,)),
    ])
    x_out = torch.empty((n, 3), dtype=dt, device=dev)
    lelem_out = torch.empty((n,), dtype=torch.int32, device=dev)
    done_out = torch.empty((n,), dtype=torch.bool, device=dev)
    exited_out = torch.empty((n,), dtype=torch.bool, device=dev)
    pending = torch.empty((n,), dtype=torch.int32, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    p = kernels.ptr

    def launch(det=None):
        kernels.launch(
            "block_walk", dt, dev, p(table), p(x), p(lelem), p(dest),
            p(flying), p(weight), p(done), p(exited),
            p(flux if tally else None), p(x_out), p(lelem_out), p(done_out),
            p(exited_out), p(pending), p(iters), p(sched_counts), blocks, L,
            n // blocks, float(tol), int(max_iters), int(bool(tally)), det,
        )

    if deterministic and tally:
        # New outputs and only records: iters and the counts are put back
        # for a redo.
        walk_and_commit("vmem_walk_local", launch, n, flux, None,
                        (iters, sched_counts), workspace(deterministic))
    else:
        launch()
    return x_out, lelem_out, done_out, exited_out, pending, flux, iters


def vmem_walk_local(
    table, x, lelem, dest, flying, weight, done, exited, flux, *,
    tally: bool, tol: float, max_iters: int, blocks: int = 1,
    sched_counts: Optional[torch.Tensor] = None, deterministic=False,
):
    """Block-local walk: returns ``(x, lelem, done, exited, pending,
    flux, iters)``.

    ``table`` is ``blocks`` stacked [L,20] block tables; the S slots are
    grouped by block (``S // blocks`` each) with block-local ``lelem``;
    ``flux`` is [blocks*L] and is updated in place (None when not
    tallying). CUDA tensors launch kernel W1; CPU tensors run
    ``vmem_walk_local_plain``. ``sched_counts`` (CUDA only, see
    ``check_sched_counts``) collects what the kernel's CUDA blocks
    did. ``deterministic``: the deterministic commit (module docstring),
    for a tallying walk: True, or the ``det_commit.DetWorkspace`` whose
    record streams it reuses."""
    blocks = int(blocks)
    if tally and flux is None:
        raise ValueError("a tallying walk needs a flux tensor")
    check_sched_counts("vmem_walk_local", sched_counts, x.device)
    if x.is_cuda:
        return _vmem_walk_cuda(table, x, lelem, dest, flying, weight, done,
                               exited, flux, tally=tally, tol=tol,
                               max_iters=max_iters, blocks=blocks,
                               sched_counts=sched_counts,
                               deterministic=deterministic)
    if x.device.type != "cpu":
        raise ValueError(
            f"vmem_walk_local runs on CUDA or CPU tensors, not {x.device}"
        )
    return vmem_walk_local_plain(
        table, x, lelem, dest, flying, weight, done, exited, flux,
        tally=tally, tol=tol, max_iters=max_iters, blocks=blocks,
        deterministic=deterministic,
    )
