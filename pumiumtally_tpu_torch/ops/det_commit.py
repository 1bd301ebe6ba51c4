"""The deterministic flux commit (kernel DC, csrc/det_commit.cu), with its
plain PyTorch version ``det_commit_plain`` beside it.

W0 and W4 add flux and scoring lanes with float atomics, so the order of
each sum, and the low bits of flux, change from run to run on the card.
The resilience layer's contract is bitwise (a resumed campaign equals an
uninterrupted one), so a facade that carries a ``CheckpointPolicy``, and
a direct caller that passes ``deterministic=True`` to ``ops.walk.walk``,
``parallel.partition.walk_local`` or ``walk_local_list``, walks with the
deterministic commit instead:

- the walk writes one RECORD a non-zero contribution, ``(key, ord,
  val)``: ``key`` the index of the bank entry (the flux's element, W4's
  block-padded row, or a scoring lane), ``ord = step << 32 | pid`` (the
  crossing's step in this walk call, then the particle: W0's particle
  index, W4's place in its work list, or its slot without one) and the
  value (csrc/det_records.cuh);
- ``det_commit`` adds each bank entry's records in ascending ``ord``,
  one by one, onto its standing value.

That is the order in which the plain walks' serial ``index_add_``
commits (step by step, and within a step in particle order), so the
flux and the lanes equal the plain versions' bitwise: a zero
contribution makes no record, which changes no bit (a sum that starts
at +0.0 never becomes -0.0 under round-to-nearest). A record stream's
count is read once on the host after the walk; a stream that ran out of
room is grown and the walk is made again from its inputs (W0 writes new
tensors; W4's in-place rows are restored from a copy first), never
committed in part and never committed by atomics. The streams live in
a ``DetWorkspace`` that the caller passes as ``deterministic=`` (a
facade keeps one); ``deterministic=True`` gives a call its own.

``det_commit`` launches DC for CUDA tensors and runs ``det_commit_plain``
for CPU tensors. DC (csrc/det_commit.cu) partitions the records into
tiles of consecutive keys, a tile's records contiguous, and orders and
sums each tile in one CTA's shared memory:

- ``dc_plan`` cuts the keys into tiles from the record count (already
  on the host after the walk: no new sync), the bank's size, the dtype
  and the device's shared memory, so that a tile's expected records fill
  about half a CTA's stage; the tiles are grouped into windows of about
  16 MB of records;
- a histogram counts the records by tile and by window, then two splits
  move them, each grouping 4,096 records at a time by a few hundred
  digits in shared memory so that its stores coalesce: by window, then
  within each window by tile, into the scratch that ``DetRecords``
  reserves (two buffers of ``rec_bytes`` a record);
- a CTA a tile sorts its records by key group, then each group by its
  order keys (in a thread's or a warp's registers, or in shared memory),
  and adds each group serially onto its standing values;
- a tile past the stage (a hot element, a skewed source) is committed
  from global memory inside DC, chosen on the device
  (``DetRecords.overfull`` counts such tiles of the last commit).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from pumiumtally_tpu_torch import kernels

# csrc/det_commit.cu's constants: CUDA threads a CTA (DC_THREADS),
# records a split stages at a time (DC_SUB), key groups of a tile (and
# digits of a split, DC_HIST_MAX), the groups a CTA sorts together
# (DC_BIG_MAX) and the largest a warp sorts (DC_WARP_MAX).
DC_THREADS = 512
DC_WARPS = DC_THREADS // 32
DC_SUB = 4096
DC_HIST_MAX = 2048
DC_BIG_MAX, DC_WARP_MAX = 64, 512
# The plan's design choices: two tile-commit CTAs an SM (one's loads
# overlap the other's sorts), a tile's expected records half its stage
# (room for skew before a tile goes over-full), at most DC_TILES_MAX
# tiles (the histogram's per-tile counters in 48 KB of shared memory),
# about CHUNKS_PER_SM histogram and coarse-split CTAs an SM, windows of
# consecutive tiles holding about WINDOW_BYTES of records (few, so that
# the coarse split's runs are long; small, so that the fine split's
# concurrent pieces write into L2), or one window, with no coarse split,
# where all the records (ONE_WINDOW_BYTES) fit the H100's 50 MB L2; and
# the shared memory each CTA leaves to its static arrays and the
# system's 1 KB.
CTAS_PER_SM = 2
DC_TILES_MAX = 12288
CHUNKS_PER_SM = 4
WINDOW_BYTES = 16 << 20
ONE_WINDOW_BYTES = 40 << 20
STATIC_SMEM = 2048
# A record stream's first capacity, in records a particle, and its growth
# past the count a walk asked for.
FIRST_RECORDS_PER_PARTICLE = 16
GROWTH = 1.25


def det_ord(step: int, pid: torch.Tensor) -> torch.Tensor:
    """The order keys ``step << 32 | pid`` (int64) of one lock-step
    iteration's records."""
    return (step << 32) | pid.to(torch.int64)


def det_commit_plain(target: torch.Tensor, key: torch.Tensor,
                     ord_: torch.Tensor, val: torch.Tensor) -> None:
    """Add ``val`` into ``target[key]`` IN PLACE, each entry's values in
    ascending ``ord_`` one by one onto its standing value: the records
    are ordered by (key, ord), then the j-th values of every bucket are
    added together (distinct keys), for j = 0, 1, ... On any device."""
    if key.numel() == 0:
        return
    perm = torch.argsort(ord_, stable=True)
    perm = perm[torch.argsort(key[perm], stable=True)]
    k, v = key[perm].long(), val[perm].to(target.dtype)
    idx = torch.arange(k.numel(), device=k.device)
    first = torch.ones_like(k, dtype=torch.bool)
    first[1:] = k[1:] != k[:-1]
    start = torch.cummax(torch.where(first, idx, torch.zeros_like(idx)),
                         dim=0).values
    rank = idx - start
    by_rank = torch.argsort(rank, stable=True)
    at = 0
    for c in torch.bincount(rank).tolist():
        sel = by_rank[at:at + c]
        at += c
        target[k[sel]] = target[k[sel]] + v[sel]


def rec_bytes(elem_bytes: int) -> int:
    """The bytes of one partitioned record (csrc/det_commit.cu DcRec: the
    ord, the value, the key): 16 in float32, 24 in float64."""
    return 16 if elem_bytes == 4 else 24


@dataclass(frozen=True)
class DcPlan:
    """DC's cut of one commit (``dc_plan``): ``tk`` keys a tile,
    ``tiles`` of them, keys grouped by ``1 << group_shift`` in a tile's
    counting sort, ``chunks`` histogram and coarse-split CTAs of
    ``chunk_records`` records each, a stage of ``stage`` records,
    ``tw`` tiles a window and ``windows`` of them, the over-full path's
    grid; the dynamic shared memory of the
    tile commit (and the over-full path) and of the two splits; the
    int32 scratch (the tiles' starts, the over-full list, the tiles'
    cursors, the fine split's piece offsets, a row of window counts and
    places a chunk)."""

    tk: int
    tiles: int
    group_shift: int
    chunks: int
    chunk_records: int
    stage: int
    tw: int
    windows: int
    overfull_grid: int
    tiles_smem: int
    coarse_smem: int
    fine_smem: int
    scratch_ints: int

    @property
    def groups(self) -> int:
        """Key groups of a full tile (its counting sort's buckets)."""
        return ((self.tk - 1) >> self.group_shift) + 1

    def host_args(self):
        """The ``plan`` argument of DC's entry: a ctypes array of int64
        (csrc/det_commit.cu ``det_commit``). Keep it alive over the
        launch and pass ``ctypes.addressof`` of it."""
        vals = (self.tk, self.tiles, self.group_shift, self.chunks,
                self.chunk_records, self.stage, self.tw, self.windows,
                self.overfull_grid)
        return (ctypes.c_longlong * len(vals))(*vals)


def split_smem(digits: int, elem_bytes: int) -> int:
    """The dynamic shared memory of a split over ``digits`` digits
    (csrc/det_commit.cu dc_split_bytes): their counts, places and
    cursors, then DC_SUB staged records and their digits."""
    return -(-(12 * digits + 4) // 16) * 16 + DC_SUB * (
        rec_bytes(elem_bytes) + 4)


def dc_plan(m: int, K: int, elem_bytes: int, smem_block: int,
            smem_sm: int, sms: int) -> DcPlan:
    """DC's plan for ``m`` records into ``K`` entries of ``elem_bytes``
    each on a device with ``smem_block`` bytes of opt-in shared memory a
    block, ``smem_sm`` an SM and ``sms`` SMs. A tile commit's stage
    holds (key, ord, value) records in what two CTAs an SM leave after
    the two group arrays; a tile holds ``tk`` keys, as many as fill half
    the stage on average (past DC_WARPS, a multiple of it, so that the
    warps sort a tile's groups in whole rounds; at least 1, at most K),
    widened where the tiles would pass DC_TILES_MAX; a tile's counting
    sort groups keys so that it has at most DC_HIST_MAX buckets. A
    window holds ``tw``
    consecutive tiles, about WINDOW_BYTES of records (at most
    DC_HIST_MAX tiles, and at most DC_HIST_MAX windows)."""
    if m < 1 or K < 1:
        raise ValueError(f"dc_plan: {m} records into {K} entries")
    hist_bytes = 8 * (DC_HIST_MAX + 1)
    budget = min(smem_block, smem_sm // CTAS_PER_SM) - STATIC_SMEM
    stage = min((budget - hist_bytes) // (12 + elem_bytes),
                DC_BIG_MAX * DC_WARP_MAX)
    tk = (stage // 2) * K // m
    if tk > DC_WARPS:  # whole rounds of the warps' sorts of one-key groups
        tk -= tk % DC_WARPS
    tk = min(max(1, tk, -(-K // DC_TILES_MAX)), K)
    tiles = -(-K // tk)
    shift = 0
    while ((tk - 1) >> shift) + 1 > DC_HIST_MAX:
        shift += 1
    rc = DC_THREADS * max(1, -(-m // (DC_THREADS * CHUNKS_PER_SM * sms)))
    chunks = -(-m // rc)
    window = WINDOW_BYTES // rec_bytes(elem_bytes)
    if m * rec_bytes(elem_bytes) <= ONE_WINDOW_BYTES:
        window = m  # one window: a single split, into L2
    tw = max(1, min(DC_HIST_MAX, tiles, window * K // (m * tk)),
             -(-tiles // DC_HIST_MAX))
    windows = -(-tiles // tw)
    plan = DcPlan(tk=tk, tiles=tiles, group_shift=shift, chunks=chunks,
                  chunk_records=rc, stage=stage, tw=tw, windows=windows,
                  overfull_grid=min(tiles, sms),
                  tiles_smem=stage * (12 + elem_bytes) + hist_bytes,
                  coarse_smem=split_smem(windows, elem_bytes),
                  fine_smem=split_smem(tw, elem_bytes),
                  scratch_ints=3 * tiles + windows + 2 + windows * chunks)
    if stage < 1 or max(plan.coarse_smem, plan.fine_smem,
                        4 * tiles) > smem_block:
        raise ValueError(f"det_commit: a device with {smem_block} bytes of "
                         "shared memory a block cannot hold DC's stage")
    return plan


_DEVICE_SMEM: Dict[int, Tuple[int, int, int]] = {}


def device_smem(device: torch.device) -> Tuple[int, int, int]:
    """(opt-in shared memory a block, shared memory an SM, SMs) of a
    CUDA device, cached."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    got = _DEVICE_SMEM.get(idx)
    if got is None:
        p = torch.cuda.get_device_properties(idx)
        got = _DEVICE_SMEM[idx] = (int(p.shared_memory_per_block_optin),
                                   int(p.shared_memory_per_multiprocessor),
                                   int(p.multi_processor_count))
    return got


def b_rec_words(cap: int, dtype: torch.dtype) -> int:
    """The int64 words of a stream's partitioned records: two buffers of
    ``cap`` records of ``rec_bytes`` each (the coarse split's and the
    fine split's)."""
    return 2 * cap * rec_bytes(torch.finfo(dtype).bits // 8) // 8


class DetRecords:
    """One stream of records on the card: int32 keys, int64 order keys,
    values in the walk's dtype, and an int64 counter of the records the
    walk asked for; plus DC's scratch of the same length (two buffers of
    partitioned records, ``rec_bytes`` each) and ``overfull``, an int32
    count of the tiles the last commit of the stream took through the
    over-full path (CUDA only)."""

    def __init__(self, device: torch.device, dtype: torch.dtype):
        self.device, self.dtype = device, dtype
        self.cap = 0
        self.count = torch.zeros((1,), dtype=torch.int64, device=device)
        self.overfull = torch.zeros((1,), dtype=torch.int32, device=device)
        self.key = self.ord = self.val = self.b_rec = None

    def reserve(self, cap: int) -> None:
        """Room for at least ``cap`` records (contents dropped)."""
        cap = int(cap)
        if cap <= self.cap:
            return
        if cap >= 2**31:
            raise ValueError(f"det_commit: {cap} records do not fit the "
                             "kernels' int32 places")
        dev, dt = self.device, self.dtype
        self.key = self.ord = self.val = self.b_rec = None
        self.key = torch.empty((cap,), dtype=torch.int32, device=dev)
        self.ord = torch.empty((cap,), dtype=torch.int64, device=dev)
        self.val = torch.empty((cap,), dtype=dt, device=dev)
        self.b_rec = torch.empty((b_rec_words(cap, dt),), dtype=torch.int64,
                                 device=dev)
        self.cap = cap

    def host_args(self) -> Tuple[int, int, int, int, int]:
        p = kernels.ptr
        return (p(self.key), p(self.ord), p(self.val), p(self.count),
                self.cap)


class DetWorkspace:
    """The record streams of one caller's deterministic walks, per
    device, dtype and stream ("flux", "lanes"), grown to the largest walk
    seen: a facade owns one and passes it as ``deterministic=``."""

    def __init__(self):
        self._streams: Dict[tuple, DetRecords] = {}

    def records(self, device: torch.device, dtype: torch.dtype, name: str,
                first_cap: int) -> DetRecords:
        """The named stream, with room for at least ``first_cap`` records
        when it is new."""
        key = (str(device), dtype, name)
        rec = self._streams.get(key)
        if rec is None:
            rec = self._streams[key] = DetRecords(device, dtype)
            rec.reserve(max(first_cap, 1024))
        return rec


def workspace(deterministic) -> Optional[DetWorkspace]:
    """A walk's ``deterministic`` argument as a workspace: a
    ``DetWorkspace`` as it is, True a new one for this call, False or
    None no deterministic commit."""
    if isinstance(deterministic, DetWorkspace):
        return deterministic
    return DetWorkspace() if deterministic else None


def det_host_args(flux: DetRecords, lanes: Optional[DetRecords]):
    """The ``det`` argument of W0's and W4's entries: a ctypes array of
    ten int64 (key, ord, val, count, cap of the flux's stream, then of
    the lanes'; zeros for no lanes). Keep it alive over the launch and
    pass ``ctypes.addressof`` of it."""
    vals = list(flux.host_args()) + (
        [0] * 5 if lanes is None else list(lanes.host_args()))
    return (ctypes.c_longlong * 10)(*(int(v or 0) for v in vals))


def walk_deterministic(launch, streams, restore=None) -> Tuple[int, ...]:
    """Run ``launch(det)`` (one kernel launch writing the given streams'
    records) until every stream held all its records: each stream's
    counter is zeroed first; after the launch the counts are read on the
    host (one sync), and a stream that ran out of room grows by GROWTH
    past its count, ``restore()`` puts back what the launch wrote in
    place, and the launch is made again. Returns the record counts."""
    flux, lanes = streams
    while True:
        for rec in (flux, lanes):
            if rec is not None:
                rec.count.zero_()
        args = det_host_args(flux, lanes)
        launch(ctypes.addressof(args))
        counts = [int(c) for c in torch.cat(
            [r.count for r in (flux, lanes) if r is not None]).tolist()]
        short = [(r, c) for r, c in zip(
            [r for r in (flux, lanes) if r is not None], counts)
            if c > r.cap]
        if not short:
            return tuple(counts)
        for rec, c in short:
            rec.reserve(int(c * GROWTH) + 1)
        if restore is not None:
            restore()


def walk_and_commit(where: str, launch, n: int, flux: torch.Tensor,
                    scoring, written, ws: DetWorkspace) -> None:
    """A tallying walk's kDet instantiation, then DC over its records:
    ``launch(det)`` walks ``n`` particles (or list places) writing the
    records of ``flux`` and, with ``scoring = (kinds, bank, ...)``, of
    the bank's lanes into the streams of the workspace ``ws``
    (``walk_deterministic``); ``written`` are the tensors the launch
    writes in place or adds into (None entries skipped), copied first
    and put back before a walk is made again. Then each stream is
    committed into its target (``det_commit``)."""
    if flux.numel() >= 2**31 or (
            scoring is not None and scoring[1].numel() >= 2**31):
        raise ValueError(f"{where}: the deterministic commit keys a bank "
                         "of fewer than 2**31 entries")
    dev, dt = flux.device, flux.dtype
    flux_rec = ws.records(dev, dt, "flux", FIRST_RECORDS_PER_PARTICLE * n)
    lane_rec = None
    if scoring is not None:
        lane_rec = ws.records(dev, dt, "lanes", FIRST_RECORDS_PER_PARTICLE
                              * n * len(scoring[0]))
    saved = [None if t is None else t.clone() for t in written]

    def restore():
        for t, t0 in zip(written, saved):
            if t is not None:
                t.copy_(t0)

    m = walk_deterministic(launch, (flux_rec, lane_rec), restore)
    det_commit(flux, flux_rec, m[0])
    if lane_rec is not None:
        det_commit(scoring[1], lane_rec, m[1])


def det_commit(target: torch.Tensor, rec: DetRecords, m: int) -> None:
    """Add the first ``m`` records of ``rec`` into ``target`` IN PLACE in
    their order (module docstring); the records are left as they are.
    CUDA tensors launch DC; CPU tensors run ``det_commit_plain``."""
    if not target.is_cuda:
        det_commit_plain(target, rec.key[:m], rec.ord[:m], rec.val[:m])
        return
    K = target.numel()
    kernels.check_cuda_args("det_commit", target.device, [
        ("target", target, rec.dtype, (K,)),
    ])
    if m > rec.cap:
        raise ValueError(f"det_commit: {m} records past the stream's "
                         f"{rec.cap}")
    if K >= 2**31:
        raise ValueError("det_commit: a target of 2**31 entries or more "
                         "does not fit the kernels' int32 keys")
    if m == 0 or K == 0:
        return
    plan = dc_plan(int(m), int(K), target.element_size(),
                   *device_smem(target.device))
    scratch = torch.empty((plan.scratch_ints,), dtype=torch.int32,
                          device=target.device)
    args = plan.host_args()
    p = kernels.ptr
    kernels.launch("det_commit", rec.dtype, target.device, p(rec.key),
                   p(rec.ord), p(rec.val), int(m), p(target), int(K),
                   ctypes.addressof(args), p(scratch), p(rec.b_rec),
                   p(rec.overfull))
