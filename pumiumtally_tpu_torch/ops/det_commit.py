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
for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from pumiumtally_tpu_torch import kernels

# Offsets a CUDA block of DC's scan covers (csrc/det_commit.cu DC_CHUNK).
DC_CHUNK = 4096
# The bucketed records a pass of DC's scatter writes at most (16 bytes a
# record), near the H100's 50 MB L2: the best of 12, 24, 48 MB and one
# pass on the box's flux and lanes (PERF.md, PR 13).
SCATTER_PASS_BYTES = 48 << 20
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


class DetRecords:
    """One stream of records on the card: int32 keys, int64 order keys,
    values in the walk's dtype, and an int64 counter of the records the
    walk asked for; plus DC's scratch of the same length (the bucketed
    records, 16 bytes each, and a large bucket's values in order)."""

    def __init__(self, device: torch.device, dtype: torch.dtype):
        self.device, self.dtype = device, dtype
        self.cap = 0
        self.count = torch.zeros((1,), dtype=torch.int64, device=device)
        self.key = self.ord = self.val = self.b_rec = self.s_val = None

    def reserve(self, cap: int) -> None:
        """Room for at least ``cap`` records (contents dropped)."""
        cap = int(cap)
        if cap <= self.cap:
            return
        if cap >= 2**31:
            raise ValueError(f"det_commit: {cap} records do not fit the "
                             "kernels' int32 places")
        dev, dt = self.device, self.dtype
        self.key = self.ord = self.val = self.b_rec = self.s_val = None
        self.key = torch.empty((cap,), dtype=torch.int32, device=dev)
        self.ord = torch.empty((cap,), dtype=torch.int64, device=dev)
        self.val = torch.empty((cap,), dtype=dt, device=dev)
        self.b_rec = torch.empty((2 * cap,), dtype=torch.int64, device=dev)
        self.s_val = torch.empty((cap,), dtype=dt, device=dev)
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
    off = torch.empty((K + 1 + -(-(K + 1) // DC_CHUNK),), dtype=torch.int32,
                      device=target.device)
    passes = max(1, min(K, -(-m * 16 // SCATTER_PASS_BYTES)))
    p = kernels.ptr
    kernels.launch("det_commit", rec.dtype, target.device, p(rec.key),
                   p(rec.ord), p(rec.val), int(m), p(target), int(K),
                   int(passes), p(off), p(off[K + 1:]), p(rec.b_rec),
                   p(rec.s_val))
