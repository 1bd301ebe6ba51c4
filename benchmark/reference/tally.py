"""The reference tally of a traffic pool: what the three-call protocol
should produce for each batch of the pool, in float64.

For each batch: the localization walk from the state the previous batch
left (``CopyInitialPosition``), then each move: the relocation to the
origins where they differ from the current positions (the two-phase
protocol's phase A; none when the origins echo), and the tallied walk to
the destinations. Its flux, scoring lanes and final positions and
elements, and what each walk touched.

The configuration's working precision is float32, so positions,
weights, energies and times enter as the float32 values the caller's
float64 arrays round to (the staging cast), and everything after that is
float64. Scoring follows the spec's definitions: bins by
``searchsorted(edges, value, right) - 1`` over the float32 edges, out of
range dropped; "flux" scores track length x weight, "heating" track
length x weight x energy, "events" one a face crossing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from benchmark.reference.walk import F64, RefMesh, Score, Touched, walk

SCORE_KINDS = {"flux": ("track", "one"), "heating": ("track", "energy"),
               "events": ("count", "one")}


def as_f32(a: np.ndarray, device) -> torch.Tensor:
    """The float32 rounding of a float64 host array, as float64."""
    return torch.as_tensor(np.asarray(a, np.float32), device=device).to(F64)


@dataclass
class BatchRef:
    flux: torch.Tensor  # [E]
    bank: Optional[torch.Tensor]  # [E*stride] or None
    x: torch.Tensor  # [N,3] final positions
    elem: torch.Tensor  # [N] final elements
    localize: Touched = field(default_factory=Touched)
    relocate: List[Touched] = field(default_factory=list)
    moves: List[Touched] = field(default_factory=list)
    track: float = 0.0  # the batch's analytic track length x weight


def bins(scoring: dict, energy, time_, n: int, bank_size: int, device):
    """(bin_off [N] int64, fac [N,S]) of one move's particles."""
    names = scoring["scores"]
    b = torch.zeros(n, dtype=torch.long, device=device)
    bad = torch.zeros(n, dtype=torch.bool, device=device)
    for edges, vals in ((scoring.get("energy_edges"), energy),
                        (scoring.get("time_edges"), time_)):
        if edges is None:
            continue
        e32 = as_f32(edges, device)
        nb = e32.shape[0] - 1
        k = torch.searchsorted(e32, as_f32(vals, device), right=True) - 1
        bad |= (k < 0) | (k >= nb)
        b = b * nb + k.clamp(0, nb - 1)
    off = torch.where(bad, bank_size, b * len(names))
    cols = [torch.ones(n, dtype=F64, device=device)
            if SCORE_KINDS[s][1] == "one" else as_f32(energy, device)
            for s in names]
    return off, torch.stack(cols, dim=1)


def stride_of(scoring: Optional[dict]) -> int:
    if scoring is None:
        return 0
    nb = 1
    for key in ("energy_edges", "time_edges"):
        if scoring.get(key) is not None:
            nb *= len(scoring[key]) - 1
    return nb * len(scoring["scores"])


def reference_pool(mesh: RefMesh, pool, protocol: str,
                   scoring: Optional[dict]) -> List[BatchRef]:
    """Each pool batch's reference, its localization walked from the
    final state of the batch before it in the pool's cycle (the first
    from the centroid of element 0, where the program seeds every
    particle, then again from the last batch's end)."""
    dev = mesh.device
    n = pool[0].points[0].shape[0]
    stride = stride_of(scoring)
    bank_size = mesh.nelems * stride
    x = mesh.centroid0.expand(n, 3).clone()
    elem = torch.zeros(n, dtype=torch.long, device=dev)
    refs = []
    for batch in pool:
        src = as_f32(batch.points[0], dev)
        x, elem, loc = walk(mesh, x, elem, src)
        flux = torch.zeros(mesh.nelems, dtype=F64, device=dev)
        bank = (torch.zeros(bank_size, dtype=F64, device=dev)
                if scoring is not None else None)
        ref = BatchRef(flux=flux, bank=bank, x=x, elem=elem, localize=loc)
        w = as_f32(batch.weights, dev)
        prev = src
        for m in range(1, batch.moves + 1):
            dest = as_f32(batch.points[m], dev)
            if protocol == "two_phase" and not bool((prev == x).all()):
                x, elem, t = walk(mesh, x, elem, prev)
                ref.relocate.append(t)
            score = None
            if scoring is not None:
                off, fac = bins(
                    scoring,
                    None if batch.energy is None else batch.energy[m - 1],
                    None if batch.time is None else batch.time[m - 1],
                    n, bank_size, dev)
                score = Score(bank, stride, off, fac,
                              tuple(SCORE_KINDS[s][0]
                                    for s in scoring["scores"]))
            ref.track += float((torch.linalg.norm(dest - x, dim=1)
                                * w).sum())
            x, elem, t = walk(mesh, x, elem, dest, weight=w, flux=flux,
                              score=score)
            ref.moves.append(t)
            prev = dest
        ref.x, ref.elem = x, elem
        refs.append(ref)
    if len(pool) > 1:
        # The first batch's localization as the cycle runs it: from the
        # last batch's end.
        src = as_f32(pool[0].points[0], dev)
        _, _, refs[0].localize = walk(mesh, refs[-1].x, refs[-1].elem, src)
    return refs
