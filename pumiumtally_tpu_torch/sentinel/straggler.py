"""Straggler escalation for the facades that walk the whole mesh (port of
``pumiumtally_tpu/sentinel/straggler.py``), over W0.

A particle still unfinished when the walk's step budget runs out would
be truncated mid-flight (its partial track is tallied, the rest
dropped). The ladder re-walks the residue instead:

1. the stragglers, compacted into a batch padded to a power of two
   (floor 8; pad rows hold, ``fly=0, dest=x``, and tally nothing), are
   walked at ``retry_factor`` x the budget, floored at ``64 + E`` steps.
   With the phase's start positions and the walk's ray coordinates
   (``x_start``, ``s_init``) the retry CONTINUES the exact
   parametrisation (W0's ``s_init``), so a recovered particle's
   position, element and flux are an unconstrained walk's;
2. on a two-tier mesh, once more on the full-precision planes
   (``table_dtype="float32"``: W0's unpacked instantiation over the
   refinement tier, in place);
3. whatever remains is declared lost (the caller counts it and writes
   quarantine records).

Scoring lanes are continued the same way: the retry scores into the
bank with the move's bin offsets and factors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pumiumtally_tpu_torch.ops.walk import walk


def padded_size(k: int, floor: int = 8) -> int:
    """Next power of two >= k (>= floor)."""
    m = max(int(floor), 1)
    while m < k:
        m *= 2
    return m


def _retry_step(mesh, x, elem, dest, fly, w, flux, k: int, s_init=None,
                scoring=None, *, tol: float, max_iters: int,
                table_dtype: Optional[str] = None):
    """One rung: a tallied walk of a compacted batch whose first ``k``
    rows are real (the pad rows are made to hold). Returns
    ``(x, elem, done, s)``; flux and the bank are updated in place."""
    valid = torch.arange(x.shape[0], device=x.device) < k
    fly_v = torch.where(valid, fly, torch.zeros_like(fly)).to(torch.int8)
    dest_v = torch.where((fly_v == 1)[:, None], dest, x)
    r = walk(mesh, x, elem, dest_v, fly_v, w, flux, tally=True, tol=tol,
             max_iters=max_iters, s_init=s_init, table_dtype=table_dtype,
             scoring=scoring)
    return r.x, r.elem, r.done, r.s


def run_ladder(mesh, x, elem, dests, fly, w, flux, unfinished: np.ndarray,
               *, tol: float, base_iters: int, retry_factor: int,
               two_tier: bool = False, x_start=None, s_init=None,
               scoring=None) -> Tuple[torch.Tensor, torch.Tensor,
                                      np.ndarray, np.ndarray]:
    """The ladder over the host mask ``unfinished`` (call it only when
    the mask has a set entry). The tensors are the facade's committed
    caller-order state. With ``x_start`` / ``s_init`` (the phase's start
    positions and the walk's final ray coordinates) the rungs continue
    the original parametrisation; without them (the non-tallying
    localization ladder) they restart from the committed positions.
    ``scoring``: ``(kinds, bank, bin_off, fac)`` of the interrupted
    move. Flux (and the bank) are updated in place. Returns ``(x, elem,
    recovered_idx, lost_idx)``: new tensors with the straggler rows
    replaced, and the index sets as host arrays."""
    idx = np.flatnonzero(unfinished)
    k = idx.size
    m = padded_size(k)
    idx_pad = np.concatenate([idx, np.full(m - k, idx[0], idx.dtype)])
    rows = torch.as_tensor(idx_pad, device=x.device)
    continuing = x_start is not None and s_init is not None
    xs = (x_start if continuing else x)[rows]
    es = elem[rows]
    ss = s_init[rows] if continuing else None
    ds, fs, ws = dests[rows], fly[rows], w[rows]
    sc = None
    if scoring is not None:
        kinds, bank, bin_off, fac = scoring
        sc = (kinds, bank, bin_off[rows], fac[rows])
    # A deliberately tiny engine budget must not starve its own cure;
    # the walk stops as soon as its particles are done anyway.
    retry_iters = max(int(base_iters) * int(retry_factor),
                      64 + int(mesh.nelems))
    rungs = [None]
    if two_tier:
        rungs.append("float32")
    x_out, e_out, done_acc = xs, es, None
    for table_dtype in rungs:
        xr, er, done_r, sr = _retry_step(
            mesh, xs, es, ds, fs, ws, flux, k, ss, sc, tol=tol,
            max_iters=retry_iters, table_dtype=table_dtype)
        if done_acc is None:
            x_out, e_out, done_acc = xr, er, done_r
        else:
            # A particle's (x, elem) come from the rung that finished it.
            newly = done_r & ~done_acc
            x_out = torch.where(newly[:, None], xr, x_out)
            e_out = torch.where(newly, er, e_out)
            done_acc = done_acc | done_r
        if bool(done_acc[:k].all()):
            break
        # The next rung walks only the unfinished rows, from this rung's
        # progress: its element, and its ray coordinate (continuing) or
        # its committed position.
        fs = torch.where(done_acc, torch.zeros_like(fs), fs)
        es = er
        if continuing:
            ss = sr  # xs stays the original start: the same ray
        else:
            xs = xr
    real = rows[:k]
    x = x.index_put((real,), x_out[:k])
    elem = elem.index_put((real,), e_out[:k])
    done_h = done_acc[:k].cpu().numpy()
    return x, elem, idx[done_h], idx[~done_h]
