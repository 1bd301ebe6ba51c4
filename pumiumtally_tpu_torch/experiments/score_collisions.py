"""How often the particles of one W0 warp score the same lanes at the same
step: the case a per-warp merge of equal lanes before the scoring commit
would pay for.

    python -m pumiumtally_tpu_torch.experiments.score_collisions
    python -m pumiumtally_tpu_torch.experiments.score_collisions \\
        --device cpu --div 10 --n 62500        # the box's density, smaller

W0 (csrc/walk.cu) hands a warp ``WALK_GRAB`` = 32 consecutive particle
indices at a time. A lock-step replay of the plain walk takes, at every
step, the crossings of the particles that still walk and score (not
dropped), keys each by (index // 32, element, bin offset) and counts the
keys that two or more crossings share. ``merges`` is what a perfect
per-warp merge would save (crossings less distinct keys). The real warp
mixes steps (lanes refill as particles end), so this is the upper end of
what it could find.

The configuration is chip_smoke.py's: bench.py's box (``--div 20``,
48,000 tets), 500,000 particles on its trajectory (seed 0), the first
move, and the stride-96 spec's 32 bins, drawn uniformly (chip_smoke.py's
energies are log-uniform over geometric edges and its times uniform, so
its bins are uniform too; chip_smoke.py counts its own resolved bins on
the card with ``warp_collisions``). One JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
from pumiumtally_tpu_torch.experiments.block_rounds import make_trajectory
from pumiumtally_tpu_torch.ops.walk import advance_cols

WALK_GRAB = 32  # csrc/walk.cu: particle indices a warp takes at a time
MESH_DIV = 20
N = 500_000
BINS, SCORES = 32, 3  # the stride-96 spec: 8 energy x 4 time bins


def warp_collisions(step, x, elem, dest, sbin, scoring, nelems: int,
                    stride: int, tol: float) -> dict:
    """Scored crossings of a lock-step replay, and how many of them share
    (warp share, element, bin offset) with another at the same step.
    ``step(rows, s, d0, dest, tol)`` is one crossing of every row (the
    plain versions' ``advance_cols`` on a packed table or
    ``advance_twotier``); ``scoring`` marks the particles that score."""
    d0 = dest - x
    s = torch.zeros_like(d0[:, 0])
    e = elem.long()
    share = torch.arange(x.shape[0], device=x.device) // WALK_GRAB
    tol_t = torch.tensor(tol, dtype=x.dtype, device=x.device)
    active = scoring.clone()
    crossings = merges = shared = 0
    while bool(active.any()):
        i = active.nonzero().squeeze(1)
        key = (share[i] * nelems + e[i]) * stride + sbin[i].long()
        _, counts = torch.unique(key, return_counts=True)
        crossings += i.numel()
        merges += i.numel() - counts.numel()
        shared += int(counts[counts > 1].sum())
        s_new, nxt, reached = step(e, s, d0, dest, tol_t)
        stop = reached | (nxt < 0)
        e = torch.where(active & ~stop, nxt.long(), e)
        s = torch.where(active, s_new, s)
        active = active & ~stop
    return {"scored_crossings": crossings, "in_shared_keys": shared,
            "merges": merges,
            "merge_share": merges / crossings if crossings else 0.0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--div", type=int, default=MESH_DIV)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    mesh = build_box(1, 1, 1, args.div, args.div, args.div,
                     dtype=torch.float32, device=dev)
    pts = make_trajectory(np.random.default_rng(0), args.n, 1)
    t = PumiTally(mesh, args.n, TallyConfig(check_found_all=False),
                  device=dev)
    t.CopyInitialPosition(np.ascontiguousarray(pts[0].reshape(-1)))
    rng = np.random.default_rng(1)
    sbin = torch.as_tensor(rng.integers(0, BINS, args.n) * SCORES,
                           device=dev)
    table = mesh.walk_table
    out = warp_collisions(
        lambda rows, s, d0, dest, tol: advance_cols(table[rows], s, d0, dest,
                                                    tol),
        t.x, t.elem, torch.as_tensor(pts[1], dtype=t.dtype, device=dev),
        sbin, torch.ones((args.n,), dtype=torch.bool, device=dev),
        mesh.nelems, BINS * SCORES, t._tol)
    print(json.dumps({"device": str(dev), "tets": mesh.nelems, "n": args.n,
                      **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
