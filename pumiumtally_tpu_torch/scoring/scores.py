"""The score registry (a copy of ``pumiumtally_tpu/scoring/scores.py``):
what each score contributes per committed walk segment.

- ``basis``: ``"track"`` scores the segment's track length x weight, the
  flux lane's own per-crossing value ``(s_new - s) * eff_w``, so the
  ``flux`` score's lanes sum to the flux lane; ``"count"`` scores 1 per
  committed face crossing (interior step, block-face pause or boundary
  exit), exact small integers.
- ``factor``: a per-particle multiplier resolved once per move,
  ``"one"`` or ``"energy"`` (the staged energy).

Shipped: ``flux`` (track x 1), ``heating`` (track x energy, a
KERMA-shaped placeholder), ``events`` (crossings x 1). Three scores
and no duplicates: a spec has at most 3 scores, and the kernels rely
on that (csrc/walk.cu, csrc/twotier_block_walk.cu).
"""

from __future__ import annotations

# name -> (basis, factor); see the module docstring.
SCORES: dict = {
    "flux": ("track", "one"),
    "heating": ("track", "energy"),
    "events": ("count", "one"),
}

# The most scores a spec can hold: the kernels keep one factor register
# per score.
MAX_SCORES = len(SCORES)
