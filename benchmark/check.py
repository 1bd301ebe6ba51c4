"""The comparison that decides ``correct``.

Once the window has closed, the program's answers are read through the
facade's public surface: the accumulated flux, the final positions and
elements, and, where the configuration has them, the scoring bank and
the batch-statistics lanes. The facade is then freed, and the reference
(``reference/tally.py``) works out each pool batch in float64 from the
same inputs. The run sent each pool batch a counted number of times, so
what the program should hold is that count times each batch's
reference, summed (and, for the sum-of-squares lanes, the count times
the square of each batch's tally).

The numbers compared, each against its configuration's limit:

- ``flux_l1``: the flux's L1 gap over the reference's total;
- ``flux_max``: the widest gap of one element, over the larger of its
  reference flux and the median element's;
- ``final_miss``: the share of the last batch's particles whose final
  position lies more than ``SLACK_CM`` from the reference's, or whose
  final element does not hold that position to within ``SLACK_CM``;
- ``bank_l1``: each score's lanes' L1 gap over their reference total,
  the largest of the scores;
- ``stats_l1``: the same L1 gap for the flux's and the bank's sum and
  sum-of-squares lanes, the largest of the four.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from benchmark.reference.walk import F64

# A final position may lie this far outside the element reported for it
# (cm): float32 rounding of the positions and the walk's own tolerance
# are well inside it.
SLACK_CM = 1e-5
# The reference's flux must conserve each batch's track length to this.
REFERENCE_RTOL = 1e-9


@dataclass
class Answers:
    """What the program holds after the window."""

    flux: torch.Tensor
    positions: torch.Tensor  # [N,3]
    elem: torch.Tensor  # [N]
    bank: Optional[torch.Tensor] = None
    stats: Optional[tuple] = None  # (flux_sum, flux_sq_sum, batches)
    bank_stats: Optional[tuple] = None


def read_answers(t, device) -> Answers:
    """The facade's answers, copied off it so that it can be freed."""
    def own(a):
        return torch.as_tensor(a).to(device=device).clone()

    ans = Answers(flux=own(t.flux), positions=own(t.positions),
                  elem=own(t.elem_ids))
    if t.config.scoring is not None:
        ans.bank = own(t.score_bank)
    if t.config.batch_stats:
        st = t.batch_statistics()
        ans.stats = (own(st.flux_sum), own(st.flux_sq_sum), st.num_batches)
        if t.config.scoring is not None:
            st = t.score_statistics()
            ans.bank_stats = (own(st.flux_sum), own(st.flux_sq_sum),
                              st.num_batches)
    return ans


def l1(got: torch.Tensor, want: torch.Tensor) -> float:
    den = float(want.abs().sum())
    num = float((got.to(F64) - want).abs().sum())
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def check_reference(refs) -> None:
    for i, r in enumerate(refs):
        total = float(r.flux.sum())
        if abs(total - r.track) > REFERENCE_RTOL * r.track:
            raise RuntimeError(
                f"the reference's flux of pool batch {i} ({total!r}) does "
                f"not conserve its track length ({r.track!r})")


def numbers(ans: Answers, refs, counts: List[int], mesh, last: int,
            scores: Optional[List[str]]) -> Dict[str, float]:
    """Every number the check can compare (module docstring).
    ``counts[p]``: how often pool batch p ran; ``last``: the pool index
    of the last batch."""
    check_reference(refs)
    want = sum(c * r.flux for c, r in zip(counts, refs))
    gap = (ans.flux.to(F64) - want).abs()
    floor = torch.maximum(want, want.median())
    out = {"flux_l1": l1(ans.flux, want),
           "flux_max": float((gap / floor).max())}
    ref = refs[last]
    x = ans.positions.to(F64)
    off = (x - ref.x).abs().amax(dim=1) > SLACK_CM
    outside = mesh.outside_by(ans.elem.long(), ref.x) > SLACK_CM
    out["final_miss"] = float((off | outside).to(F64).mean())
    if ans.bank is not None:
        bank_want = sum(c * r.bank for c, r in zip(counts, refs))
        s = len(scores)
        out["bank_l1"] = max(l1(ans.bank.reshape(-1, s)[:, k],
                                bank_want.reshape(-1, s)[:, k])
                             for k in range(s))
    if ans.stats is not None:
        gaps = [l1(ans.stats[0], want),
                l1(ans.stats[1], sum(c * r.flux ** 2
                                     for c, r in zip(counts, refs)))]
        if ans.bank_stats is not None:
            gaps.append(l1(ans.bank_stats[0], bank_want))
            gaps.append(l1(ans.bank_stats[1], sum(
                c * r.bank ** 2 for c, r in zip(counts, refs))))
        if ans.stats[2] != sum(counts):
            gaps.append(float("inf"))
        out["stats_l1"] = max(gaps)
    return out


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, the compared numbers each beside its limit)."""
    compared = {k: {"value": nums[k], "limit": float(v)}
                for k, v in limits.items() if k in nums}
    missing = [k for k in limits if k not in nums]
    ok = not missing and all(c["value"] <= c["limit"]
                             for c in compared.values())
    return ok, compared
