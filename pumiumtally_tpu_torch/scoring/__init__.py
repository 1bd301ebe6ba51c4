"""Filtered multi-score tallies: energy/time-binned scoring lanes (port
of ``pumiumtally_tpu/scoring``).

- ``EnergyFilter`` / ``TimeFilter``: bin-edge filters over the
  per-particle ``energy=`` / ``time=`` move inputs;
- ``SCORES``: the registry (``flux``, ``heating``, ``events``);
- ``ScoringSpec``: the configuration (``TallyConfig.scoring``);
- ``ScoringRuntime``: a facade's bank geometry and the per-move bin
  resolution on the device.

The lanes are committed at the same point as the flux lane, inside the
walk kernels: W0 (csrc/walk.cu) and W2 (csrc/twotier_block_walk.cu)
each have a scoring instantiation, and the scoring-off one is the code
that ran before scoring existed.
"""

from pumiumtally_tpu_torch.scoring.binding import (
    ScoringRuntime,
    ScoringSpec,
    score_cell_data,
)
from pumiumtally_tpu_torch.scoring.filters import EnergyFilter, TimeFilter
from pumiumtally_tpu_torch.scoring.scores import SCORES

__all__ = [
    "EnergyFilter",
    "TimeFilter",
    "SCORES",
    "ScoringRuntime",
    "ScoringSpec",
    "score_cell_data",
]
