"""Bin-edge filters over per-particle move attributes (a numpy-only copy
of ``pumiumtally_tpu/scoring/filters.py``).

A filter is a host-side, immutable description of a binned axis: a
strictly increasing edge array over one per-particle attribute the host
stages with each move (``energy=`` / ``time=`` on
``MoveToNextLocation``). A particle's bin is resolved once per move on
the device (scoring/binding.py), so the walk kernels do no filter work
per crossing.
"""

from __future__ import annotations

import numpy as np


class _EdgeFilter:
    """Shared edge validation; subclasses fix the attribute they bin."""

    #: the MoveToNextLocation keyword this filter bins (set by subclass)
    attribute: str = ""

    def __init__(self, edges):
        e = np.asarray(edges, dtype=np.float64).reshape(-1)
        if e.shape[0] < 2:
            raise ValueError(
                f"{type(self).__name__} needs at least 2 edges "
                f"(1 bin), got {e.shape[0]}"
            )
        if not np.isfinite(e).all():
            raise ValueError(
                f"{type(self).__name__} edges must be finite, got {e!r}"
            )
        if not np.all(np.diff(e) > 0):
            raise ValueError(
                f"{type(self).__name__} edges must be strictly "
                f"increasing, got {e!r}"
            )
        self.edges = e

    @property
    def n_bins(self) -> int:
        return self.edges.shape[0] - 1

    def __repr__(self) -> str:
        return f"{type(self).__name__}(edges={self.edges.tolist()!r})"


class EnergyFilter(_EdgeFilter):
    """Bin by the per-particle ``energy`` staged with each move (OpenMC's
    EnergyFilter). Values outside ``[edges[0], edges[-1])`` follow
    ``ScoringSpec.overflow``."""

    attribute = "energy"


class TimeFilter(_EdgeFilter):
    """Bin by the per-particle ``time`` staged with each move (OpenMC's
    TimeFilter), with the same out-of-range policy."""

    attribute = "time"
