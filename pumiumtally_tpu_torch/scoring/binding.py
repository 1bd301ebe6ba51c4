"""ScoringSpec (configuration) and ScoringRuntime (a facade's binding):
the port of ``pumiumtally_tpu/scoring/binding.py``.

Lane-bank layout: one flattened ``[E * B * S]`` tensor per facade,
score-minor, ``lane(e, b, k) = e*(B*S) + b*S + k``, with ``B`` the bin
count (the product over the filters, time-minor) and ``S`` the score
count. The walk kernels need only the per-particle ``bin_off = b*S``
(or the DROP sentinel) and the per-particle ``[S]`` factor row, both
resolved once per move by ``ScoringRuntime.resolve`` on the device: a
``torch.searchsorted`` per filter over the edges, kept as tensors in the
working dtype.

Out-of-range policy (``ScoringSpec.overflow``, one knob for every
filter):

- ``"drop"`` (default, OpenMC's convention): a value below ``edges[0]``
  or at or above ``edges[-1]`` scores into no bin; its bin offset is the
  sentinel ``bank_size``, and every lane index built from it lies past
  the bank, where the walks drop it;
- ``"clamp"``: an out-of-range value lands in the nearest edge bin.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from pumiumtally_tpu_torch.scoring.filters import (
    EnergyFilter,
    TimeFilter,
    _EdgeFilter,
)
from pumiumtally_tpu_torch.scoring.scores import SCORES

OVERFLOW_POLICIES = ("drop", "clamp")


class ScoringSpec:
    """User-facing scoring configuration (``TallyConfig.scoring``).

    Args:
      filters: at most one ``EnergyFilter`` and one ``TimeFilter``
        (none: one unfiltered bin).
      scores: names from ``scoring.SCORES``, no duplicates, at least one.
      overflow: the out-of-range policy, ``"drop"`` or ``"clamp"``.
    """

    def __init__(
        self,
        filters: Sequence[_EdgeFilter] = (),
        scores: Sequence[str] = ("flux",),
        overflow: str = "drop",
    ):
        self.energy_filter: Optional[EnergyFilter] = None
        self.time_filter: Optional[TimeFilter] = None
        for f in filters:
            if isinstance(f, EnergyFilter):
                if self.energy_filter is not None:
                    raise ValueError("at most one EnergyFilter per spec")
                self.energy_filter = f
            elif isinstance(f, TimeFilter):
                if self.time_filter is not None:
                    raise ValueError("at most one TimeFilter per spec")
                self.time_filter = f
            else:
                raise ValueError(
                    f"filters must be EnergyFilter/TimeFilter, got {f!r}"
                )
        scores = tuple(scores)
        if not scores:
            raise ValueError("ScoringSpec needs at least one score")
        if len(set(scores)) != len(scores):
            raise ValueError(f"duplicate scores in {scores!r}")
        for s in scores:
            if s not in SCORES:
                raise ValueError(
                    f"unknown score {s!r}; available: {sorted(SCORES)}"
                )
        if overflow not in OVERFLOW_POLICIES:
            raise ValueError(
                f"overflow must be one of {OVERFLOW_POLICIES}, "
                f"got {overflow!r}"
            )
        self.scores = scores
        self.overflow = overflow

    @property
    def n_ebins(self) -> int:
        return 0 if self.energy_filter is None else self.energy_filter.n_bins

    @property
    def n_tbins(self) -> int:
        return 0 if self.time_filter is None else self.time_filter.n_bins

    @property
    def n_bins(self) -> int:
        """Combined bin count (product over filters, time-minor)."""
        return max(1, self.n_ebins) * max(1, self.n_tbins)

    @property
    def n_scores(self) -> int:
        return len(self.scores)

    @property
    def kinds(self) -> Tuple[str, ...]:
        """Per-score segment basis, "track" or "count"."""
        return tuple(SCORES[s][0] for s in self.scores)

    @property
    def fac_kinds(self) -> Tuple[str, ...]:
        """Per-score factor source, "one" or "energy"."""
        return tuple(SCORES[s][1] for s in self.scores)

    @property
    def needs_energy(self) -> bool:
        return self.energy_filter is not None or "energy" in self.fac_kinds

    @property
    def needs_time(self) -> bool:
        return self.time_filter is not None

    def static_key(self) -> tuple:
        """The spec's identity without the edge values: the scores, the
        policy and the bin counts."""
        return (self.scores, self.overflow, self.n_ebins, self.n_tbins)

    def __repr__(self) -> str:
        fs = [f for f in (self.energy_filter, self.time_filter) if f]
        return (
            f"ScoringSpec(filters={fs!r}, scores={self.scores!r}, "
            f"overflow={self.overflow!r})"
        )


class ScoringRuntime:
    """A facade's scoring binding: the edges as device tensors, the bank
    geometry and the per-move bin and factor resolution.

    ``bank_size`` is the facade's own flattened bank length: ``E*B*S``
    for the facades that walk the whole mesh, the padded
    ``nparts*L*B*S`` for the partitioned ones. The DROP sentinel is
    ``bank_size`` itself: every lane index built from it lies at or past
    the end of the bank, and past the ``L*stride`` slice of any block
    (``bin_off + k >= stride``), where the walks drop it."""

    def __init__(self, spec: ScoringSpec, nelems: int, dtype: torch.dtype,
                 device: Any, bank_size: Optional[int] = None):
        self.spec = spec
        self.nelems = int(nelems)
        self.dtype = dtype
        self.device = torch.device(device)
        self.stride = spec.n_bins * spec.n_scores  # lanes per element
        self.bank_size = (self.nelems * self.stride if bank_size is None
                          else int(bank_size))
        ef, tf = spec.energy_filter, spec.time_filter
        self.e_edges = None if ef is None else self._edges(ef)
        self.t_edges = None if tf is None else self._edges(tf)

    def _edges(self, f: _EdgeFilter) -> torch.Tensor:
        return torch.as_tensor(f.edges, dtype=self.dtype, device=self.device)

    def resolve(self, energy: Optional[torch.Tensor],
                time_: Optional[torch.Tensor], n: int):
        """``(bin_off [n] int32, fac [n,S])`` for one staged move, on the
        device, with no host synchronization (the port of JAX's
        ``_bins_and_factors``). ``energy``/``time_`` are [n] tensors, or
        None where the spec reads no such attribute (the facade checks
        that, with errors that name the argument). Each value is cast to
        the edges' dtype before the search, as in JAX: a value an ulp
        from an edge falls on the same side in both packages."""
        spec = self.spec
        bin_idx = torch.zeros((n,), dtype=torch.int32, device=self.device)
        bad = torch.zeros((n,), dtype=torch.bool, device=self.device)
        for edges, vals in ((self.e_edges, energy), (self.t_edges, time_)):
            if edges is None:
                continue
            nb = edges.shape[0] - 1
            b = torch.searchsorted(
                edges, vals.to(edges.dtype).contiguous(), right=True,
            ).to(torch.int32) - 1
            bad = bad | (b < 0) | (b >= nb)
            bin_idx = bin_idx * nb + b.clamp(0, nb - 1)
        bin_off = bin_idx * spec.n_scores
        if spec.overflow != "clamp":
            bin_off = torch.where(
                bad, torch.full_like(bin_off, self.bank_size), bin_off)
        ones = torch.ones((n,), dtype=self.dtype, device=self.device)
        cols = [ones if k == "one" else energy.to(self.dtype)
                for k in spec.fac_kinds]
        return bin_off, torch.stack(cols, dim=1)

    def zero_bank(self) -> torch.Tensor:
        return torch.zeros((self.bank_size,), dtype=self.dtype,
                           device=self.device)


def score_cell_data(spec: Optional[ScoringSpec], bank,
                    volumes: np.ndarray) -> dict:
    """``<score>_bin<k>`` cell arrays for the VTK writers from a bank in
    original element order, every lane divided by the element volume as
    the flux array is. Returns {} for a None spec, so a scoring-off file
    keeps the reference payload."""
    if spec is None:
        return {}
    vol = np.asarray(volumes, dtype=np.float64)
    arr = np.asarray(bank, dtype=np.float64).reshape(
        vol.shape[0], spec.n_bins, spec.n_scores
    ) / vol[:, None, None]
    out = {}
    for b in range(spec.n_bins):
        for j, name in enumerate(spec.scores):
            out[f"{name}_bin{b}"] = arr[:, b, j]
    return out
