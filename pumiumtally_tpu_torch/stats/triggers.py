"""Convergence triggers over the batch statistics (port of
``pumiumtally_tpu/stats/triggers.py``).

A ``TriggerSpec`` names a per-element metric ("rel_err", or "std_err":
the standard error of the mean, not the sample std dev), a threshold and
a quantile over the scored elements (mean != 0): ``quantile=1.0`` asks
every scored element to converge (OpenMC's default), lower quantiles
ignore the slowest tail.

Evaluation is one reduction on the device and one scalar read; the
threshold test and the 1/sqrt(N) batches-remaining projection are host
arithmetic on that scalar: with value v at N batches and v ~ c/sqrt(N),
reaching threshold T needs ``ceil(N * ((v/T)^2 - 1))`` more batches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

_METRICS = ("rel_err", "std_err")


@dataclass(frozen=True)
class TriggerSpec:
    """Convergence criterion evaluated at batch close.

    Attributes:
      threshold: converge when the metric's quantile is <= this.
      metric: "rel_err" (relative error of the mean) or "std_err"
        (standard error of the mean, in flux units).
      quantile: which quantile of the per-element metric over scored
        elements must pass; 1.0 = the maximum.
    """

    threshold: float
    metric: str = "rel_err"
    quantile: float = 1.0

    def __post_init__(self) -> None:
        if self.metric not in _METRICS:
            raise ValueError(
                f"metric must be one of {_METRICS}, got {self.metric!r}"
            )
        if not (float(self.threshold) > 0.0):
            raise ValueError(
                f"threshold must be > 0, got {self.threshold!r}"
            )
        if not (0.0 < float(self.quantile) <= 1.0):
            raise ValueError(
                f"quantile must be in (0, 1], got {self.quantile!r}"
            )


@dataclass(frozen=True)
class TriggerResult:
    """One trigger evaluation: the metric value, the verdict and the
    projected batches still needed (0 when converged; None before 2
    closed batches or for a non-finite value)."""

    converged: bool
    value: float
    threshold: float
    metric: str
    quantile: float
    num_batches: int
    batches_remaining: Optional[int]


def _trigger_reduction(flux_sum: torch.Tensor, flux_sq_sum: torch.Tensor,
                       num_batches: int, *, metric: str,
                       quantile: float) -> torch.Tensor:
    """[E] lanes -> one 0-d tensor on their device: the quantile of the
    per-element metric over scored elements (+inf when none is scored).
    Unscored elements sort last as +inf, so the k scored values take the
    first k ascending places and the q-quantile is rank ceil(q*k)-1."""
    n = torch.tensor(float(num_batches), dtype=flux_sum.dtype,
                     device=flux_sum.device)
    mean = flux_sum / n
    var = torch.clamp(flux_sq_sum / n - mean * mean, min=0.0) * (
        n / torch.clamp(n - 1.0, min=1.0))
    sem = torch.sqrt(var / n)
    scored = flux_sum != 0
    if metric == "rel_err":
        vals = sem / torch.where(scored, torch.abs(mean),
                                 torch.ones_like(mean))
    else:  # "std_err", validated by TriggerSpec
        vals = sem
    vals = torch.where(scored, vals, torch.full_like(vals, float("inf")))
    k = scored.sum().to(torch.float64)
    idx = (torch.ceil(quantile * k).to(torch.int64) - 1).clamp(
        0, vals.shape[0] - 1)
    return torch.sort(vals).values[idx]


def evaluate_trigger(accumulator, spec: TriggerSpec) -> TriggerResult:
    """Evaluate ``spec`` against a ``BatchAccumulator``'s lanes. With
    fewer than 2 closed batches the variance is undefined: the result is
    unconverged with ``value=inf`` and no projection, and nothing runs on
    the device."""
    nb = accumulator.num_batches
    if nb < 2:
        return TriggerResult(
            converged=False, value=math.inf,
            threshold=float(spec.threshold), metric=spec.metric,
            quantile=float(spec.quantile), num_batches=nb,
            batches_remaining=None,
        )
    # The one scalar device -> host read of a batch close.
    value = float(_trigger_reduction(
        accumulator.flux_sum, accumulator.flux_sq_sum, nb,
        metric=spec.metric, quantile=float(spec.quantile),
    ))
    threshold = float(spec.threshold)
    converged = value <= threshold
    if converged:
        remaining: Optional[int] = 0
    elif math.isfinite(value) and value > 0:
        remaining = max(1, math.ceil(nb * ((value / threshold) ** 2 - 1.0)))
    else:
        remaining = None
    return TriggerResult(
        converged=converged, value=value, threshold=threshold,
        metric=spec.metric, quantile=float(spec.quantile),
        num_batches=nb, batches_remaining=remaining,
    )
