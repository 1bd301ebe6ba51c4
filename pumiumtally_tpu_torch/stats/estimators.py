"""Per-element statistics from the (sum, sum-of-squares) lanes (port of
``pumiumtally_tpu/stats/estimators.py``). With x_i the per-element flux
of batch i and N closed batches:

  mean       = (1/N) sum x_i
  sample var = (sum x_i^2 / N - mean^2) * N / (N - 1)
  rel_err    = sqrt(var / N) / |mean|
  FOM        = 1 / (rel_err^2 * t)      (t: transport seconds)

An element with a mean of exactly zero has no relative error: it reports
``inf``, so a threshold can never read it as converged; the VTK writer
maps infs to 0. Net-negative elements are scored through |mean|. Plain
tensor code in the lanes' dtype, on the lanes' device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


def _n(like: torch.Tensor, num_batches: int) -> torch.Tensor:
    """The batch count as a 0-d tensor of the lanes' dtype (JAX's
    ``jnp.asarray(float(num_batches), dtype)``)."""
    return torch.tensor(float(num_batches), dtype=like.dtype,
                        device=like.device)


def batch_mean(flux_sum: torch.Tensor, num_batches: int) -> torch.Tensor:
    """Per-element mean of the per-batch flux contributions."""
    if num_batches < 1:
        raise ValueError("mean needs at least 1 closed batch")
    return flux_sum / _n(flux_sum, num_batches)


def sample_variance(flux_sum: torch.Tensor, flux_sq_sum: torch.Tensor,
                    num_batches: int) -> torch.Tensor:
    """Unbiased per-element sample variance of the batch values, clamped
    at zero (``sq_sum/N - mean^2`` can round below zero when the batch
    values are all but equal)."""
    if num_batches < 2:
        raise ValueError("sample variance needs at least 2 closed batches")
    n = _n(flux_sum, num_batches)
    mean = flux_sum / n
    return (torch.clamp(flux_sq_sum / n - mean * mean, min=0.0)
            * (n / (n - 1.0)))


def std_dev(flux_sum: torch.Tensor, flux_sq_sum: torch.Tensor,
            num_batches: int) -> torch.Tensor:
    """Per-element sample standard deviation of the batch values."""
    return torch.sqrt(sample_variance(flux_sum, flux_sq_sum, num_batches))


def rel_err(flux_sum: torch.Tensor, flux_sq_sum: torch.Tensor,
            num_batches: int) -> torch.Tensor:
    """Relative error of the mean, sem/|mean|; ``inf`` where the mean is
    exactly zero."""
    n = _n(flux_sum, num_batches)
    sem = torch.sqrt(sample_variance(flux_sum, flux_sq_sum, num_batches)
                     / n)
    scored = flux_sum != 0
    denom = torch.where(scored, torch.abs(flux_sum) / n,
                        torch.ones_like(flux_sum))
    return torch.where(scored, sem / denom,
                       torch.full_like(flux_sum, float("inf")))


def figure_of_merit(rel_err_arr: torch.Tensor,
                    elapsed_seconds: float) -> torch.Tensor:
    """FOM = 1/(RE^2 * t); elements with an infinite or zero RE report
    0."""
    if elapsed_seconds <= 0.0:
        raise ValueError(
            f"figure of merit needs elapsed_seconds > 0, got "
            f"{elapsed_seconds!r}"
        )
    re2 = rel_err_arr * rel_err_arr
    ok = torch.isfinite(re2) & (re2 > 0)
    safe = torch.where(ok, re2, torch.ones_like(re2))
    return torch.where(ok, 1.0 / (safe * elapsed_seconds),
                       torch.zeros_like(re2))


@dataclass(frozen=True)
class BatchStatistics:
    """Read-only view of one accumulator state (the facades'
    ``batch_statistics()``): the lanes, and the estimators computed on
    demand, as tensors on the lanes' device."""

    flux_sum: torch.Tensor
    flux_sq_sum: torch.Tensor
    num_batches: int
    elapsed_seconds: Optional[float] = None

    @property
    def mean(self) -> torch.Tensor:
        return batch_mean(self.flux_sum, self.num_batches)

    @property
    def std_dev(self) -> torch.Tensor:
        return std_dev(self.flux_sum, self.flux_sq_sum, self.num_batches)

    @property
    def rel_err(self) -> torch.Tensor:
        return rel_err(self.flux_sum, self.flux_sq_sum, self.num_batches)

    @property
    def figure_of_merit(self) -> torch.Tensor:
        if self.elapsed_seconds is None:
            raise ValueError(
                "figure of merit needs elapsed_seconds (the facade "
                "passes its TallyTimes transport total)"
            )
        return figure_of_merit(self.rel_err, self.elapsed_seconds)
