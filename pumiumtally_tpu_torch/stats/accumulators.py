"""Per-batch (sum, sum-of-squares) accumulation on the device (port of
``pumiumtally_tpu/stats/accumulators.py``).

A batch's contribution is the change in accumulated flux across it:
``close`` folds ``delta = flux_now - flux_open`` and ``delta**2`` into
the lanes. The facades update their flux in place, so the accumulator
keeps its own copy of the flux at batch open. Nothing here reads the
device from the host.

An empty batch (no move since it opened) is not a sample: closing it
leaves the lanes and the counter alone.
"""

from __future__ import annotations

from typing import Any, Optional

import torch


def _close_batch_update(flux_sum, flux_sq_sum, flux_now, flux_open):
    """The JAX package's ``close_batch`` update, out of place (a
    ``BatchStatistics`` view taken earlier keeps its lanes)."""
    delta = flux_now - flux_open
    return flux_sum + delta, flux_sq_sum + delta * delta


class BatchAccumulator:
    """Streaming per-batch (sum, sum-of-squares) over ``nelems`` lanes in
    the working dtype, in original element order.

    Lifecycle: ``close(flux, reopen=True)`` at every batch boundary;
    ``finalize`` passes ``reopen=False``."""

    def __init__(self, nelems: int, dtype: torch.dtype, device: Any):
        self.nelems = int(nelems)
        self.dtype = dtype
        self.device = torch.device(device)
        self.flux_sum = self._zeros()
        self.flux_sq_sum = self._zeros()
        self.num_batches = 0
        self.moves_in_batch = 0
        # The flux at batch open (a copy); None: no batch is open.
        self.open_flux: Optional[torch.Tensor] = None

    def _zeros(self) -> torch.Tensor:
        return torch.zeros((self.nelems,), dtype=self.dtype,
                           device=self.device)

    @property
    def batch_open(self) -> bool:
        return self.open_flux is not None

    def note_move(self) -> None:
        if self.open_flux is not None:
            self.moves_in_batch += 1

    def close(self, flux: torch.Tensor, reopen: bool = True) -> None:
        """Fold the open batch's flux delta into the lanes (a no-op when
        no batch is open or no move landed in it), then open the next
        batch at a copy of ``flux`` (``reopen=True``) or leave none
        open."""
        if self.open_flux is not None and self.moves_in_batch > 0:
            self.flux_sum, self.flux_sq_sum = _close_batch_update(
                self.flux_sum, self.flux_sq_sum, flux, self.open_flux)
            self.num_batches += 1
        self.open_flux = flux.clone() if reopen else None
        self.moves_in_batch = 0

    def reset(self, open_flux: Optional[torch.Tensor]) -> None:
        """Zero the lanes and counters and open a batch at ``open_flux``
        (the restored flux), so that a resumed run's next close measures
        the right delta: the restore of a checkpoint without
        statistics."""
        self.flux_sum = self._zeros()
        self.flux_sq_sum = self._zeros()
        self.num_batches = 0
        self.moves_in_batch = 0
        self.open_flux = open_flux

    def restore(self, flux_sum, flux_sq_sum, num_batches: int,
                moves_in_batch: int, open_flux) -> None:
        """Exact state restore (a checkpoint's lanes, or
        ``convert.load_facade_state``)."""
        def t(a):
            return torch.as_tensor(a).to(device=self.device,
                                         dtype=self.dtype).clone()

        self.flux_sum = t(flux_sum)
        self.flux_sq_sum = t(flux_sq_sum)
        self.num_batches = int(num_batches)
        self.moves_in_batch = int(moves_in_batch)
        self.open_flux = None if open_flux is None else t(open_flux)
