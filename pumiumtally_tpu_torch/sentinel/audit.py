"""The audit lanes on the device, one packed scalar (port of
``pumiumtally_tpu/sentinel/audit.py``).

For each audited move the facade hands over the caller-order view of the
move (phase-B start positions, committed end positions, flying flags,
weights, the done mask, the flux) and gets back ONE packed int32 scalar
plus two device scalars it carries (the running flux sum and the worst
residual). Everything reduces on the device in float64 (whatever the
working dtype), so the audit costs a handful of reductions and one
scalar fetch a move.

The conservation lane: a track-length tally over segments inside the
mesh satisfies ``sum(flux delta) == sum(fly * w * |x_end - x_start|)`` up
to accumulation rounding; boundary-clamped and budget-truncated
particles commit exactly the point their partial track was tallied to,
so the identity holds for them too.

Packing: ``packed = n_unfinished * 8 + anomaly_mask``; ``split_packed``
undoes it on the host.
"""

from __future__ import annotations

import torch

from pumiumtally_tpu_torch.sentinel.policy import (
    _ANOMALY_BITS,
    ANOMALY_CONSERVATION,
    ANOMALY_NONFINITE,
    ANOMALY_UNFINISHED,
)

WIDE = torch.float64  # the audit's accumulation dtype


def audit_pack(x0, x1, fly, w, done, flux, prev_sum, prev_max,
               rtol: float):
    """The audit reduction: ``(packed, flux_sum, new_max, residual)``,
    device scalars (nothing here waits for the device)."""
    flying = fly != 0
    traveled = torch.linalg.vector_norm(x1.to(WIDE) - x0.to(WIDE), dim=1)
    expected = torch.where(flying, w.to(WIDE) * traveled,
                           torch.zeros((), dtype=WIDE,
                                       device=traveled.device)).sum()
    flux_sum = flux.to(WIDE).sum()
    delta = flux_sum - prev_sum
    tiny = torch.finfo(WIDE).tiny
    residual = (delta - expected).abs() / expected.clamp(min=tiny)
    n_unf = (flying & ~done).sum().to(torch.int32)
    mask = ((n_unf > 0).to(torch.int32) * ANOMALY_UNFINISHED
            | (residual > rtol).to(torch.int32) * ANOMALY_CONSERVATION
            | (~torch.isfinite(delta)).to(torch.int32) * ANOMALY_NONFINITE)
    packed = n_unf * (1 << _ANOMALY_BITS) + mask
    return packed, flux_sum, torch.maximum(prev_max, residual), residual


def split_packed(packed: int):
    """(n_unfinished, anomaly_mask) from the fetched packed scalar."""
    p = int(packed)
    return p >> _ANOMALY_BITS, p & ((1 << _ANOMALY_BITS) - 1)
