"""The walk's roofline: the least time an H100 could take for the work
the inputs need, whatever implements it.

``bound_ms`` is a frozen copy of chip_smoke.py's ``bound_entry``: the
larger of the bytes read and written once over the HBM bandwidth and
the operations over the float32 peak outside the tensor cores, against
NVIDIA's published H100 SXM peaks (the card's power limit is printed
beside each run's numbers). The work is counted by the benchmark's own
reference walk (``reference.walk.Touched``), never from the program's
counters, so a change to the program's layout cannot move the
yardstick.

Bytes a walk needs, in float32:

- each distinct tet it walks through: four face planes (16 floats) and
  four neighbour ids, read once (80 B);
- each particle's state: its position and element read and written
  once (2 x 16 B), its destination read once (12 B), and in a tallied
  walk its weight and flying flag (5 B);
- each flux entry and scoring lane it writes: read and written once
  (2 x 4 B).

Operations: ``FLOPS_PER_CROSSING`` a step (four faces' dot products,
divisions and compares, as chip_smoke.py counts them).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
FLOPS_PER_CROSSING = 4 * 17 + 2
TET_BYTES = 80
STATE_BYTES = 2 * 16 + 12
TALLY_INPUT_BYTES = 5
ENTRY_BYTES = 2 * 4


def bound_ms(nbytes: float, crossings: int,
             flops_per_crossing: int = FLOPS_PER_CROSSING,
             flops: float = F32_FLOPS) -> float:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = crossings * flops_per_crossing / flops * 1e3
    return max(t_bytes, t_ops)


def walk_bytes(touched, particles: int, tallied: bool) -> int:
    """Bytes one walk needs (module docstring)."""
    per_particle = STATE_BYTES + (TALLY_INPUT_BYTES if tallied else 0)
    return (touched.elems * TET_BYTES + particles * per_particle
            + (touched.flux + touched.lanes) * ENTRY_BYTES)


def walk_bound_ms(touched, particles: int, tallied: bool) -> float:
    if touched.steps == 0:
        return 0.0
    return bound_ms(walk_bytes(touched, particles, tallied), touched.steps)
