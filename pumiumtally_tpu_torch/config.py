"""Engine knobs: the subset of ``pumiumtally_tpu.config.TallyConfig``
that the PyTorch port implements so far.

A knob the port does not have is not a field, so passing it is a
``TypeError``. The few values the JAX package accepts but the port does
not run yet raise ``NotImplementedError`` naming the ROADMAP.md item
that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

# ROADMAP.md items named by the refusals below.
ROADMAP_TWO_TIER = "ROADMAP.md queue 2, K2 (two-tier tables, pallas_walk_local)"
ROADMAP_GATHER_BLOCKS = (
    "ROADMAP.md queue 1, 'partitioned gather walk (walk_local)'"
)
ROADMAP_SCORING = "ROADMAP.md queue 1, 'scoring, stats and sentinel'"


@dataclasses.dataclass
class TallyConfig:
    """Knobs for the tally engine (meanings as in the JAX package).

    Attributes:
      dtype: working float dtype of coordinates and flux. ``None`` takes
        the mesh's dtype (``build_box`` builds float32 by default).
      tolerance: face-exit tolerance. ``None`` -> 1e-8 in float64,
        1e-6 in float32.
      max_iters: per-particle walk step budget. ``None`` -> 64 + E.
      localization: "walk" (walk from element 0's centroid, the
        reference's rule) or "locate" (half-space point location first).
      check_found_all: print the reference's "Not all particles are
        found" error when a walk runs out of budget.
      capacity_factor: partitioned engine only, per-block slot
        over-provisioning.
      max_migration_rounds: partitioned engine only, walk/migrate
        rounds per phase.
      walk_vmem_max_elems: partitioned engine only, the block length
        bound of the block-local walk (shared memory plays VMEM's role).
      walk_kernel / walk_block_kernel: the JAX package's block-kernel
        selectors; only the "vmem" block walk exists in the port.
      walk_table_dtype: only the float32 single-tier table exists.
      scoring: no scoring lanes yet.
      output_filename: default VTK output path.
    """

    dtype: Any = None
    tolerance: Optional[float] = None
    max_iters: Optional[int] = None
    localization: str = "walk"
    check_found_all: bool = True
    capacity_factor: float = 1.5
    max_migration_rounds: int = 64
    walk_vmem_max_elems: Optional[int] = None
    walk_kernel: str = "gather"
    walk_block_kernel: str = "vmem"
    walk_table_dtype: Optional[str] = None
    scoring: Optional[Any] = None
    output_filename: str = "fluxresult.vtk"

    def __post_init__(self) -> None:
        if self.localization not in ("walk", "locate"):
            raise ValueError(
                "localization must be 'walk' or 'locate', "
                f"got {self.localization!r}"
            )
        if self.dtype is not None:
            if self.dtype == torch.bfloat16:
                raise NotImplementedError(
                    f"bfloat16 tables are not ported yet: {ROADMAP_TWO_TIER}"
                )
            if self.dtype not in (torch.float32, torch.float64):
                raise ValueError(
                    f"dtype must be torch.float32 or torch.float64, "
                    f"got {self.dtype!r}"
                )
        if self.walk_table_dtype not in (None, "auto", "float32", "bfloat16"):
            raise ValueError(
                "walk_table_dtype must be auto/float32/bfloat16, "
                f"got {self.walk_table_dtype!r}"
            )
        if self.walk_table_dtype == "bfloat16":
            raise NotImplementedError(
                f"walk_table_dtype='bfloat16' is not ported yet: "
                f"{ROADMAP_TWO_TIER}"
            )
        if self.walk_kernel not in ("gather", "vmem", "pallas"):
            raise ValueError(
                "walk_kernel must be 'gather', 'vmem' or 'pallas', "
                f"got {self.walk_kernel!r}"
            )
        if self.walk_kernel == "pallas":
            raise NotImplementedError(
                f"walk_kernel='pallas' is not ported yet: {ROADMAP_TWO_TIER}"
            )
        if self.walk_block_kernel not in ("vmem", "gather"):
            raise ValueError(
                "walk_block_kernel must be 'vmem' or 'gather', "
                f"got {self.walk_block_kernel!r}"
            )
        if self.walk_block_kernel == "gather":
            raise NotImplementedError(
                f"walk_block_kernel='gather' is not ported yet: "
                f"{ROADMAP_GATHER_BLOCKS}"
            )
        if self.scoring is not None:
            raise NotImplementedError(
                f"scoring is not ported yet: {ROADMAP_SCORING}"
            )
        if self.walk_vmem_max_elems is not None and int(
            self.walk_vmem_max_elems
        ) < 1:
            raise ValueError(
                f"walk_vmem_max_elems must be >= 1, "
                f"got {self.walk_vmem_max_elems!r}"
            )

    def resolved_tolerance(self, dtype: Any) -> float:
        """Geometric tolerance keyed to the WORKING dtype: an f32 walk
        must not run with the 1e-8 f64 threshold."""
        if self.tolerance is not None:
            return float(self.tolerance)
        return 1e-8 if dtype == torch.float64 else 1e-6

    def resolved_max_iters(self, nelems: int) -> int:
        """Safety cap only: a straight segment can cross O(E) tets on a
        degenerate mesh, and every walk stops as soon as it is done."""
        if self.max_iters is not None:
            return int(self.max_iters)
        return 64 + int(nelems)
