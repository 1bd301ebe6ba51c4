"""Engine knobs: the subset of ``pumiumtally_tpu.config.TallyConfig``
that the PyTorch port implements so far.

A knob the port does not have is not a field, so passing it is a
``TypeError``. The few values the JAX package accepts but the port does
not run yet raise ``NotImplementedError`` naming the ROADMAP.md item
that brings them. Validation and resolution otherwise follow the JAX
package's ``TallyConfig`` (config.py:592-660, :728-746).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

# ROADMAP.md items named by the refusals below.
ROADMAP_GATHER_BLOCKS = (
    "ROADMAP.md queue 1 item 8, 'partitioned gather walk (walk_local)'"
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
        bound of the block walks (shared memory plays VMEM's role; the
        bf16 tier doubles it). Required by the "vmem" block walk; with
        "pallas" it only sizes the blocks (unset: one block).
      walk_kernel / walk_block_kernel: the JAX package's block-kernel
        selectors (``resolved_walk_kernel``): "vmem" (W1) or "pallas"
        (W2, two-tier only); the "gather" block walk is not ported.
      walk_table_dtype: "float32" (the packed table), "bfloat16" (the
        two-tier tables, both facades) or "auto"/None (the
        PUMIUMTALLY_WALK_TABLE_DTYPE environment variable, else
        float32).
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
                    "a bfloat16 working dtype is not supported: positions "
                    "and flux stay float32 or float64 (the bf16 walk-table "
                    "tier is walk_table_dtype='bfloat16')"
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
        if self.walk_kernel not in ("gather", "vmem", "pallas"):
            raise ValueError(
                "walk_kernel must be 'gather', 'vmem' or 'pallas', "
                f"got {self.walk_kernel!r}"
            )
        if (
            self.walk_kernel == "pallas"
            and self.resolved_table_dtype() != "bfloat16"
        ):
            raise ValueError(
                "walk_kernel='pallas' is the two-tier streaming kernel "
                "and needs the bf16 select tier — set "
                "walk_table_dtype='bfloat16' (got "
                f"{self.resolved_table_dtype()!r})"
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

    def resolved_table_dtype(self) -> str:
        """The walk-table tier, "float32" or "bfloat16", with "auto"
        resolved through the environment (ops/walk.py)."""
        from pumiumtally_tpu_torch.ops.walk import resolve_table_dtype

        return resolve_table_dtype(self.walk_table_dtype or "auto")

    def resolved_walk_kernel(self) -> str:
        """The block-kernel selector the partitioned engine receives:
        ``walk_kernel="gather"`` (the default) defers to
        ``walk_block_kernel``; anything else names the kernel."""
        if self.walk_kernel == "gather":
            return self.walk_block_kernel
        return self.walk_kernel

    def resolved_max_iters(self, nelems: int) -> int:
        """Safety cap only: a straight segment can cross O(E) tets on a
        degenerate mesh, and every walk stops as soon as it is done."""
        if self.max_iters is not None:
            return int(self.max_iters)
        return 64 + int(nelems)
