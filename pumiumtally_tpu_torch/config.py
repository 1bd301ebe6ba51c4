"""Engine knobs: every field of ``pumiumtally_tpu.config.TallyConfig``,
validated and resolved as the JAX package does (config.py:343-365,
:576-705, :728-746). A knob neither package has is not a field, so
passing it is a ``TypeError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

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
        bf16 tier doubles it). Unset: one block holds the whole mesh and
        the gather block walk W4 walks it; the "vmem" block walk (W1)
        runs where every block fits the bound, "pallas" (W2) and
        "gather" (W4) take it only to size the blocks.
      walk_kernel / walk_block_kernel: the JAX package's block-kernel
        selectors (``resolved_walk_kernel``): "vmem" (W1), "gather" (the
        gather block walk W4, also where bf16 tables or scoring meet
        "vmem") or "pallas" (W2, two-tier only).
      cap_frontier: partitioned engine only, the frontier-slab migrate:
        a migration round whose crossing front fits this many slots
        moves only the paused particles (stayers keep their slots);
        a larger front falls back to the full-capacity migrate. None
        (default): the full migrate every round; 0: the fallback every
        round.
      walk_table_dtype: "float32" (the packed table), "bfloat16" (the
        two-tier tables, both facades) or "auto"/None (the
        PUMIUMTALLY_WALK_TABLE_DTYPE environment variable, else
        float32).
      batch_stats: per-batch (sum, sum-of-squares) lanes over the flux
        (and over the scoring bank when ``scoring`` is set), closed at
        each ``CopyInitialPosition`` and by ``close_batch()`` /
        ``finalize()``; ``WriteTallyResults`` then adds ``flux_mean``
        (from 1 closed batch) and ``rel_err`` (from 2). Off: nothing is
        allocated.
      batch_stats_trigger: a ``stats.TriggerSpec`` that ``close_batch()``
        evaluates when the caller passes none (needs ``batch_stats``).
      scoring: a ``scoring.ScoringSpec``: energy/time-binned scoring
        lanes, a flattened [E*B*S] bank on the device, fed by the
        ``energy=``/``time=`` arguments of ``MoveToNextLocation`` and
        committed inside the walk kernels (W0, W2 and W4; a partitioned
        engine on the float32 tables scores through the gather block
        walk W4, as the JAX engine does). None: no scoring code runs.
      checkpoint: a ``resilience.CheckpointPolicy``: autosave of atomic,
        digest-sealed checkpoint generations into ``policy.dir`` at the
        policy's cadence (closed source batches and/or wall seconds,
        checked at batch close and move end), keep-last-K, and the
        SIGTERM/SIGINT graceful drain; ``checkpoint_now()`` and
        ``resume_latest()`` on every facade. It also switches W0's and
        W4's flux and scoring commits to the deterministic commit
        (ops/det_commit.py), so that a resumed run equals an
        uninterrupted one bit for bit on the card. None (default):
        nothing of it runs and no handler is installed.
      sentinel: a ``sentinel.SentinelPolicy``: per-move audit lanes on
        the device (one scalar fetch a move), the straggler-escalation
        ladder instead of silent truncation at ``max_iters``, quarantine
        records, and ``health_report()``. None (default): no sentinel
        code runs and no path changes.
      record_xpoints: ``PumiTally`` keeps the last move's staged inputs
        so that ``intersection_points()`` can replay it (the
        reference's ``getIntersectionPoints()``); the other facades
        refuse the call.
      output_filename: default VTK output path.
      auto_continue: ``MoveToNextLocation`` detects on the host when the
        staged origins echo the previous move's destinations bit for
        bit in the working dtype and reuses the device tensor that
        staged them instead of uploading them again (phase A still
        runs on the device, and W0 skips its walk when every particle
        already sits at its origin); also caches the device all-ones
        flying and weights and reuses the weights when they echo the
        previous move's. After 8 consecutive misses the snapshots stop,
        with one retry every 64 moves; ``CopyInitialPosition`` re-arms.
      fenced_timing: each protocol call synchronizes the device before
        its end stamp, so ``TallyTimes`` measures device work. False
        lets calls return after dispatch; with ``check_found_all=False``
        too, a continue move and an echoing two-phase move make no
        host synchronization at all.
      validate_inputs: the host finite check of staged positions and
        weights (after the working-dtype cast). False skips it.
      walk_cond_every, walk_perm_mode, walk_window_factor,
        walk_min_window, walk_partition_method: the JAX walk's
        compaction-cascade knobs, validated as the JAX package
        validates them and otherwise without effect: the port's kernels
        walk each particle to completion and have no cascade. They are
        accepted so that a JAX configuration crosses over
        (``convert.tally_config``).
      device_mesh: a ``parallel.DeviceMesh`` (``make_device_mesh``):
        ``PumiTally`` and ``StreamingTally`` shard the particles over it
        (the mesh tables copied to each device, flux reduced across the
        shards in fixed shard order); the partitioned facades spread
        their element blocks over it. None: one device.
      migrate_collective: the JAX package's choice of the in-loop
        migration (its collective instead of its scatter; bitwise the
        same), accepted and validated. The port's engine picks by the
        mesh: row copies within one process (the faster on the card,
        PERF.md), the collective (an all_gather of the counting-rank
        keys and a ring of packed slabs, parallel/distributed.py)
        across processes.
      placement: partitioned engines: "linear" (flat RCB ownership) or
        "pod_rcb" (hosts first, then each host's devices).
      placement_hosts: per-host device counts in mesh order (a virtual
        host layout); None derives them from the mesh's processes.
      device_groups: ``StreamingPartitionedTally``: the mesh splits into
        this many disjoint groups, the chunks going round-robin across
        them.
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
    cap_frontier: Optional[int] = None
    batch_stats: bool = False
    batch_stats_trigger: Optional[Any] = None
    scoring: Optional[Any] = None
    checkpoint: Optional[Any] = None
    sentinel: Optional[Any] = None
    record_xpoints: bool = False
    output_filename: str = "fluxresult.vtk"
    auto_continue: bool = True
    fenced_timing: bool = True
    validate_inputs: bool = True
    walk_cond_every: Optional[int] = None
    walk_perm_mode: Optional[str] = None
    walk_window_factor: Optional[int] = None
    walk_min_window: Optional[int] = None
    walk_partition_method: Optional[str] = None
    device_groups: int = 1
    device_mesh: Optional[Any] = None
    migrate_collective: bool = False
    placement: str = "linear"
    placement_hosts: Optional[tuple] = None

    def __post_init__(self) -> None:
        if self.localization not in ("walk", "locate"):
            raise ValueError(
                "localization must be 'walk' or 'locate', "
                f"got {self.localization!r}"
            )
        if int(self.device_groups) < 1:
            raise ValueError(
                f"device_groups must be >= 1, got {self.device_groups!r}"
            )
        if self.walk_perm_mode is not None and self.walk_perm_mode not in (
            "auto", "arrays", "packed", "indirect", "sorted"
        ):
            raise ValueError(
                "walk_perm_mode must be auto/arrays/packed/indirect/"
                f"sorted, got {self.walk_perm_mode!r}"
            )
        if self.walk_partition_method is not None and (
            self.walk_partition_method not in ("rank", "argsort")
        ):
            raise ValueError(
                "walk_partition_method must be 'rank' or 'argsort', "
                f"got {self.walk_partition_method!r}"
            )
        if self.walk_window_factor is not None and int(
            self.walk_window_factor
        ) < 2:
            raise ValueError(
                f"walk_window_factor must be >= 2, "
                f"got {self.walk_window_factor!r}"
            )
        if self.walk_cond_every is not None and int(self.walk_cond_every) < 1:
            raise ValueError(
                f"walk_cond_every must be >= 1, got {self.walk_cond_every!r}"
            )
        if self.walk_min_window is not None and int(self.walk_min_window) < 1:
            raise ValueError(
                f"walk_min_window must be >= 1, got {self.walk_min_window!r}"
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
        if self.cap_frontier is not None and int(self.cap_frontier) < 0:
            raise ValueError(
                f"cap_frontier must be >= 0 (0 = forced full-capacity "
                f"fallback) or None, got {self.cap_frontier!r}"
            )
        if self.placement not in ("linear", "pod_rcb"):
            raise ValueError(
                f"placement must be 'linear' or 'pod_rcb', "
                f"got {self.placement!r}"
            )
        if self.placement_hosts is not None:
            hosts = tuple(self.placement_hosts)
            if not hosts or any(
                not isinstance(h, int) or h < 1 for h in hosts
            ):
                raise ValueError(
                    "placement_hosts must be a non-empty tuple of "
                    f"positive per-host chip counts, "
                    f"got {self.placement_hosts!r}"
                )
        if self.device_mesh is not None:
            from pumiumtally_tpu_torch.parallel.device import (
                DeviceMesh,
                mesh_axis,
            )

            if not isinstance(self.device_mesh, DeviceMesh):
                raise ValueError(
                    "device_mesh must be a parallel.DeviceMesh "
                    f"(make_device_mesh), got {self.device_mesh!r}"
                )
            mesh_axis(self.device_mesh)  # must be 1-D
        if self.batch_stats_trigger is not None:
            from pumiumtally_tpu_torch.stats.triggers import TriggerSpec

            if not isinstance(self.batch_stats_trigger, TriggerSpec):
                raise ValueError(
                    "batch_stats_trigger must be a stats.TriggerSpec, "
                    f"got {self.batch_stats_trigger!r}"
                )
            if not self.batch_stats:
                raise ValueError(
                    "batch_stats_trigger needs batch_stats=True (no "
                    "lanes are accumulated otherwise)"
                )
        if self.scoring is not None:
            from pumiumtally_tpu_torch.scoring.binding import ScoringSpec

            if not isinstance(self.scoring, ScoringSpec):
                raise ValueError(
                    "scoring must be a scoring.ScoringSpec, "
                    f"got {self.scoring!r}"
                )
        if self.checkpoint is not None:
            from pumiumtally_tpu_torch.resilience.policy import (
                CheckpointPolicy,
            )

            if not isinstance(self.checkpoint, CheckpointPolicy):
                raise ValueError(
                    "checkpoint must be a resilience.CheckpointPolicy, "
                    f"got {self.checkpoint!r}"
                )
        if self.sentinel is not None:
            from pumiumtally_tpu_torch.sentinel.policy import SentinelPolicy

            if not isinstance(self.sentinel, SentinelPolicy):
                raise ValueError(
                    "sentinel must be a sentinel.SentinelPolicy, "
                    f"got {self.sentinel!r}"
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


# Kernel build tripwire budget (``utils/profiling.build_guard``), the
# counterpart of the JAX package's ``RETRACE_BUDGETS``: the most nvcc
# builds of any one CUDA library of ``kernels.SOURCES`` in a guarded
# block. Each library is one source compiled once, never when its cached
# build matches the sources; a second build means the cache key moved
# under a running process, and a rebuild on the card costs tens of
# seconds.
BUILD_BUDGET = 1
