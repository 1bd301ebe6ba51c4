"""Partitioned-mesh facade (port of ``pumiumtally_tpu/api/partitioned.py``):
the three-call protocol over element blocks + particle migration
(parallel/partition.py), on one device or, with
``TallyConfig(device_mesh=...)``, with the blocks spread over the mesh's
shards (``migrate_collective``, ``placement`` and ``placement_hosts`` as
in the JAX package). Without a mesh it warns, as the JAX facade does,
when more than one CUDA device is visible. With a
default ``TallyConfig`` one block holds the whole mesh and the gather
block walk W4 (``walk_local``) walks it; ``walk_vmem_max_elems``
sub-splits the mesh, walked by W1 (ops/vmem_walk.py) where every block
fits the bound, by W4 over the occupied blocks with
``walk_block_kernel="gather"``, or, with ``walk_table_dtype="bfloat16"``
and ``walk_kernel="pallas"``, by the two-tier block walk W2
(ops/pallas_walk.py). bf16 tables with the vmem kernel and scoring on
the float32 tables run W4, as in the JAX package. Staging, the
flying-zeroing side effect, timing and the legacy VTK output are
inherited from ``PumiTally``; a ``.pvtu`` filename writes the rank-aware
piece layout (one piece: the device owns every block). The facade's
mesh keeps its own tables: the engine builds the block tables of the
configured tier.

Scoring and batch statistics are the base facade's; the engine owns the
padded bank (its size fixes the DROP sentinel) and ``score_bank``
assembles it in original element order. An exhausted overflow-recovery
ladder latches the engine poisoned and every later call refuses.

With a sentinel armed (``TallyConfig.sentinel``) each move is audited
from the engine's caller-order view, and its stragglers go through the
engine's own rung: the interrupted phase resumed at multiplied step and
round budgets (``retry_stragglers``, walked by the block walk of the
configuration, W4 by default), then ``declare_lost_stragglers`` with
quarantine records; the engine's overflow recoveries report into the
health record (``on_overflow_recovered``). ``intersection_points`` is
refused, as in the JAX package. With a ``CheckpointPolicy`` the engine
walks W4 with the deterministic commit, and an exhausted overflow
ladder writes an ``overflow_safety`` generation before the poisoned
refusal (``on_poisoned``, api/partitioned.py:119-127 of the JAX
package).
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Optional, Union

import numpy as np
import torch

from pumiumtally_tpu_torch.api.tally import PumiTally, TallyConfig
from pumiumtally_tpu_torch.io.vtk import merge_cell_data, write_pvtu
from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh
from pumiumtally_tpu_torch.parallel.partition import PartitionedEngine
from pumiumtally_tpu_torch.sentinel.quarantine import (
    append_quarantine,
    build_records,
)
from pumiumtally_tpu_torch.utils.profiling import span


def sentinel_post_move_engine(tally, engine, x0, dests, fly, w, ok, move,
                              pid_offset: int = 0):
    """The partitioned arm of the sentinel: the audit over the engine's
    caller-order view, then the engine's straggler rung (a resumed phase
    at multiplied budgets), then the residue declared lost with its
    quarantine records. Returns the found-all verdict."""
    pol = tally.config.sentinel
    view = engine.caller_order_view(("x", "done"))
    n_unf, mask = tally._sentinel.audit(x0, view["x"], fly, w, view["done"],
                                        engine.flux_original())
    recovered = lost = 0
    if n_unf and pol.straggler_retry:
        recovered, lost = engine_straggler_rung(tally, engine, x0, dests,
                                                fly, w, n_unf, move,
                                                pid_offset)
        ok = lost == 0
        tally._sentinel.resync(tally.flux)
    tally._sentinel.note_outcome(mask, n_unf, recovered, lost, move)
    return ok


def engine_straggler_rung(tally, engine, x0, dests, fly, w, n_unf: int,
                          move: int, pid_offset: int = 0) -> tuple:
    """One engine's straggler rung over its ``n_unf`` unfinished
    particles: a resumed phase at multiplied budgets, then the residue
    quarantined and declared lost. Returns ``(recovered, lost)``."""
    lost = 0
    if not engine.retry_stragglers(tally.config.sentinel.retry_iters_factor):
        quarantine_engine(tally, engine, x0, dests, fly, w, move,
                          pid_offset)
        lost = engine.declare_lost_stragglers()
    return max(0, n_unf - lost), lost


def quarantine_engine(tally, engine, x0, dests, fly, w, move,
                      pid_offset: int = 0) -> None:
    """Quarantine records for the particles the engine is about to
    declare lost (a caller-order fetch of the residue)."""
    view = engine.caller_order_view(("done", "elem_orig"))
    idx = np.flatnonzero(~view["done"].cpu().numpy()
                         & (fly.cpu().numpy() == 1))
    if idx.size == 0:
        return
    sel = torch.as_tensor(idx, device=x0.device)
    append_quarantine(
        tally.config.sentinel.quarantine_dir,
        build_records(idx, x0[sel].cpu().numpy(), dests[sel].cpu().numpy(),
                      view["elem_orig"].cpu().numpy()[idx],
                      w[sel].cpu().numpy(), move, pid_offset=pid_offset))


class PartitionedPumiTally(PumiTally):
    """Track-length tally with the tet mesh split into blocks that each
    walk against their own table, particles migrating between them."""

    def __init__(self, mesh: Union[TetMesh, str],
                 num_particles: int = 100_000,
                 config: Optional[TallyConfig] = None, device: Any = None):
        t0 = time.perf_counter()
        mesh = self._init_common(mesh, num_particles, config, device,
                                 lowp_mesh=False)
        cfg = self.config
        if (cfg.device_mesh is None and self.device.type == "cuda"
                and torch.cuda.device_count() > 1):
            # A forgotten device_mesh leaves the other cards idle.
            warnings.warn(
                f"PartitionedPumiTally: no device_mesh configured; "
                f"running on 1 of the {torch.cuda.device_count()} "
                "available cuda devices. Pass "
                "TallyConfig(device_mesh=make_device_mesh(n)) to use them.",
                stacklevel=2,
            )
        self.engine = PartitionedEngine(
            mesh,
            self.num_particles,
            capacity_factor=self.config.capacity_factor,
            tol=self._tol,
            max_iters=self._max_iters,
            max_rounds=self.config.max_migration_rounds,
            check_found_all=self.config.check_found_all,
            vmem_walk_max_elems=self.config.walk_vmem_max_elems,
            block_kernel=self.config.resolved_walk_kernel(),
            table_dtype=self.config.resolved_table_dtype(),
            scoring=self.config.scoring,
            cap_frontier=self.config.cap_frontier,
            deterministic=self._deterministic,
            device_mesh=cfg.device_mesh,
            migrate_collective=cfg.migrate_collective,
            placement=cfg.placement,
            placement_hosts=cfg.placement_hosts,
        )
        # After the engine: the DROP sentinel is its padded bank's size.
        self._arm_scoring(bank_size=self.engine.score_padded.numel()
                          if self.config.scoring is not None else None)
        self._wire_engine_hooks(self.engine)
        self._sync()
        self.tally_times.initialization_time += time.perf_counter() - t0

    def _engine_poisoned(self) -> bool:
        return self.engine.poisoned

    def _engines(self) -> list:
        return [self.engine]

    # -- dispatch hooks ---------------------------------------------------
    def _dispatch_localize(self, dest: torch.Tensor):
        return self.engine.localize(dest), 0

    def _current_lost(self) -> int:
        return self.engine.n_lost

    def _dispatch_move(self, origins, dests, fly, w, sbin=None,
                       sfac=None) -> bool:
        # Scoring operands are caller-order [n] rows: the engine routes
        # them by pid and migrates them with their particles.
        if self._sentinel is None:
            return self.engine.move(origins, dests, fly, w, sbin, sfac)
        # The audit needs the phase-B start in caller order: the staged
        # origins, or the committed positions BEFORE a continue move
        # (migration permutes the slots).
        x0 = (origins if origins is not None
              else self.engine.caller_order_view(("x",))["x"])
        ok = self.engine.move(origins, dests, fly, w, sbin, sfac)
        return sentinel_post_move_engine(self, self.engine, x0, dests, fly,
                                         w, ok, self.iter_count)

    def WriteTallyResults(self, filename: Optional[str] = None) -> None:
        """Normalize and write results; a ``.pvtu`` filename writes one
        binary piece per device plus the index file (the reference's
        rank-aware ``vtk::write_parallel``, PumiTallyImpl.cpp:415). Any
        other extension goes to the legacy writer."""
        out = filename or self.config.output_filename
        if not out.endswith(".pvtu"):
            return super().WriteTallyResults(filename)
        with span("ptt.write"):
            self._check_poisoned()  # the .pvtu branch bypasses super()
            t0 = time.perf_counter()
            # One piece a shard: its blocks' elements.
            owner = self.engine.part.owner // self.engine.blocks_per_chip
            write_pvtu(
                out,
                self.mesh.coords.cpu().numpy(),
                self.mesh.tet2vert.cpu().numpy(),
                owner,
                cell_data=merge_cell_data({
                    "flux": self.normalized_flux().cpu().numpy(),
                    "volume": self.mesh.volumes.cpu().numpy(),
                    "owner": owner.astype(np.float64),
                }, *self._optional_cell_data()),
                field_data=self._vtk_field_data(),
                nparts=self.engine.ndev,
            )
            self.tally_times.vtk_file_write_time += time.perf_counter() - t0
            self.tally_times.print_times()

    # -- state views (caller-visible order) -------------------------------
    @property
    def x(self) -> torch.Tensor:
        return self.engine.state["x"]

    @property
    def flux(self) -> torch.Tensor:
        """Block-owned flux assembled into original element order."""
        return self.engine.flux_original()

    @property
    def score_bank(self) -> torch.Tensor:
        """The engine's scoring lanes in the canonical [E*B*S] layout."""
        self._require_scoring()
        return self.engine.score_original()

    @property
    def positions(self) -> np.ndarray:
        return self.engine.positions()[: self.num_particles]

    @property
    def elem_ids(self) -> np.ndarray:
        return self.engine.elem_ids()[: self.num_particles]
