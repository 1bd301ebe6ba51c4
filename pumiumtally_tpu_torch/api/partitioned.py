"""Partitioned-mesh facade on one device (port of
``pumiumtally_tpu/api/partitioned.py``): the three-call protocol over
element blocks + particle migration (parallel/partition.py), with the
block-local walk W1 (ops/vmem_walk.py) on the packed tables or, with
``walk_table_dtype="bfloat16"`` and ``walk_kernel="pallas"``, the
two-tier block walk W2 (ops/pallas_walk.py). Staging, the flying-zeroing
side effect, timing and the legacy VTK output are inherited from
``PumiTally``; a ``.pvtu`` filename writes the rank-aware piece layout
(one piece: the device owns every block). The facade's mesh keeps its
own tables: the engine builds the block tables of the configured tier.

W1 requires ``TallyConfig.walk_vmem_max_elems`` (the gather walk that
runs without it is not ported yet). Left out: multi-device meshes and
the sentinel/scoring hooks.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Union

import numpy as np
import torch

from pumiumtally_tpu_torch.api.tally import PumiTally, TallyConfig
from pumiumtally_tpu_torch.io.vtk import merge_cell_data, write_pvtu
from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh
from pumiumtally_tpu_torch.parallel.partition import PartitionedEngine


class PartitionedPumiTally(PumiTally):
    """Track-length tally with the tet mesh split into blocks that each
    walk against their own table, particles migrating between them."""

    def __init__(self, mesh: Union[TetMesh, str],
                 num_particles: int = 100_000,
                 config: Optional[TallyConfig] = None, device: Any = None):
        t0 = time.perf_counter()
        mesh = self._init_common(mesh, num_particles, config, device,
                                 lowp_mesh=False)
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
        )
        self._sync()
        self.tally_times.initialization_time += time.perf_counter() - t0

    # -- dispatch hooks ---------------------------------------------------
    def _dispatch_localize(self, dest: torch.Tensor):
        return self.engine.localize(dest), 0

    def _current_lost(self) -> int:
        return self.engine.n_lost

    def _dispatch_move(self, origins, dests, fly, w) -> bool:
        return self.engine.move(origins, dests, fly, w)

    def WriteTallyResults(self, filename: Optional[str] = None) -> None:
        """Normalize and write results; a ``.pvtu`` filename writes one
        binary piece per device plus the index file (the reference's
        rank-aware ``vtk::write_parallel``, PumiTallyImpl.cpp:415). Any
        other extension goes to the legacy writer."""
        out = filename or self.config.output_filename
        if not out.endswith(".pvtu"):
            return super().WriteTallyResults(filename)
        t0 = time.perf_counter()
        # One device owns every block: a single piece.
        owner = np.zeros_like(self.engine.part.owner)
        write_pvtu(
            out,
            self.mesh.coords.cpu().numpy(),
            self.mesh.tet2vert.cpu().numpy(),
            owner,
            cell_data=merge_cell_data({
                "flux": self.normalized_flux().cpu().numpy(),
                "volume": self.mesh.volumes.cpu().numpy(),
                "owner": owner.astype(np.float64),
            }),
            field_data=self._vtk_field_data(),
            nparts=1,
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
    def positions(self) -> np.ndarray:
        return self.engine.positions()[: self.num_particles]

    @property
    def elem_ids(self) -> np.ndarray:
        return self.engine.elem_ids()[: self.num_particles]
