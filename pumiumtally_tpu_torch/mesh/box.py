"""Structured box -> tet mesh generator (Kuhn/Freudenthal decomposition),
the port of ``pumiumtally_tpu/mesh/box.py``: the same element numbering,
which the reference's 6-tet unit-cube oracles depend on.

Local tet k of a cell occupies the region where the coordinates sorted
by the k-th permutation are descending:

  0: y>=x>=z   1: y>=z>=x   2: z>=y>=x   3: z>=x>=y   4: x>=z>=y   5: x>=y>=z
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh

# Corner index c = ix + 2*iy + 4*iz of the unit cell; Kuhn tet for the
# permutation (p1,p2,p3): corners 0, e_p1, e_p1+e_p2, (1,1,1).
_KUHN_CORNERS = np.array(
    [
        [0, 2, 3, 7],  # y>=x>=z
        [0, 2, 6, 7],  # y>=z>=x
        [0, 4, 6, 7],  # z>=y>=x
        [0, 4, 5, 7],  # z>=x>=y
        [0, 1, 5, 7],  # x>=z>=y
        [0, 1, 3, 7],  # x>=y>=z
    ],
    dtype=np.int32,
)


def box_arrays(
    lx: float, ly: float, lz: float, nx: int, ny: int, nz: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Raw (coords, tet2vert) for an nx x ny x nz grid box of size
    lx x ly x lz."""
    if min(nx, ny, nz) < 1:
        raise ValueError("grid divisions must be >= 1")
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    zs = np.linspace(0.0, lz, nz + 1)
    # Vertex id = i + (nx+1)*(j + (ny+1)*k)
    zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
    coords = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    i, j, k = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    i = i.transpose(2, 1, 0).reshape(-1)  # cell order: k-major, then j, i
    j = j.transpose(2, 1, 0).reshape(-1)
    k = k.transpose(2, 1, 0).reshape(-1)

    def vid(di, dj, dk):
        return (i + di) + (nx + 1) * ((j + dj) + (ny + 1) * (k + dk))

    corners = np.stack(
        [vid((c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1) for c in range(8)],
        axis=1,
    )
    tets = corners[:, _KUHN_CORNERS]  # [ncells, 6, 4]
    return coords, tets.reshape(-1, 4).astype(np.int32)


def build_box(
    lx: float = 1.0, ly: float = 1.0, lz: float = 1.0,
    nx: int = 1, ny: int = 1, nz: int = 1,
    dtype: Optional[torch.dtype] = None, device: Any = "cpu",
) -> TetMesh:
    coords, tet2vert = box_arrays(lx, ly, lz, nx, ny, nz)
    return TetMesh.from_arrays(coords, tet2vert, dtype=dtype, device=device)
