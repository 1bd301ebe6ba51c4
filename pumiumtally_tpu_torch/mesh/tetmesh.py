"""Tetrahedral mesh with precomputed walk geometry (PyTorch port of
``pumiumtally_tpu/mesh/tetmesh.py``).

Everything the walk needs is computed ONCE on the host in float64 numpy
(the same code as the JAX package, so the arrays agree bit for bit) and
moved to the device as flat tensors:

- ``coords[V,3]``, ``tet2vert[E,4]`` int32 (positively oriented)
- ``face_adj[E,4]`` int32: neighbour across the face opposite local
  vertex f, -1 at the boundary
- ``volumes[E]``
- ``walk_table[E,20]``: per tet, 4 outward unit face normals | 4 plane
  offsets | 4 neighbour ids stored as floats. One 80 B (f32) row is what
  a walk step reads; the ids are exact below 2^24 in f32, which
  ``from_arrays`` enforces.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

# Local face f is the face opposite local vertex f.
_FACE_OF_VERT = np.array(
    [[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=np.int32
)

# The packed walk-table row layout (the same columns as the JAX package;
# the CUDA kernels read them through the same offsets, csrc/walk_step.cuh).
WALK_TABLE_NORMALS = slice(0, 12)  # 4 faces x 3 components
WALK_TABLE_OFFSETS = slice(12, 16)  # 4 face-plane offsets
WALK_TABLE_ADJ = slice(16, 20)  # 4 neighbour ids, as floats
WALK_TABLE_WIDTH = 20


def exact_id_limit(dtype: torch.dtype) -> int:
    """Element-id count exactly representable in ``dtype``: 2^24 for
    f32, 2^53 for f64."""
    return 2 ** {torch.float32: 24, torch.float64: 53}[dtype]


def _pack_walk_table(normals: np.ndarray, offsets: np.ndarray,
                     adj: np.ndarray) -> np.ndarray:
    """Assemble the float64 [E,WALK_TABLE_WIDTH] rows."""
    ne = offsets.shape[0]
    row = np.concatenate(
        [normals.reshape(ne, 12), offsets, adj.astype(np.float64)], axis=1
    )
    assert row.shape[1] == WALK_TABLE_WIDTH
    return row


def _signed_volumes(coords: np.ndarray, tet2vert: np.ndarray) -> np.ndarray:
    v = coords[tet2vert]  # [E,4,3]
    a = v[:, 1] - v[:, 0]
    b = v[:, 2] - v[:, 0]
    c = v[:, 3] - v[:, 0]
    return np.einsum("ei,ei->e", np.cross(a, b), c) / 6.0


def _build_face_adjacency(tet2vert: np.ndarray) -> np.ndarray:
    """face_adj[E,4]: tet across the face opposite local vertex f, or -1
    (half-faces keyed by their sorted vertex triple; a key seen twice is
    an interior face)."""
    ne = tet2vert.shape[0]
    faces = tet2vert[:, _FACE_OF_VERT]  # [E,4,3]
    keys = np.sort(faces.reshape(-1, 3), axis=1)  # [4E,3]
    order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
    sk = keys[order]
    same = np.all(sk[1:] == sk[:-1], axis=1)
    owner = order // 4
    face_adj = np.full(ne * 4, -1, dtype=np.int32)
    lo = np.nonzero(same)[0]
    face_adj[order[lo]] = owner[lo + 1]
    face_adj[order[lo + 1]] = owner[lo]
    return face_adj.reshape(ne, 4)


def mesh_geometry(coords: np.ndarray, tet2vert: np.ndarray):
    """Host-side float64 precompute shared by ``TetMesh.from_arrays``:
    (coords, oriented tet2vert, unit outward normals [E,4,3], offsets
    [E,4], face_adj [E,4], volumes [E])."""
    coords = np.asarray(coords, dtype=np.float64)
    tet2vert = np.array(tet2vert, dtype=np.int32, copy=True)
    if coords.ndim != 2 or coords.shape[1] != 3:
        raise ValueError(f"coords must be [V,3], got {coords.shape}")
    if tet2vert.ndim != 2 or tet2vert.shape[1] != 4:
        raise ValueError(f"tet2vert must be [E,4], got {tet2vert.shape}")
    # Positive orientation: swap two verts where the signed volume < 0.
    sv = _signed_volumes(coords, tet2vert)
    neg = sv < 0
    tet2vert[neg, 2], tet2vert[neg, 3] = (
        tet2vert[neg, 3].copy(), tet2vert[neg, 2].copy(),
    )
    volumes = _signed_volumes(coords, tet2vert)
    if np.any(volumes <= 0):
        bad = int(np.sum(volumes <= 0))
        raise ValueError(f"{bad} degenerate (zero-volume) tets in mesh")
    v = coords[tet2vert]  # [E,4,3]
    fa = v[:, _FACE_OF_VERT]  # [E,4,3verts,3xyz]
    e1 = fa[:, :, 1] - fa[:, :, 0]
    e2 = fa[:, :, 2] - fa[:, :, 0]
    n = np.cross(e1, e2)
    # Outward: n . (v_opp - face_point) must be negative.
    s = np.einsum("efc,efc->ef", n, v - fa[:, :, 0])
    n = np.where((s > 0)[..., None], -n, n)
    n = n / np.linalg.norm(n, axis=2, keepdims=True)
    offsets = np.einsum("efc,efc->ef", n, fa[:, :, 0])
    return coords, tet2vert, n, offsets, _build_face_adjacency(tet2vert), volumes


@dataclasses.dataclass(frozen=True)
class TetMesh:
    """Immutable tet mesh as tensors on one device."""

    coords: torch.Tensor  # [V,3] float
    tet2vert: torch.Tensor  # [E,4] int32
    face_adj: torch.Tensor  # [E,4] int32, -1 = boundary
    volumes: torch.Tensor  # [E] float
    walk_table: torch.Tensor  # [E,20] float: normals|offsets|adj

    @property
    def face_normals(self) -> torch.Tensor:
        return self.walk_table[:, WALK_TABLE_NORMALS].reshape(-1, 4, 3)

    @property
    def face_offsets(self) -> torch.Tensor:
        return self.walk_table[:, WALK_TABLE_OFFSETS]

    @property
    def dtype(self) -> torch.dtype:
        return self.coords.dtype

    @property
    def device(self) -> torch.device:
        return self.coords.device

    @property
    def nelems(self) -> int:
        return int(self.tet2vert.shape[0])

    @property
    def nverts(self) -> int:
        return int(self.coords.shape[0])

    @classmethod
    def from_arrays(
        cls, coords: np.ndarray, tet2vert: np.ndarray,
        dtype: Optional[torch.dtype] = None, device: Any = "cpu",
    ) -> "TetMesh":
        """Build a mesh (host-side precompute) from raw connectivity:
        orientation fix, outward face planes, adjacency and volumes."""
        dtype = torch.float32 if dtype is None else dtype
        coords, tet2vert, n, offsets, face_adj, volumes = mesh_geometry(
            coords, tet2vert
        )
        ne = tet2vert.shape[0]
        if ne >= exact_id_limit(dtype):
            raise NotImplementedError(
                f"{ne} elements exceed the exact float-id limit of "
                f"{dtype} walk tables; the int32-adjacency layout is not "
                "ported yet (ROADMAP.md queue 1, 'partitioned gather walk "
                "(walk_local)')"
            )
        return cls.from_numpy(
            coords, tet2vert, face_adj, volumes,
            _pack_walk_table(n, offsets, face_adj), dtype=dtype,
            device=device,
        )

    @classmethod
    def from_numpy(cls, coords, tet2vert, face_adj, volumes, walk_table,
                   dtype: torch.dtype, device: Any = "cpu") -> "TetMesh":
        """Move host arrays to ``device``: floats in ``dtype`` (the
        table from its float64 form, so ids stay exact), ids int32."""
        def f(a):
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)

        def i(a):
            return torch.tensor(np.asarray(a, dtype=np.int32), device=device)

        return cls(
            coords=f(coords), tet2vert=i(tet2vert), face_adj=i(face_adj),
            volumes=f(volumes), walk_table=f(walk_table),
        )

    def to(self, dtype: Optional[torch.dtype] = None,
           device: Any = None) -> "TetMesh":
        """This mesh in another working dtype and/or on another device.
        The table is rebuilt through float64 so adjacency ids survive."""
        dtype = self.dtype if dtype is None else dtype
        device = self.device if device is None else device
        table = self.walk_table.to(torch.float64, copy=True)
        table[:, WALK_TABLE_ADJ] = self.face_adj.double()
        return TetMesh(
            coords=self.coords.to(device=device, dtype=dtype),
            tet2vert=self.tet2vert.to(device),
            face_adj=self.face_adj.to(device),
            volumes=self.volumes.to(device=device, dtype=dtype),
            walk_table=table.to(device=device, dtype=dtype),
        )

    def centroids(self) -> torch.Tensor:
        """Element centroids [E,3] (the reference seeds particles at
        element 0's, PumiTallyImpl.cpp:500-509)."""
        return self.coords[self.tet2vert.long()].mean(dim=1)
