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
- or, in its place, the two-tier tables (``table_dtype="bfloat16"``,
  ``with_lowp_tables``): ``walk_table_lo[E,16]`` bf16, the SELECT tier
  (normals | offsets, one 32 B row picks the exit face), and
  ``walk_table_hi[E*4,5]`` in the working dtype, the per-face
  REFINEMENT tier (nx, ny, nz, off, adj of face f in row ``elem*4+f``:
  one 20 B row re-solves the winning face's crossing and names the
  neighbour). The adj lane holds ids as floats, under the same exact-id
  ceiling as the packed table.
- or the unpacked layout, where no table carries the ids: the face
  planes beside the int32 ``face_adj``, in one of two row layouts that
  W0 reads as whole 16-byte words at compile-time widths (csrc/walk.cu).
  ROW16 (``PLANE_ROW16``): one [E,16] buffer in the working dtype whose
  row holds the packed row's first 16 lanes (12 normal components, 4
  offsets); ``stored_face_normals`` is its [E,4,3] view with strides
  (16,3,1) and ``stored_face_offsets`` its [E,4] view with strides
  (16,1) at +12. ``from_arrays`` builds it for a mesh of
  ``exact_id_limit`` tets or more (2^24 in float32) or when asked
  (``force_unpacked``), and ``from_numpy``, ``to`` and
  ``with_unpacked_planes`` keep or make it. ROW20 (``PLANE_ROW20``):
  ``with_plane_views`` gives a two-tier mesh the views of its
  refinement tier in place (strides (20,5,1) and (20,5) at +3), for the
  float32 tier's walk; the kernel takes the neighbours from the tier's
  adj lanes.
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

# The two-tier layout (csrc/twotier_step.cuh reads the same columns).
WALK_TABLE_LO_NORMALS = slice(0, 12)  # bf16, 4 faces x 3 components
WALK_TABLE_LO_OFFSETS = slice(12, 16)  # bf16, 4 face-plane offsets
WALK_TABLE_LO_WIDTH = 16
WALK_PLANE_WIDTH = 5  # refinement row: (nx, ny, nz, off, adj) of ONE face

# The unpacked layout's row widths (``plane_layout``): a tet's planes in
# one row of the ROW16 buffer, or the refinement tier's four face rows.
PLANE_ROW16 = 16
PLANE_ROW20 = 4 * WALK_PLANE_WIDTH


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


def pack_lo_table(normals: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """The bf16 SELECT tier: [E,WALK_TABLE_LO_WIDTH] rows of
    normals|offsets, rounded to bf16 once, here."""
    ne = offsets.shape[0]
    row = torch.cat([normals.reshape(ne, 12), offsets], dim=1)
    assert row.shape[1] == WALK_TABLE_LO_WIDTH
    return row.to(torch.bfloat16)


def pack_plane_table(normals: torch.Tensor, offsets: torch.Tensor,
                     adj: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The REFINEMENT tier: [E*4,WALK_PLANE_WIDTH] rows, one per (elem,
    face), holding (nx, ny, nz, off, adj) in ``dtype``. Assembled in
    float64 so the ids survive the cast (the caller checks that they
    are exact in ``dtype``)."""
    ne = offsets.shape[0]
    row = torch.cat([
        normals.reshape(ne * 4, 3).double(),
        offsets.reshape(ne * 4, 1).double(),
        adj.reshape(ne * 4, 1).double(),
    ], dim=1)
    assert row.shape[1] == WALK_PLANE_WIDTH
    return row.to(dtype)


def row16_views(rows: torch.Tensor) -> dict:
    """``stored_face_normals`` [E,4,3] (strides (16,3,1)) and
    ``stored_face_offsets`` [E,4] (strides (16,1), at +12): the views of
    a contiguous ROW16 buffer that a TetMesh stores."""
    ne = rows.shape[0]
    return dict(stored_face_normals=rows[:, WALK_TABLE_NORMALS].view(ne, 4, 3),
                stored_face_offsets=rows[:, WALK_TABLE_OFFSETS])


# Each unpacked row layout: (row width, the normals' strides, the
# offsets' strides, the offsets' place in the row).
_PLANE_LAYOUTS = (
    (PLANE_ROW16, (16, 3, 1), (16, 1), 12),
    (PLANE_ROW20, (20, 5, 1), (20, 5), 3),
)


def plane_layout(normals: torch.Tensor,
                 offsets: torch.Tensor) -> Optional[int]:
    """The row width W0 reads the planes at: ``PLANE_ROW16`` for the
    views of a ROW16 buffer, ``PLANE_ROW20`` for a refinement tier's in
    place (``with_plane_views``), None for any other layout or a row
    base off a 16-byte boundary (the kernel reads whole 16-byte words).
    Shapes and dtype are the caller's to check."""
    storage = normals.untyped_storage()
    if (storage.data_ptr() != offsets.untyped_storage().data_ptr()
            or normals.data_ptr() % 16):
        return None
    base = normals.storage_offset()
    for row, nrm_strides, off_strides, at in _PLANE_LAYOUTS:
        # The storage holds every row whole (ROW20's last adj lane too).
        end = (base + row * normals.shape[0]) * normals.element_size()
        if (normals.stride() == nrm_strides
                and offsets.stride() == off_strides
                and offsets.storage_offset() == base + at
                and storage.nbytes() >= end):
            return row
    return None


def _check_two_tier_ids(ne: int, dtype: torch.dtype) -> None:
    if ne >= exact_id_limit(dtype):
        raise ValueError(
            f"two-tier walk tables store neighbor ids in "
            f"{str(dtype).removeprefix('torch.')} refinement rows; {ne} "
            f"elements exceed the exact-id limit {exact_id_limit(dtype)}"
        )


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
    # Contiguous: a reader may hand over a strided view (the binary
    # Gmsh v2 node records interleave ids and coordinates), which
    # torch.tensor refuses.
    coords = np.ascontiguousarray(coords, dtype=np.float64)
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
    """Immutable tet mesh as tensors on one device. It carries exactly one
    walk layout: the packed ``walk_table``, the two-tier tables
    (``walk_table_lo`` and ``walk_table_hi``, both set), or the unpacked
    planes (``stored_face_normals`` and ``stored_face_offsets``, both
    set, beside ``face_adj``)."""

    coords: torch.Tensor  # [V,3] float
    tet2vert: torch.Tensor  # [E,4] int32
    face_adj: torch.Tensor  # [E,4] int32, -1 = boundary
    volumes: torch.Tensor  # [E] float
    walk_table: Optional[torch.Tensor]  # [E,20] float: normals|offsets|adj
    walk_table_lo: Optional[torch.Tensor] = None  # [E,16] bf16
    walk_table_hi: Optional[torch.Tensor] = None  # [E*4,5] float
    # The unpacked layout's planes (None otherwise): views of a ROW16
    # buffer, or of the refinement tier (``with_plane_views``).
    stored_face_normals: Optional[torch.Tensor] = None  # [E,4,3] float
    stored_face_offsets: Optional[torch.Tensor] = None  # [E,4] float

    @property
    def face_normals(self) -> torch.Tensor:
        if self.stored_face_normals is not None:
            return self.stored_face_normals
        if self.walk_table is not None:
            return self.walk_table[:, WALK_TABLE_NORMALS].reshape(-1, 4, 3)
        return self.walk_table_hi.reshape(-1, 4, WALK_PLANE_WIDTH)[:, :, :3]

    @property
    def face_offsets(self) -> torch.Tensor:
        if self.stored_face_offsets is not None:
            return self.stored_face_offsets
        if self.walk_table is not None:
            return self.walk_table[:, WALK_TABLE_OFFSETS]
        return self.walk_table_hi.reshape(-1, 4, WALK_PLANE_WIDTH)[:, :, 3]

    @property
    def two_tier(self) -> bool:
        return self.walk_table_lo is not None

    @property
    def unpacked(self) -> bool:
        """Whether the walk reads the unpacked planes and ``face_adj``."""
        return self.stored_face_normals is not None

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
        table_dtype: str = "float32", force_unpacked: bool = False,
    ) -> "TetMesh":
        """Build a mesh (host-side precompute) from raw connectivity:
        orientation fix, outward face planes, adjacency and volumes.
        ``table_dtype="bfloat16"`` builds the two-tier tables straight
        from the float64 planes instead of the packed table. A mesh
        whose ids the float lanes cannot hold exactly (``exact_id_limit``
        tets or more), or one built with ``force_unpacked``, takes the
        unpacked layout (the two-tier tables have no such fallback: past
        the limit they are refused)."""
        dtype = torch.float32 if dtype is None else dtype
        coords, tet2vert, n, offsets, face_adj, volumes = mesh_geometry(
            coords, tet2vert
        )
        ne = tet2vert.shape[0]
        if table_dtype == "bfloat16":
            _check_two_tier_ids(ne, dtype)
            n_t, off_t = torch.from_numpy(n), torch.from_numpy(offsets)
            mesh = cls.from_numpy(coords, tet2vert, face_adj, volumes, None,
                                  dtype=dtype, device=device)
            return dataclasses.replace(
                mesh,
                walk_table_lo=pack_lo_table(n_t, off_t).to(device),
                walk_table_hi=pack_plane_table(
                    n_t, off_t, torch.from_numpy(face_adj), dtype
                ).to(device),
            )
        if ne >= exact_id_limit(dtype) or force_unpacked:
            return cls.from_numpy(coords, tet2vert, face_adj, volumes, None,
                                  dtype=dtype, device=device,
                                  face_normals=n, face_offsets=offsets)
        return cls.from_numpy(
            coords, tet2vert, face_adj, volumes,
            _pack_walk_table(n, offsets, face_adj), dtype=dtype,
            device=device,
        )

    @classmethod
    def from_numpy(cls, coords, tet2vert, face_adj, volumes, walk_table,
                   dtype: torch.dtype, device: Any = "cpu",
                   face_normals=None, face_offsets=None) -> "TetMesh":
        """Move host arrays to ``device``: floats in ``dtype`` (the
        table from its float64 form, so ids stay exact), ids int32.
        ``face_normals`` and ``face_offsets`` (with ``walk_table`` None)
        give the unpacked layout, in one ROW16 buffer; neither leaves the
        tables to the caller."""
        def f(a):
            return None if a is None else torch.tensor(
                np.asarray(a), dtype=dtype, device=device)

        def i(a):
            return torch.tensor(np.asarray(a, dtype=np.int32), device=device)

        planes = {}
        if face_normals is not None:
            ne = np.shape(face_offsets)[0]
            planes = row16_views(f(np.concatenate(
                [np.asarray(face_normals).reshape(ne, 12),
                 np.asarray(face_offsets)], axis=1)))
        return cls(
            coords=f(coords), tet2vert=i(tet2vert), face_adj=i(face_adj),
            volumes=f(volumes), walk_table=f(walk_table), **planes,
        )

    def with_lowp_tables(self) -> "TetMesh":
        """This mesh with the two-tier tables in place of the packed
        table, built from its current full-precision planes (the bf16
        rounding of the stored values IS the conversion; the adj lane
        goes through float64). Idempotent."""
        if self.two_tier:
            return self
        _check_two_tier_ids(self.nelems, self.dtype)
        fn, fo = self.face_normals, self.face_offsets
        return dataclasses.replace(
            self, walk_table=None, stored_face_normals=None,
            stored_face_offsets=None,
            walk_table_lo=pack_lo_table(fn, fo),
            walk_table_hi=pack_plane_table(fn, fo, self.face_adj,
                                           self.dtype),
        )

    def with_packed_table(self) -> "TetMesh":
        """This mesh with the packed table, rebuilt through float64 from
        the refinement tier's full-precision planes and ``face_adj``, in
        place of the two-tier tables: what the JAX walk reads from a
        two-tier mesh at the float32 tier. Idempotent."""
        if not self.two_tier:
            return self
        table = torch.cat([self.face_normals.reshape(-1, 12).double(),
                           self.face_offsets.double(),
                           self.face_adj.double()], dim=1)
        return dataclasses.replace(self, walk_table=table.to(self.dtype),
                                   walk_table_lo=None, walk_table_hi=None)

    def _has_row16(self) -> bool:
        return self.unpacked and plane_layout(
            self.face_normals, self.face_offsets) == PLANE_ROW16

    def row16(self) -> torch.Tensor:
        """The planes as [E,PLANE_ROW16] rows of normals|offsets (the
        packed row's first 16 lanes): a ROW16 mesh's own buffer (no
        copy), else assembled from the planes of its layout."""
        if self._has_row16():
            return self.face_normals.as_strided(
                (self.nelems, PLANE_ROW16), (PLANE_ROW16, 1))
        return torch.cat([self.face_normals.reshape(-1, 12),
                          self.face_offsets], dim=1)

    def with_unpacked_planes(self) -> "TetMesh":
        """This mesh in the unpacked layout with its planes in one ROW16
        buffer, copied from the packed table, the two-tier refinement
        tier or planes held in any other layout (the walk's ids then come
        from ``face_adj``). A ROW16 mesh is returned as it is."""
        if self._has_row16():
            return self
        return dataclasses.replace(
            self, walk_table=None, walk_table_lo=None, walk_table_hi=None,
            **row16_views(self.row16()))

    def with_plane_views(self) -> "TetMesh":
        """A two-tier mesh in the unpacked layout over its refinement
        tier: ``stored_face_normals`` / ``stored_face_offsets`` are
        strided views of ``walk_table_hi`` (no copy), the neighbours come
        from ``face_adj``. This is the float32 tier's walk of a two-tier
        mesh (the JAX walk reads the same planes through the same
        views). Any other mesh is returned as it is."""
        if not self.two_tier:
            return self
        return dataclasses.replace(
            self, walk_table_lo=None, walk_table_hi=None,
            stored_face_normals=self.face_normals,
            stored_face_offsets=self.face_offsets)

    def to(self, dtype: Optional[torch.dtype] = None,
           device: Any = None) -> "TetMesh":
        """This mesh in another working dtype and/or on another device.
        The packed table is rebuilt through float64 so adjacency ids
        survive; a two-tier mesh stays two-tier (the bf16 tier is
        unchanged, the refinement tier converts directly: its ids are
        exact within the checked limit); an unpacked mesh stays unpacked
        (its planes convert directly, its ids are integers), and so
        does a packed one with more tets than ``dtype``'s float lanes
        hold ids for. The unpacked planes land in one ROW16 buffer (a
        ROW16 buffer already in ``dtype`` on ``device`` is kept, no
        copy)."""
        dtype = self.dtype if dtype is None else dtype
        device = self.device if device is None else device
        common = dict(
            coords=self.coords.to(device=device, dtype=dtype),
            tet2vert=self.tet2vert.to(device),
            face_adj=self.face_adj.to(device),
            volumes=self.volumes.to(device=device, dtype=dtype),
        )
        if self.two_tier:
            if self.nelems >= exact_id_limit(dtype):
                raise ValueError(
                    f"cannot convert two-tier tables to {dtype}: "
                    f"{self.nelems} elements exceed the exact-id limit "
                    f"{exact_id_limit(dtype)}"
                )
            return TetMesh(
                **common, walk_table=None,
                walk_table_lo=self.walk_table_lo.to(device),
                walk_table_hi=self.walk_table_hi.to(device=device,
                                                    dtype=dtype),
            )
        if self.unpacked or self.nelems >= exact_id_limit(dtype):
            return TetMesh(**common, walk_table=None, **row16_views(
                self.row16().to(device=device, dtype=dtype)))
        table = self.walk_table.to(torch.float64, copy=True)
        table[:, WALK_TABLE_ADJ] = self.face_adj.double()
        return TetMesh(**common,
                       walk_table=table.to(device=device, dtype=dtype))

    def centroids(self) -> torch.Tensor:
        """Element centroids [E,3] (the reference seeds particles at
        element 0's, PumiTallyImpl.cpp:500-509)."""
        return self.coords[self.tet2vert.long()].mean(dim=1)
