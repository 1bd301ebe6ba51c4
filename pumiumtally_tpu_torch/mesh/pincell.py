"""Pincell mesh builder: a fuel cylinder inside a square pitch, extruded.

The reference's headline workload is an OpenMC pincell tallied on an
unstructured tet mesh (~10k tets, BASELINE.json configs[0-1]; the
reference obtains such meshes from Gmsh via msh2osh, README.md:115-125).
This builder produces that geometry natively: an O-grid — structured
radial rings inside the fuel cylinder, transition rings morphing from
the circle to the square cell boundary — extruded in z, every prism
split into 3 tets with the smallest-global-vertex diagonal rule
(Dompierre et al., "How to Subdivide Pyramids, Prisms and Hexahedra
into Tetrahedra"), which makes diagonals on shared quad faces agree
between neighboring prisms: the mesh is conforming by construction.

Returns raw (coords, tet2vert, region) arrays plus a convenience
``build_pincell`` that runs them through ``TetMesh.from_arrays`` (which
re-orients and validates every tet). ``region`` is 0 inside the fuel
radius and 1 outside (moderator) — the two-material split an OpenMC
pincell tally cares about.

A copy of ``pumiumtally_tpu/mesh/pincell.py`` (numpy only), building the
port's ``TetMesh``: the arrays are the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh


def _square_point(theta: np.ndarray, half: float) -> np.ndarray:
    """Point on the axis-aligned square of half-width ``half`` along
    direction ``theta`` (the square's radial parametrization)."""
    c, s = np.cos(theta), np.sin(theta)
    m = np.maximum(np.abs(c), np.abs(s))
    return half * np.stack([c / m, s / m], axis=-1)


def _ogrid_2d(
    pitch: float,
    fuel_radius: float,
    n_theta: int,
    n_rings_fuel: int,
    n_rings_pad: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One cell's 2-D O-grid: (pts2[V2,2] pin-centered, tris[T,3],
    tri_region[T] 0 fuel / 1 moderator)."""
    if n_theta % 8:
        # The square's corners sit at 45°+k·90°; sector boundaries land
        # on them only when n_theta is a multiple of 8 — otherwise the
        # outer ring polygon cuts the corners off and the mesh no
        # longer fills the cell.
        raise ValueError("n_theta must be a multiple of 8")
    if 2 * fuel_radius >= pitch:
        raise ValueError("fuel diameter must be smaller than the pitch")
    if n_rings_fuel < 1 or n_rings_pad < 1:
        # Zero fuel rings mislabels the center fan, zero pad rings
        # drops the moderator (mesh no longer fills the cell).
        raise ValueError("n_rings_fuel and n_rings_pad must be >= 1")
    half = pitch / 2.0
    theta = np.arange(n_theta) * (2 * np.pi / n_theta)

    # 2-D O-grid vertices: center, then rings.
    pts2 = [np.zeros((1, 2))]
    ring_r = np.linspace(0.0, fuel_radius, n_rings_fuel + 1)[1:]
    for r in ring_r:
        pts2.append(np.stack([r * np.cos(theta), r * np.sin(theta)], axis=-1))
    sq = _square_point(theta, half)
    circ = fuel_radius * np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    for s in np.linspace(0.0, 1.0, n_rings_pad + 1)[1:]:
        pts2.append((1.0 - s) * circ + s * sq)
    pts2 = np.concatenate(pts2, axis=0)
    nrings = n_rings_fuel + n_rings_pad

    def ring_vert(j: int, k: int) -> int:
        """2-D vertex index of ring j (1-based), sector k."""
        return 1 + (j - 1) * n_theta + (k % n_theta)

    # 2-D triangulation + per-triangle region (0 fuel / 1 moderator).
    tris = []
    tri_region = []
    for k in range(n_theta):  # center fan
        tris.append([0, ring_vert(1, k), ring_vert(1, k + 1)])
        tri_region.append(0)
    for j in range(1, nrings):
        reg = 0 if j < n_rings_fuel else 1
        for k in range(n_theta):
            a, b = ring_vert(j, k), ring_vert(j, k + 1)
            c, d = ring_vert(j + 1, k), ring_vert(j + 1, k + 1)
            tris.append([a, b, d])
            tris.append([a, d, c])
            tri_region.extend([reg, reg])
    return (
        pts2,
        np.asarray(tris, np.int64),
        np.asarray(tri_region, np.int64),
    )


def _extrude_prisms(
    pts2: np.ndarray,
    tris: np.ndarray,
    tri_labels: np.ndarray,  # [T, L] any per-triangle labels to replicate
    height: float,
    nz: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extrude a 2-D triangulation into tets: every prism splits into 3
    by the smallest-GLOBAL-vertex diagonal rule (Dompierre et al.), so
    diagonals on shared quad faces agree between neighboring prisms —
    including prisms from different lattice cells — and the mesh is
    conforming by construction. Returns (coords, tet2vert, labels[E,L]).
    """
    if nz < 1:
        raise ValueError("nz must be >= 1")
    nv2 = pts2.shape[0]
    zs = np.linspace(0.0, height, nz + 1)
    coords = np.concatenate(
        [np.concatenate([pts2, np.full((nv2, 1), z)], axis=1) for z in zs],
        axis=0,
    )
    # All nz·T prisms at once (the per-prism Python loop was the
    # generation bottleneck at assembly scale — ~1M tets).
    tris = np.asarray(tris, np.int64)
    layers = np.arange(nz, dtype=np.int64)[:, None, None] * nv2
    bot = (tris[None, :, :] + layers).reshape(-1, 3)  # [P,3]
    v = np.concatenate([bot, bot + nv2], axis=1)  # [P,6]
    # Rotate so the globally smallest bottom/top pair is first.
    rot = np.argmin(np.minimum(v[:, 0:3], v[:, 3:6]), axis=1)  # [P]
    o = (rot[:, None] + np.arange(3)[None, :]) % 3  # [P,3]
    v = np.take_along_axis(v, np.concatenate([o, o + 3], axis=1), axis=1)
    # Diagonal choice on the far quad face (Dompierre rule).
    left = np.minimum(v[:, 1], v[:, 5]) < np.minimum(v[:, 2], v[:, 4])
    split_a = v[:, [0, 1, 2, 5,   0, 1, 5, 4,   0, 4, 5, 3]]
    split_b = v[:, [0, 1, 2, 4,   0, 4, 2, 5,   0, 4, 5, 3]]
    tets = np.where(left[:, None], split_a, split_b).reshape(-1, 4)
    labels = np.repeat(
        np.tile(np.asarray(tri_labels), (nz, 1)), 3, axis=0
    )
    return (
        np.asarray(coords, np.float64),
        tets.astype(np.int32),
        labels.astype(np.int32),
    )


def pincell_arrays(
    pitch: float = 1.26,
    fuel_radius: float = 0.4095,
    height: float = 1.0,
    n_theta: int = 16,
    n_rings_fuel: int = 3,
    n_rings_pad: int = 3,
    nz: int = 4,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(coords[V,3], tet2vert[E,4], region[E]) for a single pincell.

    n_theta sectors around the pin (multiple of 8 keeps the square's
    corners on sector boundaries), n_rings_fuel rings inside the fuel,
    n_rings_pad transition rings from the fuel surface to the square
    boundary, nz extruded layers. Tet count: 3*nz*n_theta*(2*(n_rings_
    fuel+n_rings_pad) - 1).
    """
    pts2, tris, tri_region = _ogrid_2d(
        pitch, fuel_radius, n_theta, n_rings_fuel, n_rings_pad
    )
    # The cell sits in [0,pitch]^2 x [0,height] (corner origin — shared
    # by every consumer; the O-grid itself is built pin-centered).
    coords, tets, labels = _extrude_prisms(
        pts2 + pitch / 2.0, tris, tri_region[:, None], height, nz
    )
    return coords, tets, labels[:, 0]


def lattice_arrays(
    nx: int,
    ny: int,
    pitch: float = 1.26,
    fuel_radius: float = 0.4095,
    height: float = 1.0,
    n_theta: int = 16,
    n_rings_fuel: int = 3,
    n_rings_pad: int = 3,
    nz: int = 4,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(coords[V,3], tet2vert[E,4], region[E], cell_id[E]) for an
    nx×ny pincell lattice (a fuel-assembly slab) in
    [0, nx·pitch]×[0, ny·pitch]×[0, height].

    The reference's larger benchmark configs tally assemblies of
    pincells on ~1M-tet unstructured meshes (BASELINE.json configs[1-2]
    scale); this builds that geometry natively. Every cell reuses one
    2-D O-grid pattern; coincident boundary vertices of neighboring
    cells are WELDED in 2-D (their coordinates agree to float rounding;
    the weld snaps them identical), and the single global extrusion
    applies the smallest-global-vertex prism rule, so shared faces —
    including cell-to-cell interfaces — triangulate identically from
    both sides: the assembly is conforming by construction.
    ``region`` is 0 fuel / 1 moderator; ``cell_id`` is j·nx+i.
    """
    if nx < 1 or ny < 1:
        raise ValueError("nx and ny must be >= 1")
    pts2, tris, tri_region = _ogrid_2d(
        pitch, fuel_radius, n_theta, n_rings_fuel, n_rings_pad
    )
    half = pitch / 2.0
    nv2 = pts2.shape[0]
    all_pts = []
    all_tris = []
    all_lab = []
    for j in range(ny):
        for i in range(nx):
            all_pts.append(pts2 + np.array([i * pitch + half,
                                            j * pitch + half]))
            off = (j * nx + i) * nv2
            all_tris.append(tris + off)
            all_lab.append(
                np.stack(
                    [tri_region,
                     np.full_like(tri_region, j * nx + i)],
                    axis=1,
                )
            )
    pts = np.concatenate(all_pts, axis=0)
    tris_all = np.concatenate(all_tris, axis=0)
    labels = np.concatenate(all_lab, axis=0)

    # Weld coincident 2-D vertices (cell-boundary points shared by
    # neighbors agree to ~1e-16·pitch; interior spacings are orders of
    # magnitude larger, so a coarse quantization cannot merge distinct
    # points). First occurrence's coordinates win → exactly identical
    # shared vertices.
    quant = np.round(pts / (pitch * 1e-9)).astype(np.int64)
    _, first, inverse = np.unique(
        quant, axis=0, return_index=True, return_inverse=True
    )
    welded = pts[np.sort(first)]
    # unique() orders by key; remap to first-occurrence order so vertex
    # numbering stays cell-major (keeps the extrusion rule stable).
    order = np.argsort(first)
    rank_of_unique = np.empty_like(order)
    rank_of_unique[order] = np.arange(order.shape[0])
    vmap = rank_of_unique[inverse]
    tris_w = vmap[tris_all]

    coords, tets, labels3 = _extrude_prisms(
        welded, tris_w, labels, height, nz
    )
    return coords, tets, labels3[:, 0], labels3[:, 1]


def build_lattice(
    nx: int,
    ny: int,
    pitch: float = 1.26,
    fuel_radius: float = 0.4095,
    height: float = 1.0,
    n_theta: int = 16,
    n_rings_fuel: int = 3,
    n_rings_pad: int = 3,
    nz: int = 4,
    dtype=None,
) -> Tuple[TetMesh, np.ndarray, np.ndarray]:
    """(TetMesh, region[E], cell_id[E]) — validated nx×ny assembly."""
    coords, tets, region, cell_id = lattice_arrays(
        nx, ny, pitch, fuel_radius, height, n_theta, n_rings_fuel,
        n_rings_pad, nz,
    )
    return TetMesh.from_arrays(coords, tets, dtype=dtype), region, cell_id


# The flagship benchmark geometry (BASELINE configs[0]: OpenMC pincell
# class, ~22k anisotropic tets): ONE definition consumed by bench.py
# and the experiment scripts, so every A/B measures the same mesh.
FLAGSHIP_PINCELL = dict(
    pitch=1.26, height=1.0, n_theta=32, n_rings_fuel=5, n_rings_pad=5,
    nz=12,
)


def build_pincell(
    pitch: float = 1.26,
    fuel_radius: float = 0.4095,
    height: float = 1.0,
    n_theta: int = 16,
    n_rings_fuel: int = 3,
    n_rings_pad: int = 3,
    nz: int = 4,
    dtype=None,
) -> Tuple[TetMesh, np.ndarray]:
    """(TetMesh, region[E]) — validated, walk-ready pincell mesh.

    NOTE: ``TetMesh.from_arrays`` preserves element order, so the
    region array indexes the mesh's elements directly.
    """
    coords, tets, region = pincell_arrays(
        pitch, fuel_radius, height, n_theta, n_rings_fuel, n_rings_pad, nz
    )
    return TetMesh.from_arrays(coords, tets, dtype=dtype), region
