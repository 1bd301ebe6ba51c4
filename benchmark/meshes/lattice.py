"""Mesh kind ``lattice``: a frozen copy, numpy only, of the pincell
lattice builder the program ships (``mesh/pincell.py``).

An O-grid pincell (rings of triangles inside the fuel radius, transition
rings out to the square pitch), tiled nx x ny with coincident vertices
welded, extruded in z, every prism split into 3 tets by the
smallest-global-vertex rule, so the mesh is conforming. It is frozen
here so that a later change to the program's generator cannot change
the benchmark's input.

A configuration's ``mesh`` is ``{"kind": "lattice", <lattice_arrays'
arguments>}``.
"""

from __future__ import annotations

import numpy as np


def _square_point(theta: np.ndarray, half: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    m = np.maximum(np.abs(c), np.abs(s))
    return half * np.stack([c / m, s / m], axis=-1)


def _ogrid_2d(pitch, fuel_radius, n_theta, n_rings_fuel, n_rings_pad):
    """One cell's 2-D O-grid: (pts2 [V2,2] pin-centred, tris [T,3])."""
    if n_theta % 8:
        raise ValueError("n_theta must be a multiple of 8")
    if 2 * fuel_radius >= pitch:
        raise ValueError("fuel diameter must be smaller than the pitch")
    if n_rings_fuel < 1 or n_rings_pad < 1:
        raise ValueError("n_rings_fuel and n_rings_pad must be >= 1")
    half = pitch / 2.0
    theta = np.arange(n_theta) * (2 * np.pi / n_theta)
    pts2 = [np.zeros((1, 2))]
    for r in np.linspace(0.0, fuel_radius, n_rings_fuel + 1)[1:]:
        pts2.append(np.stack([r * np.cos(theta), r * np.sin(theta)], axis=-1))
    sq = _square_point(theta, half)
    circ = fuel_radius * np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    for s in np.linspace(0.0, 1.0, n_rings_pad + 1)[1:]:
        pts2.append((1.0 - s) * circ + s * sq)
    pts2 = np.concatenate(pts2, axis=0)
    nrings = n_rings_fuel + n_rings_pad

    def ring_vert(j: int, k: int) -> int:
        return 1 + (j - 1) * n_theta + (k % n_theta)

    tris = [[0, ring_vert(1, k), ring_vert(1, k + 1)] for k in range(n_theta)]
    for j in range(1, nrings):
        for k in range(n_theta):
            a, b = ring_vert(j, k), ring_vert(j, k + 1)
            c, d = ring_vert(j + 1, k), ring_vert(j + 1, k + 1)
            tris.append([a, b, d])
            tris.append([a, d, c])
    return pts2, np.asarray(tris, np.int64)


def _extrude_prisms(pts2, tris, height, nz):
    """Extrude a triangulation nz layers into tets (3 a prism, the
    smallest-global-vertex diagonal rule): (coords, tets)."""
    if nz < 1:
        raise ValueError("nz must be >= 1")
    nv2 = pts2.shape[0]
    zs = np.linspace(0.0, height, nz + 1)
    coords = np.concatenate(
        [np.concatenate([pts2, np.full((nv2, 1), z)], axis=1) for z in zs],
        axis=0,
    )
    layers = np.arange(nz, dtype=np.int64)[:, None, None] * nv2
    bot = (tris[None, :, :] + layers).reshape(-1, 3)
    v = np.concatenate([bot, bot + nv2], axis=1)
    rot = np.argmin(np.minimum(v[:, 0:3], v[:, 3:6]), axis=1)
    o = (rot[:, None] + np.arange(3)[None, :]) % 3
    v = np.take_along_axis(v, np.concatenate([o, o + 3], axis=1), axis=1)
    left = np.minimum(v[:, 1], v[:, 5]) < np.minimum(v[:, 2], v[:, 4])
    split_a = v[:, [0, 1, 2, 5, 0, 1, 5, 4, 0, 4, 5, 3]]
    split_b = v[:, [0, 1, 2, 4, 0, 4, 2, 5, 0, 4, 5, 3]]
    tets = np.where(left[:, None], split_a, split_b).reshape(-1, 4)
    return np.asarray(coords, np.float64), tets.astype(np.int32)


def lattice_arrays(nx, ny, pitch=1.26, fuel_radius=0.4095, height=1.0,
                   n_theta=16, n_rings_fuel=3, n_rings_pad=3, nz=4):
    """(coords [V,3] float64, tets [E,4] int32) of an nx x ny pincell
    lattice in [0, nx*pitch] x [0, ny*pitch] x [0, height]."""
    if nx < 1 or ny < 1:
        raise ValueError("nx and ny must be >= 1")
    pts2, tris = _ogrid_2d(pitch, fuel_radius, n_theta, n_rings_fuel,
                           n_rings_pad)
    half = pitch / 2.0
    nv2 = pts2.shape[0]
    all_pts, all_tris = [], []
    for j in range(ny):
        for i in range(nx):
            all_pts.append(pts2 + np.array([i * pitch + half,
                                            j * pitch + half]))
            all_tris.append(tris + (j * nx + i) * nv2)
    pts = np.concatenate(all_pts, axis=0)
    tris_all = np.concatenate(all_tris, axis=0)
    # Weld the cells' coincident boundary vertices (first occurrence
    # wins), keeping the numbering cell-major.
    quant = np.round(pts / (pitch * 1e-9)).astype(np.int64)
    _, first, inverse = np.unique(quant, axis=0, return_index=True,
                                  return_inverse=True)
    welded = pts[np.sort(first)]
    order = np.argsort(first)
    rank_of_unique = np.empty_like(order)
    rank_of_unique[order] = np.arange(order.shape[0])
    tris_w = rank_of_unique[inverse.reshape(-1)][tris_all]
    return _extrude_prisms(welded, tris_w, height, nz)


def extent(spec: dict) -> np.ndarray:
    """The lattice's extent (its lower corner is the origin)."""
    pitch, height = spec.get("pitch", 1.26), spec.get("height", 1.0)
    return np.array([spec["nx"] * pitch, spec["ny"] * pitch, height],
                    np.float64)


def arrays(spec: dict):
    """(coords [V,3] float64, tets [E,4] int32) of the spec's lattice."""
    return lattice_arrays(**{k: v for k, v in spec.items() if k != "kind"})
