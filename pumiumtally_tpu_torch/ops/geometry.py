"""Geometry helpers (port of ``pumiumtally_tpu/ops/geometry.py``):
simplex volumes and half-space point location.

Point location is a matrix product plus a compare-and-reduce, so plain
PyTorch is right here. TF32 keeps about three decimal digits and would
misplace points that sit near a face, so this module turns it off for
CUDA matrix products and the point tests run in full precision.
"""

from __future__ import annotations

from typing import Optional

import torch

# Full-precision float32 matrix products on CUDA (TF32 would misplace
# points within ~1e-3 relative of a face).
torch.backends.cuda.matmul.allow_tf32 = False


def tet_volumes(coords: torch.Tensor, tet2vert: torch.Tensor) -> torch.Tensor:
    """Signed tet volumes [E] from coords [V,3] and connectivity [E,4]."""
    v = coords[tet2vert.long()]
    a = v[:, 1] - v[:, 0]
    b = v[:, 2] - v[:, 0]
    c = v[:, 3] - v[:, 0]
    return (torch.linalg.cross(a, b) * c).sum(dim=1) / 6.0


def locate_chunk_by_planes(
    nmat: torch.Tensor,  # [4E,3] face normals, row-major per element
    fo: torch.Tensor,  # [E,4] face offsets
    valid: Optional[torch.Tensor],  # [E] bool mask (None = all valid)
    pts: torch.Tensor,  # [C,3]
    tol: float,
) -> torch.Tensor:
    """Containing element id [C] (-1 = none) by half-space tests: a point
    is inside a tet iff it is on the inner side of all four face planes.
    Ties (points within tol of a shared face) go to the lowest element
    id, deterministically."""
    proj = pts @ nmat.T  # [C, 4E]
    ok = (proj.reshape(pts.shape[0], -1, 4) <= fo[None] + tol).all(dim=2)
    if valid is not None:
        ok = ok & valid[None, :]
    found = ok.any(dim=1)
    le = ok.to(torch.uint8).argmax(dim=1).to(torch.int32)
    return torch.where(found, le, torch.full_like(le, -1))


def locate_by_planes(
    face_normals: torch.Tensor,  # [E,4,3]
    face_offsets: torch.Tensor,  # [E,4]
    pts: torch.Tensor,  # [N,3]
    tol: float,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Containing element id [N] (-1 = none) for arbitrary points,
    chunked so the [C,4E] intermediate stays <= ~8M entries."""
    n = pts.shape[0]
    ne = face_offsets.shape[0]
    nmat = face_normals.reshape(ne * 4, 3)
    c = chunk or max(1, min(2048, (1 << 23) // max(ne, 1)))
    return torch.cat([
        locate_chunk_by_planes(nmat, face_offsets, None, pts[i:i + c], tol)
        for i in range(0, n, c)
    ]) if n else torch.empty((0,), dtype=torch.int32, device=pts.device)
