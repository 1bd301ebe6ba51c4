"""The plain reference: a straight-line walk through a tet mesh in
float64, in plain PyTorch, written from the mesh's coordinates and tets
alone.

It builds its own tables (unit outward face planes and face adjacency)
and walks each particle element to element along its segment: in an
element it takes the nearest face the segment leaves through (the face
planes the segment points out of, ``n . d > 0``), credits the element
with the segment's length inside it times the weight, and steps to the
neighbour across that face, until the segment's end lies inside the
element or the segment leaves the mesh (clamped at the boundary).

It imports nothing of the program and takes nothing the program made.
The particles walk in lock step, and each iteration carries only the
ones still walking.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

F64 = torch.float64
# Face f of a tet is the one opposite its vertex f.
FACES = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))
# A walk that takes more iterations than this has looped: the reference
# refuses it rather than answer.
MAX_ITERS = 1 << 16


class RefMesh:
    """Face planes and adjacency built from ``coords`` [V,3] and
    ``tets`` [E,4] on ``device``, in float64."""

    def __init__(self, coords, tets, device):
        c = torch.as_tensor(coords, dtype=F64, device=device)
        t = torch.as_tensor(tets, device=device).long()
        self.device = torch.device(device)
        self.nelems = t.shape[0]
        face_idx = torch.tensor(FACES, device=device)
        v = c[t]  # [E,4,3]
        fv = v[:, face_idx]  # [E,4,3 verts,3]
        nrm = torch.linalg.cross(fv[:, :, 1] - fv[:, :, 0],
                                 fv[:, :, 2] - fv[:, :, 0])
        # Outward: the opposite vertex lies on the inner side.
        inner = ((v - fv[:, :, 0]) * nrm).sum(-1)
        nrm = torch.where((inner > 0)[..., None], -nrm, nrm)
        nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True)
        self.normals = nrm.contiguous()  # [E,4,3]
        self.offsets = (nrm * fv[:, :, 0]).sum(-1).contiguous()  # [E,4]
        self.adj = self._adjacency(t, face_idx, c.shape[0])
        self.centroid0 = v[0].mean(dim=0)

    @staticmethod
    def _adjacency(t, face_idx, nverts: int) -> torch.Tensor:
        """[E,4] neighbour across each face, -1 on the boundary: faces
        matched by their sorted vertex triples."""
        tri = torch.sort(t[:, face_idx], dim=-1).values.reshape(-1, 3)
        if nverts ** 3 >= 2 ** 62:
            raise ValueError("too many vertices for the face keys")
        key = (tri[:, 0] * nverts + tri[:, 1]) * nverts + tri[:, 2]
        order = torch.argsort(key)
        k = key[order]
        same = k[1:] == k[:-1]
        if bool((same[1:] & same[:-1]).any()):
            raise ValueError("a face is shared by more than two tets")
        adj = torch.full((key.shape[0],), -1, dtype=torch.long,
                         device=t.device)
        a, b = order[:-1][same], order[1:][same]
        adj[a] = b // 4
        adj[b] = a // 4
        return adj.reshape(-1, 4)

    def outside_by(self, elem, p) -> torch.Tensor:
        """How far each point ``p`` [N,3] lies outside its element
        ``elem`` [N] (0 or less: inside)."""
        e = elem.long()
        return ((self.normals[e] * p[:, None, :]).sum(-1)
                - self.offsets[e]).amax(dim=1)


@dataclass
class Score:
    """A tallied walk's scoring lanes: ``bank`` [E*stride] float64,
    each particle's ``bin_off`` [N] (``drop`` or past: scores nowhere)
    and factor ``fac`` [N,S], and each score's kind ("track" or
    "count")."""

    bank: torch.Tensor
    stride: int
    bin_off: torch.Tensor
    fac: torch.Tensor
    kinds: tuple


@dataclass
class Touched:
    """What one walk touched, for the roofline's byte count: the steps
    walked (one a particle and element), the distinct elements walked
    through, flux entries and scoring lanes written."""

    steps: int = 0
    elems: int = 0
    flux: int = 0
    lanes: int = 0


def walk(mesh: RefMesh, x, elem, dest, *, weight=None, flux=None,
         score: Optional[Score] = None):
    """Walk every particle from ``x`` [N,3] in ``elem`` [N] to ``dest``
    [N,3]. With ``weight`` [N] and ``flux`` [E], each element is
    credited, in place, the length of the segment inside it times the
    weight; with ``score``, its lanes too. Returns (x, elem, touched)."""
    n = x.shape[0]
    dev = mesh.device
    d0 = dest - x
    length = torch.linalg.norm(d0, dim=1)
    s = torch.zeros(n, dtype=F64, device=dev)
    e = elem.long().clone()
    seen = torch.zeros(mesh.nelems, dtype=torch.bool, device=dev)
    lanes = (torch.zeros(score.bank.shape[0], dtype=torch.bool, device=dev)
             if score is not None else None)
    touched = Touched()
    idx = torch.arange(n, device=dev)
    iters = 0
    while idx.numel():
        iters += 1
        if iters > MAX_ITERS:
            raise RuntimeError(f"reference walk: {idx.numel()} particles "
                               f"still walking after {MAX_ITERS} steps")
        ee = e[idx]
        nrm = mesh.normals[ee]
        dd = d0[idx]
        ss = s[idx]
        a = (nrm * dd[:, None, :]).sum(-1)
        gap = mesh.offsets[ee] - (nrm * x[idx][:, None, :]).sum(-1)
        out = a > 0
        s_face = torch.where(out, gap / torch.where(out, a, 1.0),
                             torch.inf)
        s_face = torch.maximum(s_face, ss[:, None])
        s_exit, face = s_face.min(dim=1)
        reached = s_exit >= 1.0
        s_new = torch.where(reached, 1.0, s_exit)
        nxt = mesh.adj[ee, face]
        if flux is not None:
            contrib = (s_new - ss) * length[idx] * weight[idx]
            flux.index_add_(0, ee, contrib)
            if score is not None:
                _score(score, lanes, idx, ee, contrib,
                       (~reached).to(F64))
        seen[ee] = True
        touched.steps += idx.numel()
        stop = reached | (nxt < 0)
        s[idx] = s_new
        e[idx] = torch.where(stop, ee, nxt)
        idx = idx[~stop]
    touched.elems = int(seen.sum())
    if flux is not None:
        touched.flux = touched.elems
    if lanes is not None:
        touched.lanes = int(lanes.sum())
    exited = s < 1.0
    x_fin = torch.where(exited[:, None], x + s[:, None] * d0, dest)
    return x_fin, e, touched


def _score(score: Score, lanes, idx, ee, contrib, crossed) -> None:
    """One step's lanes: ``elem*stride + bin_off + k`` gets the step's
    track contribution ("track") or its face crossing ("count") times
    the particle's factor for score k; dropped bins score nowhere."""
    off = score.bin_off[idx]
    keep = off < score.bank.shape[0]
    base = ee[keep] * score.stride + off[keep]
    for k, kind in enumerate(score.kinds):
        val = contrib[keep] if kind == "track" else crossed[keep]
        lane = base + k
        score.bank.index_add_(0, lane, val * score.fac[idx][keep][:, k])
        lanes[lane] = True
