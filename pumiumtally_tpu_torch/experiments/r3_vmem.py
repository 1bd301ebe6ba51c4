"""The whole-mesh walk with the mesh resident on chip (the port of
tools/exp_r3_vmem.py), as kernel W3 (csrc/resident_walk.cu) with its
plain PyTorch version beside it.

The tool's Pallas kernel ``walk_vmem_pallas`` pins a small mesh's table
in VMEM and runs the whole walk loop of a particle tile in one kernel,
fetching rows and scattering the tally with one-hot MXU matmuls. W3
keeps the mesh in shared memory instead, as an image this module builds
(``resident_image``): the 16 plane floats of each tet, quad-major, and,
up to ``w3_shared_adj_max_elems()`` elements (3,140), the four
neighbour ids packed as 12-bit codes (``pack_ids``), so that a crossing
reads no mesh data from global memory. Above that, up to
``w3_max_elems()`` (3,418), the image holds the planes only and the
kernel reads the winning face's neighbour from the int32 adjacency in
global memory (``w3_shared_adj`` picks the regime from L). The image is
built once per mesh and regime (``cached_image``), and its layout is
worked out here only: the wrapper passes the kernel its byte count. The tool's
other arm, ``walk_onehot_jnp``, is XLA code (the MXU formulation, no
Pallas kernel) and is not ported.

Contract (the tool's): every particle walks from ``x`` in ``elem`` to
``dest`` (done starts false), only flying ones tally
(``eff_w = w * |d0|`` when flying, else 0), ``max_iters`` caps each
particle's crossings, and the result is ``x = dest`` for a particle that
reached its destination, else ``dest + (s - 1) * d0``, with
``exited = done & (s < 1)``. Flux is added IN PLACE into ``flux``.

Usage:
  python -m pumiumtally_tpu_torch.experiments.r3_vmem check [--device cpu]
  python -m pumiumtally_tpu_torch.experiments.r3_vmem bench [N]

``check`` holds W3 against W0 (``ops.walk.walk``) at L = 162 and 750;
``bench`` sweeps the tool's meshes (L = 750, 1,296, 2,058, 3,072) with
W3 and W0. Both run on the card unless given ``--device cpu``, where the
plain versions run.
"""

from __future__ import annotations

import argparse
import sys
import weakref
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pumiumtally_tpu_torch import kernels
from pumiumtally_tpu_torch.api.tally import _localize_step
from pumiumtally_tpu_torch.experiments import time_ms
from pumiumtally_tpu_torch.mesh.box import build_box
from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh
from pumiumtally_tpu_torch.ops.walk import eff_weight, select_rows_lo, walk

TOL = 1e-6
MAX_ITERS = 4096
BENCH_DIVS = (5, 6, 7, 8)  # L = 750, 1296, 2058, 3072 (the tool's sweep)
PLANE_WIDTH = 16  # 4 normals + 4 offsets per tet, the resident row
# Dynamic shared memory a block may use on an H100, and W3's layout
# (csrc/resident_walk.cu): a 16 B header, the image (64 B of planes an
# element, then 6 B of packed ids in the shared-adjacency regime, padded
# to 16 B), and a 4 B flux partial an element.
SMEM_BYTES = 232_448
SMEM_HEADER = 16
PLANE_BYTES = PLANE_WIDTH * 4
ID_BYTES = 6
PARTIAL_BYTES = 4
# A neighbour id in the image: 12 bits, the all-ones code for the
# boundary (-1).
ID_BITS = 12
ID_BOUNDARY = (1 << ID_BITS) - 1
# The kernel's optional counts, in order (CUDA only).
W3_COUNTS = ("walked", "warp steps")


class ResidentWalkResult(NamedTuple):
    x: torch.Tensor  # [N,3] committed position
    elem: torch.Tensor  # [N] int32 final element
    done: torch.Tensor  # [N] bool (False = max_iters ran out)
    exited: torch.Tensor  # [N] bool: finished by leaving the domain
    flux: torch.Tensor  # [L], the input tensor, updated in place
    s: torch.Tensor  # [N] final ray coordinate along x -> dest


def _round16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def w3_image_bytes(L: int, shared_adj: bool) -> int:
    """Bytes of W3's mesh image: the planes, then the packed ids."""
    return PLANE_BYTES * L + (_round16(ID_BYTES * L) if shared_adj else 0)


def w3_smem_bytes(L: int, shared_adj: bool) -> int:
    """Dynamic shared memory W3 asks for at L elements in a regime."""
    return SMEM_HEADER + w3_image_bytes(L, shared_adj) + PARTIAL_BYTES * L


def w3_max_elems() -> int:
    """The largest mesh W3 holds in shared memory (planes and partial,
    neighbours read from global memory): 3,418 elements."""
    return (SMEM_BYTES - SMEM_HEADER) // (PLANE_BYTES + PARTIAL_BYTES)


def w3_shared_adj_max_elems() -> int:
    """The largest mesh whose neighbour ids W3 also holds in shared
    memory: 3,140 elements."""
    L = (SMEM_BYTES - SMEM_HEADER) // (PLANE_BYTES + ID_BYTES
                                       + PARTIAL_BYTES)
    while w3_smem_bytes(L, True) > SMEM_BYTES:
        L -= 1
    return L


def w3_shared_adj(L: int) -> bool:
    """W3's regime at L elements: True when the neighbour ids are staged
    in shared memory, False when they are read from global memory."""
    return L <= w3_shared_adj_max_elems()


def resident_tables(mesh: TetMesh):
    """W3's tables: the [L,16] plane rows (normals | offsets, the packed
    row's first 16 columns) and the [L,4] int32 neighbour ids."""
    planes = torch.cat([mesh.face_normals.reshape(-1, 12),
                        mesh.face_offsets], dim=1).contiguous()
    return planes, mesh.face_adj.contiguous()


def _wrap(v: torch.Tensor, bits: int, dtype: torch.dtype) -> torch.Tensor:
    """Unsigned ``bits``-wide values as the signed ``dtype`` of that width
    (the same bits)."""
    return torch.where(v >= 1 << (bits - 1), v - (1 << bits), v).to(dtype)


def pack_ids(adj: torch.Tensor):
    """The [L,4] neighbour ids as W3's 6-byte codes: an int32 word
    ``id0 | id1 << 12 | (id2 & 0xFF) << 24`` and an int16 word
    ``id2 >> 8 | id3 << 4`` per element, each id 12 bits with
    ``ID_BOUNDARY`` for the boundary (-1)."""
    if bool(((adj < -1) | (adj >= ID_BOUNDARY)).any()):
        raise ValueError(f"pack_ids: neighbour ids must lie in [-1, "
                         f"{ID_BOUNDARY - 1}]")
    ids = torch.where(adj < 0, ID_BOUNDARY, adj).long()
    a = ids[:, 0] | ids[:, 1] << 12 | (ids[:, 2] & 0xFF) << 24
    b = ids[:, 2] >> 8 | ids[:, 3] << 4
    return _wrap(a, 32, torch.int32), _wrap(b, 16, torch.int16)


def resident_image(mesh: TetMesh, shared_adj: bool) -> torch.Tensor:
    """W3's mesh image as int32 words, the bytes the kernel stages: the
    plane rows quad-major ([4][L] float4: quad q of element e holds its
    row's floats 4q..4q+3), then, when ``shared_adj``, the [L] int32 and
    [L] int16 words of ``pack_ids``, padded to 16 bytes."""
    planes, adj = resident_tables(mesh)
    L = planes.shape[0]
    quads = planes.reshape(L, 4, 4).transpose(0, 1).contiguous()
    words = [quads.reshape(-1).view(torch.int32)]
    if shared_adj:
        a, b = pack_ids(adj)
        pad = (w3_image_bytes(L, True) - PLANE_BYTES * L - 4 * L) // 2 - L
        words += [a, torch.cat([b, b.new_zeros(pad)]).view(torch.int32)]
    return torch.cat(words)


# Built images, by mesh and regime: id(mesh) -> (a weak reference to the
# mesh, {shared_adj: image}). An entry goes when its mesh is collected.
_IMAGES: Dict[int, Tuple[weakref.ref, Dict[bool, torch.Tensor]]] = {}


def cached_image(mesh: TetMesh, shared_adj: bool) -> torch.Tensor:
    """``resident_image(mesh, shared_adj)``, built (and its ids' range
    checked) once per mesh and regime and kept while the mesh lives; a
    TetMesh is immutable, so the image stays its mesh's."""
    key = id(mesh)
    hit = _IMAGES.get(key)
    if hit is None or hit[0]() is not mesh:
        hit = _IMAGES[key] = (
            weakref.ref(mesh, lambda _, key=key: _IMAGES.pop(key, None)), {})
    images = hit[1]
    if shared_adj not in images:
        images[shared_adj] = resident_image(mesh, shared_adj)
    return images[shared_adj]


def walk_vmem_plain(mesh: TetMesh, x, elem, dest, in_flight, weight, flux,
                    *, tol: float, max_iters: int) -> ResidentWalkResult:
    """W3's plain PyTorch version: a masked lock-step loop over W3's
    tables, one crossing of every unfinished particle per iteration, in
    the kernel's operation order (csrc/walk_step.cuh ``walk_exit``)."""
    planes, adj = resident_tables(mesh)
    n = x.shape[0]
    d0 = dest - x
    eff_w = eff_weight(d0, in_flight, weight)
    tol_t = torch.tensor(tol, dtype=x.dtype, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    s = torch.zeros((n,), dtype=x.dtype, device=x.device)
    elem = elem.to(torch.int32).clone()
    done = torch.zeros((n,), dtype=torch.bool, device=x.device)
    iters = 0
    while iters < max_iters and not bool(done.all()):
        active = ~done
        e = elem.long()
        s_exit, f_exit = select_rows_lo(planes[e], s, dest, d0, tol_t)
        reached = s_exit >= one
        s_new = torch.where(reached, one, s_exit)
        nxt = adj[e, f_exit]
        hit_boundary = ~reached & (nxt == -1)
        contrib = torch.where(active, (s_new - s) * eff_w,
                              torch.zeros_like(s))
        flux.index_add_(0, e, contrib)
        moving = active & ~reached & ~hit_boundary
        elem = torch.where(moving, nxt, elem)
        s = torch.where(active, s_new, s)
        done = done | reached | hit_boundary
        iters += 1
    exited = done & (s < 1)
    at_dest = (done & ~exited)[:, None]
    x_fin = torch.where(at_dest, dest, dest + (s - 1)[:, None] * d0)
    return ResidentWalkResult(x=x_fin, elem=elem, done=done, exited=exited,
                              flux=flux, s=s)


def _walk_vmem_cuda(mesh, x, elem, dest, in_flight, weight, flux, *, tol,
                    max_iters, counts) -> ResidentWalkResult:
    dev, n, L = x.device, x.shape[0], mesh.nelems
    if L > w3_max_elems():
        raise ValueError(
            f"walk_vmem: {L} elements do not fit in shared memory (W3 holds "
            f"at most {w3_max_elems()}: {PLANE_BYTES + PARTIAL_BYTES} B each "
            f"of {SMEM_BYTES - SMEM_HEADER} B)"
        )
    f32 = torch.float32
    if mesh.dtype != f32:
        raise TypeError(f"walk_vmem: W3 walks float32 meshes, not "
                        f"{mesh.dtype}")
    shared_adj = w3_shared_adj(L)
    image = cached_image(mesh, shared_adj)
    adj = mesh.face_adj.contiguous()
    kernels.check_cuda_args("walk_vmem", dev, [
        ("image", image, torch.int32, (w3_image_bytes(L, shared_adj) // 4,)),
        ("adj", adj, torch.int32, (L, 4)),
        ("x", x, f32, (n, 3)),
        ("elem", elem, torch.int32, (n,)),
        ("dest", dest, f32, (n, 3)),
        ("in_flight", in_flight, torch.int8, (n,)),
        ("weight", weight, f32, (n,)),
        ("flux", flux, f32, (L,)),
        ("counts", counts, torch.int32, (len(W3_COUNTS),)),
    ])
    kernels.check_aligned("walk_vmem", [("the mesh image", image)])
    x_out = torch.empty((n, 3), dtype=f32, device=dev)
    elem_out = torch.empty((n,), dtype=torch.int32, device=dev)
    done = torch.empty((n,), dtype=torch.bool, device=dev)
    exited = torch.empty((n,), dtype=torch.bool, device=dev)
    s = torch.empty((n,), dtype=f32, device=dev)
    nxt = torch.zeros((1,), dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch(
        "resident_walk", f32, dev, p(image), p(adj), p(x), p(elem), p(dest),
        p(in_flight), p(weight), p(flux), p(x_out), p(elem_out), p(done),
        p(exited), p(s), p(nxt), p(counts), n, L, int(shared_adj),
        w3_image_bytes(L, shared_adj), float(tol), int(max_iters),
    )
    return ResidentWalkResult(x=x_out, elem=elem_out, done=done,
                              exited=exited, flux=flux, s=s)


def walk_vmem(mesh: TetMesh, x, elem, dest, in_flight, weight, flux, *,
              tol: float, max_iters: int,
              counts: Optional[torch.Tensor] = None) -> ResidentWalkResult:
    """Walk every particle to ``dest`` with the mesh resident on chip.
    CUDA tensors launch W3 (float32, at most ``w3_max_elems()``
    elements); CPU tensors run ``walk_vmem_plain``. ``counts`` (CUDA
    only: an int32 tensor, one entry per ``W3_COUNTS`` name) gets the
    particles the kernel walked and the loop iterations its warps ran
    added to it."""
    if x.is_cuda:
        return _walk_vmem_cuda(mesh, x, elem, dest, in_flight, weight, flux,
                               tol=tol, max_iters=max_iters, counts=counts)
    if x.device.type != "cpu":
        raise ValueError(f"walk_vmem runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    if counts is not None:
        raise ValueError("walk_vmem: counts are counted by the CUDA kernel; "
                         "the plain version has no schedule")
    return walk_vmem_plain(mesh, x, elem, dest, in_flight, weight, flux,
                           tol=tol, max_iters=max_iters)


def setup(divs: int, n: int, seed: int = 0, device="cuda"):
    """The tool's ``_setup``: a float32 divs^3 unit box, n particles
    localized (non-tallying walk from element 0's centroid) to uniform
    sources, and destinations one normal step away, clipped inside.
    Returns (mesh, x, elem, dest)."""
    mesh = build_box(1, 1, 1, divs, divs, divs, dtype=torch.float32,
                     device=device)
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    dest = np.clip(
        src + rng.normal(scale=0.25 / np.sqrt(3), size=(n, 3)), 0.02, 0.98
    ).astype(np.float32)
    c0 = mesh.coords[mesh.tet2vert[0].long()].mean(dim=0)
    x, elem, done, _ = _localize_step(
        mesh, c0.expand(n, 3).contiguous(),
        torch.zeros((n,), dtype=torch.int32, device=device),
        torch.as_tensor(src, device=device), tol=TOL, max_iters=MAX_ITERS,
    )
    assert bool(done.all())
    return mesh, x, elem, torch.as_tensor(dest, device=device)


def check(device="cuda") -> None:
    """W3 against W0 on the tool's check inputs (n = 2,000, L = 162 and
    750), with the tool's bounds: under 1% of element ids differ (a
    destination on a face may resolve to the neighbour), positions
    within 2e-6, flux within rtol 2e-4 / atol 1e-5."""
    n = 2000
    for divs in (3, 5):
        mesh, x, elem, dest = setup(divs, n, device=device)
        fly = torch.ones((n,), dtype=torch.int8, device=device)
        w = torch.as_tensor(np.random.default_rng(1).uniform(0.5, 1.5, n),
                            dtype=torch.float32, device=device)

        def flux0():
            return torch.zeros((mesh.nelems,), dtype=torch.float32,
                               device=device)

        ref = walk(mesh, x, elem, dest, fly, w, flux0(), tally=True, tol=TOL,
                   max_iters=MAX_ITERS)
        got = walk_vmem(mesh, x, elem, dest, fly, w, flux0(), tol=TOL,
                        max_iters=MAX_ITERS)
        assert bool(got.done.all()), "walk_vmem: a particle did not finish"
        mism = float((got.elem != ref.elem).double().mean())
        assert mism < 0.01, ("walk_vmem", mism)
        np.testing.assert_allclose(got.x.cpu().numpy(), ref.x.cpu().numpy(),
                                   atol=2e-6, err_msg="walk_vmem")
        np.testing.assert_allclose(got.flux.cpu().numpy(),
                                   ref.flux.cpu().numpy(), rtol=2e-4,
                                   atol=1e-5, err_msg="walk_vmem")
        print(f"divs={divs} walk_vmem: OK (sum flux "
              f"{float(got.flux.sum()):.4f} vs {float(ref.flux.sum()):.4f})")


def bench(n: int = 500_000, device="cuda", reps: int = 3) -> list:
    """The tool's L sweep: moves/s of W0 (the tool's ``walk_gather``
    arm) and W3 (its ``pallas_vmem`` arm) per mesh. Returns one dict
    per L with each arm's milliseconds."""
    rows = []
    for divs in BENCH_DIVS:
        mesh, x, elem, dest = setup(divs, n, device=device)
        L = mesh.nelems
        fly = torch.ones((n,), dtype=torch.int8, device=device)
        w = torch.ones((n,), dtype=torch.float32, device=device)
        flux = torch.zeros((L,), dtype=torch.float32, device=device)
        arms = {
            "walk_gather": lambda: walk(mesh, x, elem, dest, fly, w, flux,
                                        tally=True, tol=TOL,
                                        max_iters=MAX_ITERS),
            "walk_vmem": lambda: walk_vmem(mesh, x, elem, dest, fly, w, flux,
                                           tol=TOL, max_iters=MAX_ITERS),
        }
        row = {"L": L}
        print(f"L={L}:")
        for name, fn in arms.items():
            row[name] = ms = time_ms(fn, reps, device)
            print(f"  {name:14s} {n / ms / 1e3:.2f}M moves/s ({ms:.3f} ms)")
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="check",
                    choices=("check", "bench"))
    ap.add_argument("n", nargs="?", type=int, default=500_000,
                    help="particles for bench")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mode == "bench":
        bench(args.n, device=args.device)
    else:
        check(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
