"""The whole-mesh walk with the mesh resident on chip (the port of
tools/exp_r3_vmem.py), as kernel W3 (csrc/resident_walk.cu) with its
plain PyTorch version beside it.

The tool's Pallas kernel ``walk_vmem_pallas`` pins a small mesh's table
in VMEM and runs the whole walk loop of a particle tile in one kernel,
fetching rows and scattering the tally with one-hot MXU matmuls. W3
keeps the mesh's 16 plane floats per tet in shared memory instead and
reads rows by index; the winning face's neighbour comes from an int32
adjacency table in global memory. The tool's other arm,
``walk_onehot_jnp``, is XLA code (the MXU formulation, no Pallas
kernel) and is not ported.

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
from typing import NamedTuple

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
# Dynamic shared memory a block may use on an H100, and what W3 keeps
# per element: the 16 plane floats and one flux-partial float.
SMEM_BYTES = 232_448
SMEM_BYTES_PER_ELEM = (PLANE_WIDTH + 1) * 4


class ResidentWalkResult(NamedTuple):
    x: torch.Tensor  # [N,3] committed position
    elem: torch.Tensor  # [N] int32 final element
    done: torch.Tensor  # [N] bool (False = max_iters ran out)
    exited: torch.Tensor  # [N] bool: finished by leaving the domain
    flux: torch.Tensor  # [L], the input tensor, updated in place
    s: torch.Tensor  # [N] final ray coordinate along x -> dest


def w3_max_elems() -> int:
    """The largest mesh W3 holds in shared memory: 3,418 elements."""
    return SMEM_BYTES // SMEM_BYTES_PER_ELEM


def resident_tables(mesh: TetMesh):
    """W3's tables: the [L,16] plane rows (normals | offsets, the packed
    row's first 16 columns) and the [L,4] int32 neighbour ids."""
    planes = torch.cat([mesh.face_normals.reshape(-1, 12),
                        mesh.face_offsets], dim=1).contiguous()
    return planes, mesh.face_adj.contiguous()


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
                    max_iters) -> ResidentWalkResult:
    dev, n, L = x.device, x.shape[0], mesh.nelems
    if L > w3_max_elems():
        raise ValueError(
            f"walk_vmem: {L} elements do not fit in shared memory (W3 holds "
            f"at most {w3_max_elems()}: {SMEM_BYTES_PER_ELEM} B each of "
            f"{SMEM_BYTES} B)"
        )
    planes, adj = resident_tables(mesh)
    f32 = torch.float32
    kernels.check_cuda_args("walk_vmem", dev, [
        ("planes", planes, f32, (L, PLANE_WIDTH)),
        ("adj", adj, torch.int32, (L, 4)),
        ("x", x, f32, (n, 3)),
        ("elem", elem, torch.int32, (n,)),
        ("dest", dest, f32, (n, 3)),
        ("in_flight", in_flight, torch.int8, (n,)),
        ("weight", weight, f32, (n,)),
        ("flux", flux, f32, (L,)),
    ])
    if planes.data_ptr() % 16:  # staged as float4
        raise ValueError("walk_vmem: the plane table must start on a "
                         "16-byte boundary")
    x_out = torch.empty((n, 3), dtype=f32, device=dev)
    elem_out = torch.empty((n,), dtype=torch.int32, device=dev)
    done = torch.empty((n,), dtype=torch.bool, device=dev)
    exited = torch.empty((n,), dtype=torch.bool, device=dev)
    s = torch.empty((n,), dtype=f32, device=dev)
    p = kernels.ptr
    kernels.launch(
        "resident_walk", f32, dev, p(planes), p(adj), p(x), p(elem), p(dest),
        p(in_flight), p(weight), p(flux), p(x_out), p(elem_out), p(done),
        p(exited), p(s), n, L, float(tol), int(max_iters),
    )
    return ResidentWalkResult(x=x_out, elem=elem_out, done=done,
                              exited=exited, flux=flux, s=s)


def walk_vmem(mesh: TetMesh, x, elem, dest, in_flight, weight, flux, *,
              tol: float, max_iters: int) -> ResidentWalkResult:
    """Walk every particle to ``dest`` with the mesh resident on chip.
    CUDA tensors launch W3 (float32, at most ``w3_max_elems()``
    elements); CPU tensors run ``walk_vmem_plain``."""
    if x.is_cuda:
        return _walk_vmem_cuda(mesh, x, elem, dest, in_flight, weight, flux,
                               tol=tol, max_iters=max_iters)
    if x.device.type != "cpu":
        raise ValueError(f"walk_vmem runs on CUDA or CPU tensors, not "
                         f"{x.device}")
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
