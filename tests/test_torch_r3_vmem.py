"""PyTorch port, kernel W3's contract: ``walk_vmem`` (on CPU tensors its
plain version ``walk_vmem_plain``) against the Pallas kernel it ports,
tools/exp_r3_vmem.py ``walk_vmem_pallas``, run in interpret mode (the
tool is loaded by file path; its ``__main__`` guard keeps it inert).

Tolerances, float32 (the tool's dtype): element ids, done and exited
exact; positions within 1e-6 absolute (the tool's own check bound is
2e-6 against ``walk``; both sides compute the same column-wise
projections, so equal ids give equal rounding); flux within rtol 1e-5
and atol 1e-6 (the tool sums each 256-particle tile with a one-hot
matmul and then the tiles, the port scatter-adds crossing by crossing).

The Python side of the kernel's layout is held here too: the packed
12-bit neighbour ids round-trip exactly, the image holds what the
kernel reads, and the shared-adjacency regime ends where shared memory
does.
"""

import gc
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu_torch import convert
from pumiumtally_tpu_torch.experiments import r3_vmem
from pumiumtally_tpu_torch.experiments.r3_vmem import (
    walk_vmem,
    walk_vmem_plain,
)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-6
POS_ATOL = 1e-6
FLUX_RTOL, FLUX_ATOL = 1e-5, 1e-6


def _tool():
    spec = importlib.util.spec_from_file_location(
        "exp_r3_vmem", ROOT / "tools" / "exp_r3_vmem.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _workload(divs, n, seed):
    """float32 box of divs^3 cells; particles at element centroids with
    random destinations, some outside the box (boundary exits); a mixed
    in_flight mask (every particle walks, only flying ones tally)."""
    jmesh = jax_build_box(1, 1, 1, divs, divs, divs, dtype=jnp.float32)
    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(jmesh))
    arrays = convert.mesh_arrays(jmesh)
    rng = np.random.default_rng(seed)
    elem = rng.integers(0, mesh.nelems, n).astype(np.int32)
    coords = arrays["coords"].astype(np.float64)
    x = coords[arrays["tet2vert"][elem]].mean(axis=1).astype(np.float32)
    dest = (x + rng.normal(scale=0.35, size=(n, 3))).astype(np.float32)
    fly = (rng.random(n) > 0.3).astype(np.int8)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return jmesh, mesh, dict(x=x, elem=elem, dest=dest, fly=fly, w=w)


def _unpack_ids(a, b):
    """``r3_vmem.pack_ids``'s inverse, as csrc/resident_walk.cu decodes:
    the [L,4] int32 neighbour ids, -1 at the boundary."""
    v = (a.long() & 0xFFFFFFFF) | (b.long() & 0xFFFF) << 32
    shifts = r3_vmem.ID_BITS * torch.arange(4, device=a.device)
    ids = (v[:, None] >> shifts) & r3_vmem.ID_BOUNDARY
    return torch.where(ids == r3_vmem.ID_BOUNDARY, -1, ids).to(torch.int32)


def _run_tool(tool, jmesh, d, max_iters):
    out = tool.walk_vmem_pallas(
        jmesh, *(jnp.asarray(d[k]) for k in ("x", "elem", "dest", "fly",
                                             "w")),
        jnp.zeros((jmesh.nelems,), jnp.float32), tol=TOL,
        max_iters=max_iters, interpret=True,
    )
    return [np.asarray(o) for o in out]


def _run_port(fn, mesh, d, max_iters):
    r = fn(mesh, *(torch.from_numpy(d[k]) for k in ("x", "elem", "dest",
                                                    "fly", "w")),
           torch.zeros((mesh.nelems,), dtype=torch.float32), tol=TOL,
           max_iters=max_iters)
    return [convert.host(o) for o in r]


@pytest.mark.parametrize("divs,max_iters", [(3, 4096), (5, 4096), (3, 3)])
def test_walk_vmem_matches_the_tool_kernel(divs, max_iters):
    tool = _tool()
    jmesh, mesh, d = _workload(divs, n=600, seed=divs + max_iters)
    assert mesh.nelems == 6 * divs ** 3  # L = 162 or 750
    ref = _run_tool(tool, jmesh, d, max_iters)
    port = _run_port(walk_vmem, mesh, d, max_iters)
    for i, k in ((1, "elem"), (2, "done"), (3, "exited")):
        np.testing.assert_array_equal(port[i], ref[i], err_msg=k)
    np.testing.assert_allclose(port[0], ref[0], rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(port[4], ref[4], rtol=FLUX_RTOL,
                               atol=FLUX_ATOL)
    # The workload exercises boundary exits, non-flying walkers and, at
    # max_iters=3, walkers the cap stops before their destination.
    assert ref[3].any() and (d["fly"] == 0).any()
    assert (not ref[2].all()) == (max_iters == 3)


def test_wrapper_runs_the_plain_version_on_cpu():
    _, mesh, d = _workload(3, n=64, seed=7)
    a = _run_port(walk_vmem, mesh, d, 4096)
    b = _run_port(walk_vmem_plain, mesh, d, 4096)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_check_entry_point_passes_on_cpu(capsys):
    assert r3_vmem.main(["check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "divs=3 walk_vmem: OK" in out and "divs=5 walk_vmem: OK" in out


def test_shared_memory_ceiling():
    # 232,448 B of dynamic shared memory, 16 B of header and 68 B per
    # element in the global-adjacency regime (16 plane floats and one
    # flux-partial float): the tool's L = 3,072 fits.
    assert r3_vmem.w3_max_elems() == 3418
    assert 6 * max(r3_vmem.BENCH_DIVS) ** 3 == 3072 <= r3_vmem.w3_max_elems()
    assert r3_vmem.w3_smem_bytes(3418, False) <= r3_vmem.SMEM_BYTES
    assert r3_vmem.w3_smem_bytes(3419, False) > r3_vmem.SMEM_BYTES


def test_regime_flips_at_the_shared_limit():
    # 6 B more per element (four 12-bit ids), padded to 16 B: the ids
    # stay in shared memory up to 3,140 elements, the tool's sweep
    # included, and are read from global memory above, to 3,418.
    limit = r3_vmem.w3_shared_adj_max_elems()
    assert limit == 3140
    assert r3_vmem.w3_smem_bytes(limit, True) <= r3_vmem.SMEM_BYTES
    assert r3_vmem.w3_smem_bytes(limit + 1, True) > r3_vmem.SMEM_BYTES
    assert r3_vmem.w3_shared_adj(limit)
    assert not r3_vmem.w3_shared_adj(limit + 1)
    assert all(r3_vmem.w3_shared_adj(6 * d ** 3) for d in r3_vmem.BENCH_DIVS)
    assert not r3_vmem.w3_shared_adj(6 * 8 * 7 * 10)  # L = 3,360
    assert r3_vmem.w3_max_elems() == 3418


@pytest.mark.parametrize("dims", [(3, 3, 3), (8, 7, 10)])
def test_packed_ids_round_trip(dims):
    jmesh = jax_build_box(1, 1, 1, *dims, dtype=jnp.float32)
    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(jmesh))
    a, b = r3_vmem.pack_ids(mesh.face_adj)
    assert a.dtype == torch.int32 and b.dtype == torch.int16
    assert (mesh.face_adj == -1).any()
    assert torch.equal(_unpack_ids(a, b), mesh.face_adj)
    # Every id the 12 bits hold, the boundary code's neighbour included.
    ids = torch.arange(-1, r3_vmem.ID_BOUNDARY, dtype=torch.int32)
    adj = ids[torch.randperm(ids.numel(),
                             generator=torch.Generator().manual_seed(0))]
    adj = adj[: adj.numel() // 4 * 4].reshape(-1, 4)
    assert torch.equal(_unpack_ids(*r3_vmem.pack_ids(adj)), adj)
    with pytest.raises(ValueError, match="neighbour ids"):
        r3_vmem.pack_ids(torch.tensor([[0, 1, 2, r3_vmem.ID_BOUNDARY]]))


@pytest.mark.parametrize("shared_adj", [True, False])
def test_resident_image_layout(shared_adj):
    _, mesh, _ = _workload(3, n=1, seed=0)
    L = mesh.nelems
    image = r3_vmem.resident_image(mesh, shared_adj)
    assert image.dtype == torch.int32
    assert image.numel() * 4 == r3_vmem.w3_image_bytes(L, shared_adj)
    planes, adj = r3_vmem.resident_tables(mesh)
    quads = image[: 16 * L].view(torch.float32).reshape(4, L, 4)
    assert torch.equal(quads.transpose(0, 1).reshape(L, 16), planes)
    if shared_adj:  # the kernel's words: [L] int32, then [L] int16
        a, b = image[16 * L: 17 * L], image[17 * L:].view(torch.int16)[:L]
        assert torch.equal(_unpack_ids(a, b), adj)


def test_image_is_built_once_per_mesh_and_regime():
    _, mesh, _ = _workload(3, n=1, seed=0)
    first = {r: r3_vmem.cached_image(mesh, r) for r in (True, False)}
    for shared_adj, image in first.items():
        assert r3_vmem.cached_image(mesh, shared_adj) is image
        assert torch.equal(image, r3_vmem.resident_image(mesh, shared_adj))
    assert first[True].numel() > first[False].numel()
    key = id(mesh)
    assert key in r3_vmem._IMAGES
    del mesh, first
    gc.collect()
    assert key not in r3_vmem._IMAGES


def test_counts_are_refused_on_cpu():
    _, mesh, d = _workload(3, n=8, seed=1)
    with pytest.raises(ValueError, match="counts"):
        walk_vmem(mesh, *(torch.from_numpy(d[k]) for k in ("x", "elem",
                                                           "dest", "fly",
                                                           "w")),
                  torch.zeros((mesh.nelems,), dtype=torch.float32), tol=TOL,
                  max_iters=16, counts=torch.zeros((2,), dtype=torch.int32))
