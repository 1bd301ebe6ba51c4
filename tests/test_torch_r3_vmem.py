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
"""

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
    # 232,448 B of dynamic shared memory, 68 B per element (16 plane
    # floats and one flux-partial float): the tool's L = 3,072 fits.
    assert r3_vmem.w3_max_elems() == 3418
    assert 6 * max(r3_vmem.BENCH_DIVS) ** 3 == 3072 <= r3_vmem.w3_max_elems()
