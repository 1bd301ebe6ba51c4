"""PyTorch port, kernel W0's contract: ``walk`` (on CPU tensors its plain
version ``walk_plain``) against the JAX package's ``walk``, plus the
reference's 6-tet cube oracle and the geometric probes of
tests/test_walk_robustness.py through the port's ``PumiTally``.

Tolerances, float64: element ids and done/exited masks exact (face ties
have measure zero on seeded interior points); positions and the ray
coordinate s to 1e-12 absolute (the JAX walk forms the projections with
an einsum, the port column by column); flux to rtol 1e-10 (another
addition order); the oracle to 1e-8 (the reference's tolerance)."""

import dataclasses

import numpy as np
import pytest
import torch

from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu.ops.walk import walk as jax_walk
from pumiumtally_tpu_torch import (
    PumiTally,
    TallyConfig,
    build_box,
    convert,
    kernels,
)
from pumiumtally_tpu_torch.ops.walk import _walk_cuda, walk, walk_plain

F64 = torch.float64
TOL = 1e-8
NUM = 5


def _workload(seed, n=600, div=4, spread=0.35):
    """Particles at element centroids (interior points) with random
    destinations, some outside the box (boundary exits), some not
    flying (dest == x, the caller's hold contract)."""
    jmesh = jax_build_box(1, 1, 1, div, div, div)
    arrays = convert.mesh_arrays(jmesh)
    rng = np.random.default_rng(seed)
    elem = rng.integers(0, arrays["tet2vert"].shape[0], n).astype(np.int32)
    x = arrays["coords"][arrays["tet2vert"][elem]].mean(axis=1)
    fly = (rng.random(n) > 0.15).astype(np.int8)
    dest = np.where(fly[:, None] == 1,
                    x + rng.normal(scale=spread, size=(n, 3)), x)
    w = rng.uniform(0.5, 2.0, n)
    return jmesh, convert.tetmesh_from_arrays(arrays), dict(
        x=x, elem=elem, dest=dest, fly=fly, w=w)


def _jax(jmesh, d, *, tally, max_iters=4096, s_init=None, elem=None):
    import jax.numpy as jnp

    ne = jmesh.nelems
    r = jax_walk(
        jmesh, jnp.asarray(d["x"]),
        jnp.asarray(d["elem"] if elem is None else elem),
        jnp.asarray(d["dest"]), jnp.asarray(d["fly"]), jnp.asarray(d["w"]),
        jnp.zeros((ne,)), tally=tally, tol=TOL, max_iters=max_iters,
        s_init=None if s_init is None else jnp.asarray(s_init),
    )
    return {k: np.asarray(getattr(r, k))
            for k in ("x", "elem", "done", "exited", "flux", "s", "iters")}


def _port(mesh, d, *, tally, max_iters=4096, s_init=None, elem=None):
    t = {k: torch.tensor(v) for k, v in d.items()}
    r = walk(
        mesh, t["x"], torch.tensor(d["elem"] if elem is None else elem),
        t["dest"], t["fly"], t["w"],
        torch.zeros((mesh.nelems,), dtype=F64) if tally else None,
        tally=tally, tol=TOL, max_iters=max_iters,
        s_init=None if s_init is None else torch.tensor(s_init),
    )
    out = {k: getattr(r, k).numpy() for k in
           ("x", "elem", "done", "exited", "s", "iters")}
    out["flux"] = None if r.flux is None else r.flux.numpy()
    return out


def _assert_same(port, ref, tally=True):
    for k in ("elem", "done", "exited"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    np.testing.assert_allclose(port["x"], ref["x"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(port["s"], ref["s"], rtol=0, atol=1e-12)
    if tally:
        np.testing.assert_allclose(port["flux"], ref["flux"], rtol=1e-10,
                                   atol=1e-13)
    # The JAX walk checks its budget every cond_every (4) steps.
    assert port["iters"] <= ref["iters"] < port["iters"] + 4


@pytest.mark.parametrize("tally", [True, False])
def test_walk_plain_matches_jax_walk(tally):
    jmesh, mesh, d = _workload(seed=3)
    ref = _jax(jmesh, d, tally=tally)
    port = _port(mesh, d, tally=tally)
    _assert_same(port, ref, tally)
    # The workload must exercise exits, holds and interior arrivals.
    assert ref["exited"].sum() > 0 and (~ref["exited"]).sum() > 0
    assert ref["done"].all()
    if not tally:
        assert port["flux"] is None


def test_walk_wrapper_runs_the_plain_version_on_cpu():
    _, mesh, d = _workload(seed=4, n=64)
    t = {k: torch.tensor(v) for k, v in d.items()}
    args = (mesh, t["x"], t["elem"], t["dest"], t["fly"], t["w"])
    a = walk(*args, torch.zeros(mesh.nelems, dtype=F64), tally=True,
             tol=TOL, max_iters=4096)
    b = walk_plain(*args, torch.zeros(mesh.nelems, dtype=F64), tally=True,
                   tol=TOL, max_iters=4096)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_s_init_continues_the_original_parametrisation():
    jmesh, mesh, d = _workload(seed=5)
    full = _port(mesh, d, tally=True)
    cut = _jax(jmesh, d, tally=True, max_iters=3)
    assert not cut["done"].all()
    ref = _jax(jmesh, d, tally=True, s_init=cut["s"], elem=cut["elem"])
    port = _port(mesh, d, tally=True, s_init=cut["s"], elem=cut["elem"])
    _assert_same(port, ref)
    # Interrupted + continued lands exactly where the uninterrupted
    # walk does.
    for k in ("elem", "done", "exited", "x", "s"):
        np.testing.assert_array_equal(port[k], full[k], err_msg=k)


def test_boundary_clamp_and_zero_length_flights():
    _, mesh, _ = _workload(seed=0, n=1)
    x = torch.tensor([[0.4, 0.5, 0.5]] * 3, dtype=F64)
    dest = torch.tensor([[1.7, 0.5, 0.5], [0.4, 0.5, 0.5], [0.4, 0.5, -2.0]],
                        dtype=F64)
    elem = geometry_locate(mesh, x)
    flux = torch.zeros(mesh.nelems, dtype=F64)
    r = walk(mesh, x, elem, dest, torch.ones(3, dtype=torch.int8),
             torch.ones(3, dtype=F64), flux, tally=True, tol=TOL,
             max_iters=4096)
    np.testing.assert_allclose(r.x.numpy(), [[1.0, 0.5, 0.5],
                                             [0.4, 0.5, 0.5],
                                             [0.4, 0.5, 0.0]], atol=1e-12)
    assert r.exited.tolist() == [True, False, True]
    assert r.done.all()
    np.testing.assert_allclose(flux.sum().item(), 0.6 + 0.5, rtol=1e-12)


def geometry_locate(mesh, pts):
    from pumiumtally_tpu_torch.ops.geometry import locate_by_planes

    return locate_by_planes(mesh.face_normals, mesh.face_offsets, pts, TOL)


# -- the reference's 6-tet cube oracle through the port facade ---------------

@pytest.fixture()
def tally():
    return PumiTally(build_box(1, 1, 1, 1, 1, 1, dtype=F64), NUM,
                     TallyConfig(), device="cpu")


def _flat(points):
    return np.ascontiguousarray(np.asarray(points, np.float64).reshape(-1))


def test_oracle_full_sequence(tally):
    np.testing.assert_allclose(tally.positions,
                               np.tile([0.5, 0.75, 0.25], (NUM, 1)), atol=TOL)
    init = np.tile([0.1, 0.4, 0.5], (NUM, 1))
    tally.CopyInitialPosition(_flat(init), 3 * NUM)
    np.testing.assert_array_equal(tally.elem_ids, np.full(NUM, 2))
    np.testing.assert_allclose(tally.flux.numpy(), 0.0, atol=TOL)

    dests = np.tile([1.2, 0.4, 0.5], (NUM, 1))
    flying = np.ones(NUM, dtype=np.int8)
    tally.MoveToNextLocation(_flat(init), _flat(dests), flying,
                             np.ones(NUM), 3 * NUM)
    np.testing.assert_array_equal(flying, 0)  # zeroed in place
    np.testing.assert_array_equal(tally.elem_ids, np.full(NUM, 4))
    np.testing.assert_allclose(tally.positions,
                               np.tile([1.0, 0.4, 0.5], (NUM, 1)), atol=TOL)
    expected1 = np.array([0.0, 0.0, 0.3 * NUM, 0.1 * NUM, 0.5 * NUM, 0.0])
    np.testing.assert_allclose(tally.flux.numpy(), expected1, atol=TOL)

    origins = np.tile([1.0, 0.4, 0.5], (NUM, 1))
    next_pos = origins.copy()
    flying2 = np.zeros(NUM, dtype=np.int8)
    weights2 = np.ones(NUM)
    next_pos[0], flying2[0], weights2[0] = [0.15, 0.05, 0.20], 1, 2.0
    next_pos[2], flying2[2], weights2[2] = [0.85, 0.05, 0.10], 1, 0.5
    tally.MoveToNextLocation(_flat(origins), _flat(next_pos), flying2,
                             weights2, 3 * NUM)
    np.testing.assert_allclose(tally.positions, next_pos, atol=TOL)
    np.testing.assert_array_equal(tally.elem_ids, [3, 4, 4, 4, 4])
    expected2 = expected1.copy()
    expected2[3] += 0.08790490988459178 * 2.0
    expected2[4] += 0.879049070406094 * 2.0 + 0.552268050859363 * 0.5
    np.testing.assert_allclose(tally.flux.numpy(), expected2, atol=TOL)


def test_oracle_resampled_and_nonflying(tally):
    init = np.tile([0.1, 0.4, 0.5], (NUM, 1))
    tally.CopyInitialPosition(_flat(init), 3 * NUM)
    origins = init.copy()
    origins[0] = [0.9, 0.1, 0.05]  # resampled: relocates without tally
    dests = origins.copy()
    dests[0] = [0.9, 0.2, 0.05]
    flying = np.zeros(NUM, dtype=np.int8)
    flying[0] = 1
    tally.MoveToNextLocation(_flat(origins), _flat(dests), flying,
                             np.ones(NUM), 3 * NUM)
    expected = np.zeros(6)
    expected[5] = 0.1
    np.testing.assert_allclose(tally.flux.numpy(), expected, atol=TOL)
    assert tally.elem_ids[0] == 5
    np.testing.assert_allclose(tally.positions[1:], init[1:], atol=TOL)


def test_flux_accumulates_across_moves(tally):
    init = np.tile([0.2, 0.4, 0.5], (NUM, 1))
    tally.CopyInitialPosition(_flat(init), 3 * NUM)
    dests = np.tile([0.3, 0.4, 0.5], (NUM, 1))
    w = np.full(NUM, 0.25)
    tally.MoveToNextLocation(_flat(init), _flat(dests),
                             np.ones(NUM, np.int8), w, 3 * NUM)
    tally.MoveToNextLocation(None, _flat(init), None, w)
    expected = np.zeros(6)
    expected[2] = 2 * NUM * 0.1 * 0.25
    np.testing.assert_allclose(tally.flux.numpy(), expected, atol=TOL)


# -- robustness probes (tests/test_walk_robustness.py) -----------------------

def _drive(points, dests, div=3, config=None):
    mesh = build_box(1, 1, 1, div, div, div, dtype=F64)
    t = PumiTally(mesh, points.shape[0], config or TallyConfig(),
                  device="cpu")
    t.CopyInitialPosition(_flat(points))
    assert (t.elem_ids >= 0).all() and (t.elem_ids < mesh.nelems).all()
    t.MoveToNextLocation(None, _flat(dests))
    return t


def test_sources_on_vertices_edges_and_boundary_destinations():
    pts = np.array([
        [0.0, 0.0, 0.0], [1 / 3, 1 / 3, 1 / 3], [0.5, 1 / 3, 1 / 3],
        [0.5, 0.5, 1 / 3], [0.5, 0.5, 0.0], [1.0, 1.0, 1.0],
    ])
    dests = np.full_like(pts, 0.51)
    dests[4:] = [[1.0, 0.5, 0.5], [0.0, 0.2, 1.0]]  # exactly on faces
    t = _drive(pts, dests)
    np.testing.assert_allclose(t.positions, dests, atol=1e-9)
    np.testing.assert_allclose(
        t.flux.sum().item(), np.linalg.norm(dests - pts, axis=1).sum(),
        rtol=1e-9,
    )


def test_dest_equal_origin_tallies_nothing():
    pts = np.random.default_rng(0).uniform(0.05, 0.95, (50, 3))
    t = _drive(pts, pts.copy())
    np.testing.assert_allclose(t.flux.numpy(), 0.0, atol=1e-15)
    np.testing.assert_allclose(t.positions, pts, atol=1e-9)


def test_corner_to_corner_diagonal():
    pts = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    dests = np.array([[1.0, 1.0, 1.0], [0.0, 1.0, 1.0]])
    t = _drive(pts, dests, div=5)
    np.testing.assert_allclose(t.positions, dests, atol=1e-6)
    np.testing.assert_allclose(t.flux.sum().item(), 2 * np.sqrt(3.0),
                               rtol=1e-7)


def test_max_iters_two_warns_and_does_not_hang(capsys):
    pts = np.random.default_rng(1).uniform(0.05, 0.95, (40, 3))
    mesh = build_box(1, 1, 1, 4, 4, 4, dtype=F64)
    t = PumiTally(mesh, 40, TallyConfig(max_iters=2), device="cpu")
    t.CopyInitialPosition(_flat(pts))
    assert "Not all particles are found" in capsys.readouterr().out
    t.MoveToNextLocation(None, _flat(1.0 - pts))
    assert "Not all particles are found" in capsys.readouterr().out


def test_non_finite_inputs_rejected_before_staging():
    mesh = build_box(1, 1, 1, 3, 3, 3, dtype=F64)
    n = 12
    src = np.full((n, 3), 0.4) + np.arange(n)[:, None] * 0.01
    t = PumiTally(mesh, n, device="cpu")
    t.CopyInitialPosition(_flat(src))
    before = t.flux.clone()
    dest = src + 0.05
    dest[3, 0] = np.nan
    flying = np.ones(n, np.int8)
    with pytest.raises(ValueError, match="non-finite"):
        t.MoveToNextLocation(_flat(src), _flat(dest), flying, np.ones(n))
    assert torch.equal(t.flux, before)
    np.testing.assert_array_equal(flying, 1)  # refused before zeroing
    w = np.ones(n)
    w[5] = np.inf
    with pytest.raises(ValueError, match="weights"):
        t.MoveToNextLocation(_flat(src), _flat(src + 0.05), flying, w)
    mesh32 = build_box(1, 1, 1, 3, 3, 3)
    t32 = PumiTally(mesh32, n, device="cpu")
    t32.CopyInitialPosition(_flat(src))
    big = src + 0.05
    big[2, 0] = 1e300  # finite in f64, inf after the f32 cast
    with pytest.raises(ValueError, match="destinations"):
        t32.MoveToNextLocation(None, _flat(big))


def _unaligned(t):
    """A copy of ``t`` whose data starts 4 bytes (8 for float64) past an
    allocation boundary (allocations are at least 16-byte aligned)."""
    off = max(4, t.element_size())
    buf = torch.empty(t.numel() * t.element_size() + off, dtype=torch.uint8)
    view = buf[off:].view(t.dtype).view(t.shape)
    view.copy_(t)
    return view


def test_check_aligned_refuses_a_view_offset_by_4_bytes():
    table = torch.zeros((6, 20), dtype=torch.float32)
    kernels.check_aligned("walk", [("walk_table", table), ("none", None)])
    off = _unaligned(table)
    assert off.data_ptr() % 16 == 4 and torch.equal(off, table)
    with pytest.raises(ValueError, match="walk_table must start on a "
                                         "16-byte boundary"):
        kernels.check_aligned("walk", [("walk_table", off)])


@pytest.mark.parametrize("two_tier", [False, True])
def test_walk_wrapper_refuses_unaligned_tables(two_tier):
    """W0's wrapper checks the tables it reads in 16-byte words (the
    packed row, or the select row) before anything is launched."""
    _, mesh, d = _workload(seed=6, n=8)
    if two_tier:
        mesh = mesh.with_lowp_tables()
        mesh = dataclasses.replace(
            mesh, walk_table_lo=_unaligned(mesh.walk_table_lo))
        name = "walk_table_lo"
    else:
        mesh = dataclasses.replace(
            mesh, walk_table=_unaligned(mesh.walk_table))
        name = "walk_table"
    t = {k: torch.tensor(v) for k, v in d.items()}
    with pytest.raises(ValueError, match=f"{name} must start on a 16-byte"):
        _walk_cuda(mesh, t["x"], t["elem"], t["dest"], t["fly"], t["w"],
                   torch.zeros(mesh.nelems, dtype=F64), tally=True, tol=TOL,
                   max_iters=4096, s_init=None, counts=None)


def test_walk_counts_are_the_kernels_own():
    _, mesh, d = _workload(seed=7, n=8)
    t = {k: torch.tensor(v) for k, v in d.items()}
    with pytest.raises(ValueError, match="counts are counted by the CUDA"):
        walk(mesh, t["x"], t["elem"], t["dest"], t["fly"], t["w"], None,
             tally=False, tol=TOL, max_iters=4096,
             counts=torch.zeros((1,), dtype=torch.int32))
