"""PyTorch port, the reference's fourth call: ``walk_xpoints`` (plain
PyTorch) against the JAX ``walk_xpoints`` on the packed, two-tier and
unpacked meshes, and ``PumiTally.intersection_points()`` against the
reference's 6-tet cube (tests/test_walk_oracle.py) and the JAX facade,
with the JAX refusals on the other facades.

Tolerances, float64: intersection points to 1e-12 against the JAX
replay (the JAX walk forms its projections with an einsum, the port
column by column); the oracle's points to 1e-8 (the reference's
tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumiumtally_tpu import PumiTally as JaxPumiTally
from pumiumtally_tpu import TallyConfig as JaxTallyConfig
from pumiumtally_tpu import TetMesh as JaxTetMesh
from pumiumtally_tpu.mesh.box import box_arrays
from pumiumtally_tpu.ops.walk import walk_xpoints as jax_walk_xpoints
from pumiumtally_tpu_torch import (
    PartitionedPumiTally,
    PumiTally,
    StreamingPartitionedTally,
    StreamingTally,
    TallyConfig,
    build_box,
    convert,
)
from pumiumtally_tpu_torch.ops.walk import walk_xpoints

F64 = torch.float64
TOL = 1e-8
NUM = 5


def _flat(points):
    return np.ascontiguousarray(np.asarray(points, np.float64).reshape(-1))


def _jax_mesh(layout):
    coords, tets = box_arrays(1, 1, 1, 4, 4, 4)
    jm = JaxTetMesh.from_arrays(coords, tets, dtype=jnp.float64,
                                force_unpacked=layout == "unpacked")
    return jm.with_lowp_tables() if layout == "two_tier" else jm


@pytest.mark.parametrize("layout,table_dtype", [
    ("packed", "float32"), ("unpacked", "float32"),
    ("two_tier", "bfloat16"), ("two_tier", "float32")])
def test_walk_xpoints_matches_jax(layout, table_dtype):
    jm = _jax_mesh(layout)
    pm = convert.tetmesh_from_arrays(convert.mesh_arrays(jm))
    assert pm.unpacked == (layout == "unpacked")
    assert pm.two_tier == (layout == "two_tier")
    rng = np.random.default_rng(21)
    n = 400
    elem = rng.integers(0, pm.nelems, n).astype(np.int32)
    x = pm.centroids().numpy()[elem]
    dest = x + rng.normal(scale=0.4, size=(n, 3))  # some exit the box
    fly = (rng.random(n) > 0.15).astype(np.int8)
    want = np.asarray(jax_walk_xpoints(
        jm, jnp.asarray(x), jnp.asarray(elem), jnp.asarray(dest),
        jnp.asarray(fly), tol=TOL, max_iters=4096, table_dtype=table_dtype))
    got = walk_xpoints(pm, torch.tensor(x), torch.tensor(elem),
                       torch.tensor(dest), torch.tensor(fly), tol=TOL,
                       max_iters=4096, table_dtype=table_dtype).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # Held particles and particles that crossed nothing keep their start.
    np.testing.assert_array_equal(got[fly == 0], x[fly == 0])
    assert (np.abs(got - x).sum(axis=1) > 0).sum() > n // 2


def test_intersection_points_debug_surface():
    """tests/test_walk_oracle.py's case: on the oracle ray the last
    crossing is the boundary point x = 1; a ray stopping inside element
    3 last crosses x = 0.4; a move inside one tet keeps its start; a
    non-flying particle keeps its position."""
    mesh = build_box(1, 1, 1, 1, 1, 1, dtype=F64)
    t = PumiTally(mesh, NUM, TallyConfig(record_xpoints=True), device="cpu")
    init = np.tile([0.1, 0.4, 0.5], (NUM, 1))
    t.CopyInitialPosition(_flat(init), 3 * NUM)
    np.testing.assert_allclose(t.intersection_points(), init, atol=TOL)
    dests = np.tile([1.2, 0.4, 0.5], (NUM, 1))
    t.MoveToNextLocation(_flat(init), _flat(dests), np.ones(NUM, np.int8),
                         np.ones(NUM))
    np.testing.assert_allclose(t.intersection_points(),
                               np.tile([1.0, 0.4, 0.5], (NUM, 1)), atol=TOL)
    t2 = PumiTally(mesh, NUM, TallyConfig(record_xpoints=True), device="cpu")
    t2.CopyInitialPosition(_flat(init), 3 * NUM)
    half = np.tile([0.45, 0.4, 0.5], (NUM, 1))
    t2.MoveToNextLocation(_flat(init), _flat(half), np.ones(NUM, np.int8),
                          np.ones(NUM))
    np.testing.assert_allclose(t2.intersection_points(),
                               np.tile([0.4, 0.4, 0.5], (NUM, 1)), atol=TOL)
    tiny = half + np.tile([0.001, 0.0, 0.0], (NUM, 1))
    t2.MoveToNextLocation(None, _flat(tiny))
    np.testing.assert_allclose(t2.intersection_points(), half, atol=TOL)
    fly = np.ones(NUM, np.int8)
    fly[0] = 0
    far = np.tile([0.9, 0.4, 0.5], (NUM, 1))
    t2.MoveToNextLocation(_flat(tiny), _flat(far), fly, np.ones(NUM))
    xp = t2.intersection_points()
    np.testing.assert_allclose(xp[0], tiny[0], atol=TOL)
    np.testing.assert_allclose(xp[1:], np.tile([0.5, 0.4, 0.5], (NUM - 1, 1)),
                               atol=TOL)
    # A new source batch resets the points to the new positions.
    t2.CopyInitialPosition(_flat(init), 3 * NUM)
    np.testing.assert_allclose(t2.intersection_points(), init, atol=TOL)


def test_intersection_points_phase_a_and_errors_match_jax():
    """A move whose origins are not the committed positions replays a
    non-trivial phase A first; the result equals the JAX facade's. The
    record_xpoints and before-any-call refusals carry the JAX
    messages."""
    coords, tets = box_arrays(1, 1, 1, 4, 4, 4)
    jm = JaxTetMesh.from_arrays(coords, tets, dtype=jnp.float64)
    pm = convert.tetmesh_from_arrays(convert.mesh_arrays(jm))
    n = 300
    rng = np.random.default_rng(22)
    src, orig = rng.uniform(0.05, 0.95, (2, n, 3))
    dest = rng.uniform(-0.2, 1.2, (n, 3))
    fly = (rng.random(n) > 0.1).astype(np.int8)
    jt = JaxPumiTally(jm, n, JaxTallyConfig(record_xpoints=True))
    pt = PumiTally(pm, n, TallyConfig(record_xpoints=True), device="cpu")
    for t in (jt, pt):
        with pytest.raises(RuntimeError, match="CopyInitialPosition must be"):
            t.intersection_points()
        t.CopyInitialPosition(_flat(src))
        t.MoveToNextLocation(_flat(orig), _flat(dest), fly.copy(),
                             np.ones(n))
    got, want = pt.intersection_points(), np.asarray(jt.intersection_points())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # Phase A was not trivial: the replay started from the origins.
    moved = np.abs(got - orig).sum(axis=1) > 0
    assert moved[fly == 1].sum() > n // 2
    np.testing.assert_array_equal(got[fly == 0], pt.positions[fly == 0])
    off = PumiTally(pm, n, device="cpu")
    off.CopyInitialPosition(_flat(src))
    with pytest.raises(RuntimeError,
                       match=r"needs TallyConfig.record_xpoints=True"):
        off.intersection_points()


@pytest.mark.parametrize("facade", ["PartitionedPumiTally", "StreamingTally",
                                    "StreamingPartitionedTally"])
def test_intersection_points_refused_on_other_facades(facade):
    mesh = build_box(1, 1, 1, 2, 2, 2, dtype=F64)
    cfg = TallyConfig(record_xpoints=True)
    t = {"PartitionedPumiTally": lambda: PartitionedPumiTally(
             mesh, 8, cfg, device="cpu"),
         "StreamingTally": lambda: StreamingTally(
             mesh, 8, chunk_size=4, config=cfg, device="cpu"),
         "StreamingPartitionedTally": lambda: StreamingPartitionedTally(
             mesh, 8, chunk_size=4, config=cfg, device="cpu")}[facade]()
    t.CopyInitialPosition(_flat(np.full((8, 3), 0.3)))
    with pytest.raises(NotImplementedError,
                       match=r"implemented for the monolithic/sharded "
                             rf"PumiTally facade only, not {facade}$"):
        t.intersection_points()
