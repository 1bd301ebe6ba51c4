"""The reference walk and the roofline's count, by hand on small meshes,
and the frozen mesh generator against the program's."""

import numpy as np
import pytest
import torch

from benchmark import check, meshgen, roofline
from benchmark.reference.tally import reference_pool
from benchmark.reference.walk import F64, RefMesh, walk
from benchmark.traffic import make_pool

# The unit cube as 6 tets around its main diagonal (0,0,0)-(1,1,1).
CUBE = np.array([[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)],
                np.float64)
CUBE_TETS = np.array([[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
                      [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], np.int32)


def cube():
    return RefMesh(CUBE, CUBE_TETS, "cpu")


def t(a):
    return torch.tensor(a, dtype=F64)


def test_cube_tables():
    m = cube()
    assert m.nelems == 6
    # Every tet has two faces on the cube's surface and two inside.
    assert ((m.adj >= 0).sum(dim=1) == 2).all()
    # Adjacency is symmetric.
    for e in range(6):
        for nb in m.adj[e][m.adj[e] >= 0].tolist():
            assert e in m.adj[nb].tolist()
    # Every vertex of a tet lies inside or on all four of its planes.
    v = torch.tensor(CUBE)[torch.tensor(CUBE_TETS).long()]
    side = (m.normals[:, :, None, :] * v[:, None, :, :]).sum(-1) \
        - m.offsets[:, :, None]
    assert (side <= 1e-12).all()


def test_walk_along_an_edge_free_line_credits_each_tet_its_length():
    m = cube()
    # From near the corner (0,0,0) side to near (1,1,1), off the diagonal.
    x0 = t([[0.1, 0.2, 0.05]])
    dest = t([[0.9, 0.7, 0.95]])
    e0 = int(torch.nonzero(m.outside_by(torch.arange(6),
                                        x0.expand(6, 3)) <= 0)[0])
    flux = torch.zeros(6, dtype=F64)
    x, e, touched = walk(m, x0, torch.tensor([e0]), dest,
                         weight=t([2.0]), flux=flux)
    length = float(torch.linalg.norm(dest - x0))
    assert float(flux.sum()) == pytest.approx(2 * length, rel=1e-14)
    assert torch.equal(x, dest)
    assert float(m.outside_by(e, dest)) <= 1e-12
    # Steps: one a tet walked through; every walked tet got track.
    assert touched.steps == touched.elems == int((flux > 0).sum())
    assert touched.flux == touched.elems


def test_walk_clamps_at_the_boundary():
    m = cube()
    x0 = t([[0.5, 0.4, 0.3]])
    dest = t([[0.5, 0.4, 1.7]])
    e0 = int(torch.nonzero(m.outside_by(torch.arange(6),
                                        x0.expand(6, 3)) <= 0)[0])
    flux = torch.zeros(6, dtype=F64)
    x, _, _ = walk(m, x0, torch.tensor([e0]), dest, weight=t([1.0]),
                   flux=flux)
    assert x[0].tolist() == pytest.approx([0.5, 0.4, 1.0], abs=1e-12)
    assert float(flux.sum()) == pytest.approx(0.7, rel=1e-12)


def test_roofline_hand_count():
    m = cube()
    x0 = t([[0.1, 0.2, 0.05], [0.3, 0.3, 0.3]])
    dest = t([[0.9, 0.7, 0.95], [0.3, 0.3, 0.31]])
    e0 = torch.tensor([int(torch.nonzero(
        m.outside_by(torch.arange(6), x0[i].expand(6, 3)) <= 0)[0])
        for i in range(2)])
    flux = torch.zeros(6, dtype=F64)
    _, _, touched = walk(m, x0, e0, dest, weight=t([1.0, 1.0]), flux=flux)
    # Particle 1 stays in its tet: one step; particle 0 crosses k faces.
    k = touched.steps - 1
    nbytes = roofline.walk_bytes(touched, 2, tallied=True)
    assert nbytes == (touched.elems * 80 + 2 * (16 + 16 + 12 + 5)
                      + touched.flux * 8)
    by_bytes = nbytes / 3.35e12 * 1e3
    by_ops = (k + 1) * 70 / 67e12 * 1e3
    assert roofline.walk_bound_ms(touched, 2, True) == max(by_bytes, by_ops)
    assert roofline.walk_bytes(touched, 2, tallied=False) == \
        nbytes - 2 * 5
    assert roofline.walk_bound_ms(type(touched)(), 2, True) == 0.0


def test_frozen_lattice_equals_the_programs():
    from pumiumtally_tpu_torch.mesh.pincell import lattice_arrays

    spec = dict(nx=2, ny=2, pitch=1.26, fuel_radius=0.4095, height=1.0,
                n_theta=16, n_rings_fuel=2, n_rings_pad=2, nz=3)
    c, tt = meshgen.kind("lattice").lattice_arrays(**spec)
    c2, t2, _, _ = lattice_arrays(**spec)
    assert np.array_equal(c, c2) and np.array_equal(tt, t2)
    assert meshgen.extent(dict(spec, kind="lattice")).tolist() == \
        [2.52, 2.52, 1.0]


def tiny_pool(protocol="two_phase", scoring=None, seed=5):
    mix = {"protocol": protocol, "moves_per_batch": 3, "pool_batches": 2,
           "mean_step": 0.25, "source_range": [0.02, 0.98],
           "walls": [0.02, 0.98],
           "weight": 1.0,
           "energy": {"kind": "log_uniform", "out_share": 0.01},
           "time": {"kind": "uniform"}}
    spec = dict(kind="lattice", nx=1, ny=1, n_theta=8, n_rings_fuel=1,
                n_rings_pad=1, nz=2)
    coords, tets = meshgen.build_arrays(spec)
    return (RefMesh(coords, tets, "cpu"),
            make_pool(mix, seed, 300, meshgen.extent(spec), scoring))


@pytest.mark.parametrize("protocol", ["two_phase", "continue"])
def test_reference_conserves_track_length(protocol):
    mesh, pool = tiny_pool(protocol)
    refs = reference_pool(mesh, pool, protocol, None)
    check.check_reference(refs)
    for b, r in zip(pool, refs):
        pts = [np.asarray(p, np.float32).astype(np.float64)
               for p in b.points]
        want = sum(np.linalg.norm(pts[m] - pts[m - 1], axis=1).sum()
                   for m in range(1, len(pts)))
        assert float(r.flux.sum()) == pytest.approx(want, rel=1e-12)
        # The echoing origins relocate nothing.
        assert r.relocate == []
        assert float(mesh.outside_by(r.elem, r.x).max()) <= 1e-9


def test_reference_check_refuses_a_leak():
    mesh, pool = tiny_pool()
    refs = reference_pool(mesh, pool, "two_phase", None)
    refs[1].flux[0] += 1e-3
    with pytest.raises(RuntimeError, match="conserve"):
        check.check_reference(refs)


def test_reference_scoring_lanes_sum_to_the_flux():
    scoring = {"energy_edges": np.geomspace(1e-5, 2e7, 9),
               "time_edges": np.linspace(0.0, 1.0, 5),
               "scores": ["flux", "heating", "events"]}
    mesh, pool = tiny_pool(scoring=scoring)
    refs = reference_pool(mesh, pool, "two_phase", scoring)
    for r in refs:
        lanes = r.bank.reshape(mesh.nelems, 32, 3)
        kept = float(lanes[:, :, 0].sum())
        # About 1% of the energies fall outside the edges and score
        # nowhere; the rest of the track is in the flux score.
        assert 0.97 < kept / float(r.flux.sum()) <= 1 + 1e-12
        events = lanes[:, :, 2]
        assert torch.equal(events, events.round())
        assert r.moves[0].lanes > 0
