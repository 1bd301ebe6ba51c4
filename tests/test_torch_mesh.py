"""PyTorch port, mesh layer: ``build_box`` / ``TetMesh`` and
``build_partition`` against the JAX package, the box-mesh fixture
checks of tests/test_box_mesh.py on the port, and ``convert.py``.

The host precompute is the same float64 numpy code in both packages, so
every array must be EQUAL, not just close."""

import numpy as np
import pytest
import torch

from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu.parallel.partition import (
    build_partition as jax_build_partition,
)
from pumiumtally_tpu_torch import convert
from pumiumtally_tpu_torch.mesh.box import build_box
from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh
from pumiumtally_tpu_torch.ops import geometry
from pumiumtally_tpu_torch.parallel.partition import build_partition

F64 = torch.float64


@pytest.fixture(scope="module")
def cube():
    return build_box(1, 1, 1, 1, 1, 1, dtype=F64)


@pytest.mark.parametrize("div", [1, 10])
def test_build_box_arrays_equal_jax(div):
    port = convert.mesh_arrays(build_box(1, 1, 1, div, div, div, dtype=F64))
    ref = convert.mesh_arrays(jax_build_box(1, 1, 1, div, div, div))
    assert port.keys() == ref.keys()
    for k in convert.MESH_KEYS:
        assert port[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


def test_counts_volumes_centroid(cube):
    assert cube.nelems == 6 and cube.nverts == 8
    v = cube.volumes.numpy()
    np.testing.assert_allclose(v, 1.0 / 6.0, atol=1e-12)
    # Reference oracle: element 0's centroid is (0.5, 0.75, 0.25).
    np.testing.assert_allclose(cube.centroids()[0].numpy(),
                               [0.5, 0.75, 0.25], atol=1e-12)


def test_point_containment_matches_oracle(cube):
    pts = torch.tensor([[0.1, 0.4, 0.5], [0.15, 0.05, 0.2],
                        [0.85, 0.05, 0.1]], dtype=F64)
    elems = geometry.locate_by_planes(cube.face_normals, cube.face_offsets,
                                      pts, 1e-8)
    np.testing.assert_array_equal(elems.numpy(), [2, 3, 4])
    far = torch.tensor([[2.0, 0.5, 0.5]], dtype=F64)
    assert int(geometry.locate_by_planes(cube.face_normals,
                                         cube.face_offsets, far, 1e-8)) == -1


def test_face_adjacency_and_outward_normals(cube):
    adj = cube.face_adj.numpy()
    for e in range(6):
        for f in range(4):
            if adj[e, f] >= 0:
                assert e in adj[adj[e, f]], (e, f)
    assert (adj == -1).sum() == 12
    n = cube.face_normals.numpy()
    off = cube.face_offsets.numpy()
    cent = cube.centroids().numpy()
    assert np.all(np.einsum("efc,ec->ef", n, cent) - off < 0)
    np.testing.assert_allclose(
        geometry.tet_volumes(cube.coords, cube.tet2vert).numpy(),
        cube.volumes.numpy(), rtol=1e-14,
    )


def test_larger_box_adjacency_counts():
    m = build_box(2.0, 1.0, 3.0, 3, 2, 4, dtype=F64)
    assert m.nelems == 6 * 24
    np.testing.assert_allclose(m.volumes.sum().item(), 6.0, rtol=1e-12)
    nbnd = 2 * 2 * (3 * 2 + 2 * 4 + 3 * 4)
    assert (m.face_adj.numpy() == -1).sum() == nbnd


def test_float32_mesh_keeps_ids_exact():
    m64 = build_box(1, 1, 1, 3, 3, 3, dtype=F64)
    m32 = m64.to(dtype=torch.float32)
    assert m32.walk_table.dtype == torch.float32
    np.testing.assert_array_equal(
        m32.walk_table[:, 16:].numpy().astype(np.int64),
        m64.face_adj.numpy(),
    )
    np.testing.assert_array_equal(
        m32.walk_table.numpy(), m64.walk_table.numpy().astype(np.float32)
    )


def test_packed_table_past_exact_ids_refused(monkeypatch):
    """A float32 mesh with as many tets as the float lanes hold exactly
    (2^24, lowered here to 4 so a 6-tet box crosses it) is no longer
    refused: it builds in the unpacked layout (no packed table, the
    planes and the int32 ids apart) and walks as the packed mesh does,
    bitwise."""
    from pumiumtally_tpu_torch.mesh import tetmesh
    from pumiumtally_tpu_torch.ops.walk import walk

    arrays = convert.mesh_arrays(build_box(1, 1, 1, 1, 1, 1, dtype=F64))
    packed = TetMesh.from_arrays(arrays["coords"], arrays["tet2vert"],
                                 dtype=torch.float32)
    monkeypatch.setattr(tetmesh, "exact_id_limit", lambda dtype: 4)
    mesh = TetMesh.from_arrays(arrays["coords"], arrays["tet2vert"],
                               dtype=torch.float32)
    assert mesh.unpacked and mesh.walk_table is None
    assert torch.equal(mesh.face_normals, packed.face_normals)
    assert torch.equal(mesh.face_adj, packed.face_adj)
    rng = np.random.default_rng(9)
    n = 64
    x = torch.tensor(rng.uniform(0.1, 0.9, (n, 3)), dtype=torch.float32)
    elem = geometry.locate_by_planes(packed.face_normals,
                                     packed.face_offsets, x, 1e-6)
    dest = torch.tensor(rng.uniform(-0.2, 1.2, (n, 3)), dtype=torch.float32)
    out = [walk(m, x, elem.to(torch.int32), dest,
                torch.ones(n, dtype=torch.int8),
                torch.ones(n, dtype=torch.float32),
                torch.zeros(m.nelems, dtype=torch.float32), tally=True,
                tol=1e-6, max_iters=256) for m in (packed, mesh)]
    for f in ("x", "elem", "done", "exited", "s", "flux"):
        assert torch.equal(getattr(out[0], f), getattr(out[1], f)), f


def test_convert_round_trip_and_from_jax():
    port = build_box(1, 1, 1, 3, 2, 2, dtype=F64)
    back = convert.tetmesh_from_arrays(convert.mesh_arrays(port))
    from_jax = convert.tetmesh_from_arrays(
        convert.mesh_arrays(jax_build_box(1, 1, 1, 3, 2, 2))
    )
    for m in (back, from_jax):
        assert isinstance(m, TetMesh) and m.dtype == F64
        for k in convert.MESH_KEYS:
            assert torch.equal(getattr(m, k), getattr(port, k)), k
    as32 = convert.tetmesh_from_arrays(convert.mesh_arrays(port),
                                       dtype=torch.float32)
    assert torch.equal(as32.walk_table, port.to(torch.float32).walk_table)


@pytest.mark.parametrize("nparts", [1, 5])
def test_build_partition_equals_jax(nparts):
    port = build_partition(build_box(1, 1, 1, 4, 4, 4, dtype=F64), nparts)
    ref = jax_build_partition(jax_build_box(1, 1, 1, 4, 4, 4), nparts)
    pa, ra = convert.partition_arrays(port), convert.partition_arrays(ref)
    for k in convert.PARTITION_KEYS:
        np.testing.assert_array_equal(pa[k], ra[k], err_msg=k)
    back = convert.partition_from_arrays(ra)
    for k in ("glid_of_orig", "orig_of_glid", "table"):
        assert torch.equal(getattr(back, k), getattr(port, k)), k
    # Remote neighbours are local-encoded as -(glid+2).
    adj = pa["table"][:, 16:]
    assert (adj <= -2).any() == (nparts > 1)
