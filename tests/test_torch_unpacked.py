"""PyTorch port, the unpacked mesh layout (no table carries the ids: the
planes in one ROW16 buffer beside the int32 ``face_adj`` for meshes past
the float lanes' exact ids and ``force_unpacked``, or a two-tier mesh's
refinement tier in place, ROW20, through ``with_plane_views``), the
layout check W0's unpacked entries run (``check_plane_layout``) and W0's
plain unpacked branch, against the JAX package's unpacked mesh and walk
(``_gather_walk_row``'s fallback).

Tolerances, float64: mesh arrays equal; within the port the unpacked
walk equals the packed walk bitwise (the same arithmetic on the same
planes); against the JAX walk ids and masks exact, positions and s to
1e-12, flux to rtol 1e-10 (the JAX walk forms its projections with an
einsum, the port column by column)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumiumtally_tpu import PumiTally as JaxPumiTally
from pumiumtally_tpu import TetMesh as JaxTetMesh
from pumiumtally_tpu.mesh.box import box_arrays
from pumiumtally_tpu.ops.walk import walk as jax_walk
from pumiumtally_tpu_torch import (
    EnergyFilter,
    PumiTally,
    ScoringSpec,
    TallyConfig,
    TetMesh,
    convert,
)
from pumiumtally_tpu_torch.mesh.tetmesh import PLANE_ROW16, PLANE_ROW20
from pumiumtally_tpu_torch.ops.walk import (
    check_plane_layout,
    walk,
    walk_plain,
)

F64 = torch.float64
TOL = 1e-8
CPU = torch.device("cpu")


def _meshes(div=3, dtype=F64):
    coords, tets = box_arrays(1, 1, 1, div, div, div)
    return (TetMesh.from_arrays(coords, tets, dtype=dtype),
            TetMesh.from_arrays(coords, tets, dtype=dtype,
                                force_unpacked=True))


def _workload(mesh, seed, n=500, spread=0.4):
    """Particles at element centroids with random destinations (some out
    of the box: boundary exits), some not flying (dest == x)."""
    rng = np.random.default_rng(seed)
    elem = rng.integers(0, mesh.nelems, n).astype(np.int32)
    x = mesh.centroids().double().numpy()[elem]
    fly = (rng.random(n) > 0.15).astype(np.int8)
    dest = np.where(fly[:, None] == 1,
                    x + rng.normal(scale=spread, size=(n, 3)), x)
    return dict(x=x, elem=elem, dest=dest, fly=fly,
                w=rng.uniform(0.5, 2.0, n))


def _walk(mesh, d, fn=walk, **kw):
    dt = mesh.dtype
    t = {k: torch.tensor(v) for k, v in d.items()}
    return fn(mesh, t["x"].to(dt), t["elem"], t["dest"].to(dt), t["fly"],
              t["w"].to(dt), torch.zeros((mesh.nelems,), dtype=dt),
              tally=True, tol=TOL if dt == F64 else 1e-6, max_iters=4096,
              **kw)


def _assert_bitwise(a, b):
    for f in ("x", "elem", "done", "exited", "iters", "s", "flux"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_mesh_arrays_equal_jax_force_unpacked():
    coords, tets = box_arrays(1, 1, 1, 3, 2, 2)
    jm = JaxTetMesh.from_arrays(coords, tets, dtype=jnp.float64,
                                force_unpacked=True)
    pm = TetMesh.from_arrays(coords, tets, dtype=F64, force_unpacked=True)
    assert jm.walk_table is None and pm.walk_table is None and pm.unpacked
    for k in ("coords", "tet2vert", "face_adj", "volumes",
              "stored_face_normals", "stored_face_offsets"):
        np.testing.assert_array_equal(getattr(pm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    # convert carries the layout both ways.
    back = convert.tetmesh_from_arrays(convert.mesh_arrays(jm))
    assert back.unpacked
    for k in convert.MESH_KEYS[:-1]:
        assert torch.equal(getattr(back, k), getattr(pm, k)), k


def test_astype_and_conversions_keep_the_layout():
    packed, unpacked = _meshes()
    u32 = unpacked.to(torch.float32)
    assert u32.unpacked and u32.walk_table is None
    assert torch.equal(u32.face_normals, packed.to(torch.float32).face_normals)
    assert unpacked.to(F64).unpacked
    lo = unpacked.with_lowp_tables()
    assert lo.two_tier and not lo.unpacked
    assert torch.equal(lo.walk_table_hi, packed.with_lowp_tables().walk_table_hi)
    # The float32 tier of a two-tier mesh: views of the refinement tier.
    views = lo.with_plane_views()
    assert views.unpacked and not views.two_tier
    hi = lo.walk_table_hi
    for t in (views.face_normals, views.face_offsets):
        assert t.untyped_storage().data_ptr() == \
            hi.untyped_storage().data_ptr()
    assert check_plane_layout(views, CPU, F64) == PLANE_ROW20
    assert check_plane_layout(unpacked, CPU, F64) == PLANE_ROW16
    bad = TetMesh(**{**unpacked.__dict__, "stored_face_normals":
                     unpacked.face_normals.transpose(1, 2).contiguous()
                     .transpose(1, 2)})
    with pytest.raises(ValueError, match="strides"):
        check_plane_layout(bad, CPU, F64)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_walk_plain_unpacked_equals_packed_bitwise(dtype):
    packed, unpacked = _meshes(dtype=dtype)
    d = _workload(packed, seed=11)
    _assert_bitwise(_walk(unpacked, d, walk_plain), _walk(packed, d,
                                                          walk_plain))
    # The scoring lanes too.
    n = d["x"].shape[0]
    spec = ScoringSpec([EnergyFilter([0.0, 1.0, 2.0])], ["flux", "events"])
    banks = []
    for mesh in (packed, unpacked):
        bank = torch.zeros((mesh.nelems * 4,), dtype=dtype)
        r = _walk(mesh, d, walk_plain, scoring=(
            spec.kinds, bank, torch.tensor(np.arange(n) % 2 * 2,
                                           dtype=torch.int32),
            torch.ones((n, 2), dtype=dtype)))
        banks.append((r, bank))
    _assert_bitwise(banks[0][0], banks[1][0])
    assert torch.equal(banks[0][1], banks[1][1])


def test_unpacked_walk_matches_jax_walk():
    coords, tets = box_arrays(1, 1, 1, 4, 4, 4)
    jm = JaxTetMesh.from_arrays(coords, tets, dtype=jnp.float64,
                                force_unpacked=True)
    pm = TetMesh.from_arrays(coords, tets, dtype=F64, force_unpacked=True)
    d = _workload(pm, seed=12)
    r = jax_walk(jm, *(jnp.asarray(d[k]) for k in
                       ("x", "elem", "dest", "fly", "w")),
                 jnp.zeros((jm.nelems,)), tally=True, tol=TOL,
                 max_iters=4096)
    p = _walk(pm, d)
    for f in ("elem", "done", "exited"):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(r, f)), err_msg=f)
    for f in ("x", "s"):
        np.testing.assert_allclose(getattr(p, f).numpy(),
                                   np.asarray(getattr(r, f)), rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(p.flux.numpy(), np.asarray(r.flux),
                               rtol=1e-10, atol=1e-13)
    assert np.asarray(r.exited).sum() > 0 and np.asarray(r.done).all()


def test_unpacked_facade_matches_packed_and_jax():
    """tests/test_box_mesh.py::test_unpacked_walk_table_fallback_matches_packed
    through the port's PumiTally: packed and unpacked bitwise, and the
    JAX facade on its unpacked mesh to the module's tolerances."""
    coords, tets = box_arrays(1, 1, 1, 3, 3, 3)
    n = 800
    rng = np.random.default_rng(41)
    src = rng.uniform(0.05, 0.95, (n, 3))
    d1 = rng.uniform(-0.1, 1.1, (n, 3))  # includes boundary exits
    out = []
    for force in (False, True):
        mesh = TetMesh.from_arrays(coords, tets, dtype=F64,
                                   force_unpacked=force)
        assert mesh.unpacked == force
        t = PumiTally(mesh, n, device="cpu")
        assert t.mesh.unpacked == force  # the facade keeps the layout
        t.CopyInitialPosition(src.reshape(-1).copy())
        t.MoveToNextLocation(src.reshape(-1).copy(), d1.reshape(-1).copy(),
                             np.ones(n, np.int8), np.ones(n))
        out.append((t.flux.numpy(), t.positions, t.elem_ids))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    jt = JaxPumiTally(JaxTetMesh.from_arrays(coords, tets,
                                             force_unpacked=True), n)
    jt.CopyInitialPosition(src.reshape(-1).copy())
    jt.MoveToNextLocation(src.reshape(-1).copy(), d1.reshape(-1).copy(),
                          np.ones(n, np.int8), np.ones(n))
    np.testing.assert_array_equal(out[1][2], jt.elem_ids)
    np.testing.assert_allclose(out[1][1], jt.positions, rtol=0, atol=1e-12)
    np.testing.assert_allclose(out[1][0], np.asarray(jt.flux), rtol=1e-10,
                               atol=1e-13)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_two_tier_float32_tier_walks_the_plane_views(dtype):
    """A two-tier mesh at ``table_dtype="float32"`` walks its refinement
    tier's planes in place, bitwise ``with_packed_table``'s walk; a
    facade on it with the float32 tier packs the planes once at set-up
    and walks the packed table."""
    packed, _ = _meshes(div=4, dtype=dtype)
    lo = packed.with_lowp_tables()
    d = _workload(packed, seed=13)
    a = _walk(lo, d, table_dtype="float32")
    b = _walk(lo.with_packed_table(), d)
    _assert_bitwise(a, b)
    t = PumiTally(lo, 8, TallyConfig(walk_table_dtype="float32"),
                  device="cpu")
    assert not t.mesh.unpacked and not t.mesh.two_tier
    torch.testing.assert_close(t.mesh.walk_table,
                               lo.with_packed_table().walk_table,
                               rtol=0, atol=0)


def _is_row16(mesh):
    """The planes are the two views of one contiguous [E,16] buffer."""
    nrm, off = mesh.stored_face_normals, mesh.stored_face_offsets
    return (nrm.stride() == (16, 3, 1) and off.stride() == (16, 1)
            and off.storage_offset() == nrm.storage_offset() + 12
            and nrm.untyped_storage().data_ptr()
            == off.untyped_storage().data_ptr())


def _split(mesh):
    """``mesh`` with its planes copied into two contiguous arrays (the
    layout the unpacked meshes stored before ROW16)."""
    return dataclasses.replace(
        mesh, stored_face_normals=mesh.face_normals.contiguous(),
        stored_face_offsets=mesh.face_offsets.contiguous())


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_row16_views_equal_jax_force_unpacked(dtype):
    coords, tets = box_arrays(1, 1, 1, 2, 3, 2)
    jdt = {F64: jnp.float64, torch.float32: jnp.float32}[dtype]
    jm = JaxTetMesh.from_arrays(coords, tets, dtype=jdt, force_unpacked=True)
    pm = TetMesh.from_arrays(coords, tets, dtype=dtype, force_unpacked=True)
    assert _is_row16(pm)
    assert check_plane_layout(pm, CPU, dtype) == PLANE_ROW16
    for k in ("stored_face_normals", "stored_face_offsets"):
        want = np.asarray(getattr(jm, k))
        got = getattr(pm, k).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        # Bitwise: the values' bit patterns.
        bits = f"u{got.itemsize}"
        np.testing.assert_array_equal(np.ascontiguousarray(got).view(bits),
                                      np.ascontiguousarray(want).view(bits),
                                      err_msg=k)
    # The buffer's rows are the packed row's first 16 lanes.
    packed = TetMesh.from_arrays(coords, tets, dtype=dtype)
    assert torch.equal(pm.row16(), packed.walk_table[:, :16])
    assert pm.row16().data_ptr() == pm.face_normals.data_ptr()


def test_to_dtype_round_trip_and_convert_keep_row16():
    packed, unpacked = _meshes()
    f32 = torch.float32
    # (the mesh, the packed mesh its planes must equal bitwise)
    for m, ref in (
            (unpacked.to(f32), packed.to(f32)),
            # The f64 -> f32 -> f64 trip rounds once, as the packed
            # table's does.
            (unpacked.to(f32).to(F64), packed.to(f32).to(F64)),
            (unpacked.to(device="cpu"), packed),
            (convert.tetmesh_from_arrays(convert.mesh_arrays(unpacked)),
             packed),
            (convert.tetmesh_from_arrays(convert.mesh_arrays(unpacked),
                                         dtype=f32), packed.to(f32)),
            (_split(unpacked).to(F64), packed),
            (packed.with_unpacked_planes(), packed),
            (packed.with_lowp_tables().with_plane_views().to(F64), packed)):
        assert m.unpacked and m.walk_table is None and _is_row16(m)
        assert m.dtype == ref.dtype
        assert torch.equal(m.row16(), ref.walk_table[:, :16])
        assert torch.equal(m.face_normals, ref.face_normals)
        assert torch.equal(m.face_offsets, ref.face_offsets)
        assert torch.equal(m.face_adj, ref.face_adj)
    # A ROW16 buffer already in the dtype on the device is kept.
    same = unpacked.to(F64, "cpu")
    assert same.face_normals.data_ptr() == unpacked.face_normals.data_ptr()
    assert unpacked.with_unpacked_planes() is unpacked


def test_layout_check_accepts_row16_and_the_refinement_block():
    packed, unpacked = _meshes()
    views = packed.with_lowp_tables().with_plane_views()
    assert check_plane_layout(unpacked, CPU, F64) == PLANE_ROW16
    assert check_plane_layout(views, CPU, F64) == PLANE_ROW20
    hi = packed.with_lowp_tables().walk_table_hi
    assert views.face_normals.stride() == (20, 5, 1)
    assert views.face_offsets.stride() == (20, 5)
    # The block base is the normals' pointer; the offsets sit at +3.
    assert views.face_offsets.storage_offset() == \
        views.face_normals.storage_offset() + 3
    assert hi.stride() == (5, 1)
    with pytest.raises(ValueError, match="float32"):
        check_plane_layout(unpacked, CPU, torch.float32)


@pytest.mark.parametrize("case", ["misaligned", "stride 17", "split",
                                  "offsets elsewhere"])
def test_layout_check_refuses_other_layouts(case):
    _, unpacked = _meshes()
    ne = unpacked.nelems
    rows = unpacked.row16()
    if case == "misaligned":
        # ROW16 strides, 8 bytes past a 16-byte boundary.
        buf = torch.zeros((ne * 16 + 2,), dtype=F64)
        base = 1 if buf.data_ptr() % 16 == 0 else 2
        shifted = buf[base:base + ne * 16].view(ne, 16)
        shifted.copy_(rows)
        assert shifted.data_ptr() % 16 == 8
        planes = {"stored_face_normals": shifted[:, :12].view(ne, 4, 3),
                  "stored_face_offsets": shifted[:, 12:]}
    elif case == "stride 17":
        wide = torch.zeros((ne, 17), dtype=F64)
        wide[:, :16] = rows
        planes = {"stored_face_normals": wide[:, :12].view(ne, 4, 3),
                  "stored_face_offsets": wide[:, 12:16]}
    elif case == "split":
        planes = {"stored_face_normals": unpacked.face_normals.contiguous(),
                  "stored_face_offsets": unpacked.face_offsets.contiguous()}
    else:
        other = rows.clone()
        planes = {"stored_face_normals": unpacked.face_normals,
                  "stored_face_offsets": other[:, 12:]}
    bad = dataclasses.replace(unpacked, **planes)
    with pytest.raises(ValueError, match=r"with_unpacked_planes\(\)"):
        check_plane_layout(bad, CPU, F64)
    # The named method gives the layout back.
    good = bad.with_unpacked_planes()
    assert check_plane_layout(good, CPU, F64) == PLANE_ROW16
    assert torch.equal(good.row16(), rows)


def test_facade_repacks_separate_planes_and_matches_packed_and_jax():
    """A caller's mesh with its planes in two separate arrays: the facade
    repacks them once at set-up into ROW16 and walks bitwise the packed
    mesh's walk, and the JAX facade on its unpacked mesh to the module's
    tolerances."""
    coords, tets = box_arrays(1, 1, 1, 3, 2, 3)
    packed = TetMesh.from_arrays(coords, tets, dtype=F64)
    separate = _split(TetMesh.from_arrays(coords, tets, dtype=F64,
                                          force_unpacked=True))
    assert not _is_row16(separate)
    n = 600
    rng = np.random.default_rng(43)
    src = rng.uniform(0.05, 0.95, (n, 3))
    moves = [rng.uniform(-0.1, 1.1, (n, 3)) for _ in range(2)]
    out = []
    for mesh in (packed, separate):
        t = PumiTally(mesh, n, device="cpu")
        assert t.mesh.unpacked == (mesh is separate)
        if mesh is separate:
            assert _is_row16(t.mesh)
            assert check_plane_layout(t.mesh, CPU, F64) == PLANE_ROW16
        t.CopyInitialPosition(src.reshape(-1).copy())
        t.MoveToNextLocation(src.reshape(-1).copy(),
                             moves[0].reshape(-1).copy(),
                             np.ones(n, np.int8), np.ones(n))
        t.MoveToNextLocation(None, moves[1].reshape(-1).copy())
        out.append((t.flux.numpy().copy(), t.positions, t.elem_ids))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    jt = JaxPumiTally(JaxTetMesh.from_arrays(coords, tets,
                                             force_unpacked=True), n)
    jt.CopyInitialPosition(src.reshape(-1).copy())
    jt.MoveToNextLocation(src.reshape(-1).copy(),
                          moves[0].reshape(-1).copy(), np.ones(n, np.int8),
                          np.ones(n))
    jt.MoveToNextLocation(None, moves[1].reshape(-1).copy())
    np.testing.assert_array_equal(out[1][2], jt.elem_ids)
    np.testing.assert_allclose(out[1][1], jt.positions, rtol=0, atol=1e-12)
    np.testing.assert_allclose(out[1][0], np.asarray(jt.flux), rtol=1e-10,
                               atol=1e-13)
