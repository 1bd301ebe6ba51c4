"""PyTorch port, the two-tier walk tables (a bf16 SELECT tier picks the
exit face, one full-precision REFINEMENT row re-solves its crossing and
names the neighbour) against the JAX package: the tables, the row
helpers, W0's two-tier branch (``walk``, on CPU tensors ``walk_plain``)
and the ``PumiTally`` facade with ``walk_table_dtype="bfloat16"``.

Tolerances, float64: the bf16 tier compared as bits and the refinement
tier exactly; the bf16 lift exact; the helpers' winning face and
neighbour exact, ray coordinates to 1e-12 (the JAX helpers form the
projections with an einsum, the port column by column); walks with
element ids and masks exact, positions and s to 1e-12, flux rtol 1e-10;
in-box conservation at 1e-9."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from pumiumtally_tpu import PumiTally as JaxPumiTally
from pumiumtally_tpu import TallyConfig as JaxTallyConfig
from pumiumtally_tpu.mesh.box import box_arrays
from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu.mesh.tetmesh import TetMesh as JaxTetMesh
from pumiumtally_tpu.ops.walk import _lift_bf16 as jax_lift_bf16
from pumiumtally_tpu.ops.walk import refine_plane_hi as jax_refine_plane_hi
from pumiumtally_tpu.ops.walk import select_rows_lo as jax_select_rows_lo
from pumiumtally_tpu.ops.walk import walk as jax_walk
from pumiumtally_tpu.parallel.partition import (
    build_partition as jax_build_partition,
)
from pumiumtally_tpu_torch import PumiTally, TallyConfig, convert
from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh
from pumiumtally_tpu_torch.ops.walk import (
    lift_bf16,
    refine_plane_hi,
    select_rows_lo,
    walk,
    walk_plain,
)
from pumiumtally_tpu_torch.parallel.partition import build_partition

F64 = torch.float64
TOL = 1e-8
BF16 = "bfloat16"


def _flat(a):
    return np.ascontiguousarray(np.asarray(a, np.float64).reshape(-1))


def _assert_tiers_equal(port, ref):
    """Two-tier tables: the bf16 tier as bits, the refinement tier and
    everything else exactly."""
    p, r = convert.mesh_arrays(port), convert.mesh_arrays(ref)
    assert "walk_table" not in p and "walk_table" not in r
    assert p["walk_table_lo"].dtype == r["walk_table_lo"].dtype == np.uint16
    for k in r:
        np.testing.assert_array_equal(p[k], r[k], err_msg=k)


# -- tables ------------------------------------------------------------------

@pytest.mark.parametrize("div", [2, 5])
def test_from_arrays_two_tier_tables_match_jax(div):
    coords, tet2vert = box_arrays(1.0, 1.3, 0.7, div, div + 1, div)
    ref = JaxTetMesh.from_arrays(coords, tet2vert, dtype=jnp.float64,
                                 table_dtype=BF16)
    port = TetMesh.from_arrays(coords, tet2vert, dtype=F64,
                               table_dtype=BF16)
    assert port.two_tier and port.walk_table is None
    assert port.walk_table_lo.dtype == torch.bfloat16
    _assert_tiers_equal(port, ref)
    # Carried across packages (as uint16 bits) it stays bit for bit.
    _assert_tiers_equal(
        convert.tetmesh_from_arrays(convert.mesh_arrays(ref)), ref)


def test_with_lowp_tables_and_to_match_jax():
    jmesh = jax_build_box(1, 1, 1, 4, 4, 4)
    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(jmesh))
    ref = jmesh.with_lowp_tables()
    port = mesh.with_lowp_tables()
    _assert_tiers_equal(port, ref)
    assert port.with_lowp_tables() is port  # idempotent
    # face_normals/face_offsets derive from the refinement tier.
    np.testing.assert_array_equal(port.face_normals.numpy(),
                                  mesh.face_normals.numpy())
    np.testing.assert_array_equal(port.face_offsets.numpy(),
                                  mesh.face_offsets.numpy())
    # astype / to: the two-tier mesh stays two-tier, lo unchanged.
    _assert_tiers_equal(port.to(dtype=torch.float32),
                        ref.astype(jnp.float32))
    # Back to the packed table: the full-precision planes, exact ids.
    packed = port.with_packed_table()
    assert not packed.two_tier
    np.testing.assert_array_equal(packed.walk_table.numpy(),
                                  mesh.walk_table.numpy())


def test_two_tier_exact_id_ceiling_refused(monkeypatch):
    """Neighbour ids ride a float lane: every two-tier build refuses a
    mesh past the exact-id limit (lowered here to 4 so a 6-tet box
    crosses it)."""
    from pumiumtally_tpu_torch.mesh import tetmesh
    from pumiumtally_tpu_torch.parallel import partition

    coords, tet2vert = box_arrays(1, 1, 1, 1, 1, 1)
    mesh = TetMesh.from_arrays(coords, tet2vert, dtype=F64)
    lowp = mesh.with_lowp_tables()
    for mod in (tetmesh, partition):
        monkeypatch.setattr(mod, "exact_id_limit", lambda dtype: 4)
    with pytest.raises(ValueError, match="exact-id limit 4"):
        TetMesh.from_arrays(coords, tet2vert, dtype=F64, table_dtype=BF16)
    with pytest.raises(ValueError, match="exact-id limit 4"):
        mesh.with_lowp_tables()
    with pytest.raises(ValueError, match="exact-id limit 4"):
        lowp.to(dtype=torch.float32)
    with pytest.raises(ValueError, match="exact-id range"):
        build_partition(mesh, 2, table_dtype=BF16)


@pytest.mark.parametrize("ndev", [1, 5])
def test_partition_two_tier_tables_match_jax(ndev):
    jmesh = jax_build_box(1, 1, 1, 4, 4, 4)
    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(jmesh))
    ref = jax_build_partition(jmesh, ndev, table_dtype=BF16)
    port = build_partition(mesh, ndev, table_dtype=BF16)
    assert port.table.dtype == torch.bfloat16
    assert tuple(port.table_hi.shape) == (ndev * port.L * 4, 5)
    p, r = convert.partition_arrays(port), convert.partition_arrays(ref)
    assert set(p) == set(r) and p["table"].dtype == np.uint16
    for k in r:
        np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    # Padding rows keep adjacency -1 (and zero planes).
    pad = np.flatnonzero(p["orig_of_glid"] < 0)
    assert (p["table_hi"].reshape(-1, 4, 5)[pad, :, 4] == -1).all()
    # Carried across packages, bit for bit.
    back = convert.partition_arrays(
        convert.partition_from_arrays(convert.partition_arrays(ref)))
    for k in r:
        np.testing.assert_array_equal(back[k], r[k], err_msg=k)
    with pytest.raises(ValueError, match="force_split_adj"):
        build_partition(mesh, ndev, table_dtype=BF16, force_split_adj=True)


# -- row helpers --------------------------------------------------------------

def test_lift_bf16_is_exact():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 16, 50_000).astype(np.uint16)
    bits = bits[(bits & 0x7F80) != 0x7F80]  # finite values only
    lo = convert.bf16_from_bits(bits)
    want = (bits.astype(np.uint32) << 16).view(np.float32)
    # XLA on the CPU flushes subnormals to zero; table values are O(1).
    normal = (bits & 0x7F80) != 0
    for dt in (torch.float32, F64):
        got = lift_bf16(lo, dt).numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype))
        ref = jax_lift_bf16(
            lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16),
            jnp.float64 if dt == F64 else jnp.float32)
        np.testing.assert_array_equal(got[normal], np.asarray(ref)[normal])


def _rows(seed, n=4000):
    """Real two-tier rows of random elements with points and rays:
    centroid origins, random destinations, ray coordinates part way."""
    jmesh = jax_build_box(1, 1, 1, 4, 4, 4).with_lowp_tables()
    a = convert.mesh_arrays(jmesh)
    rng = np.random.default_rng(seed)
    elem = rng.integers(0, a["tet2vert"].shape[0], n)
    x0 = a["coords"][a["tet2vert"][elem]].mean(axis=1)
    dest = x0 + rng.normal(scale=0.3, size=(n, 3))
    hold = rng.random(n) < 0.05
    dest[hold] = x0[hold]  # holds: no face ahead at all
    s = np.where(rng.random(n) < 0.5, 0.0, rng.uniform(0, 0.6, n))
    f = rng.integers(0, 4, n)
    return dict(lo=a["walk_table_lo"][elem],
                plane=a["walk_table_hi"][elem * 4 + f],
                dest=dest, d0=dest - x0, s=s)


@pytest.mark.parametrize("seed", [1, 2])
def test_select_and_refine_helpers_match_jax(seed):
    r = _rows(seed)
    t = {k: torch.tensor(v) for k, v in r.items() if k != "lo"}
    row = lift_bf16(convert.bf16_from_bits(r["lo"]), F64)
    tol_t = torch.tensor(TOL, dtype=F64)
    s_sel, f_exit = select_rows_lo(row, t["s"], t["dest"], t["d0"], tol_t)
    one = jnp.asarray(1.0, jnp.float64)
    j = {k: jnp.asarray(v) for k, v in r.items() if k != "lo"}
    js_sel, jf_exit = jax_select_rows_lo(
        jnp.asarray(row.numpy()), j["s"], j["dest"], j["d0"], TOL, one)
    np.testing.assert_array_equal(f_exit.numpy(), np.asarray(jf_exit))
    np.testing.assert_allclose(s_sel.numpy(), np.asarray(js_sel), rtol=0,
                               atol=1e-12)
    assert np.isinf(s_sel.numpy()).any()  # holds: nothing ahead
    # Refine the drawn face with the JAX candidate, so both sides start
    # from the same s_sel (inf included).
    s_exit, nxt = refine_plane_hi(t["plane"], t["s"], torch.tensor(
        np.asarray(js_sel)), t["dest"], t["d0"], tol_t)
    js_exit, jnxt = jax_refine_plane_hi(
        j["plane"], j["s"], js_sel, j["dest"], j["d0"], TOL, one)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    np.testing.assert_allclose(s_exit.numpy(), np.asarray(js_exit), rtol=0,
                               atol=1e-12)
    # Faces that are no genuine forward crossing keep the candidate.
    assert (s_exit.numpy() == np.asarray(js_sel)).sum() > 0


# -- W0's two-tier branch -----------------------------------------------------

def _workload(seed, n=800, div=4, spread=0.35):
    jmesh = jax_build_box(1, 1, 1, div, div, div).with_lowp_tables()
    arrays = convert.mesh_arrays(jmesh)
    rng = np.random.default_rng(seed)
    elem = rng.integers(0, arrays["tet2vert"].shape[0], n).astype(np.int32)
    x = arrays["coords"][arrays["tet2vert"][elem]].mean(axis=1)
    fly = (rng.random(n) > 0.15).astype(np.int8)
    dest = np.where(fly[:, None] == 1,
                    x + rng.normal(scale=spread, size=(n, 3)), x)
    return jmesh, convert.tetmesh_from_arrays(arrays), dict(
        x=x, elem=elem, dest=dest, fly=fly, w=rng.uniform(0.5, 2.0, n))


@pytest.mark.parametrize("tally", [True, False])
def test_walk_two_tier_matches_jax(tally):
    jmesh, mesh, d = _workload(seed=11)
    assert mesh.two_tier
    r = jax_walk(
        jmesh, *(jnp.asarray(d[k]) for k in ("x", "elem", "dest", "fly",
                                             "w")),
        jnp.zeros((jmesh.nelems,)), tally=tally, tol=TOL, max_iters=4096,
        table_dtype=BF16)
    t = {k: torch.tensor(v) for k, v in d.items()}
    flux = torch.zeros(mesh.nelems, dtype=F64) if tally else None
    p = walk(mesh, t["x"], t["elem"], t["dest"], t["fly"], t["w"], flux,
             tally=tally, tol=TOL, max_iters=4096, table_dtype=BF16)
    for k in ("elem", "done", "exited"):
        np.testing.assert_array_equal(getattr(p, k).numpy(),
                                      np.asarray(getattr(r, k)), err_msg=k)
    for k in ("x", "s"):
        np.testing.assert_allclose(getattr(p, k).numpy(),
                                   np.asarray(getattr(r, k)), rtol=0,
                                   atol=1e-12, err_msg=k)
    if tally:
        np.testing.assert_allclose(p.flux.numpy(), np.asarray(r.flux),
                                   rtol=1e-10, atol=1e-13)
    else:
        assert p.flux is None
    # The JAX walk checks its budget every cond_every (4) steps.
    assert int(p.iters) <= int(r.iters) < int(p.iters) + 4
    assert np.asarray(r.exited).sum() > 0 and np.asarray(r.done).all()
    # On CPU tensors the wrapper is the plain version.
    q = walk_plain(mesh, t["x"], t["elem"], t["dest"], t["fly"], t["w"],
                   torch.zeros(mesh.nelems, dtype=F64) if tally else None,
                   tally=tally, tol=TOL, max_iters=4096)
    for a, b in zip(p[:4], q[:4]):
        assert torch.equal(a, b)


def test_walk_table_dtype_resolves_the_tier():
    jmesh, mesh, d = _workload(seed=12, n=8)
    packed = mesh.with_packed_table()
    t = {k: torch.tensor(v) for k, v in d.items()}
    args = (t["x"], t["elem"], t["dest"], t["fly"], t["w"], None)
    with pytest.raises(ValueError, match="needs the two-tier walk tables"):
        walk(packed, *args, tally=False, tol=TOL, max_iters=8,
             table_dtype=BF16)
    with pytest.raises(ValueError, match="needs the two-tier walk tables"):
        jax_walk(jax_build_box(1, 1, 1, 4, 4, 4),
                          *(jnp.asarray(d[k]) for k in
                            ("x", "elem", "dest", "fly", "w")),
                          jnp.zeros((384,)), tally=False, tol=TOL,
                          max_iters=8, table_dtype=BF16)
    # The float32 tier walks a two-tier mesh's full-precision planes.
    a = walk(mesh, *args, tally=False, tol=TOL, max_iters=64,
             table_dtype="float32")
    b = walk(packed, *args, tally=False, tol=TOL, max_iters=64)
    for x, y in zip(a, b):
        assert x is y is None or torch.equal(x, y)


# -- the PumiTally facade -----------------------------------------------------

def _drive_pair(cfg, n=600, seed=21, mesh_fn=None):
    jmesh = jax_build_box(1, 1, 1, 5, 5, 5)
    if mesh_fn is not None:
        jmesh = mesh_fn(jmesh)
    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(jmesh))
    ref = JaxPumiTally(jmesh, n, JaxTallyConfig(**cfg))
    port = PumiTally(mesh, n, TallyConfig(**cfg), device="cpu")
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.05, 0.95, (n, 3))
    d1 = rng.uniform(0.05, 0.95, (n, 3))
    d2 = np.clip(d1 + rng.normal(scale=0.3, size=(n, 3)), -0.2, 1.2)
    fly = (rng.random(n) > 0.1).astype(np.int8)
    w = rng.uniform(0.5, 2.0, n)
    for t in (ref, port):
        t.CopyInitialPosition(_flat(src))
    for t in (ref, port):
        t.MoveToNextLocation(_flat(src), _flat(d1), fly.copy(), w)
    # The first move stays in the box: its whole track length tallies.
    tallied = (port.flux.sum().item(),
               float((np.linalg.norm(d1 - src, axis=1) * w)[fly == 1].sum()))
    for t in (ref, port):
        t.MoveToNextLocation(None, _flat(d2))
    return ref, port, tallied


def _assert_facades_same(port, ref):
    np.testing.assert_array_equal(port.elem_ids, ref.elem_ids)
    np.testing.assert_allclose(port.positions, ref.positions, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(port.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-13)


def test_pumitally_bf16_matches_jax_and_conserves():
    ref, port, (got, want) = _drive_pair(dict(walk_table_dtype=BF16))
    assert port.mesh.two_tier and ref.mesh.walk_table_lo is not None
    np.testing.assert_allclose(got, want, rtol=1e-9)
    _assert_facades_same(port, ref)
    # Localization and WriteTallyResults read the full-precision planes
    # and volumes, which the two-tier mesh keeps.
    np.testing.assert_array_equal(port.mesh.volumes.numpy(),
                                  np.asarray(ref.mesh.volumes))


def test_pumitally_float32_tier_on_a_two_tier_mesh_matches_jax():
    """A two-tier mesh at the float32 tier walks its full-precision
    planes in both packages."""
    ref, port, _ = _drive_pair(dict(walk_table_dtype="float32"), seed=22,
                               mesh_fn=lambda m: m.with_lowp_tables())
    assert not port.mesh.two_tier
    _assert_facades_same(port, ref)
