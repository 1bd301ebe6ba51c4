"""PyTorch port, the partitioned facade on one device: the port's
``PartitionedPumiTally`` (block walk W1 + migration) against the JAX
package's with ``make_device_mesh(1)`` and the vmem block walk, on a
small box with a small block bound so there are several blocks and
migrations; plus the migration and bucket primitives and the config
refusals.

Tolerances, float64: element ids and every integer slot row exact;
positions to 1e-12 absolute; flux to rtol 1e-10."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pumiumtally_tpu import PartitionedPumiTally as JaxPartitioned
from pumiumtally_tpu import TallyConfig as JaxTallyConfig
from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu.ops.bucketize import (
    counting_ranks as jax_counting_ranks,
    partition_perm as jax_partition_perm,
)
from pumiumtally_tpu.parallel import make_device_mesh
from pumiumtally_tpu.parallel.partition import _migrate_impl
from pumiumtally_tpu_torch import (
    PartitionedPumiTally,
    TallyConfig,
    convert,
)
from pumiumtally_tpu_torch.ops.bucketize import counting_ranks, partition_perm
from pumiumtally_tpu_torch.parallel.partition import (
    OVERFLOW_MESSAGE,
    migrate,
)

N = 300
BOUND = 40  # 384 tets -> 10 blocks of <= 39 elements
INT_ROWS = ("lelem", "pending", "pid", "alive", "done", "exited", "lost",
            "fly")


def _flat(a):
    return np.ascontiguousarray(np.asarray(a, np.float64).reshape(-1))


def _pair(bound=BOUND, capacity_factor=2.0):
    jmesh = jax_build_box(1, 1, 1, 4, 4, 4)
    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(jmesh))
    ref = JaxPartitioned(jmesh, N, JaxTallyConfig(
        device_mesh=make_device_mesh(1), capacity_factor=capacity_factor,
        walk_vmem_max_elems=bound))
    port = PartitionedPumiTally(mesh, N, TallyConfig(
        capacity_factor=capacity_factor, walk_vmem_max_elems=bound),
        device="cpu")
    return ref, port


def _assert_same(port, ref, slots=True):
    np.testing.assert_array_equal(port.elem_ids, ref.elem_ids)
    np.testing.assert_allclose(port.positions, ref.positions, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(port.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-13)
    if slots:  # the slot layout is the JAX engine's, slot by slot
        ps, rs = convert.facade_state(port), convert.facade_state(ref)
        for k in INT_ROWS:
            np.testing.assert_array_equal(ps[k], rs[k], err_msg=k)
        np.testing.assert_allclose(ps["x"], rs["x"], rtol=0, atol=1e-12)


def test_partitioned_facade_matches_jax(tmp_path):
    ref, port = _pair()
    eng, jeng = port.engine, ref.engine
    assert (eng.nparts, eng.part.L, eng.cap_per_block) == \
        (jeng.nparts, jeng.part.L, jeng.cap_per_block)
    assert eng.nparts == 10 and jeng.use_vmem_walk
    rng = np.random.default_rng(0)
    src = rng.uniform(0.05, 0.95, (N, 3))
    d1 = rng.uniform(0.05, 0.95, (N, 3))
    d1[::7] = rng.uniform(-0.2, 1.2, (len(d1[::7]), 3))  # some exit
    d2 = rng.uniform(0.05, 0.95, (N, 3))
    fly = (rng.random(N) > 0.1).astype(np.int8)
    w = rng.uniform(0.5, 2.0, N)
    for t in (ref, port):
        t.CopyInitialPosition(_flat(src))
    _assert_same(port, ref)
    for t in (ref, port):
        t.MoveToNextLocation(_flat(src), _flat(d1), fly.copy(), w)
    _assert_same(port, ref)
    assert eng.last_walk_rounds == jeng.last_walk_rounds > 2
    for t in (ref, port):
        t.MoveToNextLocation(None, _flat(d2))
    _assert_same(port, ref)
    assert port.lost_particles == ref.lost_particles == 0
    # Rank-aware output: one piece for the one device, same bytes as
    # the JAX writer once the flux is the same.
    convert.load_facade_state(port, convert.facade_state(ref))
    for t, name in ((ref, "jax.pvtu"), (port, "port.pvtu")):
        t.WriteTallyResults(str(tmp_path / name))
    assert (tmp_path / "jax_p0.vtu").read_bytes() == \
        (tmp_path / "port_p0.vtu").read_bytes()


def test_partitioned_conserves_and_revives_lost():
    """Sources outside the box are lost (excluded from transport, id -1)
    in both packages; a later two-phase move with in-box origins revives
    them."""
    ref, port = _pair()
    rng = np.random.default_rng(3)
    src = rng.uniform(0.05, 0.95, (N, 3))
    src[:5] += 2.0  # in no element
    for t in (ref, port):
        t.CopyInitialPosition(_flat(src))
    assert port.lost_particles == ref.lost_particles == 5
    assert (port.elem_ids[:5] == -1).all()
    d1 = rng.uniform(0.05, 0.95, (N, 3))
    origins = src.copy()
    origins[:5] -= 2.0
    for t in (ref, port):
        t.MoveToNextLocation(_flat(origins), _flat(d1),
                             np.ones(N, np.int8), np.ones(N))
    _assert_same(port, ref, slots=False)
    assert port.engine.n_lost == 0
    np.testing.assert_allclose(
        port.flux.sum().item(),
        np.linalg.norm(d1 - origins, axis=1).sum(), rtol=1e-10,
    )


def test_migrate_matches_jax_and_keeps_state_on_overflow():
    rng = np.random.default_rng(1)
    nparts, L, cap_b = 4, 8, 6
    cap = nparts * cap_b
    alive = rng.random(cap) < 0.7
    st = {
        "x": rng.normal(size=(cap, 3)),
        "lelem": rng.integers(0, L, cap).astype(np.int32),
        "pending": np.where(rng.random(cap) < 0.4,
                            rng.integers(0, nparts * L, cap), -1
                            ).astype(np.int32),
        "pid": np.where(alive, np.arange(cap), -1).astype(np.int32),
        "alive": alive, "done": ~alive,
        "fly": rng.integers(0, 2, cap).astype(np.int8),
        "w": rng.random(cap),
    }
    want, ovf = _migrate_impl(L, nparts, cap_b,
                              {k: jnp.asarray(v) for k, v in st.items()})
    got, ovf_p = migrate(L, nparts, cap_b,
                         {k: torch.tensor(v) for k, v in st.items()})
    assert bool(ovf) == ovf_p
    for k in st:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # Everyone targets block 0: overflow keeps the old state verbatim.
    st["pending"] = np.zeros(cap, np.int32)
    t_st = {k: torch.tensor(v) for k, v in st.items()}
    got, ovf_p = migrate(L, nparts, cap_b, t_st)
    assert ovf_p is True and got is t_st


@pytest.mark.parametrize("num_buckets", [2, 3, 11])
def test_bucket_partition_matches_jax(num_buckets):
    key = np.random.default_rng(num_buckets).integers(0, num_buckets, 500)
    perm, counts, starts = partition_perm(torch.tensor(key), num_buckets)
    jperm, jcounts, jstarts = jax_partition_perm(jnp.asarray(key),
                                                 num_buckets)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
    np.testing.assert_array_equal(
        counting_ranks(torch.tensor(key), num_buckets).numpy(),
        np.asarray(jax_counting_ranks(jnp.asarray(key), num_buckets)),
    )


def test_capacity_overflow_raises_over_intact_state():
    """Every particle heading into one corner overflows its block's
    slots: the port raises the JAX package's message (its recovery
    ladder is not ported) with the pre-migration state kept."""
    jmesh = jax_build_box(1, 1, 1, 4, 4, 4)
    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(jmesh))
    n = 2500
    t = PartitionedPumiTally(mesh, n, TallyConfig(
        capacity_factor=1.01, walk_vmem_max_elems=BOUND), device="cpu")
    assert t.engine.cap_per_block < n
    src = np.random.default_rng(13).uniform(0.05, 0.95, (n, 3))
    t.CopyInitialPosition(_flat(src))
    with pytest.raises(RuntimeError, match=OVERFLOW_MESSAGE[:30]):
        t.MoveToNextLocation(None, _flat(np.tile([0.02] * 3, (n, 1))))
    assert int(t.engine.state["alive"].sum()) == n


def test_config_subset_and_refusals():
    with pytest.raises(TypeError):
        TallyConfig(cap_frontier=4)  # a knob the port does not have
    for kw in ({"walk_kernel": "pallas"}, {"walk_block_kernel": "gather"},
               {"walk_table_dtype": "bfloat16"}, {"scoring": object()},
               {"dtype": torch.bfloat16}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TallyConfig(**kw)
    with pytest.raises(ValueError):
        TallyConfig(localization="bogus")
    mesh = convert.tetmesh_from_arrays(
        convert.mesh_arrays(jax_build_box(1, 1, 1, 2, 2, 2)))
    with pytest.raises(NotImplementedError, match="gather walk"):
        PartitionedPumiTally(mesh, 8, TallyConfig(), device="cpu")
    cfg = TallyConfig()
    assert cfg.resolved_tolerance(torch.float64) == 1e-8
    assert cfg.resolved_tolerance(torch.float32) == 1e-6
    assert cfg.resolved_max_iters(100) == 164
