"""PyTorch port, the partitioned facade on one device: the port's
``PartitionedPumiTally`` (block walk W1 + migration) against the JAX
package's with ``make_device_mesh(1)`` and the vmem block walk, on a
small box with a small block bound so there are several blocks and
migrations; plus the migration and bucket primitives, the overflow
ladder on W1 and the config subset and refusals.

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
    EnergyFilter,
    PartitionedPumiTally,
    ScoringSpec,
    TallyConfig,
    convert,
)
from pumiumtally_tpu_torch.ops.bucketize import counting_ranks, partition_perm
from pumiumtally_tpu_torch.parallel.partition import (
    PartitionedEngine,
    build_partition,
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
    slots: the recovery ladder (full-migrate retry, capacity escalation)
    completes the move over the intact pre-migration state, every
    particle alive at the corner and the track length conserved."""
    jmesh = jax_build_box(1, 1, 1, 4, 4, 4)
    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(jmesh))
    n = 2500
    t = PartitionedPumiTally(mesh, n, TallyConfig(
        capacity_factor=1.01, walk_vmem_max_elems=BOUND), device="cpu")
    assert t.engine.cap_per_block < n and t.engine.use_vmem_walk
    src = np.random.default_rng(13).uniform(0.05, 0.95, (n, 3))
    t.CopyInitialPosition(_flat(src))
    corner = np.tile([0.02] * 3, (n, 1))
    t.MoveToNextLocation(None, _flat(corner))
    eng = t.engine
    assert eng.overflow_recoveries >= 1 and eng.capacity_escalations >= 1
    assert not eng.poisoned and eng.cap_per_block > n // 2
    assert int(eng.state["alive"].sum()) == n
    np.testing.assert_array_equal(t.positions, corner)
    # The corner lies on the cell diagonal: tets that share it tie.
    assert len(set(t.elem_ids.tolist())) <= 6 and (t.elem_ids >= 0).all()
    np.testing.assert_allclose(t.flux.sum().item(),
                               np.linalg.norm(corner - src, axis=1).sum(),
                               rtol=1e-10)


def test_config_subset_and_refusals():
    with pytest.raises(TypeError):
        TallyConfig(no_such_knob=True)  # a knob neither package has
    gather = TallyConfig(walk_block_kernel="gather", cap_frontier=64)
    assert gather.resolved_walk_kernel() == "gather"
    assert gather.cap_frontier == 64
    # A scoring value that is no ScoringSpec: the JAX package's refusal.
    with pytest.raises(ValueError, match="scoring must be a "
                       "scoring.ScoringSpec"):
        TallyConfig(scoring=object())
    # Scoring on the float32 block tables reroutes to the gather block
    # walk, as the JAX engine does.
    spec = ScoringSpec([EnergyFilter([0.0, 1.0])])
    small = convert.tetmesh_from_arrays(convert.mesh_arrays(
        jax_build_box(1, 1, 1, 2, 2, 2)))
    t = PartitionedPumiTally(small, 8, TallyConfig(
        scoring=spec, walk_vmem_max_elems=BOUND), device="cpu")
    assert t.engine.block_kernel == "gather"
    assert not t.engine.use_vmem_walk
    # A bf16 WORKING dtype stays refused; the bf16 table tier is
    # walk_table_dtype, which both facades accept.
    with pytest.raises(NotImplementedError, match="walk_table_dtype"):
        TallyConfig(dtype=torch.bfloat16)
    # The pallas block walk is two-tier only: the JAX package's message.
    with pytest.raises(ValueError, match="needs the bf16 select tier"):
        TallyConfig(walk_kernel="pallas")
    with pytest.raises(ValueError, match="needs the bf16 select tier"):
        TallyConfig(walk_kernel="pallas", walk_table_dtype="float32")
    bf16 = TallyConfig(walk_table_dtype="bfloat16", walk_kernel="pallas")
    assert bf16.resolved_table_dtype() == "bfloat16"
    assert bf16.resolved_walk_kernel() == "pallas"
    assert TallyConfig().resolved_walk_kernel() == "vmem"
    with pytest.raises(ValueError):
        TallyConfig(localization="bogus")
    # No bound: one block, walked by the gather block walk.
    t = PartitionedPumiTally(small, 8, TallyConfig(), device="cpu")
    assert t.engine.nparts == 1 and not t.engine.use_vmem_walk
    # bf16 tables with the vmem block walk reroute to the gather walk.
    t = PartitionedPumiTally(small, 8, TallyConfig(
        walk_table_dtype="bfloat16", walk_vmem_max_elems=4), device="cpu")
    assert t.engine.block_kernel == "gather" and t.engine.nparts > 1
    # The sidecar: never with the two-tier tables (so never under the
    # pallas block walk), and a vmem sub-split that needs it refuses.
    with pytest.raises(ValueError, match="incompatible"):
        build_partition(small, 4, force_split_adj=True,
                        table_dtype="bfloat16")
    with pytest.raises(ValueError, match="sub-split"):
        PartitionedEngine(small, 8, tol=1e-8, max_iters=64,
                          vmem_walk_max_elems=BOUND,
                          part=build_partition(small, 4,
                                               force_split_adj=True))
    cfg = TallyConfig()
    assert cfg.resolved_tolerance(torch.float64) == 1e-8
    assert cfg.resolved_tolerance(torch.float32) == 1e-6
    assert cfg.resolved_max_iters(100) == 164
