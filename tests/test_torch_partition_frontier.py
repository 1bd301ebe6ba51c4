"""PyTorch port, the partitioned engine around the gather block walk:
the frontier-slab migrate, the incremental occupied-block counts, the
overflow-recovery ladder and its poisoned latch, the phase diagnostics
and ``PhaseProfile``, against the JAX package on the CPU in float64
(mirroring tests/test_partition_frontier.py and
tests/test_blocked_gather.py).

Tolerances: migrated rows, slot rows, ids, counters and diagnostics
exact; positions within 1e-12 of the JAX engine's; flux within rtol
1e-10 of it (the summation order differs) and, between two port
engines whose rounds differ only in their slot layout, rtol 1e-12."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pumiumtally_tpu import PartitionedPumiTally as JaxPartitioned
from pumiumtally_tpu import TallyConfig as JaxTallyConfig
from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu.parallel import make_device_mesh
from pumiumtally_tpu.parallel import partition as jax_partition
from pumiumtally_tpu.parallel.partition import PhaseProfile as JaxProfile
from pumiumtally_tpu.sentinel.policy import POISONED_MESSAGE as JAX_POISONED
from pumiumtally_tpu_torch import (
    EnginePoisonedError,
    PartitionedPumiTally,
    StreamingPartitionedTally,
    TallyConfig,
    convert,
)
from pumiumtally_tpu_torch.api.tally import POISONED_MESSAGE
from pumiumtally_tpu_torch.parallel import partition
from pumiumtally_tpu_torch.parallel.partition import (
    LADDER_EXHAUSTED_MESSAGE,
    PhaseProfile,
    _frontier_migrate_impl,
    _grow_state,
    _occupancy_counts,
    migrate,
)

INT_ROWS = ("lelem", "pending", "pid", "alive", "done", "exited", "lost",
            "fly")
_JMESH = jax_build_box(1, 1, 1, 6, 6, 6)  # 1,296 tets
_MESH = convert.tetmesh_from_arrays(convert.mesh_arrays(_JMESH))


def _flat(a):
    return np.ascontiguousarray(np.asarray(a, np.float64).reshape(-1))


def _clustered_workload(n=800, seed=21, moves=2):
    """Corner-clustered sources and destinations on a finely blocked
    mesh: several migration rounds with a small crossing front."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.05, 0.30, (n, 3))
    return src, [rng.uniform(0.05, 0.30, (n, 3)) for _ in range(moves)]


def _pair(n, bound=100, **knobs):
    """The JAX and port facades on the 6^3 box, gather sub-split."""
    kw = dict(walk_vmem_max_elems=bound, walk_block_kernel="gather", **knobs)
    ref = JaxPartitioned(_JMESH, n, JaxTallyConfig(
        device_mesh=make_device_mesh(1), **kw))
    port = PartitionedPumiTally(_MESH, n, TallyConfig(**kw), device="cpu")
    return ref, port


def _drive(ts, src, dsts):
    for t in ts:
        t.CopyInitialPosition(_flat(src))
        for d in dsts:
            t.MoveToNextLocation(None, _flat(d))


def _assert_same(port, ref):
    np.testing.assert_array_equal(port.elem_ids, np.asarray(ref.elem_ids))
    np.testing.assert_allclose(port.positions, np.asarray(ref.positions),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(port.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-13)
    ps, rs = convert.facade_state(port), convert.facade_state(ref)
    for k in INT_ROWS:
        np.testing.assert_array_equal(ps[k], rs[k], err_msg=k)
    np.testing.assert_allclose(ps["x"], rs["x"], rtol=0, atol=1e-12)


def _diagnostics(eng):
    return (eng.last_walk_rounds, eng.last_block_dispatches,
            eng.last_frontier_max, eng.last_frontier_mean,
            eng.last_fallback_rounds)


# -- the frontier-slab migrate ------------------------------------------------

def _migrate_state(rng, nparts, cap_b, part_L, everyone_to=None):
    cap = nparts * cap_b
    alive = rng.uniform(size=cap) < 0.6
    pend = np.full(cap, -1, np.int32)
    movers = alive & (rng.uniform(size=cap) < 0.2)
    pend[movers] = (rng.integers(0, nparts * part_L, movers.sum())
                    if everyone_to is None else everyone_to)
    return {
        "x": rng.random((cap, 3)),
        "w": rng.random(cap),
        "lelem": rng.integers(0, part_L, cap).astype(np.int32),
        "pending": pend,
        "pid": np.where(alive, np.arange(cap), -1).astype(np.int32),
        "alive": alive,
        "done": rng.uniform(size=cap) < 0.5,
        "fly": rng.integers(0, 2, cap).astype(np.int8),
    }


@pytest.mark.parametrize("case", ["spread", "slab_of_eight", "overflow"])
def test_frontier_migrate_impl_matches_jax(case):
    """Every row, the overflow flag and the departure/arrival counts
    equal the JAX function's: stayers in place, departures reset,
    arrivals in their target block's free slots in stable order; on
    overflow the old state comes back."""
    nparts, cap_b, part_L = 5, 16, 50
    rng = np.random.default_rng(11)
    st = _migrate_state(rng, nparts, cap_b, part_L,
                        everyone_to=7 if case == "overflow" else None)
    cap = nparts * cap_b
    slab = 8 if case == "slab_of_eight" else cap
    n_move = int((st["pending"] >= 0).sum())
    if case == "slab_of_eight":
        # The caller's guarantee: the front fits the slab.
        keep = np.flatnonzero(st["pending"] >= 0)[8:]
        st["pending"][keep] = -1
        n_move = 8
    want = jax_partition._frontier_migrate_impl(
        part_L, nparts, cap_b, slab, {k: jnp.asarray(v) for k, v in st.items()})
    t_st = {k: torch.tensor(v) for k, v in st.items()}
    got = _frontier_migrate_impl(part_L, nparts, cap_b, slab, t_st)
    assert got[1] == bool(want[1]) == (case == "overflow")
    for k in st:
        np.testing.assert_array_equal(got[0][k].numpy(),
                                      np.asarray(want[0][k]), err_msg=k)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    if case == "overflow":
        assert got[0] is t_st
    else:
        assert int(got[2].sum()) == int(got[3].sum()) == n_move
    # The same overflow condition as the full migrate.
    assert migrate(part_L, nparts, cap_b, dict(t_st))[1] == got[1]


def test_grow_state_matches_jax():
    nparts, old_cb, new_cb = 3, 7, 12
    rng = np.random.default_rng(4)
    st = _migrate_state(rng, nparts, old_cb, 10)
    want = jax_partition._grow_state(
        {k: jnp.asarray(v) for k, v in st.items()}, old_cb, new_cb, nparts)
    got = _grow_state({k: torch.tensor(v) for k, v in st.items()}, old_cb,
                      new_cb, nparts)
    for k in st:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# -- cap_frontier through the engine ------------------------------------------

@pytest.mark.parametrize("cap_frontier", [None, 0, 90, "cap"])
def test_cap_frontier_matches_jax_and_default(cap_frontier):
    """Each slab setting against the JAX engine with the same setting
    (slot rows, fallback rounds and the other diagnostics exact), and
    against the port's default engine: positions and ids bitwise, flux
    to summation order. None never counts a fallback, 0 counts every
    migration round, a slab of 90 falls back only on larger fronts and
    a slab of the capacity never."""
    n = 800
    src, dsts = _clustered_workload(n, seed=23)
    cf = 10**9 if cap_frontier == "cap" else cap_frontier
    ref, port = _pair(n, capacity_factor=20.0, cap_frontier=cf)
    base = PartitionedPumiTally(_MESH, n, TallyConfig(
        walk_vmem_max_elems=100, walk_block_kernel="gather",
        capacity_factor=20.0), device="cpu")
    _drive((ref, port, base), src, dsts)
    _assert_same(port, ref)
    eng = port.engine
    assert eng.cap_frontier == ref.engine.cap_frontier
    assert _diagnostics(eng) == _diagnostics(ref.engine)
    migrations = eng.last_walk_rounds - 1
    assert migrations >= 1
    fallbacks = {None: 0, 0: migrations, "cap": 0}.get(cap_frontier)
    if fallbacks is not None:
        assert eng.last_fallback_rounds == fallbacks
    else:
        assert 0 < eng.last_fallback_rounds < migrations
    np.testing.assert_array_equal(port.positions, base.positions)
    np.testing.assert_array_equal(port.elem_ids, base.elem_ids)
    np.testing.assert_allclose(port.flux.numpy(), base.flux.numpy(),
                               rtol=1e-12, atol=1e-14)


def test_incremental_occupancy_equals_full_scan(monkeypatch):
    """The occupied-block counts carried by departure/arrival deltas
    equal a full scan of ``done`` after every frontier round, and the
    gather sub-split dispatches exactly the default engine's (and the
    JAX engine's) blocks, fewer than a full sweep."""
    checked = []
    update = partition._update_occupancy

    def checking(nparts, cap_frontier, state, n_act, dep, arr, fellback):
        got = update(nparts, cap_frontier, state, n_act, dep, arr, fellback)
        assert torch.equal(got, _occupancy_counts(state["done"], nparts))
        checked.append(fellback)
        return got

    monkeypatch.setattr(partition, "_update_occupancy", checking)
    n = 800
    src, dsts = _clustered_workload(n, seed=21)
    ref, port = _pair(n, capacity_factor=20.0, cap_frontier=4096)
    base = PartitionedPumiTally(_MESH, n, TallyConfig(
        walk_vmem_max_elems=100, walk_block_kernel="gather",
        capacity_factor=20.0), device="cpu")
    _drive((ref, port, base), src, dsts)
    # Frontier rounds of the slab engine were checked (the default
    # engine's full-migrate rounds recount anyway).
    assert False in checked
    eng = port.engine
    assert eng.nparts >= 8
    assert (eng.last_walk_rounds, eng.last_block_dispatches) == \
        (base.engine.last_walk_rounds, base.engine.last_block_dispatches) == \
        (ref.engine.last_walk_rounds, ref.engine.last_block_dispatches)
    assert eng.last_walk_rounds <= eng.last_block_dispatches \
        < eng.last_walk_rounds * eng.nparts


# -- the overflow-recovery ladder ---------------------------------------------

@pytest.mark.parametrize("cap_frontier", [4096, None])
def test_overflow_ladder_recovers_like_jax(cap_frontier):
    """Every particle converging into one corner overflows a block with
    capacity_factor 1.3: the ladder (full-migrate retry, escalation by
    demand) completes the move with the JAX engine's slot rows,
    recoveries and escalations."""
    n = 600
    rng = np.random.default_rng(3)
    src = rng.uniform(0.05, 0.95, (n, 3))
    dst = rng.uniform(0.02, 0.12, (n, 3))
    ref, port = _pair(n, capacity_factor=1.3, cap_frontier=cap_frontier)
    _drive((ref, port), src, [dst])
    _assert_same(port, ref)
    eng, jeng = port.engine, ref.engine
    assert eng.overflow_recoveries >= 1 and eng.capacity_escalations >= 1
    assert (eng.overflow_recoveries, eng.capacity_escalations,
            eng.cap_per_block, eng.capacity_factor) == \
        (jeng.overflow_recoveries, jeng.capacity_escalations,
         jeng.cap_per_block, jeng.capacity_factor)
    assert not eng.poisoned
    assert _diagnostics(eng) == _diagnostics(jeng)
    np.testing.assert_allclose(port.flux.sum().item(),
                               np.linalg.norm(dst - src, axis=1).sum(),
                               rtol=1e-10)


def test_localization_overflow_escalates_like_jax():
    """Every source in one block with slots for a fraction of them:
    one demand-sized escalation places them, as in the JAX engine."""
    jmesh = jax_build_box(1, 1, 1, 4, 4, 4)
    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(jmesh))
    n = 40
    src = np.random.default_rng(5).uniform(0.02, 0.10, (n, 3))
    kw = dict(walk_vmem_max_elems=40, walk_block_kernel="gather",
              capacity_factor=1.0)
    ref = JaxPartitioned(jmesh, n, JaxTallyConfig(
        device_mesh=make_device_mesh(1), **kw))
    port = PartitionedPumiTally(mesh, n, TallyConfig(**kw), device="cpu")
    for t in (ref, port):
        t.CopyInitialPosition(_flat(src))
    _assert_same(port, ref)
    assert port.engine.capacity_escalations == \
        ref.engine.capacity_escalations == 1
    assert port.engine.overflow_recoveries == \
        ref.engine.overflow_recoveries == 1


def test_exhausted_ladder_poisons_and_refuses(tmp_path):
    """With the escalation disabled the ladder exhausts: the engine
    fires ``on_poisoned``, latches ``poisoned`` and raises the JAX
    package's message; every later facade call refuses with the copied
    poisoned message, the streaming facade's too."""
    jmesh = jax_build_box(1, 1, 1, 4, 4, 4)
    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(jmesh))
    n = 40
    rng = np.random.default_rng(7)
    src = rng.uniform(0.1, 0.9, (n, 3))
    corner = rng.uniform(0.02, 0.10, (n, 3))
    t = PartitionedPumiTally(mesh, n, TallyConfig(
        walk_vmem_max_elems=40, walk_block_kernel="gather",
        capacity_factor=1.3, check_found_all=False), device="cpu")
    fired = []
    t.engine.on_poisoned = lambda: fired.append(True)
    t.engine._escalate_capacity = lambda *a, **k: None
    with pytest.raises(RuntimeError) as exc:
        t.CopyInitialPosition(_flat(src))
        t.MoveToNextLocation(None, _flat(corner))
    assert str(exc.value) == LADDER_EXHAUSTED_MESSAGE == \
        jax_partition.LADDER_EXHAUSTED_MESSAGE
    assert t.engine.poisoned and fired == [True]
    assert POISONED_MESSAGE == JAX_POISONED
    with pytest.raises(EnginePoisonedError, match="resume from checkpoint"):
        t.MoveToNextLocation(None, _flat(corner))
    with pytest.raises(EnginePoisonedError):
        t.CopyInitialPosition(_flat(src))
    for name in ("refused.vtk", "refused.pvtu"):
        with pytest.raises(EnginePoisonedError):
            t.WriteTallyResults(str(tmp_path / name))
        assert not (tmp_path / name).exists()
    sp = StreamingPartitionedTally(mesh, n, chunk_size=20, device="cpu")
    sp.CopyInitialPosition(_flat(src))
    sp.engines[1].poisoned = True
    with pytest.raises(EnginePoisonedError, match="corrupt"):
        sp.MoveToNextLocation(None, _flat(corner))
    with pytest.raises(EnginePoisonedError):
        sp.CopyInitialPosition(_flat(src))


# -- diagnostics and the profiled phases -------------------------------------

def test_frontier_diagnostics_match_jax():
    n = 800
    src, dsts = _clustered_workload(n, seed=37, moves=1)
    ref, port = _pair(n, capacity_factor=20.0, cap_frontier=4096)
    _drive((ref, port), src, dsts)
    eng = port.engine
    assert _diagnostics(eng) == _diagnostics(ref.engine)
    migrations = eng.last_walk_rounds - 1
    assert migrations >= 1 and eng.last_frontier_max >= 1
    assert 0.0 < eng.last_frontier_mean <= eng.last_frontier_max
    assert eng.last_frontier_mean * migrations == pytest.approx(
        eng._last_frontier_sum)


@pytest.mark.parametrize("bound", [100, None])
def test_profiled_move_bitwise_and_budget(bound):
    """A profiled move runs a plain move's rounds: flux, positions and
    every slot row bitwise, every budget section populated, the JAX
    ``as_dict`` keys, and the last_* diagnostics kept."""
    n = 800
    src, dsts = _clustered_workload(n, seed=41)

    def run(profile):
        t = PartitionedPumiTally(_MESH, n, TallyConfig(
            walk_vmem_max_elems=bound, walk_block_kernel="gather",
            capacity_factor=20.0, cap_frontier=4096), device="cpu")
        t.CopyInitialPosition(_flat(src))
        for d in dsts:
            dt = t.engine.state["x"].dtype
            t.engine.move(None, torch.tensor(d, dtype=dt),
                          torch.ones(n, dtype=torch.int8),
                          torch.ones(n, dtype=dt), profile=profile)
        return t

    prof = PhaseProfile()
    t_prof, t_plain = run(prof), run(None)
    assert torch.equal(t_prof.flux, t_plain.flux)
    for k, v in t_plain.engine.state.items():
        assert torch.equal(t_prof.engine.state[k], v), k
    assert _diagnostics(t_prof.engine) == _diagnostics(t_plain.engine)
    assert prof.rounds >= len(dsts)
    assert prof.dispatches >= prof.rounds
    assert prof.walk_s > 0 and prof.occupancy_s > 0
    assert prof.bookkeeping_s > 0
    assert len(prof.frontier_sizes) == prof.rounds - len(dsts)
    assert prof.fallback_rounds == 0
    if bound is not None:
        assert prof.rounds >= 2 and prof.migrate_s > 0
        assert prof.frontier_max == max(prof.frontier_sizes)
    d = prof.as_dict()
    assert sorted(d) == sorted(JaxProfile().as_dict())
    assert d["cap_frontier"] == 4096 and d["rounds"] == prof.rounds


def test_cap_frontier_config_and_conversion():
    with pytest.raises(ValueError, match="cap_frontier"):
        TallyConfig(cap_frontier=-1)
    assert TallyConfig(cap_frontier=0).cap_frontier == 0
    assert TallyConfig().cap_frontier is None
    cfg = convert.tally_config(JaxTallyConfig(cap_frontier=4096,
                                              walk_block_kernel="gather"))
    assert cfg.cap_frontier == 4096 and cfg.walk_block_kernel == "gather"
    assert cfg.resolved_walk_kernel() == "gather"
