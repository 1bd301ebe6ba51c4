"""PyTorch port, the partitioned engine across devices and the collective
migration (the port's counterpart of tests/test_distributed.py:101-440),
on eight CPU shards (``make_device_mesh(8, devices=[cpu] * 8)``):

- ``make_collective_migrate`` and ``make_collective_frontier_migrate``
  bitwise equal to the scatter (``migrate``, ``_frontier_migrate_impl``,
  and the shard-level ``migrate_shards`` / ``frontier_migrate_shards``):
  every lane and dtype, the overflow latch, the departure/arrival
  counts, each shard's work list; both partition methods; the commit
  and the overflow arms;
- the engine with the collective (run in one process) bitwise the
  engine's row copies (flux, positions, ids, banks), composed with
  ``cap_frontier`` (including 0 and slab overflow); within one process
  ``migrate_collective=True`` keeps the row copies;
- the 8-shard engine against the JAX ``PartitionedPumiTally`` on its
  8-device mesh (W4, W1 and W2 configurations): ids and positions exact,
  flux rtol 1e-10; ``device_groups`` 2 and 4 against JAX;
- checkpoint / resume of the 8-shard facade, both packages reading each
  other's generation;
- ``init_distributed``'s argument checks and the byte models;
- a real two-process job (two ranks of four CPU shards over gloo, this
  file as the worker): process 0's fetched results bitwise equal to the
  one-process eight-shard run."""

import argparse
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from pumiumtally_tpu_torch import (
    CheckpointPolicy,
    EnergyFilter,
    PartitionedPumiTally,
    PumiTally,
    ScoringSpec,
    StreamingPartitionedTally,
    TallyConfig,
    build_box,
    convert,
)
from pumiumtally_tpu_torch.parallel import make_device_mesh
from pumiumtally_tpu_torch.parallel.distributed import (
    UNAVAILABLE_EXIT_CODE,
    UNAVAILABLE_MARKER,
    DistributedUnavailableError,
    ShardComm,
    assert_collectives_available,
    fetch_global,
    init_distributed,
    make_collective_frontier_migrate,
    make_collective_migrate,
    modeled_migration_collective_bytes,
    state_pack_columns,
)
from pumiumtally_tpu_torch.parallel.partition import (
    _frontier_migrate_impl,
    _shard_work,
    assemble_state,
    frontier_migrate_shards,
    migrate,
    migrate_shards,
    split_state,
)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The two-process campaign of the JAX package's tests/test_distributed.py.
N2P = 256
BOX2P = (1, 1, 1, 3, 3, 3)
ARMS = ("sharded", "partitioned", "partitioned_scoring")


def _mesh8():
    return make_device_mesh(8, devices=[CPU] * 8)


def _mkstate(rng, cap, part_L, pending):
    return {
        "x": torch.as_tensor(rng.standard_normal((cap, 3))),
        "lelem": torch.as_tensor(rng.integers(0, part_L, cap),
                                 dtype=torch.int32),
        "pending": torch.as_tensor(pending, dtype=torch.int32),
        "pid": torch.arange(cap, dtype=torch.int32),
        "alive": torch.as_tensor(rng.random(cap) < 0.3),
        "done": torch.as_tensor(rng.random(cap) < 0.5),
        "exited": torch.as_tensor(rng.random(cap) < 0.1),
        "lost": torch.zeros(cap, dtype=torch.bool),
        "dest": torch.as_tensor(rng.standard_normal((cap, 3))),
        "fly": torch.as_tensor(rng.integers(0, 2, cap), dtype=torch.int8),
        "w": torch.as_tensor(rng.random(cap)),
        "sbin": torch.as_tensor(rng.integers(0, 4, cap), dtype=torch.int32),
        "sfac": torch.as_tensor(rng.random((cap, 3))),
    }


def _assert_states(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


# -- collective migration vs the scatter --------------------------------------

@pytest.mark.parametrize("method", ["rank", "argsort"])
def test_collective_migrate_bitwise_vs_scatter(method):
    dm = _mesh8()
    bpc, cap_b, part_L = 2, 5, 7
    nparts = 8 * bpc
    cap = nparts * cap_b
    rng = np.random.default_rng(0)
    coll = make_collective_migrate(dm, part_L=part_L, nparts=nparts,
                                   cap_per_block=cap_b,
                                   partition_method=method)
    pend = np.full(cap, -1)
    pend[rng.choice(cap, 8, replace=False)] = rng.integers(0, nparts * part_L,
                                                           8)
    for st, overflow in ((_mkstate(rng, cap, part_L, pend), False),
                         (_mkstate(rng, cap, part_L, np.zeros(cap)), True)):
        ref, ovf_ref = migrate(part_L, nparts, cap_b, st)
        assert ovf_ref is overflow
        for fn in (coll, lambda s: migrate_shards(part_L, nparts, cap_b, s)):
            got, ovf = fn(split_state(st, dm.devices))
            assert ovf is overflow
            _assert_states(ref, assemble_state(got, CPU))


@pytest.mark.parametrize("method", ["rank", "argsort"])
def test_collective_frontier_migrate_bitwise(method):
    dm = _mesh8()
    bpc, cap_b, part_L, cf = 2, 5, 7, 16
    nparts = 8 * bpc
    cap = nparts * cap_b
    n_loc = cap // 8
    coll = make_collective_frontier_migrate(
        dm, part_L=part_L, nparts=nparts, cap_per_block=cap_b,
        cap_frontier=cf, partition_method=method)
    rng = np.random.default_rng(0)

    def check(st, overflow):
        ref, ovf_r, dep_r, arr_r, work_r = _frontier_migrate_impl(
            part_L, nparts, cap_b, cf, st)
        assert ovf_r is overflow
        for fn in (coll, lambda s: frontier_migrate_shards(
                part_L, nparts, cap_b, cf, s)):
            got, ovf, dep, arr, works = fn(split_state(st, dm.devices))
            assert ovf is overflow
            assert dep.dtype == dep_r.dtype and torch.equal(dep, dep_r)
            assert torch.equal(arr, arr_r)
            _assert_states(ref, assemble_state(got, CPU))
            if overflow:
                assert works is None
                continue
            for i, (ids, n_w) in enumerate(works):
                want = _shard_work(work_r[0], work_r[1], i * n_loc, n_loc)
                assert torch.equal(ids[:int(n_w)], want[0]), i

    pend = np.full(cap, -1)
    pend[rng.choice(cap, 8, replace=False)] = rng.integers(0, nparts * part_L,
                                                           8)
    check(_mkstate(rng, cap, part_L, pend), overflow=False)
    pend = np.full(cap, -1)
    pend[rng.choice(cap, cf, replace=False)] = 3
    st = _mkstate(rng, cap, part_L, pend)
    st["alive"] = torch.ones(cap, dtype=torch.bool)
    check(st, overflow=True)


def test_collective_refuses_bad_geometry():
    dm = _mesh8()
    with pytest.raises(ValueError, match="not divisible"):
        make_collective_migrate(dm, part_L=4, nparts=3, cap_per_block=5)
    with pytest.raises(ValueError, match="cap_frontier"):
        make_collective_frontier_migrate(dm, part_L=4, nparts=8,
                                         cap_per_block=5, cap_frontier=0)


# -- the engine: collective on/off, cap_frontier composition ------------------

def _frontier_arrays(n=1200, seed=3):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.05, 0.95, (n, 3)) * np.array([2.0, 1.0, 1.0])
    d1 = np.clip(src + rng.normal(scale=0.3, size=(n, 3)), 0.01, 0.99)
    d1[:, 0] = np.clip(src[:, 0] + rng.normal(scale=0.6, size=n), 0.02, 1.98)
    d2 = d1.copy()
    d2[:, 0] = np.clip(d1[:, 0] + rng.normal(scale=0.6, size=n), 0.02, 1.98)
    fly = (rng.uniform(size=n) > 0.1).astype(np.int8)
    w = rng.uniform(0.5, 2.0, n)
    return src, d1, d2, fly, w


def _run(t, src, d1, d2, fly, w, energy=None):
    kw = {} if energy is None else {"energy": energy}
    n = len(w)
    t.CopyInitialPosition(src.reshape(-1).copy())
    t.MoveToNextLocation(None, d1.reshape(-1).copy(), fly.copy(), w, **kw)
    t.MoveToNextLocation(None, d2.reshape(-1).copy(), np.ones(n, np.int8), w,
                         **kw)
    return t


def _assert_same_run(a, b, bank=False):
    np.testing.assert_array_equal(a.elem_ids, b.elem_ids)
    np.testing.assert_array_equal(a.positions, b.positions)
    assert torch.equal(a.flux, b.flux)
    if bank:
        assert torch.equal(a.score_bank, b.score_bank)


def _ring(t):
    """Run facade ``t``'s migrations through the collective in this one
    process (its engine path across processes)."""
    t.engine._ring_in_process = True
    t.engine._build_collective_fns()
    assert t.engine._collective_migrate is not None
    return t


def _spec():
    return ScoringSpec(filters=[EnergyFilter([0.0, 1.0, 2.0])],
                       scores=["flux", "events"])


@pytest.mark.parametrize("kw", [
    {}, dict(cap_frontier=1024), dict(cap_frontier=8), dict(cap_frontier=0),
    dict(scoring=True), dict(scoring=True, cap_frontier=1024),
    dict(walk_vmem_max_elems=40),
])
def test_engine_collective_bitwise_the_scatter(kw):
    mesh = build_box(2, 1, 1, 8, 4, 4, dtype=torch.float64)
    arrays = _frontier_arrays(600)
    n = len(arrays[-1])
    kw = dict(kw)
    energy = None
    if kw.pop("scoring", False):
        kw["scoring"] = _spec()
        energy = np.where(np.arange(n) % 2 == 0, 0.5, 1.5)
    out = []
    for coll in (False, True):
        t = PartitionedPumiTally(mesh, n, TallyConfig(
            device_mesh=_mesh8(), migrate_collective=coll, **kw),
            device="cpu")
        # One process keeps the row copies whatever the knob says; the
        # collective's engine path runs here only when asked for.
        assert t.engine._collective_migrate is None
        if coll:
            _ring(t)
        out.append(_run(t, *arrays, energy=energy))
    _assert_same_run(*out, bank=energy is not None)
    if kw.get("cap_frontier") == 0:
        # cap_frontier=0 is the full-capacity migrate every round.
        full = _run(_ring(PartitionedPumiTally(mesh, n, TallyConfig(
            device_mesh=_mesh8()), device="cpu")), *arrays)
        _assert_same_run(out[1], full)
    if kw.get("cap_frontier") == 8:
        assert out[1].engine.last_fallback_rounds > 0


# -- the engine against the JAX package ---------------------------------------

def _jax_pair(box, n, jkw, pkw=None):
    from pumiumtally_tpu import PartitionedPumiTally as JaxPartitioned
    from pumiumtally_tpu import TallyConfig as JaxTallyConfig
    from pumiumtally_tpu.mesh.box import build_box as jax_build_box
    from pumiumtally_tpu.parallel import make_device_mesh as jax_device_mesh

    jm = jax_build_box(*box)
    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(jm))
    ref = JaxPartitioned(jm, n, JaxTallyConfig(
        device_mesh=jax_device_mesh(8), **jkw))
    port = PartitionedPumiTally(mesh, n, TallyConfig(
        device_mesh=_mesh8(), **(jkw if pkw is None else pkw)), device="cpu")
    return ref, port


@pytest.mark.parametrize("jkw", [
    {},  # W4, one block a shard
    dict(walk_vmem_max_elems=40),  # W1, sub-split blocks
    dict(migrate_collective=True, cap_frontier=512),
])
def test_engine_8_shards_matches_jax(jkw):
    n = 300
    ref, port = _jax_pair((1, 1, 1, 4, 4, 4), n, jkw)
    assert (port.engine.nparts, port.engine.part.L,
            port.engine.cap_per_block) == (ref.engine.nparts,
                                           ref.engine.part.L,
                                           ref.engine.cap_per_block)
    rng = np.random.default_rng(5)
    arrays = (rng.uniform(0.05, 0.95, (n, 3)), rng.uniform(0.05, 0.95, (n, 3)),
              rng.uniform(0.05, 0.95, (n, 3)),
              (rng.uniform(size=n) > 0.1).astype(np.int8),
              rng.uniform(0.5, 2.0, n))
    _run(ref, *arrays)
    _run(port, *arrays)
    np.testing.assert_array_equal(port.elem_ids, np.asarray(ref.elem_ids))
    np.testing.assert_array_equal(port.positions, np.asarray(ref.positions))
    np.testing.assert_allclose(port.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-14)


def test_engine_8_shards_twotier_pallas_matches_jax():
    """W2's configuration (bf16 tables, walk_kernel="pallas") over the
    shards against JAX's (its Pallas kernel in interpret mode)."""
    n = 96
    kw = dict(walk_table_dtype="bfloat16", walk_kernel="pallas",
              walk_vmem_max_elems=60)
    ref, port = _jax_pair((1, 1, 1, 3, 3, 3), n, kw)
    assert port.engine.use_pallas_walk and port.engine.blocks_per_chip >= 1
    rng = np.random.default_rng(8)
    arrays = tuple(rng.uniform(0.05, 0.95, (n, 3)) for _ in range(3)) + (
        np.ones(n, np.int8), rng.uniform(0.5, 2.0, n))
    _run(ref, *arrays)
    _run(port, *arrays)
    np.testing.assert_array_equal(port.elem_ids, np.asarray(ref.elem_ids))
    np.testing.assert_array_equal(port.positions, np.asarray(ref.positions))
    np.testing.assert_allclose(port.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("groups", [2, 4])
def test_device_groups_match_jax(groups):
    from pumiumtally_tpu import StreamingPartitionedTally as JaxSPT
    from pumiumtally_tpu import TallyConfig as JaxTallyConfig
    from pumiumtally_tpu.mesh.box import build_box as jax_build_box
    from pumiumtally_tpu.parallel import make_device_mesh as jax_device_mesh

    n, chunk = 96, 24
    jm = jax_build_box(1, 1, 1, 2, 2, 2)
    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(jm))
    ref = JaxSPT(jm, n, chunk, JaxTallyConfig(
        device_mesh=jax_device_mesh(8), device_groups=groups))
    port = StreamingPartitionedTally(mesh, n, chunk, TallyConfig(
        device_mesh=_mesh8(), device_groups=groups), device="cpu")
    sizes = [e.ndev for e in port.engines]
    assert sizes == [8 // groups] * port.nchunks
    assert [e.devices for e in port.engines[:groups]] == [
        _mesh8().devices[g * 8 // groups:(g + 1) * 8 // groups]
        for g in range(groups)]
    rng = np.random.default_rng(4)
    arrays = tuple(rng.uniform(0.05, 0.95, (n, 3)) for _ in range(3)) + (
        np.ones(n, np.int8), rng.uniform(0.5, 2.0, n))
    _run(ref, *arrays)
    _run(port, *arrays)
    np.testing.assert_array_equal(port.elem_ids, np.asarray(ref.elem_ids))
    np.testing.assert_array_equal(port.positions, np.asarray(ref.positions))
    np.testing.assert_allclose(port.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-14)


def test_partitioned_8_shards_checkpoint_resume_and_packages(tmp_path):
    """``checkpoint_now`` / ``resume_latest`` on the 8-shard facade
    resume bitwise on the same mesh; the JAX 8-device facade reads the
    port's generation and the port reads JAX's."""
    from pumiumtally_tpu import PartitionedPumiTally as JaxPartitioned
    from pumiumtally_tpu import TallyConfig as JaxTallyConfig
    from pumiumtally_tpu.mesh.box import build_box as jax_build_box
    from pumiumtally_tpu.parallel import make_device_mesh as jax_device_mesh
    from pumiumtally_tpu.resilience import CheckpointPolicy as JaxPolicy

    jm = jax_build_box(1, 1, 1, 3, 3, 3)
    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(jm))
    n = 120
    src, d1, d2, fly, w = _frontier_arrays(n, 6)
    src[:, 0] /= 2.0

    def port(d):
        # Provisioned so that no capacity escalation reshapes the slots
        # (a fresh engine then takes the layout-exact restore).
        return PartitionedPumiTally(mesh, n, TallyConfig(
            device_mesh=_mesh8(), capacity_factor=4.0,
            checkpoint=CheckpointPolicy(dir=str(d), handle_signals=False)),
            device="cpu")

    full = _run(port(tmp_path / "full"), src, d1 / 2, d2 / 2, fly, w)
    a = port(tmp_path / "a")
    a.CopyInitialPosition(src.reshape(-1).copy())
    a.MoveToNextLocation(None, (d1 / 2).reshape(-1).copy(), fly.copy(), w)
    a.checkpoint_now()
    b = port(tmp_path / "a")
    assert b.resume_latest() is not None
    b.MoveToNextLocation(None, (d2 / 2).reshape(-1).copy(),
                         np.ones(n, np.int8), w)
    _assert_same_run(b, full)
    j = JaxPartitioned(jm, n, JaxTallyConfig(
        device_mesh=jax_device_mesh(8), capacity_factor=4.0,
        checkpoint=JaxPolicy(dir=str(tmp_path / "a"),
                             handle_signals=False)))
    assert j.resume_latest() is not None
    np.testing.assert_array_equal(np.asarray(j.positions), a.positions)
    np.testing.assert_array_equal(np.asarray(j.elem_ids), a.elem_ids)
    np.testing.assert_array_equal(np.asarray(j.flux), a.flux.numpy())
    j.checkpoint_now()
    c = port(tmp_path / "a")
    assert c.resume_latest() is not None
    np.testing.assert_array_equal(c.positions, a.positions)
    np.testing.assert_array_equal(c.flux.numpy(), a.flux.numpy())


# -- front door and byte models -----------------------------------------------

def test_init_distributed_validates_arguments():
    with pytest.raises(ValueError, match="num_processes"):
        init_distributed(coordinator_address="127.0.0.1:1234")
    with pytest.raises(ValueError, match="coordinator_address"):
        init_distributed(num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="process_id must be in"):
        init_distributed("127.0.0.1:1234", 2, 2)
    with pytest.raises(ValueError, match="num_processes must be"):
        init_distributed("127.0.0.1:1234", 0, 0)
    # One process: nothing to probe; the marker and code are JAX's.
    assert_collectives_available(_mesh8())
    assert (UNAVAILABLE_EXIT_CODE, UNAVAILABLE_MARKER) == (
        77, "DISTRIBUTED-UNAVAILABLE")
    assert issubclass(DistributedUnavailableError, RuntimeError)


class _FakeDist:
    """A joined two-process job whose probe fails as ``error`` says."""

    def __init__(self, error=None, gloo=True):
        self.error, self.gloo = error, gloo

    def is_available(self):
        return True

    def is_initialized(self):
        return True

    def get_backend(self):
        return "gloo"

    def is_gloo_available(self):
        return self.gloo

    def get_world_size(self):
        return 2

    def all_reduce(self, v):
        if self.error is not None:
            raise self.error
        v *= 2


@pytest.mark.parametrize("case", ["peer_lost", "no_gloo", "ok"])
def test_collectives_probe_fails_loudly(monkeypatch, case):
    """Only a missing backend is DISTRIBUTED-UNAVAILABLE; a gloo job that
    breaks (a lost peer, a closed connection) raises as it is, so a
    broken two-process run fails instead of skipping."""
    from pumiumtally_tpu_torch.parallel import distributed
    from pumiumtally_tpu_torch.parallel.device import DeviceMesh

    fake = {"peer_lost": _FakeDist(RuntimeError(
                "[../third_party/gloo/gloo/transport/tcp/pair.cc:534] "
                "Connection closed by peer")),
            "no_gloo": _FakeDist(gloo=False),
            "ok": _FakeDist()}[case]
    monkeypatch.setattr(distributed, "_dist", lambda: fake)
    dm = DeviceMesh((CPU, CPU), ranks=(0, 1), rank=0)
    if case == "peer_lost":
        with pytest.raises(RuntimeError, match="Connection closed") as e:
            assert_collectives_available(dm)
        assert not isinstance(e.value, DistributedUnavailableError)
    elif case == "no_gloo":
        with pytest.raises(DistributedUnavailableError,
                           match=UNAVAILABLE_MARKER):
            assert_collectives_available(dm)
    else:
        assert_collectives_available(dm)


def test_fetch_global_and_byte_models():
    a = np.arange(6.0)
    assert fetch_global(a) is a
    np.testing.assert_array_equal(fetch_global(torch.arange(6.0)), a)
    st = _mkstate(np.random.default_rng(1), 80, 7, np.full(80, -1))
    fcols, icols = state_pack_columns(st)
    assert (fcols, icols) == (10, 9)
    got = modeled_migration_collective_bytes(80, 8, fcols, icols)
    n_loc = 80 // 8
    assert got == 7 * n_loc * 4 + 7 * (n_loc * (10 * 8 + 9 * 4 + 4))
    from pumiumtally_tpu.parallel.distributed import (
        modeled_migration_collective_bytes as jax_bytes,
    )

    assert got == jax_bytes(80, 8, fcols, icols)


def test_one_process_comm_paths():
    comm = ShardComm(_mesh8())
    parts = {i: torch.full((3,), float(i)) for i in range(8)}
    assert [float(t[0]) for t in comm.all_gather(parts)] == list(range(8))
    got = comm.ring_shift({i: (t,) for i, t in parts.items()})
    assert [float(got[i][0][0]) for i in range(8)] == [7.0] + list(range(7))
    assert comm.host_copies == 0 and comm.sum_int(5) == 5


# -- the real two-process job -------------------------------------------------

def build_tally(arm, dm):
    """One campaign arm's facade on mesh ``dm`` (the JAX two-process
    test's arms)."""
    mesh = build_box(*BOX2P, dtype=torch.float64)
    if arm == "sharded":
        return PumiTally(mesh, N2P, TallyConfig(device_mesh=dm,
                                                check_found_all=False),
                         device="cpu")
    kw = dict(device_mesh=dm, check_found_all=False, capacity_factor=8.0,
              migrate_collective=True)
    if arm == "partitioned_scoring":
        kw["scoring"] = _spec()
    return PartitionedPumiTally(mesh, N2P, TallyConfig(**kw), device="cpu")


def run_campaign(t, arm):
    rng = np.random.default_rng(42)
    src, d1, d2 = (rng.uniform(0.1, 0.9, (N2P, 3)) for _ in range(3))
    w = rng.uniform(0.5, 2.0, N2P)
    kw = {}
    if arm == "partitioned_scoring":
        kw["energy"] = np.where(np.arange(N2P) % 2 == 0, 0.5, 1.5)
    t.CopyInitialPosition(src.reshape(-1).copy())
    for d in (d1, d2):
        t.MoveToNextLocation(None, d.reshape(-1).copy(),
                             np.ones(N2P, np.int8), w, **kw)


def collect(t, arm):
    out = {"flux": fetch_global(t.flux), "positions": t.positions,
           "elem_ids": t.elem_ids}
    if arm == "partitioned_scoring":
        out["score_bank"] = fetch_global(t.score_bank)
    return out


def _worker(argv=None):
    """One rank of the two-process job: four CPU shards, every arm."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    try:
        dm = init_distributed(f"127.0.0.1:{args.port}", 2, args.rank,
                              local_devices=[CPU] * 4)
        assert_collectives_available(dm)
    except DistributedUnavailableError as e:
        print(e, flush=True)
        raise SystemExit(UNAVAILABLE_EXIT_CODE)
    assert dm.size == 8 and dm.local == tuple(range(4 * args.rank,
                                                    4 * args.rank + 4))
    payload = {}
    for arm in ARMS:
        t = build_tally(arm, dm)
        run_campaign(t, arm)
        payload.update({f"{arm}/{k}": v for k, v in collect(t, arm).items()})
    if args.rank == 0:
        np.savez(args.out, **payload)
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"rank {args.rank}: OK", flush=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_bitwise_parity(tmp_path):
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_gloo_available()):
        pytest.skip(UNAVAILABLE_MARKER)
    out = tmp_path / "rank0.npz"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               PUMIUMTALLY_COORD_TIMEOUT="60", OMP_NUM_THREADS="1")
    for _attempt in range(3):
        port = _free_port()
        logs = [tempfile.TemporaryFile(mode="w+") for _ in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--port", str(port), "--out", str(out)],
            env=env, cwd=REPO, stdout=logs[r], stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        try:
            rcs = [p.wait(timeout=180) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        text = []
        for log in logs:
            log.seek(0)
            text.append(log.read())
            log.close()
        if "address already in use" in "".join(text).lower():
            continue
        break
    # gloo is present (checked above), so a rank that exits with the
    # unavailable code is a failure, not a skip.
    for r, (rc, t) in enumerate(zip(rcs, text)):
        assert rc == 0, f"rank {r} rc={rc}:\n{t[-3000:]}"
    got = np.load(out)
    for arm in ARMS:
        t = build_tally(arm, _mesh8())
        run_campaign(t, arm)
        for k, v in collect(t, arm).items():
            np.testing.assert_array_equal(got[f"{arm}/{k}"], v,
                                          err_msg=f"{arm}/{k}")


if __name__ == "__main__":
    _worker()
