"""PyTorch port, cross-session fusion (service/fusion.py) and W0's
segmented commit (``ops.walk.walk(tally_seg=)``), against the JAX
package's tests/test_fusion.py contracts, float64 on the CPU (the
kernels' plain versions), inputs from numpy seeds.

- ``walk(tally_seg=)`` against the JAX ``walk(tally_seg=)`` on the same
  slab: element ids, done and exit flags exact, positions 1e-12
  absolute, each flux segment rtol 1e-10 (a 1e-13 floor); padding rows
  at ``K*E`` dropped; the deterministic commit bitwise the serial
  ``index_add_``; each segment bitwise its population's solo walk.
- fused sessions (mono continue and origin-passing, scoring with a
  sentinel-armed member, streaming chunk-wise with a ragged last chunk)
  BITWISE their port solo runs, with every move coalesced
  (``fusion_stats``) and no fallback; and held to the JAX service's
  sessions on the same campaigns (ids exact, flux and banks rtol 1e-10).
- mixed fusion keys never co-fuse; ``fuse_sessions=False`` is bitwise;
  an error in the middle of a group lands on the failing session only;
  sessions that share a caller mesh share one facade mesh and fuse.
- the scheduler's ``pick_group`` decides as JAX's on a scripted queue.

Waits are bounded (``Future.result(timeout=)``); no sleeps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pumiumtally_tpu as jx
from pumiumtally_tpu.ops.walk import walk as jax_walk
from pumiumtally_tpu.service import (
    DeficitRoundRobinScheduler as JaxScheduler,
)
from pumiumtally_tpu_torch import (
    EnergyFilter,
    PumiTally,
    ScoringSpec,
    SentinelPolicy,
    StreamingTally,
    TallyConfig,
    TallyService,
    build_box,
    convert,
)
from pumiumtally_tpu_torch.ops.walk import walk
from pumiumtally_tpu_torch.service import DeficitRoundRobinScheduler

F64 = torch.float64
N = 96
BATCHES = 2
MOVES = 2
TIMEOUT = 120
BOX = (1.0, 1.0, 1.0, 3, 3, 3)


def _mesh():
    return build_box(*BOX, dtype=F64)


def _campaign(seed, batches=BATCHES, moves=MOVES, n=N):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0.1, 0.9, (n, 3)),
             [rng.uniform(0.1, 0.9, (n, 3)) for _ in range(moves)],
             [rng.uniform(0.1, 1.9, n) for _ in range(moves)])
            for _ in range(batches)]


def _drive_direct(t, work, with_energy=False, with_origins=False):
    for src, dests, energies in work:
        t.CopyInitialPosition(src.reshape(-1).copy())
        prev = src
        for d, e in zip(dests, energies):
            kw = {"energy": e.copy()} if with_energy else {}
            org = prev.reshape(-1).copy() if with_origins else None
            t.MoveToNextLocation(org, d.reshape(-1).copy(), **kw)
            prev = d


def _submit_campaigns(svc, handles, works, with_energy=False,
                      with_origins=False):
    """Every session's whole campaign queued against a STOPPED worker,
    so that the grouping is deterministic once it starts."""
    futs = []
    for b in range(BATCHES):
        for sid, h in handles.items():
            src, dests, energies = works[sid][b]
            futs.append(h.copy_initial_position(src.reshape(-1).copy()))
            prev = src
            for d, e in zip(dests, energies):
                kw = {"energy": e.copy()} if with_energy else {}
                org = prev.reshape(-1).copy() if with_origins else None
                futs.append(h.move(org, d.reshape(-1).copy(), **kw))
                prev = d
    svc.start()
    for f in futs:
        f.result(timeout=TIMEOUT)


def _serve(svc_cls, build, seeds, with_energy, with_origins, fuse=True):
    """One service over len(seeds) sessions; returns each session's
    outputs and the fusion telemetry."""
    svc = svc_cls(autostart=False, fuse_sessions=fuse)
    handles, works = {}, {}
    for i, seed in enumerate(seeds):
        sid = f"s{i}"
        handles[sid] = svc.open_session(build(i), session_id=sid,
                                        max_queue=BATCHES * (MOVES + 2))
        works[sid] = _campaign(seed)
    _submit_campaigns(svc, handles, works, with_energy, with_origins)
    out = {}
    for sid, h in handles.items():
        out[sid] = {"flux": np.asarray(h.flux().result(timeout=TIMEOUT)),
                    "pos": np.asarray(h.tally.positions),
                    "elem": np.asarray(h.tally.elem_ids)}
        if h.tally._scoring is not None:
            out[sid]["bank"] = np.asarray(
                h.score_bank().result(timeout=TIMEOUT))
        if h.tally._sentinel is not None:
            out[sid]["health"] = h.health_report().result(
                timeout=TIMEOUT).as_dict()
    stats = dict(svc.fusion_stats)
    fallbacks = getattr(svc, "fusion_fallbacks", 0)
    svc.shutdown(drain=False, timeout=TIMEOUT)
    return out, stats, fallbacks


def _fused_vs_solo(build, *, with_energy=False, with_origins=False,
                   expect_fused, fuse=True, seeds=(71, 72, 73),
                   jax_build=None):
    """len(seeds) port sessions through one service, each BITWISE its
    port solo run; with ``jax_build``, also held to the JAX service's
    sessions on the same campaigns."""
    out, stats, fallbacks = _serve(TallyService, build, seeds, with_energy,
                                   with_origins, fuse)
    total = len(seeds) * BATCHES * MOVES
    assert fallbacks == 0
    if expect_fused:
        assert stats["fused_moves"] == total, stats
        assert stats["solo_moves"] == 0, stats
    else:
        assert stats["fused_groups"] == 0, stats
        assert stats["solo_moves"] == total, stats
    for i, seed in enumerate(seeds):
        sid = f"s{i}"
        solo = build(i)
        solo._arm_deterministic()  # as the service arms its sessions
        _drive_direct(solo, _campaign(seed), with_energy, with_origins)
        np.testing.assert_array_equal(out[sid]["flux"], solo.flux.numpy(),
                                      err_msg=sid)
        np.testing.assert_array_equal(out[sid]["pos"], solo.positions)
        np.testing.assert_array_equal(out[sid]["elem"], solo.elem_ids)
        if "bank" in out[sid]:
            np.testing.assert_array_equal(out[sid]["bank"],
                                          solo.score_bank.numpy())
        if "health" in out[sid]:
            assert out[sid]["health"] == solo.health_report().as_dict()
    if jax_build is not None:
        ref, jstats, _ = _serve(jx.TallyService, jax_build, seeds,
                                with_energy, with_origins, fuse)
        assert jstats == stats
        for sid in out:
            np.testing.assert_array_equal(out[sid]["elem"], ref[sid]["elem"])
            np.testing.assert_allclose(out[sid]["pos"], ref[sid]["pos"],
                                       rtol=0, atol=1e-12)
            np.testing.assert_allclose(out[sid]["flux"], ref[sid]["flux"],
                                       rtol=1e-10, atol=1e-13)
            if "bank" in out[sid]:
                np.testing.assert_allclose(out[sid]["bank"],
                                           ref[sid]["bank"], rtol=1e-10,
                                           atol=1e-13)
    return stats


# ---------------------------------------------------------------------------
# pick_group (pure scheduler), against JAX's on a scripted queue
# ---------------------------------------------------------------------------

def _script(seed, steps=200):
    rng = np.random.default_rng(seed)
    names = [f"s{i}" for i in range(6)]
    ops = []
    for _ in range(steps):
        costs = {k: (None if rng.random() < 0.3
                     else int(rng.integers(1, 9))) for k in names}
        keys = {k: (None if rng.random() < 0.2
                    else str(rng.integers(0, 2))) for k in names}
        ops.append((costs, keys, int(rng.integers(1, 5)),
                    bool(rng.random() < 0.3)))
    return names, ops


@pytest.mark.parametrize("quantum", [None, 3])
def test_pick_group_decisions_equal_jax(quantum):
    names, ops = _script(5 + (quantum or 0))
    port, ref = (DeficitRoundRobinScheduler(quantum=quantum),
                 JaxScheduler(quantum=quantum))
    for s in (port, ref):
        for k in names:
            s.register(k)
    for costs, keys, window, single in ops:
        for s in (port, ref):
            if single:
                s.__dict__.setdefault("_log", []).append(
                    s.pick(costs.get))
            else:
                s.__dict__.setdefault("_log", []).append(
                    s.pick_group(costs.get, keys.get, window))
        assert port._log[-1] == ref._log[-1]
        assert [port.deficit(k) for k in names] == \
            [ref.deficit(k) for k in names]
    assert any(g and len(g) > 1 for g in port._log if isinstance(g, list))


def test_pick_group_charges_cofused_heads_by_own_cost():
    sched = DeficitRoundRobinScheduler()
    for k in ("a", "b", "c"):
        sched.register(k)
    costs = {"a": 5, "b": 3, "c": 7}
    group = sched.pick_group(costs.get, lambda k: "K", max_group=8)
    assert group == ["a", "b", "c"]
    assert [sched.deficit(k) for k in "abc"] == [2, -3, -7]


# ---------------------------------------------------------------------------
# W0's segmented commit
# ---------------------------------------------------------------------------

def _slab(E, K=3, pad=2, seed=9):
    """K populations of different sizes at element 0's centroid plus
    ``pad`` dead rows (not flying, dest = x, offset K*E)."""
    arrays = convert.mesh_arrays(jx.build_box(*BOX))
    c0 = arrays["coords"][arrays["tet2vert"][0]].mean(axis=0)
    rng = np.random.default_rng(seed)
    sizes = [70, 45, 81][:K]
    n = sum(sizes) + pad
    x = np.broadcast_to(c0, (n, 3)).copy()
    dest = rng.uniform(0.05, 0.95, (n, 3))
    dest[-pad:] = x[-pad:]
    fly = np.ones(n, np.int8)
    fly[-pad:] = 0
    w = rng.uniform(0.5, 1.5, n)
    seg = np.concatenate([np.full(s, k * E, np.int32)
                          for k, s in enumerate(sizes)]
                         + [np.full(pad, K * E, np.int32)])
    return arrays, sizes, dict(x=x, elem=np.zeros(n, np.int32), dest=dest,
                               fly=fly, w=w), seg


def _port_walk(mesh, d, flux, seg=None, sl=slice(None), **kw):
    t = {k: torch.tensor(v[sl]) for k, v in d.items()}
    return walk(mesh, t["x"], t["elem"], t["dest"], t["fly"], t["w"], flux,
                tally=True, tol=1e-8, max_iters=600,
                tally_seg=None if seg is None else torch.tensor(seg), **kw)


@pytest.mark.parametrize("deterministic", [False, True])
def test_walk_tally_seg_matches_jax_and_solo(deterministic):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jmesh = jx.build_box(*BOX)
        E = int(jmesh.nelems)
        arrays, sizes, d, seg = _slab(E)
        mesh = convert.tetmesh_from_arrays(arrays)
        K = len(sizes)
        flux = torch.zeros(K * E, dtype=F64)
        fused = _port_walk(mesh, d, flux, seg, deterministic=deterministic)
        ref = jax_walk(jmesh, *(jnp.asarray(d[k]) for k in
                                ("x", "elem", "dest", "fly", "w")),
                       jnp.zeros(K * E), tally=True, tol=1e-8,
                       max_iters=600, tally_seg=jnp.asarray(seg))
        np.testing.assert_array_equal(fused.elem.numpy(), np.asarray(ref.elem))
        np.testing.assert_array_equal(fused.done.numpy(), np.asarray(ref.done))
        np.testing.assert_array_equal(fused.exited.numpy(),
                                      np.asarray(ref.exited))
        np.testing.assert_allclose(fused.x.numpy(), np.asarray(ref.x),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(flux.numpy(), np.asarray(ref.flux),
                                   rtol=1e-10, atol=1e-13)
        # Each segment is its population's solo walk, bitwise; the pad
        # rows tallied nowhere.
        a = 0
        for k, n in enumerate(sizes):
            solo_flux = torch.zeros(E, dtype=F64)
            solo = _port_walk(mesh, d, solo_flux, sl=slice(a, a + n),
                              deterministic=deterministic)
            assert torch.equal(flux[k * E:(k + 1) * E], solo_flux)
            for f in ("x", "elem", "done", "s"):
                assert torch.equal(getattr(fused, f)[a:a + n],
                                   getattr(solo, f))
            a += n
        assert flux.sum() > 0
        # The atomic and deterministic commits agree bitwise here (one
        # thread: the serial index_add_).
        other = torch.zeros(K * E, dtype=F64)
        _port_walk(mesh, d, other, seg, deterministic=not deterministic)
        assert torch.equal(other, flux)
    finally:
        torch.set_num_threads(threads)


def test_walk_tally_seg_drops_padding_rows_that_move():
    """A padding row that does walk (offset K*E, in flight) tallies
    nowhere: its index lies past the bank."""
    jmesh = jx.build_box(*BOX)
    E = int(jmesh.nelems)
    arrays, sizes, d, seg = _slab(E, K=1, pad=3)
    d["fly"][:] = 1
    d["dest"][-3:] = np.random.default_rng(2).uniform(0.1, 0.9, (3, 3))
    mesh = convert.tetmesh_from_arrays(arrays)
    flux = torch.zeros(E, dtype=F64)
    for det in (False, True):
        flux.zero_()
        _port_walk(mesh, d, flux, seg, deterministic=det)
        solo = torch.zeros(E, dtype=F64)
        _port_walk(mesh, d, solo, sl=slice(0, sizes[0]), deterministic=det)
        assert torch.equal(flux, solo)


def test_walk_tally_seg_refusals():
    arrays, sizes, d, seg = _slab(162)
    mesh = convert.tetmesh_from_arrays(arrays)
    t = {k: torch.tensor(v) for k, v in d.items()}
    with pytest.raises(ValueError, match="tally_seg"):
        walk(mesh, t["x"], t["elem"], t["dest"], t["fly"], t["w"], None,
             tally=False, tol=1e-8, max_iters=10,
             tally_seg=torch.tensor(seg))
    with pytest.raises(ValueError, match="tally_seg"):
        walk(mesh, t["x"], t["elem"], t["dest"], t["fly"], t["w"],
             torch.zeros(3 * 162, dtype=F64), tally=True, tol=1e-8,
             max_iters=10, tally_seg=torch.tensor(seg[:-1]))


# ---------------------------------------------------------------------------
# Fused sessions: bitwise their solo runs, held to the JAX service
# ---------------------------------------------------------------------------

def test_fused_mono_sessions_bitwise_vs_solo_and_jax():
    mesh = _mesh()
    jmesh = jx.build_box(*BOX)

    def build(_i):
        return PumiTally(mesh, N, TallyConfig(check_found_all=False),
                         device="cpu")

    def jbuild(_i):
        return jx.PumiTally(jmesh, N, jx.TallyConfig(check_found_all=False))

    _fused_vs_solo(build, expect_fused=True, jax_build=jbuild)
    _fused_vs_solo(build, with_origins=True, expect_fused=True)


def _spec(pkg):
    return pkg.ScoringSpec(
        filters=[pkg.EnergyFilter(np.array([0.0, 1.0, 2.0]))],
        scores=["flux", "events"])


def test_fused_scoring_and_sentinel_sessions_bitwise_vs_solo_and_jax():
    mesh = _mesh()
    jmesh = jx.build_box(*BOX)

    def build(i):
        kw = {"check_found_all": False,
              "scoring": ScoringSpec(filters=[EnergyFilter(
                  np.array([0.0, 1.0, 2.0]))], scores=["flux", "events"])}
        if i == 1:
            kw["sentinel"] = SentinelPolicy()
        return PumiTally(mesh, N, TallyConfig(**kw), device="cpu")

    def jbuild(i):
        kw = {"check_found_all": False, "scoring": _spec(jx)}
        if i == 1:
            kw["sentinel"] = jx.SentinelPolicy()
        return jx.PumiTally(jmesh, N, jx.TallyConfig(**kw))

    _fused_vs_solo(build, with_energy=True, expect_fused=True,
                   jax_build=jbuild)


def test_fused_streaming_chunkwise_bitwise_vs_solo_and_jax():
    """Chunk-wise fusion with a ragged last chunk (96 over 40: 40/40/16,
    the pad rows grounded) and origin-passing phase A."""
    mesh = _mesh()
    jmesh = jx.build_box(*BOX)

    def build(_i):
        return StreamingTally(mesh, N, chunk_size=40,
                              config=TallyConfig(check_found_all=False),
                              device="cpu")

    def jbuild(_i):
        return jx.StreamingTally(jmesh, N, chunk_size=40,
                                 config=jx.TallyConfig(check_found_all=False))

    _fused_vs_solo(build, expect_fused=True, seeds=(81, 82, 83),
                   jax_build=jbuild)
    _fused_vs_solo(build, with_origins=True, expect_fused=True,
                   seeds=(84, 85))


def test_fused_streaming_scoring_and_sentinel_bitwise_vs_solo():
    mesh = _mesh()

    def build(i):
        kw = {"check_found_all": False,
              "scoring": ScoringSpec(filters=[EnergyFilter(
                  np.array([0.0, 1.0, 2.0]))], scores=["flux", "events"])}
        if i == 1:
            kw["sentinel"] = SentinelPolicy()
        return StreamingTally(mesh, N, chunk_size=40,
                              config=TallyConfig(**kw), device="cpu")

    _fused_vs_solo(build, with_energy=True, expect_fused=True)


def test_mixed_keys_never_cofuse():
    """Other facade kinds, other caller meshes, other scoring statics and
    other chunk grids are other fusion keys: the zoo runs unfused and
    bitwise."""
    mesh_a, mesh_b = _mesh(), _mesh()
    cfg = dict(check_found_all=False)

    def build(i):
        if i == 0:
            return PumiTally(mesh_a, N, TallyConfig(**cfg), device="cpu")
        if i == 1:
            return PumiTally(mesh_b, N, TallyConfig(**cfg), device="cpu")
        if i == 2:
            return PumiTally(mesh_a, N, TallyConfig(
                scoring=ScoringSpec(scores=["flux"]), **cfg), device="cpu")
        if i == 3:
            return StreamingTally(mesh_a, N, chunk_size=32,
                                  config=TallyConfig(**cfg), device="cpu")
        return StreamingTally(mesh_a, N, chunk_size=48,
                              config=TallyConfig(**cfg), device="cpu")

    stats = _fused_vs_solo(build, expect_fused=False,
                           seeds=(91, 92, 93, 94, 95))
    assert stats["fused_groups"] == 0


def test_fuse_off_is_bitwise():
    mesh = _mesh()

    def build(_i):
        return PumiTally(mesh, N, TallyConfig(check_found_all=False),
                         device="cpu")

    _fused_vs_solo(build, expect_fused=False, fuse=False, seeds=(96, 97))


def test_sessions_on_one_caller_mesh_share_one_facade_mesh():
    """The port converts a caller mesh per facade (dtype, device, tier);
    facades built from one caller mesh share the converted object, so
    their fusion keys agree and they hold one copy of the tables."""
    mesh = build_box(*BOX)  # float32 on the CPU: converted for float64
    cfg = TallyConfig(check_found_all=False, dtype=F64)
    a = PumiTally(mesh, N, cfg, device="cpu")
    b = PumiTally(mesh, N, cfg, device="cpu")
    assert a.mesh is b.mesh and a.mesh is not mesh
    assert a._fusion_key() == b._fusion_key() is not None
    c = PumiTally(build_box(*BOX), N, cfg, device="cpu")
    assert c.mesh is not a.mesh and c._fusion_key() != a._fusion_key()

    def build(_i):
        return PumiTally(mesh, N, cfg, device="cpu")

    _fused_vs_solo(build, expect_fused=True, seeds=(98, 99))


def test_mid_group_error_lands_on_failing_session_only():
    mesh = _mesh()

    def build():
        return PumiTally(mesh, N, TallyConfig(check_found_all=False),
                         device="cpu")

    svc = TallyService(autostart=False)
    hs = [svc.open_session(build(), session_id=f"s{i}", max_queue=8)
          for i in range(3)]
    works = [_campaign(61 + i, batches=1) for i in range(3)]
    futs = []
    for i, h in enumerate(hs):
        src, dests, _ = works[i][0]
        if i != 2:  # s2 never sources: its move fails at the stage step
            futs.append(h.copy_initial_position(src.reshape(-1).copy()))
        futs.append(h.move(None, dests[0].reshape(-1).copy()))
    svc.start()
    with pytest.raises(RuntimeError, match="CopyInitialPosition"):
        futs[-1].result(timeout=TIMEOUT)
    for f in futs[:-1]:
        f.result(timeout=TIMEOUT)
    # A read behind the moves in s0's FIFO: the worker updates the
    # telemetry right after it resolves a group's futures.
    hs[0].flux().result(timeout=TIMEOUT)
    assert svc.fusion_stats["fused_groups"] == 1, svc.fusion_stats
    assert svc.fusion_stats["fused_moves"] == 2, svc.fusion_stats
    src2, dests2, _ = works[2][0]
    hs[2].copy_initial_position(src2.reshape(-1).copy())
    hs[2].move(None, dests2[0].reshape(-1).copy())
    fluxes = [h.flux().result(timeout=TIMEOUT) for h in hs]
    svc.shutdown(drain=False, timeout=TIMEOUT)
    for i in range(3):
        solo = build()
        src, dests, _ = works[i][0]
        solo.CopyInitialPosition(src.reshape(-1).copy())
        solo.MoveToNextLocation(None, dests[0].reshape(-1).copy())
        np.testing.assert_array_equal(fluxes[i], solo.flux.numpy(),
                                      err_msg=f"s{i}")


def test_failed_shared_launch_falls_back_solo_and_is_counted(monkeypatch):
    """A failing shared launch re-runs the group solo, with a warning,
    and the service counts the fallback; the sessions still land
    bitwise."""
    from pumiumtally_tpu_torch.service import fusion

    def broken(_live):
        raise RuntimeError("injected launch failure")

    monkeypatch.setattr(fusion, "_pack_and_launch", broken)
    mesh = _mesh()

    def build():
        return PumiTally(mesh, N, TallyConfig(check_found_all=False),
                         device="cpu")

    svc = TallyService(autostart=False)
    hs = [svc.open_session(build(), max_queue=4) for _ in range(2)]
    work = _campaign(41, batches=1, moves=1)
    src, dests, _ = work[0]
    futs = [h.copy_initial_position(src.reshape(-1).copy()) for h in hs]
    futs += [h.move(None, dests[0].reshape(-1).copy()) for h in hs]
    with pytest.warns(UserWarning, match="fused launch failed"):
        svc.start()
        for f in futs:
            f.result(timeout=TIMEOUT)
        fluxes = [h.flux().result(timeout=TIMEOUT) for h in hs]
    assert svc.fusion_fallbacks == 1
    assert svc.fusion_stats["fused_groups"] == 0
    assert svc.fusion_stats["solo_moves"] == 2
    svc.shutdown(drain=False, timeout=TIMEOUT)
    solo = build()
    _drive_direct(solo, work)
    for f in fluxes:
        np.testing.assert_array_equal(f, solo.flux.numpy())
