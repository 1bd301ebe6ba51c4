"""PyTorch port, the multi-session service (service/): the counterparts of
tests/test_service.py and the admission half of tests/test_traffic.py
on the port's facades, float64 on the CPU (the kernels' plain versions),
inputs from numpy seeds.

- the lifecycle (OPEN -> DRAINING -> CLOSED, idempotent close, id
  generation), backpressure (``ServiceBusyError``), the admission budget
  (``ServiceOverloadedError``) and the drain (``ServiceDrainingError``):
  the same exception types and messages as the JAX service in the same
  situations, and no side effect of a refused op;
- submit-time validation with the facades' argument-naming errors,
  execution errors on the failing op's future only, reads in the
  session's FIFO;
- concurrent sessions (client threads) each bitwise their solo runs;
- a SIGTERM drain (the service owns the handler through
  ``resilience.install_drain_owner``) writes one generation per session
  that the JAX package's ``resume_latest`` reads back exactly, and that
  a port facade resumes bitwise.

Waits are bounded (``Future.result(timeout=)``, ``join(timeout=)``);
no sleeps."""

import os
import signal
import threading

import numpy as np
import pytest
import torch

import pumiumtally_tpu as jx
from pumiumtally_tpu.resilience import CheckpointPolicy as JaxPolicy
from pumiumtally_tpu.resilience import resume_latest as jax_resume_latest
from pumiumtally_tpu.service import ServiceOverloadedError as JaxOverloaded
from pumiumtally_tpu_torch import (
    CheckpointPolicy,
    PumiTally,
    ServiceBusyError,
    SessionClosedError,
    SessionState,
    StreamingTally,
    TallyConfig,
    TallyService,
    build_box,
    resume_latest,
)
from pumiumtally_tpu_torch.service import (
    ServiceDrainingError,
    ServiceOverloadedError,
)

F64 = torch.float64
N = 64
BATCHES = 2
MOVES = 2
TIMEOUT = 120
BOX = (1.0, 1.0, 1.0, 3, 3, 3)


def _mesh():
    return build_box(*BOX, dtype=F64)


def _campaign(seed, batches=BATCHES, moves=MOVES, n=N):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0.1, 0.9, (n, 3)),
             [rng.uniform(0.1, 0.9, (n, 3)) for _ in range(moves)])
            for _ in range(batches)]


def _drive_direct(t, work):
    for src, dests in work:
        t.CopyInitialPosition(src.reshape(-1).copy())
        for d in dests:
            t.MoveToNextLocation(None, d.reshape(-1).copy())


def _mono(mesh, n=N, **cfg):
    cfg.setdefault("check_found_all", False)
    return PumiTally(mesh, n, TallyConfig(**cfg), device="cpu")


def _solo_flux(mesh, work):
    t = _mono(mesh)
    _drive_direct(t, work)
    return t.flux.numpy()


def _refusal(fn):
    with pytest.raises(Exception) as ei:
        fn()
    return type(ei.value).__name__, str(ei.value)


# ---------------------------------------------------------------------------
# Backpressure, admission, validation, errors
# ---------------------------------------------------------------------------

def test_backpressure_busy_without_corrupting_state():
    """The (k+1)-th submit against a stopped worker refuses with
    ServiceBusyError, the caller's flying buffer untouched; after the
    worker starts the campaign lands bitwise on the solo run."""
    mesh = _mesh()
    work = _campaign(7, batches=1)
    src, dests = work[0]
    svc = TallyService(autostart=False)
    h = svc.open_session(_mono(mesh), max_queue=2)
    f1 = h.copy_initial_position(src.reshape(-1).copy())
    f2 = h.move(None, dests[0].reshape(-1).copy())
    flying = np.ones(N, np.int8)
    with pytest.raises(ServiceBusyError):
        h.move(None, dests[1].reshape(-1).copy(), flying=flying)
    assert flying.sum() == N and h.tally.iter_count == 0
    svc.start()
    f1.result(timeout=TIMEOUT)
    f2.result(timeout=TIMEOUT)
    h.move(None, dests[1].reshape(-1).copy(),
           flying=flying).result(timeout=TIMEOUT)
    assert flying.sum() == 0
    flux = h.flux().result(timeout=TIMEOUT)
    svc.shutdown(drain=False, timeout=TIMEOUT)
    np.testing.assert_array_equal(flux, _solo_flux(mesh, work))


def _refusals(pkg, mesh, facade):
    """The busy, overloaded, closed and draining refusals of one
    package's service, as (type name, message) pairs."""
    out = []
    svc = pkg.TallyService(autostart=False, admission_budget=2 * N)
    h = svc.open_session(facade(mesh), session_id="s0", max_queue=1)
    src = np.full(3 * N, 0.5)
    h.copy_initial_position(src.copy())
    out.append(_refusal(lambda: h.copy_initial_position(src.copy())))
    h2 = svc.open_session(facade(mesh), session_id="s1", max_queue=4)
    h2.copy_initial_position(src.copy())
    out.append(_refusal(lambda: h2.move(None, src.copy())))
    out.append(_refusal(lambda: svc.open_session(facade(mesh))))
    h2.close()
    out.append(_refusal(lambda: h2.flux()))
    svc.request_drain()
    out.append(_refusal(lambda: svc.open_session(facade(mesh))))
    out.append(_refusal(lambda: h.flux()))
    svc.shutdown(drain=False, timeout=TIMEOUT)
    return out


def test_refusals_match_the_jax_service():
    port = _refusals(
        __import__("pumiumtally_tpu_torch"), _mesh(),
        lambda m: PumiTally(m, N, TallyConfig(check_found_all=False),
                            device="cpu"))
    ref = _refusals(
        jx, jx.build_box(*BOX),
        lambda m: jx.PumiTally(m, N, jx.TallyConfig(check_found_all=False)))
    assert [p[0] for p in port] == [
        "ServiceBusyError", "ServiceOverloadedError",
        "ServiceOverloadedError", "SessionClosedError",
        "ServiceDrainingError", "ServiceDrainingError"]
    assert port == ref


def test_admission_refusal_is_stateless_and_recovers():
    mesh = _mesh()
    svc = TallyService(autostart=False, admission_budget=N + 10)
    try:
        h = svc.open_session(_mono(mesh), session_id="s0", max_queue=8)
        (src, dests), = _campaign(11, batches=1)
        h.copy_initial_position(src.reshape(-1).copy())
        flying = np.ones(N, np.int8)
        with pytest.raises(ServiceOverloadedError) as ei:
            h.move(None, dests[0].reshape(-1).copy(), flying=flying)
        assert isinstance(ei.value, ServiceOverloadedError)
        assert not isinstance(ei.value, JaxOverloaded)
        assert (ei.value.budget, ei.value.admitted, ei.value.cost) == \
            (N + 10, N, N)
        np.testing.assert_array_equal(flying, np.ones(N, np.int8))
        st = svc.stats()
        assert st["admission"]["refused_ops"] == 1
        assert st["admission"]["queued_cost"] == N
        assert st["sessions"]["s0"]["pending"] == 1
        f_flux = h.flux()  # reads are never refused
        svc.start()
        f_flux.result(timeout=TIMEOUT)
        fut = h.move(None, dests[0].reshape(-1).copy(), flying=flying)
        assert flying.sum() == 0
        fut.result(timeout=TIMEOUT)
        h.move(None, dests[1].reshape(-1).copy()).result(timeout=TIMEOUT)
        got = h.flux().result(timeout=TIMEOUT)
        assert svc.stats()["admission"]["admitted_cost"] == 0
    finally:
        svc.shutdown(drain=False, timeout=TIMEOUT)
    np.testing.assert_array_equal(got, _solo_flux(mesh, [(src, dests)]))


def test_submit_validation_raises_before_queueing():
    mesh = _mesh()
    work = _campaign(9, batches=1)
    src, dests = work[0]
    with TallyService() as svc:
        h = svc.open_session(_mono(mesh), max_queue=4)
        h.copy_initial_position(src.reshape(-1).copy()).result(
            timeout=TIMEOUT)
        bad = dests[0].reshape(-1).copy()
        bad[5] = np.nan
        with pytest.raises(ValueError, match="destinations"):
            h.move(None, bad)
        with pytest.raises(ValueError, match="flying"):
            h.move(None, dests[0].reshape(-1).copy(),
                   flying=np.ones(3, np.int8))
        with pytest.raises(ValueError, match="energy"):
            h.move(None, dests[0].reshape(-1).copy(), energy=np.ones(N))
        assert h.pending == 0
        for d in dests:
            h.move(None, d.reshape(-1).copy())
        flux = h.flux().result(timeout=TIMEOUT)
    np.testing.assert_array_equal(flux, _solo_flux(mesh, work))


def test_float32_overflow_refuses_at_submit():
    """A float64 value past float32's range refuses at submit on a
    float32 session (the working-dtype arm), as in the JAX service."""
    mesh = build_box(*BOX)
    with TallyService() as svc:
        h = svc.open_session(_mono(mesh), max_queue=4)
        bad = np.full(3 * N, 0.5)
        bad[7] = 1e300
        with pytest.raises(ValueError, match="destinations"):
            h.move(None, bad)
        assert h.pending == 0


def test_execution_error_propagates_and_session_survives():
    mesh = _mesh()
    work = _campaign(11, batches=1, moves=1)
    src, dests = work[0]
    with TallyService() as svc:
        h = svc.open_session(_mono(mesh), max_queue=4)
        h.copy_initial_position(src.reshape(-1).copy())
        bad = h.close_batch()  # no batch_stats on this facade
        good = h.move(None, dests[0].reshape(-1).copy())
        with pytest.raises(RuntimeError, match="batch statistics"):
            bad.result(timeout=TIMEOUT)
        good.result(timeout=TIMEOUT)
        flux = h.flux().result(timeout=TIMEOUT)
    np.testing.assert_array_equal(flux, _solo_flux(mesh, work))


# ---------------------------------------------------------------------------
# Lifecycle, FIFO reads, concurrency
# ---------------------------------------------------------------------------

def test_session_lifecycle():
    mesh = _mesh()
    with TallyService() as svc:
        h = svc.open_session(_mono(mesh, 16), max_queue=4)
        assert h.state is SessionState.OPEN
        first = h.close()
        assert h.close() is first
        assert first.result(timeout=TIMEOUT) is None  # no policy armed
        assert h.state is SessionState.CLOSED and h.close() is first
        with pytest.raises(SessionClosedError):
            h.flux()
        assert svc.session_ids() == ()
        a = svc.open_session(_mono(mesh, 16), session_id="s1")
        b = svc.open_session(_mono(mesh, 16))
        assert b.id != a.id
        with pytest.raises(ValueError, match="already open"):
            svc.open_session(_mono(mesh, 16), session_id="s1")
    with pytest.raises(ValueError):
        TallyService().open_session(_mono(mesh, 16), max_queue=0)


def test_every_session_walks_the_deterministic_commit():
    """open_session arms the deterministic commit on the facade and its
    engines (the only way on the card to keep each session bitwise its
    solo run)."""
    from pumiumtally_tpu_torch import PartitionedPumiTally
    from pumiumtally_tpu_torch import StreamingPartitionedTally

    mesh = _mesh()
    facades = [
        _mono(mesh),
        StreamingTally(mesh, N, chunk_size=24, device="cpu"),
        PartitionedPumiTally(mesh, N, TallyConfig(capacity_factor=4.0),
                             device="cpu"),
        StreamingPartitionedTally(mesh, N, chunk_size=24,
                                  config=TallyConfig(capacity_factor=6.0),
                                  device="cpu"),
    ]
    assert all(t._deterministic is None for t in facades)
    with TallyService() as svc:
        for t in facades:
            svc.open_session(t)
            assert t._deterministic is not None
            for eng in t._engines():
                assert eng.deterministic is t._deterministic


def test_reads_ride_the_session_fifo():
    mesh = _mesh()
    work = _campaign(13, batches=1)
    src, dests = work[0]
    svc = TallyService(autostart=False)
    h = svc.open_session(_mono(mesh), max_queue=8)
    h.copy_initial_position(src.reshape(-1).copy())
    reads = []
    for d in dests:
        h.move(None, d.reshape(-1).copy())
        reads.append(h.flux())
    svc.start()
    got = [f.result(timeout=TIMEOUT) for f in reads]
    svc.shutdown(drain=False, timeout=TIMEOUT)
    t = _mono(mesh)
    t.CopyInitialPosition(src.reshape(-1).copy())
    for d, g in zip(dests, got):
        t.MoveToNextLocation(None, d.reshape(-1).copy())
        np.testing.assert_array_equal(g, t.flux.numpy())


def test_concurrent_client_threads_bitwise_vs_solo():
    """Four client threads drive their sessions at once (mono and
    streaming); each session's flux is bitwise its solo run."""
    mesh = _mesh()
    makers = [
        lambda: _mono(mesh),
        lambda: _mono(mesh),
        lambda: StreamingTally(mesh, N, chunk_size=24,
                               config=TallyConfig(check_found_all=False),
                               device="cpu"),
        lambda: StreamingTally(mesh, N, chunk_size=24,
                               config=TallyConfig(check_found_all=False),
                               device="cpu"),
    ]
    works = [_campaign(20 + i) for i in range(len(makers))]
    errors, fluxes = [], {}
    with TallyService() as svc:
        handles = [svc.open_session(b(), max_queue=BATCHES * (MOVES + 1))
                   for b in makers]

        def client(i):
            try:
                futs = []
                for src, dests in works[i]:
                    futs.append(handles[i].copy_initial_position(
                        src.reshape(-1).copy()))
                    futs += [handles[i].move(None, d.reshape(-1).copy())
                             for d in dests]
                for f in futs:
                    f.result(timeout=TIMEOUT)
                fluxes[i] = handles[i].flux().result(timeout=TIMEOUT)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(makers))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for i, b in enumerate(makers):
        solo = b()
        _drive_direct(solo, works[i])
        np.testing.assert_array_equal(fluxes[i], solo.flux.numpy())


# ---------------------------------------------------------------------------
# The drain: checkpoints the JAX package reads
# ---------------------------------------------------------------------------

def test_sigterm_drain_writes_generations_the_jax_package_reads(tmp_path):
    """SIGTERM to a service that owns the drain handler: every session
    stops taking work, ``shutdown(drain=True)`` writes one
    ``service_drain`` generation per session, and (1) the JAX package's
    ``resume_latest`` restores each exactly (flux, positions, ids,
    counters), (2) a port facade resumed from it finishes the campaign
    bitwise equal to an uninterrupted run."""
    mesh = _mesh()
    jmesh = jx.build_box(*BOX)
    work = {"mono": _campaign(31), "stream": _campaign(32)}

    def port_facade(kind, ckdir=None):
        cfg = dict(check_found_all=False)
        if ckdir is not None:
            cfg["checkpoint"] = CheckpointPolicy(
                dir=str(ckdir), every_n_batches=1, handle_signals=False)
        if kind == "mono":
            return PumiTally(mesh, N, TallyConfig(**cfg), device="cpu")
        return StreamingTally(mesh, N, chunk_size=24,
                              config=TallyConfig(**cfg), device="cpu")

    prev = signal.getsignal(signal.SIGTERM)
    svc = TallyService(handle_signals=True)
    try:
        handles = {k: svc.open_session(port_facade(k, tmp_path / k),
                                       session_id=k, max_queue=8)
                   for k in work}
        for k, h in handles.items():
            src, dests = work[k][0]
            h.copy_initial_position(src.reshape(-1).copy())
            for d in dests:
                h.move(None, d.reshape(-1).copy())
        flux = {k: h.flux().result(timeout=TIMEOUT)
                for k, h in handles.items()}
        os.kill(os.getpid(), signal.SIGTERM)
        assert svc.drain_requested
        with pytest.raises(ServiceDrainingError):
            handles["mono"].flux()
        saved = svc.shutdown(drain=True, timeout=TIMEOUT)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert set(saved) == set(work) and all(saved.values())
    assert signal.getsignal(signal.SIGTERM) == prev
    for k in work:
        jkw = dict(check_found_all=False, checkpoint=JaxPolicy(
            dir=str(tmp_path / k), handle_signals=False))
        jt = (jx.PumiTally(jmesh, N, jx.TallyConfig(**jkw)) if k == "mono"
              else jx.StreamingTally(jmesh, N, chunk_size=24,
                                     config=jx.TallyConfig(**jkw)))
        info = jax_resume_latest(jt)
        assert info.generation == saved[k][0]
        assert info.meta["reason"] == "service_drain"
        assert info.meta["session"] == k
        np.testing.assert_array_equal(np.asarray(jt.flux), flux[k])
        assert jt.iter_count == MOVES
        # The port resumes it and finishes bitwise.
        t = port_facade(k, tmp_path / k)
        t.resume_latest()
        _drive_direct(t, work[k][1:])
        full = port_facade(k)
        _drive_direct(full, work[k])
        np.testing.assert_array_equal(t.flux.numpy(), full.flux.numpy())
        np.testing.assert_array_equal(t.positions, full.positions)
