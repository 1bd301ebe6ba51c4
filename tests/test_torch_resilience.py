"""PyTorch port, the fault-tolerance layer (``resilience/``) and the
deterministic flux commit (``ops/det_commit.py``): the counterparts of
tests/test_resilience.py on the port's four facades, float64, the
kernels' plain versions on the CPU, inputs from numpy seeds.

Two layers, as in the JAX suite:

- in process: the generation store (atomicity, digest fallback,
  pruning, payload validation), the policy's cadence and drain, the
  bitwise resume contract on every facade (with and without a
  ``CheckpointPolicy``, whose facades commit through the deterministic
  commit), the layout fallback and the lost-particle counters;
- in subprocesses: a campaign drained by an injected SIGTERM, killed by
  SIGKILL mid-save, or resumed past a corrupted newest generation,
  reproduces the uninterrupted run's flux bitwise. The campaign driver
  is this file run as a script (``python tests/test_torch_resilience.py
  --facade part --ckpt-dir DIR --out FLUX.npy [--resume]``).

The plain commit: ``det_commit_plain`` over the plain walks' records
equals their serial ``index_add_`` bitwise (flux and lanes, one CPU
thread: torch splits a large CPU ``index_add_`` across threads, which
is then no serial sum), and the JAX ``walk`` / ``walk_local`` flux at
rtol 1e-10 with a 1e-13 floor (the cross-package class of
tests/test_torch_walk.py).

Tolerances: every resume and kill-and-resume comparison is bitwise
(flux, positions, element ids); a restore into another layout is exact
in state (flux bitwise, ids equal)."""

import argparse
import io
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as the campaign driver
    sys.path.insert(0, REPO)

from pumiumtally_tpu_torch import (  # noqa: E402
    CheckpointPolicy,
    PartitionedPumiTally,
    PumiTally,
    StreamingPartitionedTally,
    StreamingTally,
    TallyConfig,
    build_box,
    resume_latest,
)
from pumiumtally_tpu_torch.resilience import (  # noqa: E402
    CorruptCheckpointError,
    GenerationStore,
    parse_fault,
)
from pumiumtally_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_tally_state,
    save_tally_state,
)

F64 = torch.float64
N = 24
MESH_ARGS = (1, 1, 1, 3, 3, 3)
DRIVER_TIMEOUT = 180  # seconds, each campaign subprocess


def _mesh():
    return build_box(*MESH_ARGS, dtype=F64)


def _flat(a):
    return np.ascontiguousarray(np.asarray(a, np.float64).reshape(-1))


def _mono(n=N, **cfg):
    return PumiTally(_mesh(), n, TallyConfig(**cfg), device="cpu")


def _policy(tmp_path, **kw):
    kw.setdefault("handle_signals", False)
    return CheckpointPolicy(dir=str(tmp_path / "ck"), **kw)


def _drive(t, rng, moves=1):
    t.CopyInitialPosition(_flat(rng.uniform(0.1, 0.9, (t.num_particles, 3))))
    for _ in range(moves):
        t.MoveToNextLocation(
            None, _flat(rng.uniform(0.1, 0.9, (t.num_particles, 3))))


# ---------------------------------------------------------------------------
# Atomic save and the corrupt-checkpoint error
# ---------------------------------------------------------------------------

def test_load_garbage_npz_clear_error(tmp_path):
    bad = tmp_path / "garbage.npz"
    bad.write_bytes(b"this is not a zip archive at all")
    with pytest.raises(CorruptCheckpointError, match="corrupt checkpoint"):
        load_tally_state(_mono(), str(bad))


def test_load_truncated_npz_clear_error(tmp_path):
    t = _mono()
    _drive(t, np.random.default_rng(0))
    ckpt = tmp_path / "state.npz"
    save_tally_state(t, str(ckpt))
    data = ckpt.read_bytes()
    ckpt.write_bytes(data[: int(len(data) * 0.6)])
    with pytest.raises(CorruptCheckpointError, match="corrupt checkpoint"):
        load_tally_state(_mono(), str(ckpt))
    # A missing file stays FileNotFoundError: absence is not corruption.
    with pytest.raises(FileNotFoundError):
        load_tally_state(_mono(), str(tmp_path / "never_written.npz"))


def test_save_is_atomic_on_failure(tmp_path, monkeypatch):
    """A failing save leaves the previous checkpoint intact and no
    temporary file behind."""
    t = _mono()
    _drive(t, np.random.default_rng(1))
    ckpt = tmp_path / "state.npz"
    save_tally_state(t, str(ckpt))
    good = ckpt.read_bytes()

    def boom(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError, match="disk full"):
        save_tally_state(t, str(ckpt))
    monkeypatch.undo()
    assert ckpt.read_bytes() == good
    assert [p for p in os.listdir(tmp_path) if "tmp" in p] == []


# ---------------------------------------------------------------------------
# The generation store
# ---------------------------------------------------------------------------

def _store_with_gens(tmp_path, n_gens=3, keep=5):
    t = _mono()
    rng = np.random.default_rng(7)
    store = GenerationStore(str(tmp_path / "gens"), keep=keep)
    fluxes = []
    for g in range(n_gens):
        _drive(t, rng)
        store.save(t, meta={"g": g})
        fluxes.append(t.flux.numpy().copy())
    return t, store, fluxes


def test_generation_store_latest_and_prune(tmp_path):
    _, store, fluxes = _store_with_gens(tmp_path, n_gens=5, keep=2)
    assert [g for g, _ in store.generations()] == [4, 5]
    t2 = _mono()
    info = store.load_latest(t2)
    assert info.generation == 5 and info.meta["g"] == 4
    np.testing.assert_array_equal(t2.flux.numpy(), fluxes[-1])


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "header"])
def test_generation_fallback_past_damage(tmp_path, damage):
    """Damage to the newest generation: a warning, one generation back,
    never a crash."""
    _, store, fluxes = _store_with_gens(tmp_path, n_gens=3)
    gen, path = store.generations()[-1]
    data = bytearray(open(path, "rb").read())
    if damage == "truncate":
        open(path, "wb").write(data[:-80])
    elif damage == "bitflip":
        data[len(data) // 2] ^= 0xFF
        open(path, "wb").write(bytes(data))
    else:
        open(path, "wb").write(b"EHLO" + bytes(data))
    t2 = _mono()
    with pytest.warns(UserWarning, match="corrupt.*falling back"):
        info = store.load_latest(t2)
    assert info.generation == gen - 1
    np.testing.assert_array_equal(t2.flux.numpy(), fluxes[-2])


def test_generation_fallback_past_nan_payload(tmp_path, monkeypatch):
    """A digest-clean generation carrying NaN flux (``nan@gen``: poisoned
    before sealing) is refused by the payload check and skipped."""
    t, store, fluxes = _store_with_gens(tmp_path, n_gens=2)
    monkeypatch.setenv("PUMIUMTALLY_FAULT", "nan@gen:3")
    _drive(t, np.random.default_rng(11))
    store.save(t)
    monkeypatch.delenv("PUMIUMTALLY_FAULT")
    payload, _, _ = store.read_generation(store.generations()[-1][1])
    assert np.isnan(np.load(io.BytesIO(payload))["flux"]).all()
    t2 = _mono()
    with pytest.warns(UserWarning, match="non-finite"):
        info = store.load_latest(t2)
    assert info.generation == 2
    np.testing.assert_array_equal(t2.flux.numpy(), fluxes[-1])


def test_all_generations_corrupt_raises(tmp_path):
    _, store, _ = _store_with_gens(tmp_path, n_gens=2)
    for _, path in store.generations():
        open(path, "wb").write(b"\x00" * 100)
    with pytest.warns(UserWarning):
        with pytest.raises(CorruptCheckpointError, match="every checkpoint"):
            store.load_latest(_mono())


def test_empty_store_returns_none(tmp_path):
    assert GenerationStore(str(tmp_path / "empty")).load_latest(
        _mono()) is None


def test_header_mismatch_is_config_error_not_corruption(tmp_path):
    """A valid generation that does not fit the target raises the header
    ValueError at once (older generations would not fit either)."""
    _, store, _ = _store_with_gens(tmp_path, n_gens=2)
    with pytest.raises(ValueError, match="particles") as e:
        store.load_latest(_mono(N + 1))
    assert not isinstance(e.value, CorruptCheckpointError)


def test_fault_spec_grammar():
    f = parse_fault("kill@save:3")
    assert (f.action, f.site, f.ordinal, f.arg) == ("kill", "save", 3, None)
    assert parse_fault("truncate@gen:2:128").arg == 128
    for bad in ("kill@gen:1", "kill@save", "kill@save:0", "frob@save:1",
                "kill@save:1:2:3", "killsave:1"):
        with pytest.raises(ValueError, match="PUMIUMTALLY_FAULT"):
            parse_fault(bad)


# ---------------------------------------------------------------------------
# Autosave policy: cadence and drain
# ---------------------------------------------------------------------------

def test_policy_validation():
    with pytest.raises(ValueError, match="every_n_batches"):
        CheckpointPolicy(dir="ck", every_n_batches=0)
    with pytest.raises(ValueError, match="every_seconds"):
        CheckpointPolicy(dir="ck", every_seconds=0.0)
    with pytest.raises(ValueError, match="keep"):
        CheckpointPolicy(dir="ck", keep=0)
    with pytest.raises(ValueError, match="CheckpointPolicy"):
        TallyConfig(checkpoint="not-a-policy")
    # A JAX policy crosses over field by field.
    from pumiumtally_tpu import CheckpointPolicy as JaxCheckpointPolicy
    from pumiumtally_tpu import TallyConfig as JaxTallyConfig
    from pumiumtally_tpu_torch import convert

    cfg = convert.tally_config(JaxTallyConfig(checkpoint=JaxCheckpointPolicy(
        dir="ck", every_n_batches=2, every_seconds=5.0, keep=4,
        handle_signals=False)))
    assert cfg.checkpoint == CheckpointPolicy(
        dir="ck", every_n_batches=2, every_seconds=5.0, keep=4,
        handle_signals=False)


def test_checkpoint_now_needs_a_policy():
    with pytest.raises(RuntimeError, match="checkpoint_now"):
        _mono().checkpoint_now()


def test_autosave_every_n_batches(tmp_path):
    t = _mono(checkpoint=_policy(tmp_path, every_n_batches=2, keep=10))
    rng = np.random.default_rng(3)
    for _ in range(5):  # closes 4 batches (the 5th stays open)
        _drive(t, rng)
    store = t._resilience.store
    assert [g for g, _ in store.generations()] == [1, 2]
    _, _, meta = store.read_generation(store.generations()[-1][1])
    assert meta["batches_closed"] == 4 and meta["reason"] == "batch_close"
    assert meta["iter_count"] == 4


def test_autosave_every_seconds(tmp_path, monkeypatch):
    from pumiumtally_tpu_torch.resilience import policy as policy_mod

    clock = {"t": 1000.0}
    monkeypatch.setattr(policy_mod.time, "monotonic", lambda: clock["t"])
    t = _mono(checkpoint=_policy(tmp_path, every_n_batches=None,
                                 every_seconds=30.0))
    rng = np.random.default_rng(4)
    _drive(t, rng, moves=2)  # the timer is not due: no save
    store = t._resilience.store
    assert store.generations() == []
    clock["t"] += 31.0
    t.MoveToNextLocation(None, _flat(rng.uniform(0.1, 0.9, (N, 3))))
    assert [g for g, _ in store.generations()] == [1]
    _, _, meta = store.read_generation(store.generations()[0][1])
    assert meta["reason"] == "every_seconds"


def test_empty_batch_is_not_a_cadence_tick(tmp_path):
    t = _mono(checkpoint=_policy(tmp_path, every_n_batches=1))
    src = _flat(np.random.default_rng(5).uniform(0.1, 0.9, (N, 3)))
    t.CopyInitialPosition(src)
    t.CopyInitialPosition(src)  # an empty batch: no save
    assert t._resilience.store.generations() == []
    assert t._resilience.batches_closed == 0


def test_close_batch_and_finalize_are_batch_closes(tmp_path):
    t = _mono(batch_stats=True, checkpoint=_policy(tmp_path, keep=10))
    rng = np.random.default_rng(15)
    _drive(t, rng)
    t.close_batch()
    t.MoveToNextLocation(None, _flat(rng.uniform(0.1, 0.9, (N, 3))))
    t.finalize()
    store = t._resilience.store
    assert [g for g, _ in store.generations()] == [1, 2]
    assert t._resilience.batches_closed == 2


def test_drain_sigterm_saves_and_exits(tmp_path):
    """The first SIGTERM sets the drain flag; a move end writes a safety
    generation and carries on; the batch close saves (deduplicated) and
    exits 0 with the handlers restored."""
    pol = _policy(tmp_path, every_n_batches=None, handle_signals=True)
    prev_term = signal.getsignal(signal.SIGTERM)
    t = _mono(checkpoint=pol)
    runner = t._resilience
    try:
        assert signal.getsignal(signal.SIGTERM) is not prev_term
        rng = np.random.default_rng(6)
        src = _flat(rng.uniform(0.1, 0.9, (N, 3)))
        t.CopyInitialPosition(src)
        os.kill(os.getpid(), signal.SIGTERM)
        assert runner.drain_requested
        t.MoveToNextLocation(None, _flat(rng.uniform(0.1, 0.9, (N, 3))))
        gens = runner.store.generations()
        assert len(gens) == 1
        _, _, meta = runner.store.read_generation(gens[0][1])
        assert meta["reason"] == "drain_safety" and meta["iter_count"] == 1
        with pytest.raises(SystemExit) as exc:
            t.CopyInitialPosition(src)
        assert exc.value.code == 0
        assert len(runner.store.generations()) == 1
        t2 = _mono()
        GenerationStore(pol.dir).load_latest(t2)
        np.testing.assert_array_equal(t2.flux.numpy(), t.flux.numpy())
        assert signal.getsignal(signal.SIGTERM) == prev_term
    finally:
        runner.close()
        signal.signal(signal.SIGTERM, prev_term)


def test_drain_safety_generation_resumes_midbatch_bitwise(tmp_path):
    """A drain safety generation lands mid-batch; resumed move by move
    it continues bitwise."""
    pol = _policy(tmp_path, every_n_batches=None, handle_signals=True)
    prev_term = signal.getsignal(signal.SIGTERM)
    rng = np.random.default_rng(16)
    src, d1, d2 = (_flat(rng.uniform(0.1, 0.9, (N, 3))) for _ in range(3))
    t = _mono(checkpoint=pol)
    try:
        t.CopyInitialPosition(src)
        os.kill(os.getpid(), signal.SIGTERM)
        t.MoveToNextLocation(None, d1)  # the safety generation
    finally:
        t._resilience.close()
        signal.signal(signal.SIGTERM, prev_term)
    ref = _mono()
    ref.CopyInitialPosition(src)
    ref.MoveToNextLocation(None, d1)
    ref.MoveToNextLocation(None, d2)
    t2 = _mono(checkpoint=_policy(tmp_path))
    info = resume_latest(t2)
    assert info.meta["reason"] == "drain_safety"
    assert divmod(t2.iter_count, 2) == (0, 1)
    t2.MoveToNextLocation(None, d2)
    np.testing.assert_array_equal(t2.flux.numpy(), ref.flux.numpy())
    np.testing.assert_array_equal(t2.positions, ref.positions)


def test_checkpoint_now_consumes_pending_drain(tmp_path):
    """A SIGTERM during the final batch is not absorbed: the sealing
    ``checkpoint_now`` saves, restores the handlers and exits 0."""
    pol = _policy(tmp_path, every_n_batches=None, handle_signals=True)
    prev_term = signal.getsignal(signal.SIGTERM)
    t = _mono(checkpoint=pol)
    try:
        _drive(t, np.random.default_rng(17))
        os.kill(os.getpid(), signal.SIGTERM)
        with pytest.raises(SystemExit) as exc:
            t.checkpoint_now(final=True)
        assert exc.value.code == 0
        assert signal.getsignal(signal.SIGTERM) == prev_term
        store = t._resilience.store
        _, _, meta = store.read_generation(store.generations()[-1][1])
        assert meta["reason"] == "manual" and meta["final"] is True
    finally:
        t._resilience.close()
        signal.signal(signal.SIGTERM, prev_term)


def test_save_meta_reserved_keys_win(tmp_path):
    t = _mono(checkpoint=_policy(tmp_path))
    _drive(t, np.random.default_rng(18))
    t.checkpoint_now(iter_count=999, reason="lies", tag="ok")
    store = t._resilience.store
    _, _, meta = store.read_generation(store.generations()[-1][1])
    assert meta["iter_count"] == 1 and meta["reason"] == "manual"
    assert meta["tag"] == "ok"


def test_second_runner_takes_over_and_escalation_still_kills(tmp_path):
    """The newest runner owns the drain handler, and the second signal
    restores the original dispositions and re-delivers."""
    prev_int = signal.getsignal(signal.SIGINT)
    prev_term = signal.getsignal(signal.SIGTERM)
    t_a = _mono(checkpoint=CheckpointPolicy(dir=str(tmp_path / "a")))
    t_b = _mono(checkpoint=CheckpointPolicy(dir=str(tmp_path / "b")))
    try:
        os.kill(os.getpid(), signal.SIGINT)
        assert t_b._resilience.drain_requested
        assert not t_a._resilience.drain_requested
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)
        assert signal.getsignal(signal.SIGINT) == prev_int
        assert signal.getsignal(signal.SIGTERM) == prev_term
    finally:
        t_b._resilience.close()
        t_a._resilience.close()
        signal.signal(signal.SIGINT, prev_int)
        signal.signal(signal.SIGTERM, prev_term)


def test_second_sigint_escalates(tmp_path):
    prev_int = signal.getsignal(signal.SIGINT)
    prev_term = signal.getsignal(signal.SIGTERM)
    t = _mono(checkpoint=_policy(tmp_path, handle_signals=True))
    runner = t._resilience
    try:
        os.kill(os.getpid(), signal.SIGINT)
        assert runner.drain_requested
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)
    finally:
        runner.close()
        signal.signal(signal.SIGINT, prev_int)
        signal.signal(signal.SIGTERM, prev_term)


def test_resume_counters_continue(tmp_path):
    """A resumed runner continues the generation numbering and the batch
    counter where the saver stopped."""
    pol = _policy(tmp_path, every_n_batches=1, keep=10)
    rng = np.random.default_rng(13)
    work = [(_flat(rng.uniform(0.1, 0.9, (N, 3))),
             _flat(rng.uniform(0.1, 0.9, (N, 3)))) for _ in range(4)]

    def batches(t, start, stop):
        for src, dst in work[start:stop]:
            t.CopyInitialPosition(src)
            t.MoveToNextLocation(None, dst)

    batches(_mono(checkpoint=pol), 0, 3)  # closes batches 1, 2: gens 1, 2
    t2 = _mono(checkpoint=pol)
    info = t2.resume_latest()
    assert info.generation == 2 and t2._resilience.batches_closed == 2
    assert t2.iter_count == 2
    batches(t2, 2, 4)
    assert [g for g, _ in t2._resilience.store.generations()] == [1, 2, 3]
    assert t2._resilience.batches_closed == 3


# ---------------------------------------------------------------------------
# The bitwise resume contract, every facade, in process
# ---------------------------------------------------------------------------

# "part_w1" and "part_w2": the partitioned facade's sub-split walks W1
# (``walk_vmem_max_elems``) and W2 (``walk_kernel="pallas"`` on the
# two-tier tables).
FACADES = ("mono", "stream", "part", "stream_part", "part_w1", "part_w2")


def _build_facade(facade, n=N, policy=None):
    cfg = dict(check_found_all=False)
    if policy is not None:
        cfg["checkpoint"] = policy
    if facade == "mono":
        return PumiTally(_mesh(), n, TallyConfig(**cfg), device="cpu")
    if facade == "stream":
        return StreamingTally(_mesh(), n, chunk_size=10,
                              config=TallyConfig(**cfg), device="cpu")
    if facade == "part":
        return PartitionedPumiTally(_mesh(), n, TallyConfig(
            capacity_factor=4.0, **cfg), device="cpu")
    if facade == "part_w1":
        return PartitionedPumiTally(_mesh(), n, TallyConfig(
            capacity_factor=8.0, walk_vmem_max_elems=48, **cfg),
            device="cpu")
    if facade == "part_w2":
        return PartitionedPumiTally(_mesh(), n, TallyConfig(
            capacity_factor=8.0, walk_vmem_max_elems=48,
            walk_table_dtype="bfloat16", walk_kernel="pallas", **cfg),
            device="cpu")
    return StreamingPartitionedTally(_mesh(), n, chunk_size=10,
                                     config=TallyConfig(capacity_factor=6.0,
                                                        **cfg),
                                     device="cpu")


@pytest.mark.parametrize("armed", [False, True])
@pytest.mark.parametrize("facade", FACADES)
def test_resume_is_bitwise_on_every_facade(facade, armed, tmp_path):
    """Saved mid-batch (one of two moves done), restored into an
    identically configured facade and continued move by move: flux,
    positions and element ids stay bitwise equal to the uninterrupted
    run through further batches. ``armed``: both carry a
    ``CheckpointPolicy``, so they walk with the deterministic commit."""
    rng = np.random.default_rng(42)
    work = [(rng.uniform(0.1, 0.9, (N, 3)),
             [rng.uniform(0.1, 0.9, (N, 3)) for _ in range(2)])
            for _ in range(3)]

    def build():
        return _build_facade(facade, policy=_policy(tmp_path)
                             if armed else None)

    def run_batch(t, batch, skip_moves=0):
        src, dests = batch
        if skip_moves == 0:
            t.CopyInitialPosition(_flat(src))
        for d in dests[skip_moves:]:
            t.MoveToNextLocation(None, _flat(d))

    t_full = build()
    run_batch(t_full, work[0])
    src1, dests1 = work[1]
    t_full.CopyInitialPosition(_flat(src1))
    t_full.MoveToNextLocation(None, _flat(dests1[0]))
    ckpt = str(tmp_path / "mid.npz")
    save_tally_state(t_full, ckpt)
    t_res = build()
    load_tally_state(t_res, ckpt)
    assert divmod(t_res.iter_count, 2) == (1, 1)
    run_batch(t_full, work[1], skip_moves=1)
    run_batch(t_res, work[1], skip_moves=1)
    for t in (t_full, t_res):
        run_batch(t, work[2])
    np.testing.assert_array_equal(t_res.flux.numpy(), t_full.flux.numpy(),
                                  err_msg=facade)
    np.testing.assert_array_equal(t_res.positions, t_full.positions)
    np.testing.assert_array_equal(t_res.elem_ids, t_full.elem_ids)
    if armed:
        assert t_full._deterministic and t_res._deterministic


def test_layout_mismatch_falls_back_to_canonical(tmp_path):
    """A partitioned checkpoint restored into a partitioned engine of
    another capacity goes through the canonical restore: exact state."""
    t = PartitionedPumiTally(_mesh(), N, TallyConfig(capacity_factor=4.0),
                             device="cpu")
    _drive(t, np.random.default_rng(8))
    ckpt = str(tmp_path / "p.npz")
    save_tally_state(t, ckpt)
    t2 = PartitionedPumiTally(_mesh(), N, TallyConfig(capacity_factor=2.0),
                              device="cpu")
    assert t2.engine.cap != t.engine.cap
    load_tally_state(t2, ckpt)
    np.testing.assert_array_equal(t2.flux.numpy(), t.flux.numpy())
    np.testing.assert_array_equal(t2.elem_ids, t.elem_ids)
    np.testing.assert_array_equal(t2.positions, t.positions)


# ---------------------------------------------------------------------------
# Lost-particle accounting
# ---------------------------------------------------------------------------

def _sources_with_lost(rng, n, n_lost):
    src = rng.uniform(0.1, 0.9, (n, 3))
    src[:n_lost] = [2.5, 2.5, 2.5]  # outside the unit box: no element
    return src


def test_lost_particles_counter_partitioned(tmp_path):
    def part():
        return PartitionedPumiTally(_mesh(), N, TallyConfig(
            capacity_factor=4.0, check_found_all=False), device="cpu")

    t = part()
    rng = np.random.default_rng(9)
    dst = _flat(rng.uniform(0.1, 0.9, (N, 3)))
    t.CopyInitialPosition(_flat(_sources_with_lost(rng, N, 2)))
    t.MoveToNextLocation(None, dst)
    assert t.lost_particles == 2
    t.CopyInitialPosition(_flat(_sources_with_lost(rng, N, 1)))
    t.MoveToNextLocation(None, dst)
    assert t.lost_particles == 3  # cumulative
    ckpt = str(tmp_path / "l.npz")
    save_tally_state(t, ckpt)
    t2 = part()
    load_tally_state(t2, ckpt)
    assert t2.lost_particles == 3
    np.testing.assert_array_equal(t2.elem_ids, t.elem_ids)
    assert (t2.elem_ids == -1).sum() == 1


def test_lost_particles_zero_on_clamping_facades():
    src = _flat(_sources_with_lost(np.random.default_rng(10), N, 2))
    for t in (_mono(check_found_all=False),
              StreamingTally(_mesh(), N, chunk_size=10, device="cpu",
                             config=TallyConfig(check_found_all=False))):
        t.CopyInitialPosition(src)
        assert t.lost_particles == 0


def test_lost_particles_in_vtk_field_data(tmp_path, capsys):
    from pumiumtally_tpu_torch.io.vtk import read_vtk_field_scalars

    t = PartitionedPumiTally(_mesh(), N, TallyConfig(
        capacity_factor=4.0, check_found_all=False), device="cpu")
    rng = np.random.default_rng(11)
    t.CopyInitialPosition(_flat(_sources_with_lost(rng, N, 3)))
    t.MoveToNextLocation(None, _flat(rng.uniform(0.1, 0.9, (N, 3))))
    path = str(tmp_path / "out.vtk")
    t.WriteTallyResults(path)
    np.testing.assert_array_equal(
        read_vtk_field_scalars(path, "lost_particles"), [3.0])
    t.WriteTallyResults(str(tmp_path / "out.pvtu"))
    np.testing.assert_array_equal(read_vtk_field_scalars(
        str(tmp_path / "out_p0.vtu"), "lost_particles"), [3.0])
    capsys.readouterr()  # the timing prints


def test_streaming_partitioned_lost_counter():
    t = StreamingPartitionedTally(_mesh(), N, chunk_size=10, device="cpu",
                                  config=TallyConfig(capacity_factor=6.0,
                                                     check_found_all=False))
    t.CopyInitialPosition(_flat(_sources_with_lost(
        np.random.default_rng(12), N, 2)))
    assert t.lost_particles == 2


# ---------------------------------------------------------------------------
# The plain deterministic commit
# ---------------------------------------------------------------------------

def test_det_commit_plain_is_a_serial_sum_in_key_then_order():
    """Records in any order: each entry gets its values added one by one
    in ascending order key onto its standing value (numpy's serial sum
    in float32, bitwise)."""
    from pumiumtally_tpu_torch.ops.det_commit import det_commit_plain

    rng = np.random.default_rng(20)
    m, k = 5000, 37
    key = rng.integers(0, k, m).astype(np.int32)
    ords = rng.permutation(m).astype(np.int64) * 3 + (1 << 33)
    val = rng.uniform(-1, 3, m).astype(np.float32)
    start = rng.uniform(0, 5, k).astype(np.float32)
    want = start.copy()
    for j in np.argsort(ords, kind="stable"):
        want[key[j]] = np.float32(want[key[j]] + val[j])
    got = torch.tensor(start)
    det_commit_plain(got, torch.tensor(key), torch.tensor(ords),
                     torch.tensor(val))
    np.testing.assert_array_equal(got.numpy(), want)


def _serial():
    """One intra-op thread: torch splits a large CPU index_add_ over its
    threads, and the split sum is not the serial one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    return threads


def _w0_inputs(seed, n=2000, div=5):
    from pumiumtally_tpu.mesh.box import build_box as jax_build_box
    from pumiumtally_tpu_torch import convert

    jmesh = jax_build_box(1, 1, 1, div, div, div)
    arrays = convert.mesh_arrays(jmesh)
    rng = np.random.default_rng(seed)
    elem = rng.integers(0, arrays["tet2vert"].shape[0], n).astype(np.int32)
    x = arrays["coords"][arrays["tet2vert"][elem]].mean(axis=1)
    fly = (rng.random(n) > 0.1).astype(np.int8)
    dest = np.where(fly[:, None] == 1,
                    x + rng.normal(scale=0.4, size=(n, 3)), x)
    return jmesh, convert.tetmesh_from_arrays(arrays), dict(
        x=x, elem=elem, dest=dest, fly=fly, w=rng.uniform(0.5, 2.0, n))


def _spec_ops(n, nbins, kinds, seed, drop_limit):
    rng = np.random.default_rng(seed)
    stride = nbins * len(kinds)
    bin_off = (rng.integers(0, nbins, n) * len(kinds)).astype(np.int32)
    bin_off[::13] = drop_limit  # the DROP sentinel
    fac = np.stack([np.ones(n) if k == "count" else rng.uniform(0.5, 2.0, n)
                    for k in kinds], 1)
    return stride, torch.tensor(bin_off), torch.tensor(fac)


@pytest.mark.parametrize("two_tier", [False, True])
def test_det_commit_plain_equals_walk_plain_index_add(two_tier):
    """W0's plain version: the deterministic commit's records equal the
    serial index_add_ flux and lanes bitwise, and the JAX walk's flux at
    rtol 1e-10."""
    import jax.numpy as jnp

    from pumiumtally_tpu.ops.walk import walk as jax_walk
    from pumiumtally_tpu_torch.ops.walk import walk_plain

    jmesh, mesh, d = _w0_inputs(21)
    if two_tier:
        mesh = mesh.with_lowp_tables()
    n, ne = d["x"].shape[0], mesh.nelems
    kinds = ("track", "track", "count")
    stride, bin_off, fac = _spec_ops(n, 4, kinds, 22, ne * 4 * len(kinds))
    t = {k: torch.tensor(v) for k, v in d.items()}
    out = []
    threads = _serial()
    try:
        for det in (False, True):
            flux = torch.zeros(ne, dtype=F64)
            bank = torch.zeros(ne * stride, dtype=F64)
            walk_plain(mesh, t["x"], t["elem"], t["dest"], t["fly"], t["w"],
                       flux, tally=True, tol=1e-8, max_iters=4096,
                       scoring=(kinds, bank, bin_off, fac),
                       deterministic=det)
            out.append((flux, bank))
    finally:
        torch.set_num_threads(threads)
    assert out[0][0].sum() > 0 and out[0][1].sum() > 0
    assert torch.equal(out[1][0], out[0][0])
    assert torch.equal(out[1][1], out[0][1])
    if not two_tier:
        r = jax_walk(jmesh, jnp.asarray(d["x"]), jnp.asarray(d["elem"]),
                     jnp.asarray(d["dest"]), jnp.asarray(d["fly"]),
                     jnp.asarray(d["w"]), jnp.zeros((ne,)), tally=True,
                     tol=1e-8, max_iters=4096)
        np.testing.assert_allclose(out[1][0].numpy(), np.asarray(r.flux),
                                   rtol=1e-10, atol=1e-13)


def test_det_commit_plain_equals_walk_local_plain_index_add():
    """W4's plain versions (one block, and the stacked-block list walk):
    the records equal the serial index_add_ flux and lanes bitwise, and
    the JAX walk_local's flux at rtol 1e-10."""
    import jax.numpy as jnp

    from pumiumtally_tpu.parallel.partition import (
        build_partition as jax_build_partition,
        walk_local as jax_walk_local,
    )
    from pumiumtally_tpu_torch import convert
    from pumiumtally_tpu_torch.parallel.partition import (
        build_partition,
        walk_local_list_plain,
        walk_local_plain,
    )

    jmesh, mesh, d = _w0_inputs(23)
    jpart = jax_build_partition(jmesh, 1)
    part = convert.partition_from_arrays(convert.partition_arrays(jpart))
    n, L = d["x"].shape[0], part.L
    lelem = np.asarray(part.glid_of_orig)[d["elem"]].astype(np.int32)
    keys = ("x", "lelem", "dest", "fly", "w", "done", "exited")
    d = dict(d, lelem=lelem, done=np.zeros(n, bool), exited=np.zeros(n, bool))
    kinds = ("track", "count")
    stride, bin_off, fac = _spec_ops(n, 3, kinds, 24, L * 3 * len(kinds))
    out = []
    threads = _serial()
    try:
        for det in (False, True):
            flux = torch.zeros(L, dtype=F64)
            bank = torch.zeros(L * stride, dtype=F64)
            walk_local_plain(part.table, *(torch.tensor(d[k]) for k in keys),
                             flux, tally=True, tol=1e-8, max_iters=4096,
                             scoring=(kinds, bank, bin_off, fac),
                             deterministic=det)
            out.append((flux, bank))
        # The engine's stacked-block list walk, four blocks, a work list
        # out of slot order.
        part4 = build_partition(mesh, 4)
        L4 = part4.L
        cb = n  # room for any block's share
        perm = np.random.default_rng(25).permutation(n)
        glid = np.asarray(part4.glid_of_orig)[d["elem"]][perm]
        slot = np.empty(n, np.int64)
        for b in range(4):
            mine = np.flatnonzero(glid // L4 == b)
            slot[mine] = b * cb + np.arange(mine.size)
        assert slot.max() < 4 * cb
        lists = []
        for det in (False, True):
            st = {"x": torch.zeros(4 * cb, 3, dtype=F64),
                  "lelem": torch.zeros(4 * cb, dtype=torch.int32),
                  "dest": torch.zeros(4 * cb, 3, dtype=F64),
                  "fly": torch.zeros(4 * cb, dtype=torch.int8),
                  "w": torch.zeros(4 * cb, dtype=F64),
                  "done": torch.ones(4 * cb, dtype=torch.bool),
                  "exited": torch.zeros(4 * cb, dtype=torch.bool)}
            s = torch.tensor(slot)
            for k, v in (("x", d["x"][perm]), ("dest", d["dest"][perm]),
                         ("fly", d["fly"][perm]), ("w", d["w"][perm])):
                st[k][s] = torch.tensor(v)
            st["lelem"][s] = torch.tensor((glid % L4).astype(np.int32))
            st["done"][s] = False
            work = (torch.tensor(slot[::-1].copy(), dtype=torch.int32),
                    torch.tensor([n], dtype=torch.int32))
            flux = torch.zeros(4 * L4, dtype=F64)
            walk_local_list_plain(part4.table, *(st[k] for k in keys), flux,
                                  work, tally=True, tol=1e-8, max_iters=4096,
                                  blocks=4, deterministic=det)
            lists.append(flux)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(out[1][0], out[0][0])
    assert torch.equal(out[1][1], out[0][1])
    assert torch.equal(lists[1], lists[0]) and lists[0].sum() > 0
    r = jax_walk_local(jnp.asarray(jpart.table),
                       *(jnp.asarray(d[k]) for k in keys), jnp.zeros(L),
                       tally=True, tol=1e-8, max_iters=4096)
    np.testing.assert_allclose(out[1][0].numpy(), np.asarray(r[5]),
                               rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("facade", FACADES)
def test_armed_facade_walks_the_deterministic_commit(facade, tmp_path,
                                                     monkeypatch):
    """A facade with a ``CheckpointPolicy`` commits every tallying walk
    through the deterministic commit, and its flux equals the unarmed
    facade's bitwise (one CPU thread: the unarmed one's serial
    index_add_)."""
    from pumiumtally_tpu_torch.ops import walk as walk_mod

    calls = []
    real = walk_mod.det_commit_plain

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(walk_mod, "det_commit_plain", counted)
    rng = np.random.default_rng(26)
    src = _flat(rng.uniform(0.1, 0.9, (N, 3)))
    dests = [_flat(rng.uniform(0.0, 1.0, (N, 3))) for _ in range(3)]
    fluxes = []
    threads = _serial()
    try:
        for armed in (False, True):
            t = _build_facade(facade, policy=_policy(tmp_path)
                              if armed else None)
            t.CopyInitialPosition(src)
            t.MoveToNextLocation(src, dests[0])
            for d in dests[1:]:
                t.MoveToNextLocation(None, d)
            fluxes.append(t.flux.numpy())
            assert (len(calls) > 0) == armed
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(fluxes[1], fluxes[0])


# ---------------------------------------------------------------------------
# Kill and resume, in subprocesses
# ---------------------------------------------------------------------------

BATCHES = 4
MOVES = 2
DRIVER_N = 96
SEED = 1234


def _driver_build(facade, ckpt_dir):
    return _build_facade(facade, n=DRIVER_N, policy=CheckpointPolicy(
        dir=ckpt_dir, every_n_batches=1, keep=3))


def driver_main(argv=None) -> None:
    """The campaign: BATCHES source batches of MOVES continue moves, all
    inputs from one seeded rng, autosaved every batch; ``--resume``
    restores the newest intact generation and re-drives what is left,
    move by move; the final batch is sealed with ``checkpoint_now`` and
    the flux written to ``--out``."""
    p = argparse.ArgumentParser()
    p.add_argument("--facade", required=True, choices=FACADES)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--resume", action="store_true")
    args = p.parse_args(argv)
    rng = np.random.default_rng(SEED)
    src = rng.uniform(0.1, 0.9, (BATCHES, DRIVER_N, 3))
    dst = rng.uniform(0.1, 0.9, (BATCHES, MOVES, DRIVER_N, 3))
    t = _driver_build(args.facade, args.ckpt_dir)
    start_batch, done_moves = 0, 0
    if args.resume:
        info = t.resume_latest()
        if info is not None:
            start_batch, done_moves = divmod(t.iter_count, MOVES)
            print(f"resumed generation {info.generation} at batch "
                  f"{start_batch} (iter_count {t.iter_count})", flush=True)
    for b in range(start_batch, BATCHES):
        skip = done_moves if b == start_batch else 0
        if skip == 0:
            t.CopyInitialPosition(_flat(src[b]))
        for m in range(skip, MOVES):
            t.MoveToNextLocation(None, _flat(dst[b, m]))
    t.checkpoint_now(final=True)
    np.save(args.out, t.flux.numpy())


def _run_driver(facade, ckpt_dir, out, fault=None, resume=False):
    env = {k: v for k, v in os.environ.items() if k != "PUMIUMTALLY_FAULT"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"  # a small campaign: spare the test workers
    if fault:
        env["PUMIUMTALLY_FAULT"] = fault
    cmd = [sys.executable, os.path.abspath(__file__), "--facade", facade,
           "--ckpt-dir", str(ckpt_dir), "--out", str(out)]
    if resume:
        cmd.append("--resume")
    return subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                          timeout=DRIVER_TIMEOUT, env=env)


@pytest.mark.parametrize("facade", ["mono", "stream", "part"])
def test_kill_and_resume_bitwise(facade, tmp_path):
    """Three arms against an uninterrupted campaign, flux bitwise: a
    graceful drain (SIGTERM at the second batch close, exit 0, then
    ``--resume``), a hard kill mid-save of generation 3 (generations 1-2
    survive, the orphaned temporary file is swept on resume), and the
    reference run's newest generation truncated (a warning, one
    generation back, the final batch re-driven)."""
    base_out = tmp_path / "base.npy"
    r = _run_driver(facade, tmp_path / "ck_base", base_out)
    assert r.returncode == 0, r.stderr[-2000:]
    flux_base = np.load(base_out)
    assert flux_base.sum() > 0

    out1 = tmp_path / "drain.npy"
    r = _run_driver(facade, tmp_path / "ck_drain", out1,
                    fault="sigterm@batch:2")
    assert r.returncode == 0, r.stderr[-2000:]
    assert not out1.exists()  # drained before the campaign finished
    r = _run_driver(facade, tmp_path / "ck_drain", out1, resume=True)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed generation" in r.stdout
    np.testing.assert_array_equal(np.load(out1), flux_base,
                                  err_msg=f"{facade}: drain arm")

    out2 = tmp_path / "kill.npy"
    r = _run_driver(facade, tmp_path / "ck_kill", out2, fault="kill@save:3")
    assert r.returncode == -signal.SIGKILL, r.stderr[-2000:]
    names = sorted(os.listdir(tmp_path / "ck_kill"))
    assert [n for n in names if n.endswith(".ckpt")] == [
        "gen-00000001.ckpt", "gen-00000002.ckpt"]
    r = _run_driver(facade, tmp_path / "ck_kill", out2, resume=True)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed generation 2 at batch 2" in r.stdout
    np.testing.assert_array_equal(np.load(out2), flux_base,
                                  err_msg=f"{facade}: kill arm")
    assert not [n for n in os.listdir(tmp_path / "ck_kill")
                if n.startswith(".tmp-gen-")]

    gens = sorted((tmp_path / "ck_base").glob("gen-*.ckpt"))
    data = gens[-1].read_bytes()
    gens[-1].write_bytes(data[: len(data) - 120])
    out3 = tmp_path / "corrupt.npy"
    r = _run_driver(facade, tmp_path / "ck_base", out3, resume=True)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "corrupt" in (r.stderr + r.stdout)
    np.testing.assert_array_equal(np.load(out3), flux_base,
                                  err_msg=f"{facade}: corrupt arm")


if __name__ == "__main__":
    driver_main()
