"""PyTorch port, the runtime sentinels: the counterparts of
tests/test_sentinel.py (its resilience cases too: the exhausted
overflow ladder's safety save in a subprocess, and a checkpoint
restored after a capacity escalation), on the port's four facades,
their kernels' plain versions on the CPU, float64.

Tolerances: recovered runs against unconstrained runs of the same facade
bitwise in positions and element ids; flux bitwise on ``PumiTally`` and
``StreamingTally`` (the ladder continues the exact ray parametrisation
and the corridor workload gives each element one history a move, so the
split walk adds the same values in the same order), rtol 1e-12 with a
1e-15 floor on the partitioned facades (the resumed phase restarts rays
from their pause points, the engine's own re-parametrisation, as in the
JAX test). Against the JAX package: the health report's counts equal,
the conservation residual below 1e-12 in both, positions to 1e-12 and
the total flux to rtol 1e-12 on the corridor lanes (they lie on tet
faces, so element ids and the per-element flux are face ties there);
on lanes off the faces, element ids and positions exact and the
per-element flux at rtol 1e-10."""

import json
import os

import numpy as np
import pytest
import torch

from pumiumtally_tpu import PartitionedPumiTally as JaxPartitionedPumiTally
from pumiumtally_tpu import PumiTally as JaxPumiTally
from pumiumtally_tpu import SentinelPolicy as JaxSentinelPolicy
from pumiumtally_tpu import TallyConfig as JaxTallyConfig
from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu.sentinel.audit import _audit_pack as jax_audit_pack
from pumiumtally_tpu_torch import (
    EnergyFilter,
    PartitionedPumiTally,
    PumiTally,
    ScoringSpec,
    SentinelAnomalyError,
    SentinelPolicy,
    StreamingPartitionedTally,
    StreamingTally,
    TallyConfig,
    convert,
)
from pumiumtally_tpu_torch.io.vtk import read_vtk_field_scalars
from pumiumtally_tpu_torch.sentinel import (
    ANOMALY_CONSERVATION,
    ANOMALY_NONFINITE,
    ANOMALY_UNFINISHED,
    append_quarantine,
    quarantine_path,
    read_quarantine,
)
from pumiumtally_tpu_torch.sentinel import straggler
from pumiumtally_tpu_torch.sentinel.audit import audit_pack, split_packed
from pumiumtally_tpu_torch.sentinel.quarantine import atomic_append

_JMESH = jax_build_box(1.0, 1.0, 1.0, 6, 6, 6)
_MESH = convert.tetmesh_from_arrays(convert.mesh_arrays(_JMESH))


def _corridor_workload(n=6):
    """tests/test_sentinel.py's disjoint-lane workload: particle i flies
    along x inside its own (y, z) lane, so no element is scored by two
    histories in a move."""
    lanes = (np.arange(n) + 0.5) / n
    src = np.stack([np.full(n, 0.07), lanes, lanes], axis=1)
    d1 = np.stack([np.full(n, 0.93), lanes, lanes], axis=1)
    d2 = np.stack([np.full(n, 0.15), lanes, lanes], axis=1)
    return src, [d1, d2]


def _drive(t, src, moves, **move_kw):
    t.CopyInitialPosition(src.reshape(-1).copy())
    for d in moves:
        t.MoveToNextLocation(None, d.reshape(-1).copy(), **move_kw)


def _facade(kind, n, **cfg_kw):
    cfg = dict(check_found_all=False, **cfg_kw)
    if kind == "monolithic":
        return PumiTally(_MESH, n, TallyConfig(**cfg), device="cpu")
    if kind == "streaming":
        return StreamingTally(_MESH, n, chunk_size=3,
                              config=TallyConfig(**cfg), device="cpu")
    if kind == "partitioned":
        return PartitionedPumiTally(_MESH, n, TallyConfig(
            walk_vmem_max_elems=300, walk_block_kernel="gather", **cfg),
            device="cpu")
    if kind == "partitioned_default":
        return PartitionedPumiTally(_MESH, n, TallyConfig(**cfg),
                                    device="cpu")
    return StreamingPartitionedTally(_MESH, n, chunk_size=3,
                                     config=TallyConfig(**cfg), device="cpu")


@pytest.mark.parametrize("kind", ["monolithic", "streaming", "partitioned",
                                  "partitioned_default",
                                  "streaming_partitioned"])
def test_straggler_recovery_vs_unconstrained(kind):
    """max_iters=2 with the sentinel armed: the ladder recovers every
    straggler, equal to an unconstrained run of the same facade."""
    src, moves = _corridor_workload()
    n = src.shape[0]
    ref = _facade(kind, n)
    _drive(ref, src, moves)
    t = _facade(kind, n, max_iters=2, sentinel=SentinelPolicy())
    _drive(t, src, moves)
    rep = t.health_report()
    assert rep.unfinished_total > 0  # the budget really truncated
    assert rep.stragglers_lost == 0
    assert rep.stragglers_recovered == rep.unfinished_total
    assert rep.anomaly_moves == 0
    if kind in ("monolithic", "streaming"):
        np.testing.assert_array_equal(t.flux.numpy(), ref.flux.numpy())
    else:
        np.testing.assert_allclose(t.flux.numpy(), ref.flux.numpy(),
                                   rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(t.positions, ref.positions)
    np.testing.assert_array_equal(t.elem_ids, ref.elem_ids)


def test_straggler_recovery_bf16_f32_rung(monkeypatch):
    """A two-tier mesh's second rung walks the full-precision planes (W0's
    unpacked walk over the refinement tier). Rung 1 starved to one step:
    rung 2 recovers everyone, the positions equal the unconstrained
    two-tier run's, and the audit stays clean."""
    src, moves = _corridor_workload()
    n = src.shape[0]
    ref = _facade("monolithic", n, walk_table_dtype="bfloat16")
    _drive(ref, src, moves)
    real = straggler._retry_step
    calls = []

    def capped_first_rung(*args, table_dtype=None, max_iters, **kw):
        calls.append(table_dtype)
        if len(calls) == 1:
            max_iters = 1  # starve rung 1: rung 2 must do the work
        return real(*args, table_dtype=table_dtype, max_iters=max_iters,
                    **kw)

    monkeypatch.setattr(straggler, "_retry_step", capped_first_rung)
    t = _facade("monolithic", n, walk_table_dtype="bfloat16", max_iters=2,
                sentinel=SentinelPolicy())
    _drive(t, src, moves)
    assert "float32" in calls  # the full-precision rung ran
    rep = t.health_report()
    assert rep.stragglers_lost == 0 and rep.stragglers_recovered > 0
    assert rep.anomaly_moves == 0
    np.testing.assert_allclose(float(t.flux.sum()), float(ref.flux.sum()),
                               rtol=1e-12)
    np.testing.assert_array_equal(t.positions, ref.positions)


def test_unrecoverable_straggler_quarantined_and_counted(tmp_path,
                                                         monkeypatch):
    """A ladder stubbed to one-step retries loses the residue: counted in
    ``lost_particles`` and written to the quarantine file with its
    origin, destination, element and weight."""
    src, moves = _corridor_workload()
    n = src.shape[0]
    real = straggler._retry_step
    monkeypatch.setattr(
        straggler, "_retry_step",
        lambda *a, max_iters, **kw: real(*a, max_iters=1, **kw))
    t = _facade("monolithic", n, max_iters=2, sentinel=SentinelPolicy(
        quarantine_dir=str(tmp_path), on_anomaly="record"))
    # Exact localization first (the stubbed ladder would lose it too).
    full = _facade("monolithic", n)
    full.CopyInitialPosition(src.reshape(-1).copy())
    t.CopyInitialPosition(src.reshape(-1).copy())
    t.x, t.elem = full.x.clone(), full.elem.clone()
    t.MoveToNextLocation(None, moves[0].reshape(-1).copy())
    rep = t.health_report()
    assert rep.stragglers_lost > 0
    assert t.lost_particles > 0
    records = read_quarantine(quarantine_path(str(tmp_path)))
    assert len(records) == t.lost_particles
    for r in records:
        assert set(r) == {"pid", "move", "origin", "dest", "elem",
                          "weight", "reason"}
        assert r["reason"] == "iteration_budget"
        np.testing.assert_allclose(r["dest"], moves[0][r["pid"]])
        assert r["weight"] == 1.0


def test_audit_pack_split_roundtrip_and_matches_jax():
    n_unf, mask = split_packed(
        37 * 8 + (ANOMALY_UNFINISHED | ANOMALY_CONSERVATION))
    assert n_unf == 37 and mask == 3
    # The port's reduction against the JAX one on the same inputs.
    rng = np.random.default_rng(5)
    x0, x1 = rng.uniform(size=(50, 3)), rng.uniform(size=(50, 3))
    fly = (rng.random(50) > 0.2).astype(np.int8)
    w = rng.uniform(0.5, 2.0, 50)
    done = rng.random(50) > 0.1
    flux = rng.uniform(size=40)
    args = (x0, x1, fly, w, done, flux)
    for prev in (0.0, 3.0):
        got = audit_pack(*(torch.as_tensor(a) for a in args),
                         torch.tensor(prev, dtype=torch.float64),
                         torch.tensor(0.0, dtype=torch.float64), 1e-9)
        want = jax_audit_pack(*args, prev, 0.0, 1e-9)
        assert int(got[0]) == int(want[0])
        np.testing.assert_allclose(float(got[3]), float(want[3]),
                                   rtol=1e-12)


def test_clean_run_audits_clean_and_bitwise():
    """Sentinel-on over a healthy workload: no anomaly, the residual at
    rounding level, flux bitwise the sentinel-off run's."""
    src, moves = _corridor_workload()
    n = src.shape[0]
    off = _facade("monolithic", n)
    _drive(off, src, moves)
    on = _facade("monolithic", n, sentinel=SentinelPolicy())
    _drive(on, src, moves)
    rep = on.health_report()
    assert rep.moves_audited == 2 and rep.anomaly_moves == 0
    assert rep.max_conservation_residual < 1e-12
    np.testing.assert_array_equal(on.flux.numpy(), off.flux.numpy())
    assert off._sentinel is None  # off constructs nothing


def test_conservation_anomaly_detected_and_raises():
    src, moves = _corridor_workload()
    n = src.shape[0]
    t = _facade("monolithic", n, sentinel=SentinelPolicy(on_anomaly="raise"))
    t.CopyInitialPosition(src.reshape(-1).copy())
    t.MoveToNextLocation(None, moves[0].reshape(-1).copy())
    t.flux[0] += 1.0  # corruption between moves
    with pytest.raises(SentinelAnomalyError, match="conservation"):
        t.MoveToNextLocation(None, moves[1].reshape(-1).copy())
    rep = t.health_report()
    assert rep.anomaly_mask_union & ANOMALY_CONSERVATION
    assert rep.max_conservation_residual > 1e-6


def test_nonfinite_flux_anomaly_recorded(capsys):
    src, moves = _corridor_workload()
    n = src.shape[0]
    t = _facade("monolithic", n, sentinel=SentinelPolicy(on_anomaly="record"))
    t.CopyInitialPosition(src.reshape(-1).copy())
    t.flux[0] = float("nan")
    t.MoveToNextLocation(None, moves[0].reshape(-1).copy())
    rep = t.health_report()
    assert rep.anomaly_mask_union & ANOMALY_NONFINITE
    assert rep.anomaly_moves == 1
    assert "[SENTINEL]" not in capsys.readouterr().out


def test_health_report_in_vtk_field_data(tmp_path):
    src, moves = _corridor_workload()
    n = src.shape[0]
    t = _facade("monolithic", n, max_iters=2, sentinel=SentinelPolicy())
    _drive(t, src, moves)
    out = str(tmp_path / "health.vtk")
    t.WriteTallyResults(out)
    assert read_vtk_field_scalars(out, "sentinel_moves_audited")[0] == 2.0
    assert read_vtk_field_scalars(
        out, "sentinel_stragglers_recovered")[0] > 0.0
    assert read_vtk_field_scalars(out, "sentinel_stragglers_lost")[0] == 0.0
    assert read_vtk_field_scalars(out, "lost_particles")[0] == 0.0


def test_quarantine_append_and_torn_tail_readback(tmp_path):
    d = str(tmp_path)
    append_quarantine(d, [{"pid": 1, "reason": "a"}])
    append_quarantine(d, [{"pid": 2, "reason": "b"},
                          {"pid": 3, "reason": "c"}])
    path = quarantine_path(d)
    assert [r["pid"] for r in read_quarantine(path)] == [1, 2, 3]
    with open(path, "ab") as f:  # torn tail: skipped
        f.write(b'{"pid": 4, "reas')
    assert [r["pid"] for r in read_quarantine(path)] == [1, 2, 3]
    with open(path, "wb") as f:  # a torn line inside: corruption
        f.write(b'{"pid": 1}\n{"bro\n{"pid": 3}\n')
    with pytest.raises(ValueError, match="unparseable"):
        read_quarantine(path)


def test_atomic_append_creates_and_extends(tmp_path):
    p = str(tmp_path / "log.jsonl")
    atomic_append(p, b"one\n")
    atomic_append(p, b"two\n")
    with open(p, "rb") as f:
        assert f.read() == b"one\ntwo\n"
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_sentinel_policy_validation():
    with pytest.raises(ValueError, match="on_anomaly"):
        SentinelPolicy(on_anomaly="explode")
    with pytest.raises(ValueError, match="retry_iters_factor"):
        SentinelPolicy(retry_iters_factor=0)
    with pytest.raises(ValueError, match="conservation_rtol"):
        SentinelPolicy(conservation_rtol=0.0)
    with pytest.raises(ValueError, match="sentinel"):
        TallyConfig(sentinel=object())
    with pytest.raises(RuntimeError, match="sentinel"):
        _facade("monolithic", 4).health_report()
    # A JAX policy crosses over field by field.
    cfg = convert.tally_config(JaxTallyConfig(
        sentinel=JaxSentinelPolicy(retry_iters_factor=3,
                                   on_anomaly="record"),
        record_xpoints=True))
    assert cfg.sentinel == SentinelPolicy(retry_iters_factor=3,
                                          on_anomaly="record")
    assert cfg.record_xpoints


def test_straggler_recovery_keeps_scoring_bitwise():
    """tests/test_scoring.py's case: the ladder continues the scoring
    lanes too, flux and bank bitwise the unconstrained run's."""
    rng = np.random.default_rng(47)
    n, half = 240, 120

    def pts():
        p = np.empty((n, 3))
        p[:half] = rng.uniform([0.05, 0.05, 0.05], [0.45, 0.95, 0.95],
                               (half, 3))
        p[half:] = rng.uniform([0.55, 0.05, 0.05], [0.95, 0.95, 0.95],
                               (n - half, 3))
        return p

    src, dests = pts(), [pts(), pts()]
    energy = np.where(np.arange(n) < half, 0.5, 1.5)
    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(
        jax_build_box(1, 1, 1, 4, 4, 4)))
    spec = ScoringSpec([EnergyFilter([0.0, 1.0, 2.0])],
                       ["flux", "heating", "events"])
    free = PumiTally(mesh, n, TallyConfig(scoring=spec), device="cpu")
    t = PumiTally(mesh, n, TallyConfig(
        scoring=spec, max_iters=2,
        sentinel=SentinelPolicy(on_anomaly="record")), device="cpu")
    for tally in (free, t):
        _drive(tally, src, dests, energy=energy)
    rep = t.health_report()
    assert rep.stragglers_recovered > 0 and rep.stragglers_lost == 0
    np.testing.assert_array_equal(t.flux.numpy(), free.flux.numpy())
    np.testing.assert_array_equal(t.score_bank.numpy(),
                                  free.score_bank.numpy())


@pytest.mark.parametrize("kind", ["monolithic", "partitioned"])
def test_health_counts_match_jax(kind):
    """The port's health report against the JAX facade's on the same
    inputs (the JAX walk checks its budget every step here,
    ``walk_cond_every=1``, as the port's walk does)."""
    src, moves = _corridor_workload()
    n = src.shape[0]
    kw = dict(check_found_all=False, max_iters=2, walk_cond_every=1)
    if kind == "partitioned":
        kw.update(walk_vmem_max_elems=300, walk_block_kernel="gather")
        jax_t = JaxPartitionedPumiTally(_JMESH, n, JaxTallyConfig(
            sentinel=JaxSentinelPolicy(), **kw))
        port = PartitionedPumiTally(_MESH, n, TallyConfig(
            sentinel=SentinelPolicy(), **kw), device="cpu")
    else:
        jax_t = JaxPumiTally(_JMESH, n, JaxTallyConfig(
            sentinel=JaxSentinelPolicy(), **kw))
        port = PumiTally(_MESH, n, TallyConfig(sentinel=SentinelPolicy(),
                                               **kw), device="cpu")
    for t in (jax_t, port):
        _drive(t, src, moves)
    got, want = port.health_report().as_dict(), jax_t.health_report().as_dict()
    resid = "max_conservation_residual"
    assert got[resid] < 1e-12 and want[resid] < 1e-12
    del got[resid], want[resid]
    assert got == want
    assert got["unfinished_total"] > 0
    # The lanes run along the tets' diagonal faces: which of two tets
    # sharing a face holds a particle (and its track) is a face tie, so
    # the ids and the per-element flux are not compared here.
    np.testing.assert_allclose(port.positions, np.asarray(jax_t.positions),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(port.flux.sum()),
                               float(np.asarray(jax_t.flux).sum()),
                               rtol=1e-12)


def _off_diagonal_workload(n=6):
    """Lanes off the tets' faces: particle i flies along x at
    y = (i + 0.5) / n, z = 0.37, so every crossing is a transversal one
    (no face tie) and each element is scored by one history a move."""
    y = (np.arange(n) + 0.5) / n
    z = np.full(n, 0.37)
    src = np.stack([np.full(n, 0.07), y, z], axis=1)
    d1 = np.stack([np.full(n, 0.93), y, z], axis=1)
    d2 = np.stack([np.full(n, 0.15), y, z], axis=1)
    return src, [d1, d2]


@pytest.mark.parametrize("kind", ["monolithic", "partitioned",
                                  "two_tier_rung"])
def test_ladder_per_element_matches_jax(kind, monkeypatch):
    """The ladder's per-element output against the JAX facade's on lanes
    off the tets' faces, both walks checking their budget every step
    (``walk_cond_every=1``): the health counts, element ids and
    positions exact, the per-element flux at rtol 1e-10 (atol 1e-15).
    "two_tier_rung": the two-tier mesh with every rung 1 starved to one
    step in both packages, so rung 2 (the full-precision planes; in the
    port W0's unpacked walk over the refinement tier's strided views)
    finishes the stragglers."""
    import pumiumtally_tpu.sentinel.straggler as jax_straggler

    src, moves = _off_diagonal_workload()
    n = src.shape[0]
    kw = dict(check_found_all=False, max_iters=2, walk_cond_every=1)
    rungs = {"jax": [], "port": []}
    if kind == "two_tier_rung":
        kw.update(walk_table_dtype="bfloat16")
        real_j, real_p = jax_straggler._retry_step, straggler._retry_step

        def starved_j(*a, tol, max_iters, walk_kw=(), score_kinds=()):
            # The JAX rung 1 names the facade's tier, rung 2 "float32".
            f32 = dict(walk_kw).get("table_dtype") == "float32"
            rungs["jax"].append("float32" if f32 else None)
            return real_j(*a, tol=tol, max_iters=max_iters if f32 else 1,
                          walk_kw=walk_kw, score_kinds=score_kinds)

        def starved_p(*a, table_dtype=None, max_iters, **k):
            rungs["port"].append(table_dtype)
            return real_p(*a, table_dtype=table_dtype, max_iters=1
                          if table_dtype is None else max_iters, **k)

        monkeypatch.setattr(jax_straggler, "_retry_step", starved_j)
        monkeypatch.setattr(straggler, "_retry_step", starved_p)
    if kind == "partitioned":
        kw.update(walk_vmem_max_elems=300, walk_block_kernel="gather")
        jax_t = JaxPartitionedPumiTally(_JMESH, n, JaxTallyConfig(
            sentinel=JaxSentinelPolicy(), **kw))
        port = PartitionedPumiTally(_MESH, n, TallyConfig(
            sentinel=SentinelPolicy(), **kw), device="cpu")
    else:
        jax_t = JaxPumiTally(_JMESH, n, JaxTallyConfig(
            sentinel=JaxSentinelPolicy(), **kw))
        port = PumiTally(_MESH, n, TallyConfig(sentinel=SentinelPolicy(),
                                               **kw), device="cpu")
    for t in (jax_t, port):
        _drive(t, src, moves)
    got, want = port.health_report().as_dict(), jax_t.health_report().as_dict()
    resid = "max_conservation_residual"
    assert got[resid] < 1e-12 and want[resid] < 1e-12
    del got[resid], want[resid]
    assert got == want
    assert got["unfinished_total"] > 0 and got["stragglers_lost"] == 0
    if kind == "two_tier_rung":
        assert rungs["port"] == rungs["jax"] and "float32" in rungs["port"]
    np.testing.assert_array_equal(port.elem_ids, np.asarray(jax_t.elem_ids))
    np.testing.assert_array_equal(port.positions,
                                  np.asarray(jax_t.positions))
    np.testing.assert_allclose(port.flux.numpy(), np.asarray(jax_t.flux),
                               rtol=1e-10, atol=1e-15)


# ---------------------------------------------------------------------------
# The overflow ladder and the resilience layer
# ---------------------------------------------------------------------------

_POISON_ARM = r"""
import json, sys
import numpy as np
from pumiumtally_tpu_torch import (CheckpointPolicy, PartitionedPumiTally,
                                   SentinelPolicy, TallyConfig, build_box,
                                   EnginePoisonedError)
from pumiumtally_tpu_torch.resilience import GenerationStore
import torch
workdir = sys.argv[1]
mesh = build_box(1.0, 1.0, 1.0, 4, 4, 4, dtype=torch.float64)
n = 40
rng = np.random.default_rng(7)
src = rng.uniform(0.1, 0.9, (n, 3))
corner = rng.uniform(0.02, 0.10, (n, 3))
t = PartitionedPumiTally(mesh, n, TallyConfig(
    check_found_all=False, capacity_factor=1.05, walk_vmem_max_elems=100,
    walk_block_kernel="gather", sentinel=SentinelPolicy(),
    checkpoint=CheckpointPolicy(dir=workdir, handle_signals=False)),
    device="cpu")
# The ladder's escalation rungs disabled: the overflow has no cure.
t.engine._escalate_capacity = lambda *a, **k: None
try:
    t.CopyInitialPosition(src.reshape(-1).copy())
    t.MoveToNextLocation(None, corner.reshape(-1).copy())
    raise SystemExit("expected the ladder to exhaust")
except RuntimeError as e:
    ladder_msg = str(e)
try:
    t.MoveToNextLocation(None, corner.reshape(-1).copy())
    raise SystemExit("expected the poisoned refusal")
except EnginePoisonedError as e:
    refusal_msg = str(e)
store = GenerationStore(workdir)
gens = store.generations()
print(json.dumps({
    "poisoned": t.engine.poisoned,
    "ladder_msg_has_poisoned": "poisoned" in ladder_msg,
    "refusal_msg_has_resume": "resume from checkpoint" in refusal_msg,
    "generations": len(gens),
    "save_reasons": [store.read_generation(p)[2].get("reason")
                     for _, p in gens],
}))
"""


def test_overflow_poison_and_safety_save_subprocess(tmp_path):
    """The exhausted ladder (escalation disabled), across a process
    boundary: one ``overflow_safety`` generation written through the
    armed ``CheckpointPolicy``, the engine latched poisoned, and the next
    call refused with the resume-from-checkpoint error."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _POISON_ARM, str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=root,
        env={**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith("{")][-1])
    assert rec["poisoned"] is True
    assert rec["ladder_msg_has_poisoned"] is True
    assert rec["refusal_msg_has_resume"] is True
    assert rec["generations"] >= 1
    assert "overflow_safety" in rec["save_reasons"]


def test_checkpoint_restore_after_capacity_escalation(tmp_path):
    """A checkpoint saved after the overflow ladder escalated capacity
    holds a distribution a freshly built engine cannot place: the
    restore escalates and retries as the live ladder does, restores the
    state exactly, and the restored engine keeps transporting."""
    from pumiumtally_tpu_torch.utils.checkpoint import (
        load_tally_state,
        save_tally_state,
    )

    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(
        jax_build_box(1.0, 1.0, 1.0, 4, 4, 4)))
    n = 40
    rng = np.random.default_rng(9)
    src = rng.uniform(0.1, 0.9, (n, 3))
    corner = rng.uniform(0.02, 0.10, (n, 3))
    cfg = TallyConfig(check_found_all=False, capacity_factor=1.05,
                      walk_vmem_max_elems=100, walk_block_kernel="gather",
                      sentinel=SentinelPolicy())
    t = PartitionedPumiTally(mesh, n, cfg, device="cpu")
    _drive(t, src, [corner])
    assert t.engine.capacity_escalations >= 1  # the premise
    path = str(tmp_path / "escalated.npz")
    save_tally_state(t, path)
    t2 = PartitionedPumiTally(mesh, n, cfg, device="cpu")
    load_tally_state(t2, path)
    assert t2.engine.capacity_escalations >= 1
    np.testing.assert_array_equal(t2.positions, t.positions)
    np.testing.assert_array_equal(t2.elem_ids, t.elem_ids)
    np.testing.assert_allclose(t2.flux.numpy(), t.flux.numpy(), rtol=1e-12,
                               atol=1e-15)
    t2.MoveToNextLocation(None, src.reshape(-1).copy())
    assert not t2.engine.poisoned
