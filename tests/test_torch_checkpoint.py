"""PyTorch port, checkpoint and resume (``utils/checkpoint.py``): the
counterparts of tests/test_utils.py's checkpoint cases on the port's
facades, and checkpoints crossing between the packages in both
directions on all four facades. float64, the kernels' plain versions on
the CPU, inputs from numpy seeds.

Tolerances: a restore is exact (flux, positions, element ids, counters,
statistics lanes, slot rows where the layouts match); a restored engine
continued by the same engine kind stays bitwise; continued by another
engine kind (another walk's arithmetic or slot order) flux at rtol
1e-11 with a 1e-12 floor and element ids exact, as in
tests/test_utils.py; the two packages continued from one checkpoint,
flux at rtol 1e-10 with a 1e-13 floor, positions to 1e-12, ids exact
(the cross-package parity class of the other tests/test_torch_*.py)."""

import numpy as np
import pytest
import torch

from pumiumtally_tpu import PartitionedPumiTally as JaxPartitioned
from pumiumtally_tpu import PumiTally as JaxPumiTally
from pumiumtally_tpu import StreamingPartitionedTally as JaxStreamingPart
from pumiumtally_tpu import StreamingTally as JaxStreamingTally
from pumiumtally_tpu import TallyConfig as JaxTallyConfig
from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu.parallel import make_device_mesh
from pumiumtally_tpu.utils import load_tally_state as jax_load
from pumiumtally_tpu.utils import save_tally_state as jax_save
from pumiumtally_tpu_torch import (
    EnergyFilter,
    PartitionedPumiTally,
    PumiTally,
    ScoringSpec,
    StreamingPartitionedTally,
    StreamingTally,
    TallyConfig,
    convert,
)
from pumiumtally_tpu_torch.utils import checkpoint as ckpt_mod
from pumiumtally_tpu_torch.utils.checkpoint import (
    collect_tally_state,
    load_tally_state,
    save_tally_state,
)

from tests.bounds import CLIP_HI as HI, CLIP_LO as LO

N = 16
_JMESH3 = jax_build_box(1, 1, 1, 3, 3, 3)
_MESH3 = convert.tetmesh_from_arrays(convert.mesh_arrays(_JMESH3))
_JMESH4 = jax_build_box(1, 1, 1, 4, 4, 4)
_MESH4 = convert.tetmesh_from_arrays(convert.mesh_arrays(_JMESH4))


def _flat(a):
    return np.ascontiguousarray(np.asarray(a, np.float64).reshape(-1))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _mono(n=N, mesh=_MESH3, **cfg):
    return PumiTally(mesh, n, TallyConfig(**cfg), device="cpu")


def _driven_tally():
    t = _mono()
    rng = np.random.default_rng(5)
    src = rng.uniform(0.1, 0.9, (N, 3))
    dst = rng.uniform(0.1, 0.9, (N, 3))
    t.CopyInitialPosition(_flat(src))
    t.MoveToNextLocation(_flat(src), _flat(dst), np.ones(N, np.int8),
                         np.ones(N))
    return t


def test_checkpoint_roundtrip(tmp_path):
    t = _driven_tally()
    ckpt = str(tmp_path / "state.npz")
    save_tally_state(t, ckpt)
    t2 = _mono()
    load_tally_state(t2, ckpt)
    np.testing.assert_array_equal(_np(t2.flux), _np(t.flux))
    np.testing.assert_array_equal(t2.positions, t.positions)
    np.testing.assert_array_equal(t2.elem_ids, t.elem_ids)
    assert t2.iter_count == t.iter_count and t2.is_initialized
    # The resumed engine keeps tallying bitwise as the original.
    dst = np.tile([0.5, 0.5, 0.5], (N, 1))
    for eng in (t, t2):
        eng.MoveToNextLocation(_flat(eng.positions), _flat(dst),
                               np.ones(N, np.int8), np.ones(N))
    np.testing.assert_array_equal(_np(t2.flux), _np(t.flux))


def _cross_inputs(seed):
    n = 600
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.1, 0.9, (n, 3))
    dst = np.clip(src + rng.normal(scale=0.2, size=(n, 3)), LO, HI)
    return n, src, dst, np.clip(dst - 0.15, LO, HI)


def test_checkpoint_cross_engine_roundtrip(tmp_path):
    """A checkpoint is canonical: saved by one engine kind, it resumes in
    another, and the continued tally agrees."""
    n, src, dst, dst2 = _cross_inputs(9)
    t = _mono(n, _MESH4)
    t.CopyInitialPosition(_flat(src))
    t.MoveToNextLocation(None, _flat(dst))
    ckpt = str(tmp_path / "c.npz")
    save_tally_state(t, ckpt)
    targets = {
        "stream": StreamingTally(_MESH4, n, chunk_size=250, device="cpu"),
        "part": PartitionedPumiTally(_MESH4, n, TallyConfig(
            capacity_factor=4.0), device="cpu"),
        "stream_part": StreamingPartitionedTally(
            _MESH4, n, chunk_size=250,
            config=TallyConfig(capacity_factor=4.0), device="cpu"),
    }
    t.MoveToNextLocation(None, _flat(dst2))
    saved = np.load(ckpt)
    for name, t2 in targets.items():
        load_tally_state(t2, ckpt)
        np.testing.assert_allclose(_np(t2.flux), saved["flux"], atol=1e-14,
                                   err_msg=name)
        np.testing.assert_array_equal(t2.elem_ids, saved["elem"][:n])
        t2.MoveToNextLocation(None, _flat(dst2))
        np.testing.assert_allclose(_np(t2.flux), _np(t.flux), rtol=1e-11,
                                   atol=1e-12, err_msg=name)
        np.testing.assert_array_equal(t2.elem_ids, t.elem_ids, err_msg=name)
    # And the reverse: saved partitioned, resumed monolithic.
    ckpt2 = str(tmp_path / "c2.npz")
    save_tally_state(targets["part"], ckpt2)
    t3 = _mono(n, _MESH4)
    load_tally_state(t3, ckpt2)
    np.testing.assert_allclose(_np(t3.flux), _np(targets["part"].flux),
                               atol=1e-14)
    np.testing.assert_array_equal(t3.elem_ids, targets["part"].elem_ids)


@pytest.mark.parametrize("kernel", ["vmem", "gather"])
def test_checkpoint_restores_into_subsplit_engine(kernel, tmp_path):
    """The restore routes slots and sizes flux at block granularity, for
    the W1 sub-split and the gather sub-split: restored from a
    monolithic checkpoint, both engines stay together through a further
    move."""
    n, src, dst, dst2 = _cross_inputs(10)
    t = _mono(n, _MESH4)
    t.CopyInitialPosition(_flat(src))
    t.MoveToNextLocation(None, _flat(dst))
    ckpt = str(tmp_path / "b.npz")
    save_tally_state(t, ckpt)
    t2 = PartitionedPumiTally(_MESH4, n, TallyConfig(
        capacity_factor=4.0, walk_vmem_max_elems=40,
        walk_block_kernel=kernel), device="cpu")
    assert t2.engine.blocks_per_chip > 1
    assert t2.engine.use_vmem_walk == (kernel == "vmem")
    load_tally_state(t2, ckpt)
    np.testing.assert_allclose(_np(t2.flux), np.load(ckpt)["flux"],
                               atol=1e-14)
    np.testing.assert_array_equal(t2.elem_ids, np.load(ckpt)["elem"][:n])
    t.MoveToNextLocation(None, _flat(dst2))
    t2.MoveToNextLocation(None, _flat(dst2))
    np.testing.assert_allclose(_np(t2.flux), _np(t.flux), rtol=1e-11,
                               atol=1e-12)
    np.testing.assert_array_equal(t2.elem_ids, t.elem_ids)


def test_checkpoint_mismatch_raises(tmp_path):
    t = _driven_tally()
    ckpt = str(tmp_path / "state.npz")
    save_tally_state(t, ckpt)
    other = PumiTally(convert.tetmesh_from_arrays(convert.mesh_arrays(
        jax_build_box(1, 1, 1, 2, 2, 2))), N, device="cpu")
    with pytest.raises(ValueError, match="elements"):
        load_tally_state(other, ckpt)
    with pytest.raises(ValueError, match="particles"):
        load_tally_state(_mono(N + 1), ckpt)


def _driven_stats_tally(batches: int = 3, seed: int = 6):
    """A statistics tally with ``batches`` closed batches and one more
    open with a move in it."""
    t = _mono(batch_stats=True)
    rng = np.random.default_rng(seed)
    for _ in range(batches + 1):
        t.CopyInitialPosition(_flat(rng.uniform(0.1, 0.9, (N, 3))))
        t.MoveToNextLocation(None, _flat(rng.uniform(0.1, 0.9, (N, 3))))
    assert t._stats.num_batches == batches and t._stats.batch_open
    return t


def _same_stats(a, b):
    assert a.num_batches == b.num_batches
    assert a.moves_in_batch == b.moves_in_batch
    np.testing.assert_array_equal(_np(a.flux_sum), _np(b.flux_sum))
    np.testing.assert_array_equal(_np(a.flux_sq_sum), _np(b.flux_sq_sum))


def test_checkpoint_stats_roundtrip_exact(tmp_path):
    """A statistics (v3) checkpoint resumes the lanes, the counters and
    the open batch's snapshot exactly."""
    t = _driven_stats_tally()
    ckpt = str(tmp_path / "stats.npz")
    save_tally_state(t, ckpt)
    assert int(np.load(ckpt)["format_version"]) == 3
    t2 = _mono(batch_stats=True)
    load_tally_state(t2, ckpt)
    _same_stats(t2._stats, t._stats)
    dst = np.tile([0.4, 0.6, 0.5], (N, 1))
    for eng in (t, t2):
        eng.MoveToNextLocation(None, _flat(dst))
        eng.close_batch()
    _same_stats(t2._stats, t._stats)


def test_checkpoint_prestats_forward_compat(tmp_path):
    """A v2 checkpoint into a statistics engine: lanes zero, counter 0,
    and a batch opened at the restored flux."""
    t = _driven_tally()
    ckpt = str(tmp_path / "v2.npz")
    save_tally_state(t, ckpt)
    assert int(np.load(ckpt)["format_version"]) == 2
    t2 = _mono(batch_stats=True)
    load_tally_state(t2, ckpt)
    assert t2._stats.num_batches == 0 and t2._stats.batch_open
    assert np.all(_np(t2._stats.flux_sum) == 0.0)
    assert np.all(_np(t2._stats.flux_sq_sum) == 0.0)
    t2.MoveToNextLocation(None, _flat(np.tile([0.5, 0.5, 0.5], (N, 1))))
    t2.close_batch()
    np.testing.assert_allclose(_np(t2._stats.flux_sum),
                               _np(t2.flux) - np.load(ckpt)["flux"],
                               rtol=1e-12, atol=1e-14)


def test_checkpoint_stats_refused_by_old_reader(tmp_path, monkeypatch):
    """A statistics checkpoint handed to a pre-v3 reader fails at the
    header check with the format message."""
    t = _driven_stats_tally()
    path = str(tmp_path / "stats.npz")
    save_tally_state(t, path)
    monkeypatch.setattr(ckpt_mod, "_FORMAT_VERSION", 2)
    with pytest.raises(ValueError, match="format 3 newer than 2"):
        load_tally_state(_mono(), path)


def test_checkpoint_stats_into_disabled_engine_warns(tmp_path):
    t = _driven_stats_tally()
    path = str(tmp_path / "stats.npz")
    save_tally_state(t, path)
    t2 = _mono()
    with pytest.warns(UserWarning, match="batch_stats disabled"):
        load_tally_state(t2, path)
    np.testing.assert_array_equal(_np(t2.flux), _np(t.flux))
    np.testing.assert_array_equal(t2.positions, t.positions)


def _spec(nbins=3):
    edges = np.geomspace(1e-2, 1e2, nbins + 1)
    return ScoringSpec([EnergyFilter(edges)], ("flux", "events"))


def test_checkpoint_scoring_bank_roundtrip_and_spec_mismatch(tmp_path):
    """The scoring bank and its statistics restore exactly into the same
    spec (partitioned: the engine's padded bank bitwise); under another
    spec the banks are zeroed with a warning and the flux restores."""
    rng = np.random.default_rng(12)
    src = rng.uniform(0.1, 0.9, (N, 3))
    dst = rng.uniform(0.1, 0.9, (N, 3))
    energy = rng.uniform(2e-2, 50.0, N)
    for make in (lambda spec: _mono(scoring=spec, batch_stats=True),
                 lambda spec: PartitionedPumiTally(_MESH3, N, TallyConfig(
                     scoring=spec, batch_stats=True, capacity_factor=4.0),
                     device="cpu")):
        t = make(_spec())
        t.CopyInitialPosition(_flat(src))
        t.MoveToNextLocation(None, _flat(dst), energy=energy)
        path = str(tmp_path / "score.npz")
        save_tally_state(t, path)
        t2 = make(_spec())
        load_tally_state(t2, path)
        np.testing.assert_array_equal(_np(t2.score_bank), _np(t.score_bank))
        _same_stats(t2._score_stats, t._score_stats)
        t3 = make(_spec(nbins=4))
        with pytest.warns(UserWarning, match="different ScoringSpec"):
            load_tally_state(t3, path)
        assert np.all(_np(t3.score_bank) == 0.0)
        np.testing.assert_array_equal(_np(t3.flux), _np(t.flux))


# ---------------------------------------------------------------------------
# Across the packages: the JAX package saves and the port loads, and the
# reverse, on all four facades
# ---------------------------------------------------------------------------

FACADES = ("mono", "stream", "part", "stream_part")
XN = 40


def _jax_facade(kind):
    one = make_device_mesh(1)
    if kind == "mono":
        return JaxPumiTally(_JMESH3, XN)
    if kind == "stream":
        return JaxStreamingTally(_JMESH3, XN, chunk_size=16)
    if kind == "part":
        return JaxPartitioned(_JMESH3, XN, JaxTallyConfig(
            device_mesh=one, capacity_factor=4.0))
    return JaxStreamingPart(_JMESH3, XN, chunk_size=16, config=JaxTallyConfig(
        device_mesh=one, capacity_factor=4.0))


def _port_facade(kind):
    if kind == "mono":
        return PumiTally(_MESH3, XN, device="cpu")
    if kind == "stream":
        return StreamingTally(_MESH3, XN, chunk_size=16, device="cpu")
    if kind == "part":
        return PartitionedPumiTally(_MESH3, XN, TallyConfig(
            capacity_factor=4.0), device="cpu")
    return StreamingPartitionedTally(_MESH3, XN, chunk_size=16,
                                     config=TallyConfig(capacity_factor=4.0),
                                     device="cpu")


def _slot_rows(t, kind):
    """Every engine's slot rows and padded flux, as one flat dict (the
    layout-exact extras of a checkpoint)."""
    z = collect_tally_state(t) if isinstance(
        t, (PumiTally, StreamingTally)) else None
    if z is None:  # a JAX facade: its own checkpoint payload
        from pumiumtally_tpu.utils.checkpoint import (
            collect_tally_state as jax_collect,
        )
        z = jax_collect(t)
    return {k: np.asarray(v) for k, v in z.items()
            if k.startswith("eng") or k == "chunk_flux"}


@pytest.mark.parametrize("kind", FACADES)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(kind, direction, tmp_path):
    """One package's checkpoint restores into the other's facade of the
    same kind: state equal (flux, positions, ids, counters), the slot
    rows and per-chunk flux exact where the layouts match (they do
    here); then both packages continue from it together."""
    rng = np.random.default_rng(31)
    src = rng.uniform(0.1, 0.9, (XN, 3))
    d1 = np.clip(src + rng.normal(scale=0.2, size=(XN, 3)), LO, HI)
    d2 = np.clip(d1 - 0.15, LO, HI)
    jt, pt = _jax_facade(kind), _port_facade(kind)
    saver, loader = (jt, pt) if direction == "jax_to_port" else (pt, jt)
    save, load = ((jax_save, load_tally_state)
                  if direction == "jax_to_port" else
                  (save_tally_state, jax_load))
    saver.CopyInitialPosition(_flat(src))
    saver.MoveToNextLocation(None, _flat(d1))
    path = str(tmp_path / "x.npz")
    save(saver, path)
    load(loader, path)
    assert loader.iter_count == saver.iter_count == 1
    assert loader.is_initialized
    np.testing.assert_array_equal(_np(loader.flux), _np(saver.flux))
    np.testing.assert_array_equal(np.asarray(loader.positions),
                                  np.asarray(saver.positions))
    np.testing.assert_array_equal(np.asarray(loader.elem_ids),
                                  np.asarray(saver.elem_ids))
    rows_s, rows_l = _slot_rows(saver, kind), _slot_rows(loader, kind)
    assert rows_s.keys() == rows_l.keys()
    assert (len(rows_s) > 0) == (kind != "mono")
    for k in rows_s:
        np.testing.assert_array_equal(rows_l[k], rows_s[k], err_msg=k)
    for t in (jt, pt):
        t.MoveToNextLocation(None, _flat(d2))
    np.testing.assert_array_equal(np.asarray(pt.elem_ids),
                                  np.asarray(jt.elem_ids))
    np.testing.assert_allclose(np.asarray(pt.positions),
                               np.asarray(jt.positions), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(pt.flux), np.asarray(jt.flux),
                               rtol=1e-10, atol=1e-13)
