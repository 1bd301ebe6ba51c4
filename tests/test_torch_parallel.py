"""PyTorch port, the sharded facades: ``PumiTally`` and ``StreamingTally``
with ``TallyConfig(device_mesh=...)`` on eight CPU shards
(``make_device_mesh(8, devices=[cpu] * 8)``, the plain versions standing
in for W0) against the JAX package's sharded facades on its eight
virtual CPU devices, against the port's own single-device facades, and
run to run.

Tolerances, float64: the cube oracle to 1e-8; element ids and positions
exact against both; flux rtol 1e-10 against JAX (its psum orders the
sum its own way), rtol 1e-13 against one device, bitwise run to run;
conservation rtol 1e-12; scoring banks rtol 1e-10."""

import numpy as np
import pytest
import torch

from pumiumtally_tpu import EnergyFilter as JaxEnergyFilter
from pumiumtally_tpu import PumiTally as JaxPumiTally
from pumiumtally_tpu import ScoringSpec as JaxScoringSpec
from pumiumtally_tpu import StreamingTally as JaxStreamingTally
from pumiumtally_tpu import TallyConfig as JaxTallyConfig
from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu.parallel import make_device_mesh as jax_device_mesh
from pumiumtally_tpu_torch import (
    CheckpointPolicy,
    EnergyFilter,
    PumiTally,
    ScoringSpec,
    StreamingTally,
    TallyConfig,
    convert,
)
from pumiumtally_tpu_torch.parallel import DeviceMesh, make_device_mesh
from pumiumtally_tpu_torch.sentinel import SentinelPolicy

CPU = torch.device("cpu")
NUM = 5  # not divisible by 8: the capacity pads
TOL = 1e-8


def _mesh8():
    return make_device_mesh(8, devices=[CPU] * 8)


def _flat(a):
    return np.ascontiguousarray(np.asarray(a, np.float64).reshape(-1))


def _pmesh(*box):
    jm = jax_build_box(*box)
    return jm, convert.tetmesh_from_arrays(convert.mesh_arrays(jm))


def _campaign(t, src, d1, d2, fly, w, **kw):
    t.CopyInitialPosition(_flat(src))
    t.MoveToNextLocation(_flat(src), _flat(d1), fly.copy(), w.copy(), **kw)
    t.MoveToNextLocation(None, _flat(d2), np.ones(len(w), np.int8),
                         w.copy(), **kw)
    return t


def _arrays(n, seed):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.05, 0.95, (n, 3))
    d1 = rng.uniform(-0.1, 1.1, (n, 3))
    d2 = rng.uniform(0.05, 0.95, (n, 3))
    fly = (rng.uniform(size=n) < 0.8).astype(np.int8)
    w = rng.uniform(0.5, 2.0, n)
    return src, d1, d2, fly, w


def test_sharded_oracle_sequence():
    _, mesh = _pmesh(1, 1, 1, 1, 1, 1)
    t = PumiTally(mesh, NUM, TallyConfig(device_mesh=_mesh8()), device="cpu")
    assert t._cap == 8 and t.x.shape == (8, 3)
    init = np.tile([0.1, 0.4, 0.5], (NUM, 1))
    t.CopyInitialPosition(_flat(init), 3 * NUM)
    dests = np.tile([1.2, 0.4, 0.5], (NUM, 1))
    t.MoveToNextLocation(_flat(init), _flat(dests), np.ones(NUM, np.int8),
                         np.ones(NUM), 3 * NUM)
    np.testing.assert_array_equal(t.elem_ids, np.full(NUM, 4))
    np.testing.assert_allclose(t.positions, np.tile([1.0, 0.4, 0.5],
                                                    (NUM, 1)), atol=TOL)
    np.testing.assert_allclose(
        t.flux.numpy(), [0.0, 0.0, 0.3 * NUM, 0.1 * NUM, 0.5 * NUM, 0.0],
        atol=TOL)


@pytest.mark.parametrize("facade", ["mono", "streaming"])
@pytest.mark.parametrize("localization", ["walk", "locate"])
def test_sharded_matches_jax_sharded(facade, localization):
    jm, mesh = _pmesh(1, 1, 1, 4, 4, 4)
    n = 203
    arrays = _arrays(n, 42)
    if facade == "mono":
        ref = JaxPumiTally(jm, n, JaxTallyConfig(
            device_mesh=jax_device_mesh(8), localization=localization))
        port = PumiTally(mesh, n, TallyConfig(
            device_mesh=_mesh8(), localization=localization), device="cpu")
    else:
        ref = JaxStreamingTally(jm, n, 60, JaxTallyConfig(
            device_mesh=jax_device_mesh(8), localization=localization))
        port = StreamingTally(mesh, n, 60, TallyConfig(
            device_mesh=_mesh8(), localization=localization), device="cpu")
        assert port.chunk_size == ref.chunk_size == 64
    _campaign(ref, *arrays)
    _campaign(port, *arrays)
    np.testing.assert_array_equal(port.elem_ids, np.asarray(ref.elem_ids))
    np.testing.assert_array_equal(port.positions, np.asarray(ref.positions))
    np.testing.assert_allclose(port.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("facade", ["mono", "streaming"])
def test_sharded_matches_single_device(facade):
    _, mesh = _pmesh(1, 1, 1, 4, 4, 4)
    n = 97
    arrays = _arrays(n, 7)
    out = []
    for dm in (None, _mesh8()):
        cfg = TallyConfig(device_mesh=dm)
        t = (PumiTally(mesh, n, cfg, device="cpu") if facade == "mono"
             else StreamingTally(mesh, n, 40, cfg, device="cpu"))
        out.append(_campaign(t, *arrays))
    one, eight = out
    np.testing.assert_array_equal(one.elem_ids, eight.elem_ids)
    np.testing.assert_array_equal(one.positions, eight.positions)
    np.testing.assert_allclose(one.flux.numpy(), eight.flux.numpy(),
                               rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("checkpoint", [False, True])
def test_sharded_runs_are_deterministic(tmp_path, checkpoint):
    _, mesh = _pmesh(1, 1, 1, 4, 4, 4)
    n = 64
    arrays = _arrays(n, 3)
    fluxes = []
    for k in range(2):
        pol = (CheckpointPolicy(dir=str(tmp_path / f"r{k}"),
                                handle_signals=False)
               if checkpoint else None)
        t = PumiTally(mesh, n, TallyConfig(device_mesh=_mesh8(),
                                           checkpoint=pol), device="cpu")
        fluxes.append(_campaign(t, *arrays).flux.numpy())
    np.testing.assert_array_equal(fluxes[0], fluxes[1])


def test_sharded_conservation():
    _, mesh = _pmesh(1, 1, 1, 5, 5, 5)
    n = 1000
    rng = np.random.default_rng(7)
    src = rng.uniform(0.05, 0.95, (n, 3))
    dst = rng.uniform(0.0, 1.0, (n, 3))
    t = PumiTally(mesh, n, TallyConfig(device_mesh=_mesh8()), device="cpu")
    t.CopyInitialPosition(_flat(src))
    t.MoveToNextLocation(_flat(src), _flat(dst), np.ones(n, np.int8),
                         np.ones(n))
    np.testing.assert_allclose(float(t.flux.sum()),
                               np.linalg.norm(dst - src, axis=1).sum(),
                               rtol=1e-12)


@pytest.mark.parametrize("facade", ["mono", "streaming"])
def test_sharded_scoring_banks_match_jax(facade):
    jm, mesh = _pmesh(1, 1, 1, 3, 3, 3)
    n = 150
    arrays = _arrays(n, 11)
    en = np.where(np.arange(n) % 2 == 0, 0.5, 1.5)
    jspec = JaxScoringSpec(filters=[JaxEnergyFilter([0.0, 1.0, 2.0])],
                           scores=["flux", "events"])
    spec = ScoringSpec(filters=[EnergyFilter([0.0, 1.0, 2.0])],
                       scores=["flux", "events"])
    if facade == "mono":
        ref = JaxPumiTally(jm, n, JaxTallyConfig(
            device_mesh=jax_device_mesh(8), scoring=jspec))
        port = PumiTally(mesh, n, TallyConfig(device_mesh=_mesh8(),
                                              scoring=spec), device="cpu")
    else:
        ref = JaxStreamingTally(jm, n, 64, JaxTallyConfig(
            device_mesh=jax_device_mesh(8), scoring=jspec))
        port = StreamingTally(mesh, n, 64, TallyConfig(
            device_mesh=_mesh8(), scoring=spec), device="cpu")
    _campaign(ref, *arrays, energy=en)
    _campaign(port, *arrays, energy=en)
    np.testing.assert_allclose(port.score_bank.numpy(),
                               np.asarray(ref.score_bank), rtol=1e-10,
                               atol=1e-14)
    np.testing.assert_allclose(port.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-14)


def test_sharded_sentinel_audits_clean():
    _, mesh = _pmesh(1, 1, 1, 3, 3, 3)
    n = 77
    arrays = _arrays(n, 5)
    plain = _campaign(PumiTally(mesh, n, TallyConfig(device_mesh=_mesh8()),
                                device="cpu"), *arrays)
    t = _campaign(PumiTally(mesh, n, TallyConfig(
        device_mesh=_mesh8(), sentinel=SentinelPolicy()), device="cpu"),
        *arrays)
    assert t.health_report().anomaly_moves == 0
    np.testing.assert_array_equal(plain.flux.numpy(), t.flux.numpy())


def test_sharded_checkpoint_resumes_bitwise_and_crosses_packages(tmp_path):
    """``checkpoint_now`` / ``resume_latest`` on a 4-shard facade resume
    bitwise on the same mesh; the JAX sharded facade reads the port's
    generation and the port reads JAX's."""
    from pumiumtally_tpu.resilience import CheckpointPolicy as JaxPolicy

    jm, mesh = _pmesh(1, 1, 1, 3, 3, 3)
    n = 50
    src, d1, d2, fly, w = _arrays(n, 9)
    dm4 = make_device_mesh(4, devices=[CPU] * 4)

    def port_tally(d):
        return PumiTally(mesh, n, TallyConfig(
            device_mesh=dm4, checkpoint=CheckpointPolicy(
                dir=str(d), handle_signals=False)), device="cpu")

    full = port_tally(tmp_path / "full")
    _campaign(full, src, d1, d2, fly, w)
    a = port_tally(tmp_path / "a")
    a.CopyInitialPosition(_flat(src))
    a.MoveToNextLocation(_flat(src), _flat(d1), fly.copy(), w.copy())
    a.checkpoint_now()
    b = port_tally(tmp_path / "a")
    assert b.resume_latest() is not None
    b.MoveToNextLocation(None, _flat(d2), np.ones(n, np.int8), w.copy())
    np.testing.assert_array_equal(b.flux.numpy(), full.flux.numpy())
    np.testing.assert_array_equal(b.positions, full.positions)
    # Across packages, both ways, each on its own sharded facade.
    j = JaxPumiTally(jm, n, JaxTallyConfig(
        device_mesh=jax_device_mesh(4),
        checkpoint=JaxPolicy(dir=str(tmp_path / "a"),
                             handle_signals=False)))
    assert j.resume_latest() is not None
    np.testing.assert_array_equal(np.asarray(j.positions), a.positions)
    np.testing.assert_array_equal(np.asarray(j.flux), a.flux.numpy())
    j.checkpoint_now()
    c = port_tally(tmp_path / "a")
    assert c.resume_latest() is not None
    np.testing.assert_array_equal(c.positions, a.positions)
    np.testing.assert_array_equal(c.elem_ids, a.elem_ids)


def test_intersection_points_refuses_a_mesh():
    _, mesh = _pmesh(1, 1, 1, 2, 2, 2)
    t = PumiTally(mesh, 8, TallyConfig(device_mesh=_mesh8(),
                                       record_xpoints=True), device="cpu")
    t.CopyInitialPosition(_flat(np.full((8, 3), 0.5)))
    with pytest.raises(NotImplementedError, match="device_mesh"):
        t.intersection_points()


def test_device_mesh_construction():
    dm = make_device_mesh(3, devices=[CPU] * 8)
    assert dm.size == 3 and dm.axis_names == ("dp",) and dm.local == (0, 1, 2)
    assert dm.home == CPU and not dm.multi_process
    with pytest.raises(ValueError, match="requested 9 devices, only 8"):
        make_device_mesh(9, devices=[CPU] * 8)
    flat = DeviceMesh((CPU,) * 4, ("a", "b"))
    with pytest.raises(ValueError, match="1-D device mesh"):
        TallyConfig(device_mesh=flat)
    with pytest.raises(ValueError, match="DeviceMesh"):
        TallyConfig(device_mesh=jax_device_mesh(8))
    # A JAX config's mesh crosses over as a port mesh of its size.
    cfg = convert.tally_config(JaxTallyConfig(
        device_mesh=jax_device_mesh(8), migrate_collective=True,
        placement="pod_rcb", placement_hosts=(3, 5)))
    assert cfg.device_mesh.size == 8 and cfg.device_mesh.home == CPU
    assert cfg.migrate_collective and cfg.placement == "pod_rcb"
    assert cfg.placement_hosts == (3, 5)


def test_config_has_every_jax_field():
    """The port's TallyConfig has every field of the JAX one, with its
    default (a JAX mesh and its port counterpart are both None)."""
    import dataclasses

    port = {f.name: f for f in dataclasses.fields(TallyConfig)}
    for f in dataclasses.fields(JaxTallyConfig):
        assert f.name in port, f.name
        assert getattr(JaxTallyConfig(), f.name) == \
            getattr(TallyConfig(), f.name) or f.name == "dtype", f.name
