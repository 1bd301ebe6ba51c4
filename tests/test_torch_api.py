"""PyTorch port, the monolithic facade: the port's ``PumiTally`` against
the JAX package's through the three-call protocol, on one seeded
workload handed to both (mesh through ``convert``).

Tolerances, float64: element ids exact; positions to 1e-12 absolute;
normalized flux to rtol 1e-10 (another addition order); the VTK bytes
identical once the flux is identical."""

import numpy as np
import pytest
import torch

from pumiumtally_tpu import PumiTally as JaxPumiTally
from pumiumtally_tpu import TallyConfig as JaxTallyConfig
from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu_torch import PumiTally, TallyConfig, convert

N = 400


def _flat(a):
    return np.ascontiguousarray(np.asarray(a, np.float64).reshape(-1))


def _trajectory(seed=11, n=N):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.05, 0.95, (n, 3))
    d1 = rng.uniform(-0.1, 1.1, (n, 3))  # some leave the box
    fly1 = (rng.random(n) > 0.2).astype(np.int8)
    w1 = rng.uniform(0.5, 2.0, n)
    d2 = rng.uniform(0.05, 0.95, (n, 3))
    return src, d1, fly1, w1, d2


def _pair(localization="walk", div=4):
    jmesh = jax_build_box(1, 1, 1, div, div, div)
    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(jmesh))
    ref = JaxPumiTally(jmesh, N, JaxTallyConfig(localization=localization))
    port = PumiTally(mesh, N, TallyConfig(localization=localization),
                     device="cpu")
    return ref, port


def _assert_same(port, ref):
    np.testing.assert_array_equal(port.elem_ids, ref.elem_ids)
    np.testing.assert_allclose(port.positions, ref.positions, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(port.normalized_flux().numpy(),
                               np.asarray(ref.normalized_flux()),
                               rtol=1e-10, atol=1e-13)


def _protocol(t, traj):
    src, d1, fly1, w1, d2 = traj
    t.CopyInitialPosition(_flat(src), 3 * N)
    yield "localized"
    t.MoveToNextLocation(_flat(src), _flat(d1), fly1.copy(), w1)
    yield "two-phase"
    # Resample a third of the particles: phase A walks them (no tally).
    origins2 = t.positions.copy()
    origins2[::3] = d2[::3][:, ::-1]
    t.MoveToNextLocation(_flat(origins2), _flat(d2), None, None)
    yield "resampled"
    t.MoveToNextLocation(None, _flat(src))
    yield "continue"


@pytest.mark.parametrize("localization", ["walk", "locate"])
def test_facade_matches_jax_through_the_protocol(localization):
    ref, port = _pair(localization)
    traj = _trajectory()
    for step_ref, step_port in zip(_protocol(ref, traj),
                                   _protocol(port, traj)):
        assert step_ref == step_port
        _assert_same(port, ref)
    assert (port.positions.max() <= 1.0 + 1e-12
            and port.positions.min() >= -1e-12)
    assert port.iter_count == 3


def test_flying_side_effect():
    _, port = _pair()
    src, d1, fly1, w1, _ = _trajectory(n=N)
    port.CopyInitialPosition(_flat(src))
    fly = fly1.copy()
    port.MoveToNextLocation(_flat(src), _flat(d1), fly, w1)
    np.testing.assert_array_equal(fly, 0)
    as_list = [1] * N
    port.MoveToNextLocation(None, _flat(src), as_list, None)
    assert as_list == [0] * N
    ro = np.ones(N, np.int8)
    ro.flags.writeable = False
    with pytest.warns(UserWarning, match="read-only"):
        port.MoveToNextLocation(None, _flat(d1), ro, None)
    np.testing.assert_array_equal(ro, 1)


def test_state_carried_from_jax_and_vtk_bytes_identical(tmp_path):
    """Carry the JAX facade's mid-campaign state into the port through
    ``convert``; both then move identically, and with the JAX flux
    carried over, the written VTK files are byte-identical."""
    ref, port = _pair()
    src, d1, fly1, w1, d2 = _trajectory()
    ref.CopyInitialPosition(_flat(src))
    ref.MoveToNextLocation(_flat(src), _flat(d1), fly1.copy(), w1)
    convert.load_facade_state(port, convert.facade_state(ref))
    _assert_same(port, ref)
    ref.MoveToNextLocation(None, _flat(d2))
    port.MoveToNextLocation(None, _flat(d2))
    _assert_same(port, ref)
    convert.load_facade_state(port, convert.facade_state(ref))
    for t, name in ((ref, "jax.vtk"), (port, "port.vtk")):
        t.WriteTallyResults(str(tmp_path / name))
    assert (tmp_path / "jax.vtk").read_bytes() == \
        (tmp_path / "port.vtk").read_bytes()


def test_protocol_order_and_device_checks():
    _, port = _pair()
    with pytest.raises(RuntimeError, match="CopyInitialPosition"):
        port.MoveToNextLocation(None, _flat(np.zeros((N, 3))))
    with pytest.raises(ValueError, match="size"):
        port.CopyInitialPosition(_flat(np.zeros((N, 3))), 5)
    # A mesh path is loaded (tests/test_torch_io.py); a missing one
    # raises the loader's error, as in the JAX package.
    with pytest.raises(ValueError, match="DIRECTORY"):
        PumiTally("mesh.osh", 4, device="cpu")
    mesh32 = port.mesh.to(torch.float32)
    t = PumiTally(mesh32, 4, TallyConfig(dtype=torch.float64), device="cpu")
    assert t.dtype == torch.float64 and t.mesh.dtype == torch.float64
    assert t.config.resolved_tolerance(t.dtype) == 1e-8
    assert PumiTally(mesh32, 4, device="cpu")._tol == 1e-6
