"""PyTorch port, the facades' staging knobs (``auto_continue``,
``fenced_timing``, ``validate_inputs``) and the cascade knobs that cross
over from a JAX configuration: the cases of
tests/test_continue_fast_path.py, each run through the port's
``PumiTally`` and the JAX package's with the same knobs, plus W0's
``skip`` flag in its plain version.

Tolerances, float64: element ids exact; positions to 1e-12 absolute;
flux to rtol 1e-10 (atol 1e-13), another addition order (as
tests/test_torch_api.py). Within the port, a knob that only changes how
inputs are staged changes nothing: results are held bitwise."""

import numpy as np
import pytest
import torch

from pumiumtally_tpu import PumiTally as JaxPumiTally
from pumiumtally_tpu import TallyConfig as JaxTallyConfig
from pumiumtally_tpu.api.tally import _ECHO_MISS_LIMIT, _ECHO_REARM_PERIOD
from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu_torch import PumiTally, TallyConfig, convert
from pumiumtally_tpu_torch.api import tally as port_tally
from pumiumtally_tpu_torch.api.tally import (
    check_finite,
    zero_flying_side_effect,
)
from pumiumtally_tpu_torch.ops.walk import walk, walk_plain

_JMESH = jax_build_box(1, 1, 1, 4, 4, 4)
_MESH = convert.tetmesh_from_arrays(convert.mesh_arrays(_JMESH))


def _flat(a):
    return np.ascontiguousarray(np.asarray(a, np.float64).reshape(-1))


def _pair(n, **kw):
    """The JAX facade and the port's, on one mesh, with the same knobs."""
    return (JaxPumiTally(_JMESH, n, JaxTallyConfig(**kw)),
            PumiTally(_MESH, n, TallyConfig(**kw), device="cpu"))


def _both(pair, call, *args):
    """Call the same protocol method on both facades, each with its own
    copies of the array arguments (the flying buffer is zeroed)."""
    for t in pair:
        getattr(t, call)(*(a.copy() if isinstance(a, np.ndarray) else a
                           for a in args))


def _assert_same(port, ref):
    np.testing.assert_array_equal(port.elem_ids, ref.elem_ids)
    np.testing.assert_allclose(port.positions, ref.positions, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(port.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-13)


def _state(t):
    return t.flux.numpy().copy(), t.positions.copy(), t.elem_ids.copy()


def _assert_bitwise(a, b):
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_echo_fires_and_matches_disabled():
    n = 400
    rng = np.random.default_rng(11)
    src, d1, d2 = (rng.uniform(0.05, 0.95, (n, 3)) for _ in range(3))
    out = []
    for auto in (True, False):
        pair = _pair(n, auto_continue=auto)
        _both(pair, "CopyInitialPosition", _flat(src))
        _both(pair, "MoveToNextLocation", _flat(src), _flat(d1),
              np.ones(n, np.int8), np.ones(n))
        # echo: origins == the previous destinations
        _both(pair, "MoveToNextLocation", _flat(d1), _flat(d2),
              np.ones(n, np.int8), np.ones(n))
        ref, port = pair
        _assert_same(port, ref)
        assert port.auto_continue_hits == ref.auto_continue_hits
        assert port.auto_continue_hits == (1 if auto else 0)
        out.append(_state(port))
    _assert_bitwise(*out)


def test_echo_correct_after_boundary_exit():
    """A particle clamped at the hull has committed != dests, so phase A
    is not trivial on the next echoing move: the substituted device
    origins still drive the relocation walk."""
    n = 300
    rng = np.random.default_rng(12)
    src = rng.uniform(0.3, 0.7, (n, 3))
    d1 = src + np.array([2.0, 0.0, 0.0])  # everyone exits +x
    d2 = rng.uniform(0.05, 0.95, (n, 3))
    out = []
    for auto in (True, False):
        pair = _pair(n, auto_continue=auto)
        _both(pair, "CopyInitialPosition", _flat(src))
        _both(pair, "MoveToNextLocation", _flat(src), _flat(d1),
              np.ones(n, np.int8), np.ones(n))
        _both(pair, "MoveToNextLocation", _flat(d1), _flat(d2),
              np.ones(n, np.int8), np.ones(n))
        ref, port = pair
        _assert_same(port, ref)
        assert port.auto_continue_hits == ref.auto_continue_hits == int(auto)
        out.append(_state(port))
    _assert_bitwise(*out)


def test_echo_declines_on_resample_and_correct_for_nonflying():
    n = 300
    rng = np.random.default_rng(13)
    src, d1 = (rng.uniform(0.05, 0.95, (n, 3)) for _ in range(2))
    pair = _pair(n)
    _both(pair, "CopyInitialPosition", _flat(src))
    _both(pair, "MoveToNextLocation", _flat(src), _flat(d1),
          np.ones(n, np.int8), np.ones(n))
    resampled = rng.uniform(0.05, 0.95, (n, 3))
    _both(pair, "MoveToNextLocation", _flat(resampled),
          _flat(np.clip(resampled + 0.1, 0, 1)), np.ones(n, np.int8),
          np.ones(n))
    ref, port = pair
    _assert_same(port, ref)
    assert port.auto_continue_hits == ref.auto_continue_hits == 0
    # A particle held on move 1 sits at src, not d1: the echoing move 2
    # relocates it through phase A though the origins were not staged.
    out = []
    fly = np.ones(n, np.int8)
    fly[0] = 0
    for auto in (True, False):
        pair = _pair(n, auto_continue=auto)
        _both(pair, "CopyInitialPosition", _flat(src))
        _both(pair, "MoveToNextLocation", _flat(src), _flat(d1), fly,
              np.ones(n))
        _both(pair, "MoveToNextLocation", _flat(d1),
              _flat(np.clip(d1 + 0.1, 0, 1)), np.ones(n, np.int8),
              np.ones(n))
        ref, port = pair
        _assert_same(port, ref)
        assert port.auto_continue_hits == ref.auto_continue_hits == int(auto)
        out.append(_state(port))
    _assert_bitwise(*out)


def test_echo_not_fooled_by_recycled_caller_buffer():
    """A host that reuses its destination buffer to hold the next move's
    resampled origins must not make the echo check compare the caller's
    memory with itself."""
    n = 300
    rng = np.random.default_rng(14)
    src = rng.uniform(0.05, 0.95, (n, 3))
    d1 = rng.uniform(0.05, 0.95, (n, 3))
    resampled = rng.uniform(0.05, 0.95, (n, 3))
    d2 = np.clip(resampled + 0.1, 0.02, 0.98)
    for t in _pair(n):
        buf = np.empty(3 * n)  # the recycled host buffer
        t.CopyInitialPosition(_flat(src))
        buf[:] = d1.reshape(-1)
        t.MoveToNextLocation(_flat(src), buf, np.ones(n, np.int8),
                             np.ones(n))
        buf[:] = resampled.reshape(-1)  # now the resampled origins
        t.MoveToNextLocation(buf, _flat(d2), np.ones(n, np.int8), np.ones(n))
        assert t.auto_continue_hits == 0
        want = float(np.linalg.norm(d1 - src, axis=1).sum()
                     + np.linalg.norm(d2 - resampled, axis=1).sum())
        got = float(np.sum(np.asarray(t.flux)))
        assert abs(got - want) / want < 1e-12


def test_unfenced_matches_fenced():
    n = 500
    rng = np.random.default_rng(15)
    # Random points, not clipped ones: a clipped point with two equal
    # coordinates lies on a diagonal face, where ids are a tie.
    traj = [rng.uniform(0.05, 0.95, (n, 3)) for _ in range(5)]
    out = []
    for fenced in (True, False):
        pair = _pair(n, fenced_timing=fenced, check_found_all=False)
        _both(pair, "CopyInitialPosition", _flat(traj[0]))
        for m in range(1, 5):
            _both(pair, "MoveToNextLocation", _flat(traj[m - 1]),
                  _flat(traj[m]), np.ones(n, np.int8), np.ones(n))
        ref, port = pair
        _assert_same(port, ref)
        out.append(_state(port))
    _assert_bitwise(*out)


def test_flying_and_weights_caches_match_disabled():
    """All-ones flying reuses the cached device ones; unchanged weights
    reuse the previous device tensor; changed weights stage anew."""
    n = 400
    rng = np.random.default_rng(16)
    src, d1, d2, d3 = (rng.uniform(0.05, 0.95, (n, 3)) for _ in range(4))
    w = rng.uniform(0.5, 2.0, n)
    out = []
    for auto in (True, False):
        pair = _pair(n, auto_continue=auto)
        _both(pair, "CopyInitialPosition", _flat(src))
        for a, b, wm in ((src, d1, w), (d1, d2, w), (d2, d3, 2.0 * w)):
            _both(pair, "MoveToNextLocation", _flat(a), _flat(b),
                  np.ones(n, np.int8), wm)
        ref, port = pair
        _assert_same(port, ref)
        out.append(_state(port))
        got = float(port.flux.sum())
        want = float((np.linalg.norm(d1 - src, axis=1) * w).sum()
                     + (np.linalg.norm(d2 - d1, axis=1) * w).sum()
                     + (np.linalg.norm(d3 - d2, axis=1) * 2.0 * w).sum())
        assert abs(got - want) / want < 1e-12
    _assert_bitwise(*out)
    # The caches are what the staging reused: one all-ones flying
    # tensor, and the second move's weights were the first move's.
    _, port = _pair(n)
    port.CopyInitialPosition(_flat(src))
    port.MoveToNextLocation(_flat(src), _flat(d1), np.ones(n, np.int8),
                            w.copy())
    first = port._last_weights_dev
    port.MoveToNextLocation(_flat(d1), _flat(d2), np.ones(n, np.int8),
                            w.copy())
    assert port._last_weights_dev is first
    assert port._stage_flying(np.ones(n, np.int8)) is \
        port._cached_ones("fly")


def test_echo_disarm_state_machine():
    """The never-echoing caller's disarm, the periodic re-arm and the
    re-arm by CopyInitialPosition, move for move against the JAX
    facade: the miss streak, the hit count and whether a snapshot is
    held are equal after every move, and so are the results."""
    n = 200
    rng = np.random.default_rng(21)
    pair = _pair(n)
    ref, port = pair
    pts = rng.uniform(0.05, 0.95, (n, 3))
    _both(pair, "CopyInitialPosition", _flat(pts))

    def same_machine():
        assert port._echo_misses == ref._echo_misses
        assert port.auto_continue_hits == ref.auto_continue_hits
        assert (port._last_dests_host is None) == \
            (ref._last_dests_host is None)
        assert (port._last_dests_dev is None) == \
            (ref._last_dests_dev is None)

    def move(origins, dests):
        _both(pair, "MoveToNextLocation", _flat(origins), _flat(dests),
              np.ones(n, np.int8), np.ones(n))
        same_machine()

    def fresh():
        return rng.uniform(0.05, 0.95, (n, 3))

    for _ in range(_ECHO_MISS_LIMIT + 2):
        move(fresh(), fresh())
    assert port._last_dests_host is None  # disarmed
    while port._echo_misses % _ECHO_REARM_PERIOD != _ECHO_REARM_PERIOD - 2:
        move(fresh(), fresh())
    retry = fresh()
    move(fresh(), retry)  # the periodic retry snapshot
    assert port._last_dests_host is not None
    hits = port.auto_continue_hits
    move(retry, fresh())  # echo on the retry
    assert port.auto_continue_hits == hits + 1 and port._echo_misses == 0
    _both(pair, "CopyInitialPosition", _flat(pts))  # re-arms
    same_machine()
    d1 = fresh()
    move(pts, d1)
    move(d1, fresh())
    for _ in range(_ECHO_MISS_LIMIT - 2):
        move(fresh(), fresh())
    assert 0 < port._echo_misses < _ECHO_MISS_LIMIT
    move(port.positions.copy(), fresh())  # a hit resets the streak
    assert port._echo_misses == 0
    assert port_tally._ECHO_MISS_LIMIT == _ECHO_MISS_LIMIT
    assert port_tally._ECHO_REARM_PERIOD == _ECHO_REARM_PERIOD
    _assert_same(port, ref)


def test_validate_inputs_off_matches_and_lets_through_what_jax_does():
    n = 200
    rng = np.random.default_rng(17)
    src, d1 = (rng.uniform(0.05, 0.95, (n, 3)) for _ in range(2))
    w = rng.uniform(0.5, 2.0, n)
    out = []
    for validate in (True, False):
        pair = _pair(n, validate_inputs=validate)
        _both(pair, "CopyInitialPosition", _flat(src))
        _both(pair, "MoveToNextLocation", _flat(src), _flat(d1),
              np.ones(n, np.int8), w)
        ref, port = pair
        _assert_same(port, ref)
        out.append(_state(port))
    _assert_bitwise(*out)
    bad = d1.copy()
    bad[7, 1] = np.nan
    # Validated: both refuse with the same message.
    msgs = []
    for t in _pair(n):
        t.CopyInitialPosition(_flat(src))
        with pytest.raises(ValueError) as e:
            t.MoveToNextLocation(_flat(src), _flat(bad), None, None)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "destinations" in msgs[0]
    # Unvalidated: both let it through, and the flux is poisoned alike.
    pair = _pair(n, validate_inputs=False, check_found_all=False)
    _both(pair, "CopyInitialPosition", _flat(src))
    _both(pair, "MoveToNextLocation", _flat(src), _flat(bad), None, None)
    ref, port = pair
    np.testing.assert_array_equal(np.isnan(port.flux.numpy()),
                                  np.isnan(np.asarray(ref.flux)))
    assert np.isnan(port.flux.numpy()).any()


def test_flying_zeroed_in_place_whatever_its_layout():
    n = 6
    flat = np.ones(n + 2, np.int8)
    zero_flying_side_effect(flat, n)
    np.testing.assert_array_equal(flat, [0] * n + [1, 1])
    square = np.ones((2, 3), np.int32)
    zero_flying_side_effect(square, n)
    assert not square.any()
    big = np.ones(2 * n, np.int8)
    strided = big[::2]  # not contiguous: zeroed through its strides
    zero_flying_side_effect(strided, n)
    np.testing.assert_array_equal(big, [0, 1] * n)


def test_check_finite_verdicts_and_message():
    check_finite(np.ones(10), "x")
    # Finite values whose sum overflows are finite: no refusal.
    check_finite(np.full(4, np.finfo(np.float64).max), "x")
    check_finite(np.full(4, np.finfo(np.float32).max, np.float32), "x")
    for v in (np.nan, np.inf, -np.inf):
        a = np.zeros(10)
        a[3] = v
        with pytest.raises(ValueError, match="first at flat index 13"):
            check_finite(a, "x", offset=10)
    a = np.zeros(4)
    a[1], a[2] = np.inf, -np.inf  # a NaN sum
    with pytest.raises(ValueError, match="2 non-finite"):
        check_finite(a, "x")


_CASCADE = dict(walk_cond_every=2, walk_perm_mode="sorted",
                walk_window_factor=4, walk_min_window=8,
                walk_partition_method="argsort")


def test_cascade_knobs_cross_over_and_refuse_as_jax_does():
    cfg = convert.tally_config(JaxTallyConfig(auto_continue=False,
                                              **_CASCADE))
    for k, v in _CASCADE.items():
        assert getattr(cfg, k) == v
    assert cfg.auto_continue is False and cfg.fenced_timing is True
    assert cfg.validate_inputs is True and cfg.device_groups == 1
    # No effect: the port has no cascade.
    n = 200
    rng = np.random.default_rng(18)
    src, d1 = (rng.uniform(0.05, 0.95, (n, 3)) for _ in range(2))
    out = []
    for c in (cfg, TallyConfig()):
        t = PumiTally(_MESH, n, c, device="cpu")
        t.CopyInitialPosition(_flat(src))
        t.MoveToNextLocation(_flat(src), _flat(d1))
        out.append(_state(t))
    _assert_bitwise(*out)
    # The multi-device knobs and cap_frontier cross.
    assert convert.tally_config(
        JaxTallyConfig(migrate_collective=True)).migrate_collective
    assert convert.tally_config(
        JaxTallyConfig(cap_frontier=4)).cap_frontier == 4
    for k, v in (("walk_cond_every", 0), ("walk_perm_mode", "bogus"),
                 ("walk_window_factor", 1), ("walk_min_window", 0),
                 ("walk_partition_method", "bogus"),
                 ("device_groups", 0)):
        msgs = []
        for cls in (JaxTallyConfig, TallyConfig):
            with pytest.raises(ValueError) as e:
                cls(**{k: v})
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], k
    assert TallyConfig(device_groups=2).device_groups == 2


@pytest.mark.parametrize("s_init", [False, True])
def test_walk_skip_returns_its_inputs(s_init):
    n = 100
    rng = np.random.default_rng(19)
    x = torch.as_tensor(rng.uniform(0.1, 0.9, (n, 3)))
    elem = torch.as_tensor(rng.integers(0, _MESH.nelems, n), dtype=torch.int32)
    dest = torch.as_tensor(rng.uniform(0.1, 0.9, (n, 3)))
    fly = torch.ones(n, dtype=torch.int8)
    w = torch.ones(n, dtype=torch.float64)
    s0 = torch.as_tensor(rng.uniform(0, 0.5, n)) if s_init else None
    flux = torch.zeros(_MESH.nelems, dtype=torch.float64)
    kw = dict(tally=True, tol=1e-8, max_iters=500, s_init=s0)
    for fn in (walk, walk_plain):
        r = fn(_MESH, x, elem, dest, fly, w, flux, skip=torch.tensor(True),
               **kw)
        assert torch.equal(r.x, x) and torch.equal(r.elem, elem)
        assert bool(r.done.all()) and not bool(r.exited.any())
        assert torch.equal(r.s, s0 if s_init else torch.zeros(n,
                                                              dtype=x.dtype))
        assert int(r.iters) == 0 and not bool(flux.any())
    # skip false walks as no skip does.
    f1, f2 = (torch.zeros(_MESH.nelems, dtype=torch.float64)
              for _ in range(2))
    r1 = walk_plain(_MESH, x, elem, dest, fly, w, f1,
                    skip=torch.tensor(False), **kw)
    r2 = walk_plain(_MESH, x, elem, dest, fly, w, f2, **kw)
    assert torch.equal(r1.x, r2.x) and torch.equal(f1, f2)
    assert bool(f1.any())
