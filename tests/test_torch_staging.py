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


# -- the staging fill (native/host_fill.cpp) --------------------------------

def _fill_case(case: str, n: int, dtype) -> tuple:
    """A float64 source of ``n`` values with the case's edge values in
    the first chunk, the middle and the ragged tail, and the snapshot
    ``prev`` the fill compares with."""
    rng = np.random.default_rng(len(case) * 7919 + n)
    src = rng.standard_normal(n) * 10.0
    at = sorted({0, n // 2, n - 1})
    edge = {
        "finite": [0.0, -0.0, 1e-40, -3e-42, 3.4028234e38, -1e-310],
        "overflow": [3.5e38, -1e39, 1e300],
        "nan": [np.nan],
        "inf": [np.inf],
        "-inf": [-np.inf],
        "zeros": [-0.0, 0.0],
        "changed": [1.0],
        "nan_prev": [np.nan],
    }[case]
    for i, j in enumerate(at):
        src[j] = edge[i % len(edge)]
    prev = np.empty(n, dtype)
    with np.errstate(over="ignore"):
        np.copyto(prev, src, casting="unsafe")
    if case == "zeros":
        # -0.0 against 0.0 and 0.0 against -0.0: equal, as array_equal.
        prev[at] = np.where(np.signbit(prev[at]), 0.0, -0.0)
    elif case == "changed":
        prev[at[-1]] = np.nextafter(prev[at[-1]], dtype(np.inf))
    return src, prev


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("length", ["below", "at", "ragged"])
@pytest.mark.parametrize("case", ["finite", "overflow", "nan", "inf", "-inf",
                                  "zeros", "changed", "nan_prev"])
def test_host_fill_matches_numpy_bit_for_bit(dtype, length, case):
    """The fused fill writes numpy's unsafe cast bit for bit (subnormals
    kept, overflow to inf) and its flags are ``np.isfinite(...).all()``
    and ``np.array_equal(...)``: below the inline threshold, at it, and
    past it with a ragged last chunk."""
    from pumiumtally_tpu_torch.native import host_fill

    t = host_fill.inline_below()
    n = {"below": t - 1, "at": t, "ragged": 3 * t + 1234}[length]
    src, prev = _fill_case(case, n, dtype)
    want = np.empty(n, dtype)
    with np.errstate(over="ignore"):
        np.copyto(want, src, casting="unsafe")
    got = np.full(n, 7.0, dtype)
    finite, equal, threaded = host_fill.fill(got, src, prev)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    assert finite == bool(np.isfinite(want).all())
    assert equal == np.array_equal(want, prev)
    assert threaded == (length != "below" and host_fill.threads() > 1)
    # Without a snapshot: the same values, and never "equal".
    got[:] = 0
    assert host_fill.fill(got, src)[:2] == (finite, False)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# The float32 rounding boundary: values below 2^128 - 2^103 round to the
# largest float32, that value and those above it to infinity.
_F32_EDGE = 2.0 ** 128 - 2.0 ** 103
_CHECK_EDGES = {
    "clean": [1.5],
    "nan": [np.nan],
    "inf": [np.inf],
    "-inf": [-np.inf],
    "1e300": [1e300, -1e300],
    "edge_below": [np.nextafter(_F32_EDGE, 0.0),
                   -np.nextafter(_F32_EDGE, 0.0)],
    "edge_at": [_F32_EDGE, -_F32_EDGE],
    "edge_above": [np.nextafter(_F32_EDGE, np.inf)],
    "subnormal": [5e-324, -1e-310, 1e-40, -3e-42, 1e-45],
    "-0.0": [-0.0],
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("length", ["below", "at", "ragged"])
@pytest.mark.parametrize("case", list(_CHECK_EDGES))
def test_host_check_matches_numpy(dtype, length, case):
    """The check-only pass's flag is ``np.isfinite(src.astype(dtype))
    .all()`` (float32: a float64 value past float32's range is not
    finite), below the inline threshold, at it, and past it with a ragged
    last chunk; the source is left as it was."""
    from pumiumtally_tpu_torch.native import host_fill

    t = host_fill.inline_below()
    n = {"below": t - 1, "at": t, "ragged": 3 * t + 1234}[length]
    assert n % 16384 or length == "at"
    rng = np.random.default_rng(len(case) * 7919 + n)
    src = rng.standard_normal(n) * 10.0
    edge = _CHECK_EDGES[case]
    for i, j in enumerate(sorted({0, n // 2, n - 1})):
        src[j] = edge[i % len(edge)]
    before = src.copy()
    with np.errstate(over="ignore"):
        cast = src.astype(dtype)
    finite, threaded = host_fill.check(src, dtype)
    assert finite == bool(np.isfinite(cast).all())
    assert finite == (case in ("clean", "subnormal", "-0.0", "edge_below")
                      or (dtype == np.float64 and case.startswith(("1e",
                                                                   "edge"))))
    assert threaded == (length != "below" and host_fill.threads() > 1)
    np.testing.assert_array_equal(src.view(np.uint64),
                                  before.view(np.uint64))


def test_host_fill_threads_share_the_pool():
    """Python threads filling at once through the one pool (more threads
    than cores, a short switch interval): each gets its own values and
    its own flags."""
    import sys
    import threading

    from pumiumtally_tpu_torch.native import host_fill

    n = 2 * host_fill.inline_below() + 3
    errors = []

    def worker(k):
        try:
            src = np.arange(n, dtype=np.float64) * (k + 1) + 0.5
            if k % 3 == 0:
                src[k] = np.inf
            want = src.astype(np.float32)
            for _ in range(20):
                got = np.empty(n, np.float32)
                finite, equal, _ = host_fill.fill(got, src, want)
                if not (np.array_equal(got, want) and finite == (k % 3 != 0)
                        and equal):
                    errors.append(k)
        except Exception as e:  # reported below with the worker's index
            errors.append((k, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        workers = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert errors == []


_BIG = 70_000  # particles: positions and [n] attributes past the threshold


def _big_facade(**kw):
    return PumiTally(_MESH, _BIG, TallyConfig(**kw), device="cpu")


def _numpy_refusal(a, what, dtype=np.float64):
    """check_finite's message for ``a`` staged the way numpy cast it."""
    dst = np.empty(a.shape, dtype)
    np.copyto(dst, a, casting="unsafe")
    with pytest.raises(ValueError) as e:
        check_finite(dst, what)
    return str(e.value)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("buffer", ["positions", "destinations", "weights",
                                    "energy"])
def test_large_nonfinite_refused_as_before(buffer, dtype):
    """Past the threshold (the threaded fill) a NaN refuses with
    check_finite's message word for word; unvalidated it is staged."""
    from pumiumtally_tpu_torch.native import host_fill

    assert 3 * _BIG > _BIG >= host_fill.inline_below()
    n = _BIG
    rng = np.random.default_rng(23)
    src, d1 = (rng.uniform(0.05, 0.95, 3 * n) for _ in range(2))
    w = rng.uniform(0.5, 2.0, n)
    bad = {"positions": src, "destinations": d1, "weights": w,
           "energy": np.ones(n)}[buffer].copy()
    bad[bad.size - 5] = np.nan
    slot = {"positions": "dests", "destinations": "dests",
            "weights": "w", "energy": "energy"}[buffer]

    def stage(t):
        if buffer == "positions":
            t.CopyInitialPosition(bad)
            return
        t.CopyInitialPosition(src)
        if buffer == "energy":
            t._stage_move_attr(bad, "energy")
        elif buffer == "weights":
            t.MoveToNextLocation(None, d1, None, bad)
        else:
            t.MoveToNextLocation(None, bad, None, None)

    t = _big_facade(dtype=dtype)
    with pytest.raises(ValueError) as e:
        stage(t)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    assert str(e.value) == _numpy_refusal(bad, buffer, np_dtype)
    staged = 1 + (buffer != "positions") * (1 + (buffer == "weights"))
    assert (t._staging.threaded_fills + t._staging.inline_fills) == staged
    assert t._staging.threaded_fills == staged * (host_fill.threads() > 1)
    t = _big_facade(dtype=dtype, validate_inputs=False,
                    check_found_all=False)
    stage(t)
    assert np.isnan(t._staging.host(slot)[0]).sum() == 1


def test_large_weights_cache_and_fill_counters():
    """Past the threshold: unchanged weights (-0.0 against 0.0 counts as
    unchanged) reuse the device tensor, changed ones stage anew; every
    fill took the threaded path. A 5-particle facade fills inline."""
    from pumiumtally_tpu_torch.native import host_fill

    n = _BIG
    rng = np.random.default_rng(29)
    src, d1, d2, d3 = (rng.uniform(0.05, 0.95, 3 * n) for _ in range(4))
    w = rng.uniform(0.5, 2.0, n)
    w[10] = 0.0
    t = _big_facade()
    t.CopyInitialPosition(src)
    t.MoveToNextLocation(None, d1, None, w.copy())
    first = t._last_weights_dev
    w_neg = w.copy()
    w_neg[10] = -0.0
    t.MoveToNextLocation(None, d2, None, w_neg)
    assert t._last_weights_dev is first
    t.MoveToNextLocation(None, d3, None, 2.0 * w)
    assert t._last_weights_dev is not first
    np.testing.assert_array_equal(t._last_weights_dev.numpy(), 2.0 * w)
    threaded = host_fill.threads() > 1
    fills = 1 + 3 * 2  # the positions, then a move's dests and weights
    assert (t._staging.threaded_fills, t._staging.inline_fills) == (
        (fills, 0) if threaded else (0, fills))
    small = PumiTally(_MESH, 5, TallyConfig(), device="cpu")
    p = rng.uniform(0.05, 0.95, 15)
    small.CopyInitialPosition(p)
    small.MoveToNextLocation(None, p[::-1].copy(), None, np.ones(5))
    assert (small._staging.threaded_fills, small._staging.inline_fills) \
        == (0, 3)


_FORK_CHILD = r"""
import os, sys, time
import numpy as np
from pumiumtally_tpu_torch import PumiTally, TallyConfig
from pumiumtally_tpu_torch.mesh.box import build_box

n = int(sys.argv[1])
t = PumiTally(build_box(1, 1, 1, 2, 2, 2), n, TallyConfig(), device="cpu")
rng = np.random.default_rng(31)
t.CopyInitialPosition(rng.uniform(0.05, 0.95, 3 * n))  # the parent's pool
assert t._staging.threaded_fills == 1
d1 = rng.uniform(0.05, 0.95, 3 * n)
want = np.empty((n, 3), t._staging.host("dests")[0].dtype)
np.copyto(want, d1.reshape(n, 3), casting="unsafe")
pid = os.fork()
if pid == 0:
    code = 1
    try:
        t._stage_positions(d1, "dests", "destinations")
        ok = np.array_equal(t._staging.host("dests")[0], want)
        code = 0 if ok and t._staging.threaded_fills == 2 else 1
    finally:
        os._exit(code)
deadline = time.monotonic() + 60
while True:
    done, status = os.waitpid(pid, os.WNOHANG)
    if done:
        sys.exit(os.waitstatus_to_exitcode(status))
    if time.monotonic() > deadline:
        os.kill(pid, 9)
        sys.exit("the forked child hung in the fill")
    time.sleep(0.05)
"""


def test_forked_child_stages_with_its_own_pool():
    """A child forked after its parent's pool ran a fill past the
    threshold fills with a pool of its own (its parent's threads are
    not in it) and stages the values numpy would. Run in a fresh
    interpreter: this one has the JAX package's threads."""
    import subprocess
    import sys

    from pumiumtally_tpu_torch.native import host_fill

    if host_fill.threads() < 2:
        pytest.skip("one CPU in this process's affinity: no pool to fork")
    r = subprocess.run([sys.executable, "-W", "ignore::DeprecationWarning",
                        "-c", _FORK_CHILD, str(_BIG)], capture_output=True,
                       text=True, timeout=180)
    assert r.returncode == 0, r.stdout + r.stderr
