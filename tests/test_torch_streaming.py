"""PyTorch port, the streaming facades: the port's ``StreamingTally``
against the JAX package's and against the port's own ``PumiTally``, and
the port's ``StreamingPartitionedTally`` (W1 and W2 paths, their plain
versions on the CPU) against the JAX package's monolithic ``PumiTally``
(as tests/test_streaming.py holds the JAX composition, at a size that
needs no ``slow`` mark).

Tolerances, float64: element ids exact; positions to 1e-12 absolute;
flux to rtol 1e-10 (atol 1e-13), another addition order (as
tests/test_torch_api.py); the VTK bytes identical given equal flux.
Within the port, staging knobs are held bitwise."""

import numpy as np
import pytest
import torch

from pumiumtally_tpu import PumiTally as JaxPumiTally
from pumiumtally_tpu import StreamingTally as JaxStreamingTally
from pumiumtally_tpu import TallyConfig as JaxTallyConfig
from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu_torch import (
    PumiTally,
    StreamingPartitionedTally,
    StreamingTally,
    TallyConfig,
    convert,
)
from pumiumtally_tpu_torch.api import streaming

_JMESH = jax_build_box(1, 1, 1, 4, 4, 4)
_MESH = convert.tetmesh_from_arrays(convert.mesh_arrays(_JMESH))
N, CHUNK = 700, 250  # three chunks, the last one partial (200)


def _flat(a):
    return np.ascontiguousarray(np.asarray(a, np.float64).reshape(-1))


def _pair(n=N, chunk=CHUNK, **kw):
    """The JAX streaming facade and the port's, with the same knobs."""
    return (JaxStreamingTally(_JMESH, n, chunk_size=chunk,
                              config=JaxTallyConfig(**kw)),
            StreamingTally(_MESH, n, chunk_size=chunk,
                           config=TallyConfig(**kw), device="cpu"))


def _both(tallies, call, *args):
    for t in tallies:
        getattr(t, call)(*(a.copy() if isinstance(a, np.ndarray) else a
                           for a in args))


def _assert_same(port, ref):
    np.testing.assert_array_equal(port.elem_ids, np.asarray(ref.elem_ids))
    np.testing.assert_allclose(port.positions, np.asarray(ref.positions),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(port.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-13)


def _state(t):
    return t.flux.numpy().copy(), t.positions.copy(), t.elem_ids.copy()


def _assert_bitwise(a, b):
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def _workload(seed, n=N):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.05, 0.95, (n, 3))
    dest = rng.uniform(-0.1, 1.1, (n, 3))  # some leave the box
    fly = (rng.uniform(size=n) > 0.15).astype(np.int8)
    w = rng.uniform(0.5, 2.0, n)
    return src, dest, fly, w


@pytest.mark.parametrize("continue_mode", [False, True])
def test_streaming_matches_jax_and_monolithic(continue_mode):
    src, dest, fly, w = _workload(2)
    ref, port = _pair()
    mono = PumiTally(_MESH, N, device="cpu")
    assert port.nchunks == 3 and port.chunk_size == CHUNK
    tallies = (ref, port, mono)
    _both(tallies, "CopyInitialPosition", _flat(src))
    _assert_same(port, ref)
    flies = []
    for t in tallies:
        f = fly.copy()
        origins = None if continue_mode else _flat(np.asarray(t.positions))
        t.MoveToNextLocation(origins, _flat(dest), f, w)
        flies.append(f)
    for f in flies:  # the whole caller buffer is zeroed
        np.testing.assert_array_equal(f, 0)
    _assert_same(port, ref)
    _assert_same(mono, ref)
    np.testing.assert_array_equal(port.positions, mono.positions)


@pytest.mark.parametrize("chunk", [300, 699, 1000])
def test_chunk_size_that_does_not_divide_n(chunk):
    """Pad slots repeat the last row and never fly: flux, positions and
    ids are the monolithic facade's whatever the chunking."""
    src, dest, fly, w = _workload(3)
    port = StreamingTally(_MESH, N, chunk_size=chunk, device="cpu")
    mono = PumiTally(_MESH, N, device="cpu")
    assert port.nchunks == -(-N // min(chunk, N))
    for t in (port, mono):
        t.CopyInitialPosition(_flat(src))
        t.MoveToNextLocation(_flat(src), _flat(dest), fly.copy(), w)
        t.MoveToNextLocation(None, _flat(src))  # unit weights, all fly
    np.testing.assert_array_equal(port.elem_ids, mono.elem_ids)
    np.testing.assert_array_equal(port.positions, mono.positions)
    np.testing.assert_allclose(port.flux.numpy(), mono.flux.numpy(),
                               rtol=1e-10, atol=1e-13)


def test_locate_localization():
    rng = np.random.default_rng(24)
    src = rng.uniform(0.05, 0.95, (N, 3))
    src[::11] += 2.0  # out of the hull: the clamp path
    d1 = rng.uniform(0.05, 0.95, (N, 3))
    out = []
    for how in ("walk", "locate"):
        pair = _pair(localization=how)
        _both(pair, "CopyInitialPosition", _flat(src))
        _both(pair, "MoveToNextLocation", None, _flat(d1))
        ref, port = pair
        _assert_same(port, ref)
        out.append(port)
    np.testing.assert_allclose(out[0].positions, out[1].positions,
                               atol=1e-12)
    np.testing.assert_array_equal(out[0].elem_ids, out[1].elem_ids)


def test_origin_echo_dedup_on_and_off():
    rng = np.random.default_rng(21)
    src, d1, d2 = (rng.uniform(0.05, 0.95, (N, 3)) for _ in range(3))
    out = []
    for auto in (True, False):
        pair = _pair(auto_continue=auto)
        _both(pair, "CopyInitialPosition", _flat(src))
        _both(pair, "MoveToNextLocation", _flat(src), _flat(d1),
              np.ones(N, np.int8), np.ones(N))
        _both(pair, "MoveToNextLocation", _flat(d1), _flat(d2),
              np.ones(N, np.int8), np.ones(N))
        ref, port = pair
        _assert_same(port, ref)
        assert port.auto_continue_hits == ref.auto_continue_hits == int(auto)
        out.append(_state(port))
    _assert_bitwise(*out)
    # A recycled buffer holding resampled origins must miss.
    resampled = rng.uniform(0.05, 0.95, (N, 3))
    d3 = np.clip(resampled + 0.1, 0.02, 0.98)
    for t in _pair():
        buf = np.empty(3 * N)
        t.CopyInitialPosition(_flat(src))
        buf[:] = d1.reshape(-1)
        t.MoveToNextLocation(_flat(src), buf, np.ones(N, np.int8),
                             np.ones(N))
        buf[:] = resampled.reshape(-1)
        t.MoveToNextLocation(buf, _flat(d3), np.ones(N, np.int8), np.ones(N))
        assert t.auto_continue_hits == 0
        want = float(np.linalg.norm(d1 - src, axis=1).sum()
                     + np.linalg.norm(d3 - resampled, axis=1).sum())
        assert abs(float(np.sum(np.asarray(t.flux))) - want) / want < 1e-12


def test_unfenced_with_recycled_buffers():
    """An unfenced call returns with walks in flight; a host that
    overwrites its buffers at once changes nothing staged."""
    rng = np.random.default_rng(23)
    traj = [rng.uniform(0.05, 0.95, (N, 3)) for _ in range(4)]
    out = []
    for fenced in (True, False):
        t = StreamingTally(_MESH, N, chunk_size=CHUNK, config=TallyConfig(
            fenced_timing=fenced, check_found_all=False,
            auto_continue=False), device="cpu")
        obuf, dbuf = np.empty(3 * N), np.empty(3 * N)
        obuf[:] = traj[0].reshape(-1)
        t.CopyInitialPosition(obuf)
        obuf[:] = -1e30
        for m in range(1, 4):
            obuf[:] = traj[m - 1].reshape(-1)
            dbuf[:] = traj[m].reshape(-1)
            t.MoveToNextLocation(obuf, dbuf, np.ones(N, np.int8), np.ones(N))
            obuf[:] = -1e30
            dbuf[:] = -1e30
        want = sum(float(np.linalg.norm(traj[m] - traj[m - 1],
                                        axis=1).sum()) for m in range(1, 4))
        assert abs(float(t.flux.sum()) - want) / want < 1e-12
        out.append(_state(t))
    _assert_bitwise(*out)


def test_accumulates_across_batches_and_vtk_bytes(tmp_path):
    """Two source batches: flux accumulates over both, as in the JAX
    facade; with the JAX flux carried over, the VTK files are equal."""
    rng = np.random.default_rng(4)
    pair = _pair()
    for _ in range(2):
        src, d1, d2 = (rng.uniform(0.05, 0.95, (N, 3)) for _ in range(3))
        _both(pair, "CopyInitialPosition", _flat(src))
        _both(pair, "MoveToNextLocation", None, _flat(d1))
        _both(pair, "MoveToNextLocation", None, _flat(d2))
    ref, port = pair
    _assert_same(port, ref)
    flux = np.asarray(ref.flux)
    port._flux = [torch.as_tensor(flux)] + [torch.zeros_like(f)
                                            for f in port._flux[1:]]
    for t, name in ((ref, "jax.vtk"), (port, "port.vtk")):
        t.WriteTallyResults(str(tmp_path / name))
    assert (tmp_path / "jax.vtk").read_bytes() == \
        (tmp_path / "port.vtk").read_bytes()


def test_refused_narrow_move_commits_nothing():
    """float32 working dtype: a destination finite in float64 but
    infinite in float32 sits in the LAST chunk; the move is refused
    before any chunk dispatches, with the JAX package's message."""
    jmesh32 = jax_build_box(1, 1, 1, 4, 4, 4, dtype=np.float32)
    mesh32 = convert.tetmesh_from_arrays(convert.mesh_arrays(jmesh32))
    rng = np.random.default_rng(5)
    src, d1 = (rng.uniform(0.05, 0.95, (N, 3)) for _ in range(2))
    bad = d1.copy()
    bad[N - 3, 2] = 1e300
    msgs = []
    for t in (JaxStreamingTally(jmesh32, N, chunk_size=CHUNK),
              StreamingTally(mesh32, N, chunk_size=CHUNK, device="cpu")):
        t.CopyInitialPosition(_flat(src))
        t.MoveToNextLocation(None, _flat(d1))
        before = (np.asarray(t.flux).copy(), np.asarray(t.positions).copy())
        fly = np.ones(N, np.int8)
        with pytest.raises(ValueError) as e:
            t.MoveToNextLocation(None, _flat(bad), fly)
        msgs.append(str(e.value))
        np.testing.assert_array_equal(np.asarray(t.flux), before[0])
        np.testing.assert_array_equal(np.asarray(t.positions), before[1])
        np.testing.assert_array_equal(fly, 1)  # not zeroed either
        assert t.iter_count == 1
    assert msgs[0] == msgs[1]
    assert f"flat index {3 * (N - 3) + 2}" in msgs[0]


# -- the whole-batch checks past the native pass's threshold ---------------

# 210,000 position values and 70,000 weights: every pass threaded; chunks
# of 25,000, 25,000 and 20,000. A bad value sits in the last chunk.
BIG, BIG_CHUNK = 70_000, 25_000
_AT = BIG - 2
_REFUSALS = {  # case: (buffer, value, flat index)
    "destinations_nan": ("dests", np.nan, 3 * _AT + 1),
    "origins_inf_echoing": ("origins", np.inf, 3 * _AT + 1),
    "weights_nan": ("w", np.nan, _AT),
    "destinations_f32_overflow": ("dests", 1e300, 3 * _AT + 1),
    "positions_f32_overflow": ("positions", -1e300, 3 * _AT + 2),
}
_JMESH32 = jax_build_box(1, 1, 1, 4, 4, 4, dtype=np.float32)


def _host_state(t):
    return tuple(np.asarray(a).copy() for a in (t.flux, t.positions,
                                                t.elem_ids))


def _big_run(case=None, jax=False):
    """A float32 ``StreamingTally`` of BIG particles (``jax``: the JAX
    package's, on a float32 mesh): localized, one move that arms the
    echo, then ``case``'s refused call (None: a clean echoing move).
    Returns the facade, its state before the last call, the refusal's
    message and the last call's flying buffer."""
    rng = np.random.default_rng(41)
    src, d1, d2 = (rng.uniform(0.05, 0.95, 3 * BIG) for _ in range(3))
    w = rng.uniform(0.5, 2.0, BIG)
    if jax:
        t = JaxStreamingTally(_JMESH32, BIG, chunk_size=BIG_CHUNK)
    else:
        t = StreamingTally(_MESH, BIG, chunk_size=BIG_CHUNK,
                           config=TallyConfig(dtype=torch.float32),
                           device="cpu")
    assert t.nchunks == 3 and _AT >= 2 * BIG_CHUNK
    t.CopyInitialPosition(src)
    t.MoveToNextLocation(src, d1, np.ones(BIG, np.int8), w)
    bufs = {"positions": src.copy(), "origins": d1.copy(),
            "dests": d2.copy(), "w": w.copy()}
    msg = None
    if case is not None:
        buf, value, at = _REFUSALS[case]
        bufs[buf][at] = value
    before = (_host_state(t), t.iter_count, t.auto_continue_hits,
              t._echo_misses)
    fly = np.ones(BIG, np.int8)
    try:
        if case is not None and case.startswith("pos"):
            t.CopyInitialPosition(bufs["positions"])
        else:
            t.MoveToNextLocation(bufs["origins"], bufs["dests"], fly,
                                 bufs["w"])
    except ValueError as e:
        msg = str(e)
    return t, before, msg, fly


@pytest.mark.parametrize("case", list(_REFUSALS))
def test_large_refusals_match_the_numpy_path(case, monkeypatch):
    """Past the threshold, a bad value in the last chunk of each buffer
    is refused as the JAX package refuses it: the same message and flat
    index; a refused move commits nothing and leaves ``flying`` as it
    was, on both. Against the NumPy checks alone (the native pass made
    to flag every buffer): the same state and echo counters after it.
    Each refusal counts one fallback."""
    t, before, msg, fly = _big_run(case)
    assert t.batch_check_fallbacks == 1
    jt, jbefore, jmsg, jfly = _big_run(case, jax=True)
    assert msg is not None and msg == jmsg
    assert f"flat index {_REFUSALS[case][2]}" in msg
    np.testing.assert_array_equal(fly, jfly)
    with monkeypatch.context() as m:
        m.setattr(streaming.host_fill, "check",
                  lambda src, dtype: (False, False))
        ref, _, want, ref_fly = _big_run(case)
    assert msg == want
    assert (t.iter_count, t.auto_continue_hits, t._echo_misses) == (
        ref.iter_count, ref.auto_continue_hits, ref._echo_misses)
    _assert_bitwise(_host_state(t), _host_state(ref))
    np.testing.assert_array_equal(fly, ref_fly)
    if not case.startswith("pos"):
        for facade, was in ((t, before), (jt, jbefore)):
            _assert_bitwise(_host_state(facade), was[0])
            assert facade.iter_count == was[1]
        np.testing.assert_array_equal(fly, 1)
    if case == "origins_inf_echoing":
        # Refused before the echo compare: neither a hit nor a miss.
        assert (t.auto_continue_hits, t._echo_misses) == before[2:]
    if case == "destinations_f32_overflow":
        assert t.auto_continue_hits == before[2] + 1  # the echo ran first


def test_large_clean_moves_read_each_buffer_once(monkeypatch):
    """Past the threshold, a clean localization and clean moves run one
    native pass a buffer and no NumPy check (no float64 ``np.isfinite``,
    no working-dtype scratch); no pass falls back."""

    def numpy_check(*a, **k):
        raise AssertionError("a NumPy finite check ran on a clean batch")

    monkeypatch.setattr(streaming, "check_finite", numpy_check)
    t, _, msg, fly = _big_run()
    assert msg is None and t.auto_continue_hits == 1
    np.testing.assert_array_equal(fly, 0)
    # Positions once, then dests, origins and weights a move.
    assert (t.batch_checks, t.batch_check_fallbacks) == (1 + 3 + 3, 0)
    assert t._narrow_scratch is None


@pytest.mark.parametrize("path", ["W1", "W2"])
def test_streaming_partitioned_matches_jax_monolithic(path):
    cfg = (dict(walk_vmem_max_elems=100) if path == "W1" else
           dict(walk_table_dtype="bfloat16", walk_kernel="pallas",
                walk_vmem_max_elems=100))
    rng = np.random.default_rng(21)
    src = rng.uniform(0.05, 0.95, (N, 3))
    lo, hi = [0.0213, 0.0227, 0.0241], [0.9787, 0.9773, 0.9759]
    dest = np.clip(src + rng.normal(scale=0.25, size=(N, 3)), lo, hi)
    w = rng.uniform(0.5, 2.0, N)
    ref = JaxPumiTally(_JMESH, N, JaxTallyConfig(
        walk_table_dtype=cfg.get("walk_table_dtype")))
    sp = StreamingPartitionedTally(
        _MESH, N, chunk_size=CHUNK,
        config=TallyConfig(capacity_factor=4.0, **cfg), device="cpu")
    assert sp.nchunks == 3 and len({id(e.part) for e in sp.engines}) == 1
    assert [e.n for e in sp.engines] == [250, 250, 200]
    assert sp.engines[0].use_pallas_walk == (path == "W2")
    _both((ref, sp), "CopyInitialPosition", _flat(src))
    np.testing.assert_array_equal(sp.elem_ids, ref.elem_ids)
    _both((ref, sp), "MoveToNextLocation", None, _flat(dest),
          np.ones(N, np.int8), w)
    np.testing.assert_array_equal(sp.elem_ids, ref.elem_ids)
    np.testing.assert_allclose(sp.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-13)
    # A two-phase move accumulates across the chunk engines.
    dest2 = np.clip(dest - 0.15, lo, hi)
    _both((ref, sp), "MoveToNextLocation", _flat(dest), _flat(dest2))
    np.testing.assert_array_equal(sp.elem_ids, ref.elem_ids)
    np.testing.assert_allclose(sp.positions, np.asarray(ref.positions),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(sp.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-13)


def test_streaming_partitioned_lost_warning(capsys):
    n = 64
    sp = StreamingPartitionedTally(
        _MESH, n, chunk_size=32,
        config=TallyConfig(capacity_factor=4.0, walk_vmem_max_elems=100),
        device="cpu")
    src = np.random.default_rng(2).uniform(0.1, 0.9, (n, 3))
    src[::8] += 7.0  # out of the unit box
    sp.CopyInitialPosition(_flat(src))
    assert "8 source points lie in no mesh element" in capsys.readouterr().out
    assert np.all(sp.elem_ids[::8] == -1) and sp.lost_particles == 8


def test_device_groups_above_one_raise():
    """The JAX package's device-group refusals: a group count that does
    not divide the mesh (no mesh: one device), one past the chunk count,
    and a sentinel with groups."""
    from pumiumtally_tpu_torch.parallel import make_device_mesh
    from pumiumtally_tpu_torch.sentinel import SentinelPolicy

    cpu4 = make_device_mesh(4, devices=[torch.device("cpu")] * 4)
    assert TallyConfig(device_groups=2).device_groups == 2
    for cfg, n, match in (
            (TallyConfig(device_groups=2), 8, "does not divide the 1-device"),
            (TallyConfig(device_groups=3, device_mesh=cpu4), 8,
             "does not divide the 4-device"),
            (TallyConfig(device_groups=4, device_mesh=cpu4), 8,
             "exceeds the 2 chunk"),
            (TallyConfig(device_groups=2, device_mesh=cpu4,
                         sentinel=SentinelPolicy()), 8, "sentinel")):
        with pytest.raises(ValueError, match=match):
            StreamingPartitionedTally(_MESH, n, chunk_size=4, config=cfg,
                                      device="cpu")


def test_device_groups_two_matches_jax():
    """``TallyConfig(device_groups=2)`` on ``StreamingPartitionedTally``
    over four CPU shards against the JAX facade on four virtual devices:
    ids and positions exact, flux rtol 1e-10."""
    from pumiumtally_tpu import StreamingPartitionedTally as JaxSPT
    from pumiumtally_tpu import TallyConfig as JaxTallyConfig
    from pumiumtally_tpu.parallel import make_device_mesh as jax_mesh
    from pumiumtally_tpu_torch.parallel import make_device_mesh

    n = 60
    rng = np.random.default_rng(12)
    src, d1 = (rng.uniform(0.05, 0.95, (n, 3)) for _ in range(2))
    ref = JaxSPT(_JMESH, n, 30, JaxTallyConfig(device_mesh=jax_mesh(4),
                                                device_groups=2))
    port = StreamingPartitionedTally(_MESH, n, 30, TallyConfig(
        device_mesh=make_device_mesh(4, devices=[torch.device("cpu")] * 4),
        device_groups=2), device="cpu")
    for t in (ref, port):
        t.CopyInitialPosition(_flat(src))
        t.MoveToNextLocation(_flat(src), _flat(d1), np.ones(n, np.int8),
                             np.ones(n))
    np.testing.assert_array_equal(port.elem_ids, np.asarray(ref.elem_ids))
    np.testing.assert_array_equal(port.positions, np.asarray(ref.positions))
    np.testing.assert_allclose(port.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-14)
