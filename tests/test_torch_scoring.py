"""PyTorch port, filtered scoring: the port's ``scoring`` package, W0's
and W2's scoring lanes (on CPU tensors their plain versions) and the
four facades with ``TallyConfig(scoring=...)``, against the JAX package
on the same inputs (the JAX ``pallas_walk_local`` in interpret mode, as
tests/test_pallas_walk.py runs it); then the port's own contracts, as
tests/test_scoring.py holds the JAX package's.

Tolerances, float64: ids, masks and bins exact; positions and s to
1e-12 absolute; flux and the bank's track lanes to rtol 1e-10 (atol
1e-13: another addition order); the bank's ``events`` lanes exact
(whole numbers). Within the port: scoring-off and scoring-on runs
bitwise in flux, ids and positions; heating = flux x energy and the
bin-partition telescoping bitwise; the VTK files byte-identical given
equal state."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from pumiumtally_tpu import EnergyFilter as JaxEnergyFilter
from pumiumtally_tpu import PartitionedPumiTally as JaxPartitioned
from pumiumtally_tpu import PumiTally as JaxPumiTally
from pumiumtally_tpu import ScoringSpec as JaxScoringSpec
from pumiumtally_tpu import StreamingPartitionedTally as JaxStreamingPart
from pumiumtally_tpu import StreamingTally as JaxStreamingTally
from pumiumtally_tpu import TallyConfig as JaxTallyConfig
from pumiumtally_tpu import TimeFilter as JaxTimeFilter
from pumiumtally_tpu import TriggerSpec as JaxTriggerSpec
from pumiumtally_tpu.io.vtk import read_vtk_cell_scalars
from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu.ops.pallas_walk import pallas_walk_local as jax_pallas
from pumiumtally_tpu.ops.walk import walk as jax_walk
from pumiumtally_tpu.parallel import make_device_mesh
from pumiumtally_tpu.parallel.partition import (
    build_partition as jax_build_partition,
)
from pumiumtally_tpu.scoring.binding import ScoreOps
from pumiumtally_tpu.scoring.binding import ScoringRuntime as JaxRuntime
from pumiumtally_tpu_torch import (
    EnergyFilter,
    PartitionedPumiTally,
    PumiTally,
    ScoringSpec,
    StreamingPartitionedTally,
    StreamingTally,
    TallyConfig,
    TimeFilter,
    TriggerSpec,
    convert,
)
from pumiumtally_tpu_torch.ops.pallas_walk import pallas_walk_local
from pumiumtally_tpu_torch.ops.walk import walk
from pumiumtally_tpu_torch.scoring import ScoringRuntime

N = 240
E = 6 * 4**3
TOL = 1e-8
F64 = torch.float64
_JMESH = jax_build_box(1, 1, 1, 4, 4, 4)
_MESH = convert.tetmesh_from_arrays(convert.mesh_arrays(_JMESH))
FACADES = ("monolithic", "streaming", "partitioned", "streaming_partitioned")
# The partitioned facades score on W2: the two-tier tables, the pallas
# block walk, one device.
W2 = dict(walk_table_dtype="bfloat16", walk_kernel="pallas",
          capacity_factor=4.0, walk_vmem_max_elems=40)


def _spec2(pkg="port"):
    """tests/test_scoring.py's 2-energy-bin, 3-score spec."""
    ef, sp = ((EnergyFilter, ScoringSpec) if pkg == "port"
              else (JaxEnergyFilter, JaxScoringSpec))
    return sp(filters=[ef([0.0, 1.0, 2.0])],
              scores=["flux", "heating", "events"])


def _corridor_workload(rng, moves=2):
    """tests/test_scoring.py's disjoint corridors: group A (energy in bin
    0) stays in x < 0.5, group B (bin 1) in x > 0.5, so every element
    sees one bin's particles only."""
    half = N // 2

    def pts():
        p = np.empty((N, 3))
        p[:half] = rng.uniform([0.05, 0.05, 0.05], [0.45, 0.95, 0.95],
                               (half, 3))
        p[half:] = rng.uniform([0.55, 0.05, 0.05], [0.95, 0.95, 0.95],
                               (N - half, 3))
        return p

    energy = np.where(np.arange(N) < half, 0.5, 1.5)
    return pts(), [pts() for _ in range(moves)], energy


def _make(name, spec, pkg="port", **kw):
    """One facade of either package on the 4^3 box."""
    if pkg == "jax":
        cfg = lambda **k: JaxTallyConfig(scoring=spec, **kw, **k)  # noqa: E731
        dm = dict(device_mesh=make_device_mesh(1), **W2)
        return {
            "monolithic": lambda: JaxPumiTally(_JMESH, N, cfg()),
            "streaming": lambda: JaxStreamingTally(_JMESH, N, chunk_size=100,
                                                   config=cfg()),
            "partitioned": lambda: JaxPartitioned(_JMESH, N, cfg(**dm)),
            "streaming_partitioned": lambda: JaxStreamingPart(
                _JMESH, N, chunk_size=120, config=cfg(**dm)),
        }[name]()
    cfg = lambda **k: TallyConfig(scoring=spec, **kw, **k)  # noqa: E731
    return {
        "monolithic": lambda: PumiTally(_MESH, N, cfg(), device="cpu"),
        "streaming": lambda: StreamingTally(_MESH, N, chunk_size=100,
                                            config=cfg(), device="cpu"),
        "partitioned": lambda: PartitionedPumiTally(_MESH, N, cfg(**W2),
                                                    device="cpu"),
        "streaming_partitioned": lambda: StreamingPartitionedTally(
            _MESH, N, chunk_size=120, config=cfg(**W2), device="cpu"),
    }[name]()


def _drive(t, src, dests, **move_kw):
    t.CopyInitialPosition(src.reshape(-1).copy())
    for d in dests:
        t.MoveToNextLocation(None, d.reshape(-1).copy(), **move_kw)
    return t


def _np(a):
    return convert.host(a).astype(np.float64)


def _assert_lanes(got, want, kinds):
    """Track lanes at rtol 1e-10, count lanes exact and whole."""
    got, want = np.asarray(got), np.asarray(want)
    S = len(kinds)
    for k, kind in enumerate(kinds):
        if kind == "count":
            np.testing.assert_array_equal(got[k::S], want[k::S])
            np.testing.assert_array_equal(got[k::S], np.round(got[k::S]))
        else:
            np.testing.assert_allclose(got[k::S], want[k::S], rtol=1e-10,
                                       atol=1e-13)


# -- filters, specs, bin resolution ------------------------------------------

_BAD = {
    "one edge": lambda m: m["EnergyFilter"]([1.0]),
    "not increasing": lambda m: m["EnergyFilter"]([0.0, 1.0, 1.0]),
    "not finite": lambda m: m["TimeFilter"]([0.0, np.inf]),
    "unknown score": lambda m: m["ScoringSpec"](scores=["flux", "dose"]),
    "duplicate": lambda m: m["ScoringSpec"](scores=["flux", "flux"]),
    "no score": lambda m: m["ScoringSpec"](scores=[]),
    "overflow": lambda m: m["ScoringSpec"](overflow="wrap"),
    "two energy filters": lambda m: m["ScoringSpec"](
        filters=[m["EnergyFilter"]([0, 1]), m["EnergyFilter"]([0, 1])]),
    "not a filter": lambda m: m["ScoringSpec"](filters=[object()]),
    "config scoring": lambda m: m["TallyConfig"](scoring=0.5),
    "config trigger": lambda m: m["TallyConfig"](batch_stats=True,
                                                 batch_stats_trigger=0.1),
    "trigger without stats": lambda m: m["TallyConfig"](
        batch_stats_trigger=m["TriggerSpec"](threshold=0.1)),
}
_PKGS = {
    "jax": dict(EnergyFilter=JaxEnergyFilter, TimeFilter=JaxTimeFilter,
                ScoringSpec=JaxScoringSpec, TallyConfig=JaxTallyConfig,
                TriggerSpec=JaxTriggerSpec),
    "port": dict(EnergyFilter=EnergyFilter, TimeFilter=TimeFilter,
                 ScoringSpec=ScoringSpec, TallyConfig=TallyConfig,
                 TriggerSpec=TriggerSpec),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_validation_raises_the_jax_message(case):
    msgs = []
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError) as e:
            _BAD[case](_PKGS[pkg])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_spec_properties_match_jax():
    for pkg in ("jax", "port"):
        m = _PKGS[pkg]
        spec = m["ScoringSpec"](
            filters=[m["EnergyFilter"]([0, 1, 2, 3]),
                     m["TimeFilter"]([0, 1, 2])],
            scores=["flux", "events"])
        assert spec.n_bins == 6 and spec.n_scores == 2
        assert spec.needs_energy and spec.needs_time
        assert spec.kinds == ("track", "count")
        assert spec.fac_kinds == ("one", "one")
        assert spec.static_key() == (("flux", "events"), "drop", 3, 2)
    assert repr(_spec2()) == repr(_spec2("jax"))


def _edge_values(edges, dtype):
    """Values on every edge, a step inside and outside the range, and
    (float32) an ulp either side of every edge."""
    e = np.asarray(edges, np.float64)
    vals = [e, e[:1] - 1.0, e[-1:] + 1.0, (e[:-1] + e[1:]) / 2]
    if dtype == np.float32:
        e32 = e.astype(np.float32)
        vals += [np.nextafter(e32, np.float32(-np.inf)),
                 np.nextafter(e32, np.float32(np.inf))]
    return np.concatenate([np.asarray(v, np.float64) for v in vals])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("overflow", ["drop", "clamp"])
def test_resolve_matches_jax(dtype, overflow):
    """Bins and factor rows of ``ScoringRuntime.resolve`` against the JAX
    ``_bins_and_factors``: values on edges, out of range (drop: the
    sentinel; clamp: the end bins) and, in float32, an ulp from an edge
    (each side of the edge in the working dtype)."""
    e_edges = [0.1, 0.5, 2.0, 7.5]
    t_edges = [0.0, 0.25, 1.0]
    vals_e = _edge_values(e_edges, np.dtype(dtype))
    rng = np.random.default_rng(1)
    vals_t = rng.permutation(np.resize(_edge_values(t_edges,
                                                    np.dtype(dtype)),
                                       vals_e.shape[0]))
    n = vals_e.shape[0]
    jspec = JaxScoringSpec([JaxEnergyFilter(e_edges),
                            JaxTimeFilter(t_edges)],
                           ["flux", "heating", "events"], overflow)
    spec = convert.scoring_spec(jspec)
    jrt = JaxRuntime(jspec, E, jnp.dtype(dtype))
    rt = ScoringRuntime(spec, E, getattr(torch, dtype), "cpu")
    assert (rt.stride, rt.bank_size) == (jrt.stride, jrt.bank_size)
    jb, jf = jrt.resolve(jnp.asarray(vals_e.astype(dtype)),
                         jnp.asarray(vals_t.astype(dtype)), n)
    b, f = rt.resolve(torch.tensor(vals_e.astype(dtype)),
                      torch.tensor(vals_t.astype(dtype)), n)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert b.dtype == torch.int32 and f.dtype == getattr(torch, dtype)
    dropped = b.numpy() == rt.bank_size
    assert dropped.any() == (overflow == "drop")
    # Every energy bin is reached.
    assert set(b.numpy()[~dropped] // 3 // spec.n_tbins) == \
        set(range(spec.n_ebins))


# -- W0 and W2 with scoring ---------------------------------------------------

def _walk_workload(seed, two_tier, n=600):
    jmesh = jax_build_box(1, 1, 1, 4, 4, 4)
    if two_tier:
        jmesh = jmesh.with_lowp_tables()
    arrays = convert.mesh_arrays(jmesh)
    rng = np.random.default_rng(seed)
    elem = rng.integers(0, arrays["tet2vert"].shape[0], n).astype(np.int32)
    x = arrays["coords"][arrays["tet2vert"][elem]].mean(axis=1)
    fly = (rng.random(n) > 0.15).astype(np.int8)
    dest = np.where(fly[:, None] == 1,
                    x + rng.normal(scale=0.35, size=(n, 3)), x)
    return jmesh, convert.tetmesh_from_arrays(arrays), dict(
        x=x, elem=elem, dest=dest, fly=fly, w=rng.uniform(0.5, 2.0, n))


def _score_inputs(rng, n, bins, bank_size, nscores=3):
    """Bin offsets (every bin, a few DROP sentinels) and factor rows for
    ``SCORE_KINDS[nscores]`` (the first track score: 1, a second: an
    energy; the count score: 1)."""
    bin_off = (rng.integers(0, bins, n) * nscores).astype(np.int32)
    bin_off[::13] = bank_size
    energy = rng.uniform(0.5, 3.0, n)
    cols = {1: [np.ones(n)], 2: [np.ones(n), np.ones(n)],
            3: [np.ones(n), energy, np.ones(n)]}[nscores]
    return bin_off, np.stack(cols, 1)


KINDS = ("track", "track", "count")
# The walks' scoring commit over S = 1, 2, 3 scores (the kernels cover a
# crossing's S lanes with aligned vector reductions in float32).
SCORE_KINDS = {1: ("track",), 2: ("track", "count"), 3: KINDS}
# Bin counts: an even stride (B = 4) and, for odd S, an odd one (B = 3).
SCORE_BINS = [4, 3]


@pytest.mark.parametrize("bins", SCORE_BINS)
@pytest.mark.parametrize("nscores", [1, 2, 3])
@pytest.mark.parametrize("two_tier", [False, True])
def test_walk_scoring_matches_jax(two_tier, nscores, bins):
    """W0's scoring commit (``walk(scoring=)``; on CPU tensors
    ``walk_plain``) against the JAX ``walk(scoring=)`` for S = 1, 2, 3
    scores at strides B*S; scoring leaves the walk bitwise what it is
    without."""
    jmesh, mesh, d = _walk_workload(21, two_tier)
    n, kinds = d["x"].shape[0], SCORE_KINDS[nscores]
    stride = bins * nscores
    bin_off, fac = _score_inputs(np.random.default_rng(2), n, bins,
                                 E * stride, nscores)
    table = "bfloat16" if two_tier else "float32"
    r = jax_walk(
        jmesh, *(jnp.asarray(d[k]) for k in ("x", "elem", "dest", "fly",
                                             "w")),
        jnp.zeros((E,)), tally=True, tol=TOL, max_iters=4096,
        table_dtype=table,
        scoring=ScoreOps(kinds, jnp.zeros(E * stride), jnp.asarray(bin_off),
                         jnp.asarray(fac)))
    t = {k: torch.tensor(v) for k, v in d.items()}
    args = (mesh, t["x"], t["elem"], t["dest"], t["fly"], t["w"])
    bank = torch.zeros(E * stride, dtype=F64)
    p = walk(*args, torch.zeros(E, dtype=F64), tally=True, tol=TOL,
             max_iters=4096, table_dtype=table,
             scoring=(kinds, bank, torch.tensor(bin_off),
                      torch.tensor(fac)))
    for k in ("elem", "done", "exited"):
        np.testing.assert_array_equal(getattr(p, k).numpy(),
                                      np.asarray(getattr(r, k)), err_msg=k)
    for k in ("x", "s"):
        np.testing.assert_allclose(getattr(p, k).numpy(),
                                   np.asarray(getattr(r, k)), rtol=0,
                                   atol=1e-12, err_msg=k)
    np.testing.assert_allclose(p.flux.numpy(), np.asarray(r.flux),
                               rtol=1e-10, atol=1e-13)
    _assert_lanes(bank.numpy(), r.score_bank, kinds)
    assert bank[nscores - 1::nscores].sum() > 0
    assert np.asarray(r.exited).sum() > 0
    off = walk(*args, torch.zeros(E, dtype=F64), tally=True, tol=TOL,
               max_iters=4096, table_dtype=table)
    for k in ("x", "elem", "done", "exited", "s", "flux"):
        assert torch.equal(getattr(p, k), getattr(off, k)), k


def test_walk_scoring_refusals():
    _, mesh, d = _walk_workload(3, False, n=20)
    t = {k: torch.tensor(v) for k, v in d.items()}
    args = (mesh, t["x"], t["elem"], t["dest"], t["fly"], t["w"])
    ok = (KINDS, torch.zeros(E * 3, dtype=F64),
          torch.zeros(20, dtype=torch.int32), torch.ones(20, 3, dtype=F64))
    with pytest.raises(ValueError, match="tallying walk"):
        walk(*args, None, tally=False, tol=TOL, max_iters=64, scoring=ok)
    with pytest.raises(ValueError, match="kinds"):
        walk(*args, torch.zeros(E, dtype=F64), tally=True, tol=TOL,
             max_iters=64, scoring=(("track",) * 4,) + ok[1:])
    with pytest.raises(ValueError, match="whole multiple"):
        walk(*args, torch.zeros(E, dtype=F64), tally=True, tol=TOL,
             max_iters=64,
             scoring=(KINDS, torch.zeros(E * 3 + 1, dtype=F64)) + ok[2:])


@pytest.mark.parametrize("bins", SCORE_BINS)
@pytest.mark.parametrize("nscores", [1, 2, 3])
@pytest.mark.parametrize("blocks", [1, 2])
def test_pallas_walk_scoring_matches_jax(blocks, nscores, bins):
    """W2's scoring lanes (``pallas_walk_local(scoring=)``; on CPU
    tensors the plain version) against K2's in-kernel lowering run in
    interpret mode (tests/test_pallas_walk.py:173), on a slice of a
    4-part two-tier partition, for S = 1, 2, 3 scores at strides B*S:
    pauses at block faces, boundary exits, dead slots, DROP
    sentinels."""
    nparts, cap = 4, 700 if blocks == 1 else 1024
    part = convert.partition_arrays(
        jax_build_partition(_JMESH, nparts, table_dtype="bfloat16"))
    L = part["L"]
    rng = np.random.default_rng(40 + blocks)
    orig = part["orig_of_glid"].reshape(nparts, L)
    coords, tets = (np.asarray(_JMESH.coords), np.asarray(_JMESH.tet2vert))
    lelem, x = [], []
    for b in range(1, 1 + blocks):
        le = rng.choice(np.flatnonzero(orig[b] >= 0), size=cap)
        lelem.append(le)
        x.append(coords[tets[orig[b][le]]].mean(axis=1))
    lelem = np.concatenate(lelem).astype(np.int32)
    x = np.concatenate(x)
    n = x.shape[0]
    fly = (rng.random(n) > 0.15).astype(np.int8)
    d = dict(lo=part["table"][L:(1 + blocks) * L],
             hi=part["table_hi"][4 * L:4 * (1 + blocks) * L], x=x,
             lelem=lelem,
             dest=np.where(fly[:, None] == 1,
                           x + rng.normal(scale=0.25, size=(n, 3)), x),
             fly=fly, w=rng.uniform(0.5, 2.0, n), done=rng.random(n) >= 0.9,
             exited=np.zeros(n, bool), flux=np.zeros(blocks * L))
    kinds, stride = SCORE_KINDS[nscores], bins * nscores
    # The sentinel of the whole padded bank (nparts*L*stride).
    bin_off, fac = _score_inputs(rng, n, bins, nparts * L * stride,
                                 nscores)
    keys = ("lo", "hi", "x", "lelem", "dest", "fly", "w", "done", "exited",
            "flux")
    jargs = [jnp.asarray(d[k]) for k in keys]
    jargs[0] = lax.bitcast_convert_type(jargs[0], jnp.bfloat16)
    ref = jax_pallas(*jargs, tally=True, tol=TOL, max_iters=4096,
                     blocks=blocks, interpret=True,
                     scoring=ScoreOps(kinds,
                                      jnp.zeros(blocks * L * stride),
                                      jnp.asarray(bin_off),
                                      jnp.asarray(fac)))
    targs = [torch.tensor(d[k]) for k in keys]
    targs[0] = convert.bf16_from_bits(d["lo"])
    bank = torch.zeros(blocks * L * stride, dtype=F64)
    port = pallas_walk_local(*targs, tally=True, tol=TOL, max_iters=4096,
                             blocks=blocks,
                             scoring=(kinds, bank, torch.tensor(bin_off),
                                      torch.tensor(fac)))
    ref = [np.asarray(o) for o in ref]
    for i, k in ((1, "lelem"), (2, "done"), (3, "exited"), (4, "pending"),
                 (6, "iters")):
        np.testing.assert_array_equal(port[i].numpy(), ref[i], err_msg=k)
    np.testing.assert_allclose(port[0].numpy(), ref[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(port[5].numpy(), ref[5], rtol=1e-10,
                               atol=1e-13)
    _assert_lanes(bank.numpy(), ref[7], kinds)
    assert (ref[4] >= 0).sum() > 0 and bank[nscores - 1::nscores].sum() > 0
    # Scoring changes nothing else.
    targs[-1] = torch.zeros(blocks * L, dtype=F64)
    off = pallas_walk_local(*targs, tally=True, tol=TOL, max_iters=4096,
                            blocks=blocks)
    for a, b in zip(port[:7], off[:7]):
        assert torch.equal(a, b)


# -- the facades against the JAX package --------------------------------------

@pytest.mark.parametrize("name", FACADES)
def test_facade_scoring_matches_jax(name):
    """Each facade with the spec against its JAX counterpart (the
    partitioned ones on W2 with one device): a two-phase move with
    energies out of range (dropped), then continue moves."""
    rng = np.random.default_rng(61)
    src, dests, en = _corridor_workload(rng, 2)
    en_out = np.where(np.arange(N) % 7 == 0, 5.0, en)
    ref = _make(name, _spec2("jax"), "jax")
    port = _make(name, _spec2())
    for t in (ref, port):
        t.CopyInitialPosition(src.reshape(-1).copy())
        t.MoveToNextLocation(src.reshape(-1).copy(),
                             dests[0].reshape(-1).copy(),
                             np.ones(N, np.int8), np.ones(N), energy=en_out)
        t.MoveToNextLocation(None, dests[1].reshape(-1).copy(), energy=en)
    np.testing.assert_array_equal(port.elem_ids, np.asarray(ref.elem_ids))
    np.testing.assert_allclose(port.positions, np.asarray(ref.positions),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(port.flux), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-13)
    _assert_lanes(_np(port.score_bank), ref.score_bank, _spec2().kinds)
    np.testing.assert_allclose(_np(port.score_array()),
                               np.asarray(ref.score_array()), rtol=1e-10,
                               atol=1e-13)


# -- the port's own contracts -------------------------------------------------

def test_scoring_off_constructs_nothing():
    rng = np.random.default_rng(1)
    src, dests, en = _corridor_workload(rng, 1)
    for name in FACADES:
        t = _drive(_make(name, None), src, dests)
        assert t._scoring is None and t._score_bank is None
        assert t._score_stats is None and t._stats is None
        for eng in ([t.engine] if hasattr(t, "engine")
                    else getattr(t, "engines", [])):
            assert "sbin" not in eng.state and eng.score_padded is None
        if name in ("monolithic", "partitioned"):
            assert not [k for k in convert.facade_state(t)
                        if "score" in k or "stats" in k]
        with pytest.raises(RuntimeError, match="scoring.ScoringSpec"):
            t.score_bank
        with pytest.raises(ValueError, match="energy=/time= require"):
            t.MoveToNextLocation(None, dests[0].reshape(-1).copy(),
                                 energy=en)


@pytest.mark.parametrize("name", FACADES)
def test_scoring_keeps_the_walk_bitwise_and_telescopes(name):
    """Scoring on leaves flux, ids and positions bitwise those of the
    run without; on the corridor workload the flux lanes of the two bins
    sum to the flux lane bitwise, both bins populated."""
    rng = np.random.default_rng(7)
    src, dests, en = _corridor_workload(rng, 2)
    t_off = _drive(_make(name, None), src, dests)
    t_on = _drive(_make(name, _spec2()), src, dests, energy=en)
    f_off = _np(t_off.flux)
    np.testing.assert_array_equal(_np(t_on.flux), f_off)
    np.testing.assert_array_equal(t_on.positions, t_off.positions)
    np.testing.assert_array_equal(t_on.elem_ids, t_off.elem_ids)
    arr = _np(t_on.score_bank).reshape(E, 2, 3)
    np.testing.assert_array_equal(arr[:, :, 0].sum(axis=1), f_off)
    assert arr[:, 0, 0].sum() > 0 and arr[:, 1, 0].sum() > 0
    ev = arr[:, :, 2]
    assert np.array_equal(ev, np.round(ev)) and ev.sum() > 0


def test_heating_is_energy_scaled_flux_bitwise():
    spec = ScoringSpec(filters=[EnergyFilter([0.0, 4.0])],
                       scores=["flux", "heating"])
    rng = np.random.default_rng(9)
    src, dests, _ = _corridor_workload(rng, 2)
    t = _drive(_make("monolithic", spec), src, dests,
               energy=np.full(N, 2.0))
    arr = _np(t.score_array())
    np.testing.assert_array_equal(arr[:, 0, 1], 2.0 * arr[:, 0, 0])
    np.testing.assert_array_equal(arr[:, 0, 0], _np(t.flux))


@pytest.mark.parametrize("name", ["monolithic", "streaming"])
def test_energy_time_errors_name_the_argument(name):
    t = _make(name, _spec2())
    rng = np.random.default_rng(19)
    src, dests, en = _corridor_workload(rng, 1)
    t.CopyInitialPosition(src.reshape(-1).copy())
    d = dests[0].reshape(-1)
    fly = np.ones(N, np.int8)
    with pytest.raises(ValueError, match="pass energy="):
        t.MoveToNextLocation(None, d.copy(), fly)
    with pytest.raises(ValueError, match="energy buffer has 3 values"):
        t.MoveToNextLocation(None, d.copy(), fly, energy=np.ones(3))
    bad = en.copy()
    bad[7] = np.nan
    with pytest.raises(ValueError, match="energy contains 1 non-finite"):
        t.MoveToNextLocation(None, d.copy(), fly, energy=bad)
    with pytest.raises(ValueError, match="no TimeFilter"):
        t.MoveToNextLocation(None, d.copy(), fly, energy=en, time=np.ones(N))
    # The refused moves left the caller's flying buffer and the engine
    # alone: the good move transports and scores.
    np.testing.assert_array_equal(fly, 1)
    assert _np(t.flux).sum() == 0
    t.MoveToNextLocation(None, d.copy(), fly, energy=en)
    assert _np(t.score_bank).sum() > 0 and not fly.any()
    spec_t = ScoringSpec(filters=[TimeFilter([0.0, 1.0])])
    tt = _make(name, spec_t)
    tt.CopyInitialPosition(src.reshape(-1).copy())
    with pytest.raises(ValueError, match="pass time="):
        tt.MoveToNextLocation(None, d.copy())
    with pytest.raises(ValueError, match="no EnergyFilter"):
        tt.MoveToNextLocation(None, d.copy(), energy=en, time=np.ones(N))


@pytest.mark.parametrize("name", ["monolithic", "partitioned"])
def test_overflow_policy_drop_vs_clamp(name):
    rng = np.random.default_rng(17)
    src, dests, _ = _corridor_workload(rng, 1)
    en = np.where(np.arange(N) < N // 2, -3.0, 9.0)  # all out of range

    def spec(policy):
        return ScoringSpec(filters=[EnergyFilter([0.0, 1.0, 2.0])],
                           scores=["flux"], overflow=policy)

    t_drop = _drive(_make(name, spec("drop")), src, dests, energy=en)
    flux = _np(t_drop.flux)
    assert flux.sum() > 0 and _np(t_drop.score_bank).sum() == 0.0
    t_clamp = _drive(_make(name, spec("clamp")), src, dests, energy=en)
    arr = _np(t_clamp.score_bank).reshape(E, 2, 1)
    assert arr[:, 0, 0].sum() > 0 and arr[:, 1, 0].sum() > 0
    np.testing.assert_array_equal(arr.sum(axis=(1, 2)), flux)


def test_partitioned_scoring_needs_w2():
    """Scoring on the float32 block tables (the W1 knobs): both engines
    reroute to the gather block walk (W4 in the port) and agree, a
    two-phase move with dropped energies and a continue move."""
    kw = dict(walk_vmem_max_elems=40, capacity_factor=4.0)
    ref = JaxPartitioned(_JMESH, N, JaxTallyConfig(
        scoring=_spec2("jax"), device_mesh=make_device_mesh(1), **kw))
    port = PartitionedPumiTally(_MESH, N, TallyConfig(scoring=_spec2(),
                                                      **kw), device="cpu")
    assert port.engine.block_kernel == ref.engine.block_kernel == "gather"
    assert port.engine.nparts == ref.engine.nparts > 1
    rng = np.random.default_rng(67)
    src, dests, en = _corridor_workload(rng, 2)
    en_out = np.where(np.arange(N) % 7 == 0, 5.0, en)
    for t in (ref, port):
        t.CopyInitialPosition(src.reshape(-1).copy())
        t.MoveToNextLocation(src.reshape(-1).copy(),
                             dests[0].reshape(-1).copy(),
                             np.ones(N, np.int8), np.ones(N), energy=en_out)
        t.MoveToNextLocation(None, dests[1].reshape(-1).copy(), energy=en)
    np.testing.assert_array_equal(port.elem_ids, np.asarray(ref.elem_ids))
    np.testing.assert_allclose(port.positions, np.asarray(ref.positions),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(port.flux), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-13)
    _assert_lanes(_np(port.score_bank), ref.score_bank, _spec2().kinds)


def test_write_tally_results_matches_jax_files(tmp_path):
    """Given equal state (the JAX facade's, carried over by
    ``convert``), the port writes the JAX file byte for byte: with
    scoring the ``<score>_bin<k>`` arrays, volume-normalised like flux;
    without, the reference's payload."""
    rng = np.random.default_rng(31)
    src, dests, en = _corridor_workload(rng, 2)
    for spec in (_spec2(), None):
        ref = _make("monolithic", None if spec is None else _spec2("jax"),
                    "jax")
        _drive(ref, src, dests, **({} if spec is None else {"energy": en}))
        port = _make("monolithic", spec)
        convert.load_facade_state(port, convert.facade_state(ref))
        if spec is not None:
            np.testing.assert_array_equal(_np(port.score_bank),
                                          np.asarray(ref.score_bank))
        dirs = [tmp_path / f"{who}_{spec is not None}" for who in "jp"]
        for t, d in zip((ref, port), dirs):
            d.mkdir()
            t.WriteTallyResults(str(d / "out.vtk"))
        names = sorted(p.name for p in dirs[0].iterdir())
        assert names == sorted(p.name for p in dirs[1].iterdir())
        for f in names:
            assert (dirs[0] / f).read_bytes() == (dirs[1] / f).read_bytes()
        cells = str(dirs[1] / "out.vtk")
        if spec is None:
            with pytest.raises(KeyError):
                read_vtk_cell_scalars(cells, "flux_bin1")
        else:
            vol = np.asarray(_JMESH.volumes)
            np.testing.assert_array_equal(
                read_vtk_cell_scalars(cells, "flux_bin1"),
                _np(port.score_array())[:, 1, 0] / vol)
