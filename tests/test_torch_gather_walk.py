"""PyTorch port, the gather block walk W4 (``walk_local``) and the
partitioned facades' default configuration, against the JAX package on
the CPU in float64.

- ``walk_local_plain`` (the kernel's plain version) against the JAX
  ``walk_local`` on one block of a box split into parts, so that
  particles pause at block faces: packed rows with in-row adjacency,
  with the forced int32 sidecar, the two-tier tables, and packed rows
  with scoring (S = 1 and 3), tally on and off, the JAX walk with and
  without its compaction cascade;
- the facades with ``make_device_mesh(1)`` on the JAX side: a default
  ``TallyConfig`` (one block, W4), the gather sub-split, bf16 tables
  with the vmem kernel (rerouted to W4), float32 scoring and a
  partition with the forced sidecar; ``StreamingPartitionedTally`` with
  the default config.

Tolerances: ids, masks and ``pending`` exact, every integer slot row
exact, positions within 1e-12, flux and scoring lanes within rtol 1e-10
(the summation order differs), ``iters`` within the JAX walk's
``cond_every`` band (it checks its budget every ``cond_every`` steps)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pumiumtally_tpu import PartitionedPumiTally as JaxPartitioned
from pumiumtally_tpu import StreamingPartitionedTally as JaxStreamingPart
from pumiumtally_tpu import TallyConfig as JaxTallyConfig
from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu.ops.walk import COND_EVERY_DEFAULT
from pumiumtally_tpu.parallel import make_device_mesh
from pumiumtally_tpu.parallel.partition import (
    PartitionedEngine as JaxEngine,
    build_partition as jax_build_partition,
    walk_local as jax_walk_local,
)
from pumiumtally_tpu.scoring import EnergyFilter as JaxEnergyFilter
from pumiumtally_tpu.scoring import ScoringSpec as JaxScoringSpec
from pumiumtally_tpu.scoring.binding import ScoreOps
from pumiumtally_tpu_torch import (
    EnergyFilter,
    PartitionedPumiTally,
    ScoringSpec,
    StreamingPartitionedTally,
    TallyConfig,
    convert,
)
from pumiumtally_tpu_torch.parallel.partition import (
    PartitionedEngine,
    build_partition,
    walk_local,
    walk_local_plain,
)

TOL = 1e-8
F64 = torch.float64
N = 300
INT_ROWS = ("lelem", "pending", "pid", "alive", "done", "exited", "lost",
            "fly")
_JMESH = jax_build_box(1, 1, 1, 4, 4, 4)  # 384 tets
_MESH = convert.tetmesh_from_arrays(convert.mesh_arrays(_JMESH))


def _flat(a):
    return np.ascontiguousarray(np.asarray(a, np.float64).reshape(-1))


# -- walk_local_plain against the JAX walk_local ------------------------------

NPARTS = 4  # 384 tets -> 4 blocks of 96
LAYOUTS = ("packed", "sidecar", "two_tier", "scored1", "scored3")
SCORE_KINDS = {"scored1": ("track",), "scored3": ("track", "track", "count")}
BINS = 3


def _block_inputs(layout: str, seed: int = 7):
    """One block's rows (both packages' partitions of the 4^3 box into
    NPARTS parts) and particles in its elements, heading anywhere in
    the box and beyond, so that they finish, exit or pause."""
    two_tier = layout == "two_tier"
    kw = dict(table_dtype="bfloat16" if two_tier else "float32",
              force_split_adj=layout == "sidecar")
    jpart = jax_build_partition(_JMESH, NPARTS, **kw)
    part = build_partition(_MESH, NPARTS, **kw)
    ja, pa = convert.partition_arrays(jpart), convert.partition_arrays(part)
    assert sorted(ja) == sorted(pa)
    for k in ja:
        np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)
    assert (part.adj_int is not None) == (layout == "sidecar")
    b, L = 1, part.L
    orig = part.orig_of_glid[b * L:(b + 1) * L].numpy()
    rng = np.random.default_rng(seed)
    n = 240
    lelem = rng.choice(np.flatnonzero(orig >= 0), n).astype(np.int32)
    arrays = convert.mesh_arrays(_JMESH)
    verts = arrays["coords"][arrays["tet2vert"][orig[lelem]]]
    bary = rng.dirichlet(np.ones(4), n)
    x = np.einsum("nv,nvc->nc", bary, verts)
    fly = (rng.random(n) > 0.1).astype(np.int8)
    dest = np.where(fly[:, None] == 1,
                    x + rng.normal(scale=0.3, size=(n, 3)), x)
    done = rng.random(n) < 0.1
    d = dict(x=x, lelem=lelem, dest=dest, fly=fly,
             w=rng.uniform(0.5, 2.0, n), done=done,
             exited=np.zeros(n, bool))
    rows = slice(b * L, (b + 1) * L)
    tables = {"table": (ja["table"][rows], part.table[rows])}
    if two_tier:
        hi = slice(4 * b * L, 4 * (b + 1) * L)
        tables["table_hi"] = (ja["table_hi"][hi], part.table_hi[hi])
        # The JAX select tier is bf16: hand it its own array.
        tables["table"] = (jpart.table[rows], part.table[rows])
    if layout == "sidecar":
        tables["adj_int"] = (ja["adj_int"][rows], part.adj_int[rows])
    return L, d, tables


# Scoring rides tallying walks only (both packages refuse it without).
WALK_CASES = [(layout, tally, compact) for layout in LAYOUTS
              for tally in (True, False) for compact in (False, True)
              if tally or not layout.startswith("scored")]


@pytest.mark.parametrize("layout,tally,compact", WALK_CASES)
def test_walk_local_plain_matches_jax(layout, tally, compact):
    L, d, tables = _block_inputs(layout)
    n = d["x"].shape[0]
    kinds = SCORE_KINDS.get(layout)
    jkw, pkw = {}, {}
    for k, (jv, pv) in tables.items():
        if k != "table":
            jkw[k], pkw[k] = jnp.asarray(jv), pv
    if kinds is not None:
        stride = BINS * len(kinds)
        rng = np.random.default_rng(3)
        bin_off = (rng.integers(0, BINS, n) * len(kinds)).astype(np.int32)
        bin_off[::11] = NPARTS * L * stride  # the DROP sentinel
        # Track factors vary (an energy-scaled score); counts weigh 1.
        fac = np.stack([np.ones(n) if k == "count"
                        else rng.uniform(0.5, 2.0, n) for k in kinds], 1)
        jkw["scoring"] = ScoreOps(kinds, jnp.zeros(L * stride),
                                  jnp.asarray(bin_off), jnp.asarray(fac))
        bank = torch.zeros(L * stride, dtype=F64)
        pkw["scoring"] = (kinds, bank, torch.tensor(bin_off),
                          torch.tensor(fac))
    keys = ("x", "lelem", "dest", "fly", "w", "done", "exited")
    r = jax_walk_local(
        jnp.asarray(tables["table"][0]), *(jnp.asarray(d[k]) for k in keys),
        jnp.zeros(L), tally=tally, tol=TOL, max_iters=4096,
        compact=compact, min_window=16, **jkw)
    p = walk_local_plain(tables["table"][1],
                         *(torch.tensor(d[k]) for k in keys),
                         torch.zeros(L, dtype=F64) if tally else None,
                         tally=tally, tol=TOL, max_iters=4096, **pkw)
    for i, k in ((1, "lelem"), (2, "done"), (3, "exited"), (4, "pending")):
        np.testing.assert_array_equal(p[i].numpy(), np.asarray(r[i]),
                                      err_msg=k)
    np.testing.assert_allclose(p[0].numpy(), np.asarray(r[0]), rtol=0,
                               atol=1e-12)
    it_p, it_r = int(p[6]), int(r[6])
    assert it_p <= it_r < it_p + COND_EVERY_DEFAULT, (it_p, it_r)
    pending = p[4].numpy()
    assert (pending >= 0).sum() > 0 and p[3].numpy().sum() > 0
    # A paused particle keeps its element and sits on the block face.
    assert not p[2].numpy()[pending >= 0].any()
    if tally:
        np.testing.assert_allclose(p[5].numpy(), np.asarray(r[5]),
                                   rtol=1e-10, atol=1e-13)
        assert p[5].sum() > 0
    if kinds is not None:
        np.testing.assert_allclose(p[7].numpy(), np.asarray(r[7]),
                                   rtol=1e-10, atol=1e-13)
        if kinds[-1] == "count":
            ev = p[7].numpy()[len(kinds) - 1::len(kinds)]
            np.testing.assert_array_equal(ev, np.round(ev))
            assert ev.sum() > 0


def test_walk_local_wrapper_walks_listed_blocks_only():
    """The wrapper over stacked blocks: each listed block is
    ``walk_local_plain`` on its slice; an unlisted block keeps its slots
    and gets pending -1, its flux untouched."""
    part = build_partition(_MESH, NPARTS)
    L, cb = part.L, 60
    rng = np.random.default_rng(5)
    n = NPARTS * cb
    lelem = torch.tensor(rng.integers(0, L, n), dtype=torch.int32)
    valid = part.orig_of_glid.view(NPARTS, L).numpy()
    for b in range(NPARTS):  # real elements only
        ok = np.flatnonzero(valid[b] >= 0)
        lelem[b * cb:(b + 1) * cb] = torch.tensor(rng.choice(ok, cb))
    glid = (torch.arange(n) // cb) * L + lelem.long()
    orig = part.orig_of_glid[glid].long()
    x = _MESH.coords[_MESH.tet2vert[orig]].mean(dim=1)
    dest = x + torch.tensor(rng.normal(scale=0.3, size=(n, 3)))
    args = (x, lelem, dest, torch.ones(n, dtype=torch.int8),
            torch.ones(n, dtype=F64), torch.zeros(n, dtype=torch.bool),
            torch.zeros(n, dtype=torch.bool))
    flux = torch.zeros(NPARTS * L, dtype=F64)
    ids = torch.tensor([0, 2], dtype=torch.int32)
    res = walk_local(part.table, *args, flux, tally=True, tol=TOL,
                     max_iters=4096, blocks=NPARTS, block_ids=ids)
    it = 0
    for b in range(NPARTS):
        ps, es = slice(b * cb, (b + 1) * cb), slice(b * L, (b + 1) * L)
        if b in (0, 2):
            fb = torch.zeros(L, dtype=F64)
            want = walk_local_plain(part.table[es], *(a[ps] for a in args),
                                    fb, tally=True, tol=TOL, max_iters=4096)
            for k in range(5):
                assert torch.equal(res[k][ps], want[k]), (b, k)
            assert torch.equal(flux[es], fb)
            it = max(it, int(want[6]))
        else:
            # x, lelem, done, exited come back as they went in.
            for k, a in zip(range(4), (0, 1, 5, 6)):
                assert torch.equal(res[k][ps], args[a][ps])
            assert (res[4][ps] == -1).all() and (flux[es] == 0).all()
    assert int(res[6]) == it


# -- the facades against the JAX package --------------------------------------

def _spec(pkg):
    ef, sp = ((EnergyFilter, ScoringSpec) if pkg == "port"
              else (JaxEnergyFilter, JaxScoringSpec))
    return sp(filters=[ef([0.0, 1.0, 2.0])],
              scores=["flux", "heating", "events"])


# name -> (config knobs, scoring, sidecar partition of this many parts)
CASES = {
    "default": ({}, False, None),
    "gather_subsplit": (dict(walk_vmem_max_elems=40,
                             walk_block_kernel="gather"), False, None),
    "bf16_vmem_reroute": (dict(walk_vmem_max_elems=40,
                               walk_table_dtype="bfloat16"), False, None),
    "f32_scoring": ({}, True, None),
    "f32_scoring_subsplit": (dict(walk_vmem_max_elems=40), True, None),
    "sidecar": ({}, False, 5),
}


def _pair(case):
    knobs, scoring, sidecar = CASES[case]
    ref = JaxPartitioned(_JMESH, N, JaxTallyConfig(
        device_mesh=make_device_mesh(1), capacity_factor=2.0,
        scoring=_spec("jax") if scoring else None, **knobs))
    port = PartitionedPumiTally(_MESH, N, TallyConfig(
        capacity_factor=2.0, scoring=_spec("port") if scoring else None,
        **knobs), device="cpu")
    if sidecar:
        # A partition with the forced int32 sidecar under each facade.
        ref.engine = JaxEngine(
            _JMESH, ref.device_mesh, N, capacity_factor=2.0, tol=TOL,
            max_iters=4096, block_kernel="gather",
            part=jax_build_partition(_JMESH, sidecar, force_split_adj=True))
        ref._wire_engine_hooks(ref.engine)
        port.engine = PartitionedEngine(
            _MESH, N, capacity_factor=2.0, tol=TOL, max_iters=4096,
            block_kernel="gather",
            part=build_partition(_MESH, sidecar, force_split_adj=True))
        assert port.engine.part.adj_int is not None
    return ref, port


def _assert_same(port, ref, scoring=False):
    np.testing.assert_array_equal(port.elem_ids, np.asarray(ref.elem_ids))
    np.testing.assert_allclose(port.positions, np.asarray(ref.positions),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(port.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-13)
    ps, rs = convert.facade_state(port), convert.facade_state(ref)
    for k in INT_ROWS + (("sbin",) if scoring else ()):
        np.testing.assert_array_equal(ps[k], rs[k], err_msg=k)
    np.testing.assert_allclose(ps["x"], rs["x"], rtol=0, atol=1e-12)
    if scoring:
        np.testing.assert_allclose(port.score_bank.numpy(),
                                   np.asarray(ref.score_bank), rtol=1e-10,
                                   atol=1e-13)


@pytest.mark.parametrize("case", sorted(CASES))
def test_partitioned_facade_matches_jax(case, tmp_path):
    ref, port = _pair(case)
    eng, jeng = port.engine, ref.engine
    assert (eng.nparts, eng.part.L, eng.cap_per_block) == \
        (jeng.nparts, jeng.part.L, jeng.cap_per_block)
    assert not (eng.use_vmem_walk or eng.use_pallas_walk)
    assert not (jeng.use_vmem_walk or jeng.use_pallas_walk)
    assert eng.block_kernel == jeng.block_kernel
    scoring = CASES[case][1]
    rng = np.random.default_rng(11)
    src = rng.uniform(0.05, 0.95, (N, 3))
    d1 = rng.uniform(0.05, 0.95, (N, 3))
    d1[::7] = rng.uniform(-0.2, 1.2, (len(d1[::7]), 3))  # some exit
    d2 = rng.uniform(0.05, 0.95, (N, 3))
    d3 = rng.uniform(0.05, 0.95, (N, 3))
    fly = (rng.random(N) > 0.1).astype(np.int8)
    w = rng.uniform(0.5, 2.0, N)
    en = rng.uniform(0.2, 1.8, N)
    mkw = {"energy": en} if scoring else {}
    for t in (ref, port):
        t.CopyInitialPosition(_flat(src))
    _assert_same(port, ref, scoring)
    for t in (ref, port):
        t.MoveToNextLocation(_flat(src), _flat(d1), fly.copy(), w, **mkw)
    _assert_same(port, ref, scoring)
    for d in (d2, d3):
        for t in (ref, port):
            t.MoveToNextLocation(None, _flat(d), **mkw)
        _assert_same(port, ref, scoring)
    assert eng.last_walk_rounds == jeng.last_walk_rounds
    assert eng.last_block_dispatches == jeng.last_block_dispatches
    if eng.nparts > 1:
        assert eng.last_walk_rounds > 2
    # Given equal flux, the VTK bytes are the JAX writer's.
    convert.load_facade_state(port, convert.facade_state(ref))
    for t, name in ((ref, "jax.vtk"), (port, "port.vtk")):
        t.WriteTallyResults(str(tmp_path / name))
    assert (tmp_path / "jax.vtk").read_bytes() == \
        (tmp_path / "port.vtk").read_bytes()


def test_default_config_is_one_gather_block():
    """No bound: one block holds the mesh and W4 walks it once a round,
    as the JAX engine does; the vmem/bf16 reroute and scoring land on the
    gather kernel too."""
    t = PartitionedPumiTally(_MESH, 8, device="cpu")
    assert t.engine.nparts == 1 and t.engine.block_kernel == "vmem"
    assert not t.engine.use_vmem_walk and t.engine.part.adj_int is None
    for knobs, scoring in ((dict(walk_table_dtype="bfloat16"), False),
                           ({}, True)):
        t = PartitionedPumiTally(_MESH, 8, TallyConfig(
            scoring=_spec("port") if scoring else None, **knobs),
            device="cpu")
        assert t.engine.block_kernel == "gather"


def test_streaming_partitioned_default_matches_jax():
    ref = JaxStreamingPart(_JMESH, N, chunk_size=120, config=JaxTallyConfig(
        device_mesh=make_device_mesh(1), capacity_factor=2.0))
    port = StreamingPartitionedTally(_MESH, N, chunk_size=120,
                                     config=TallyConfig(capacity_factor=2.0),
                                     device="cpu")
    assert [e.nparts for e in port.engines] == [1, 1, 1]
    rng = np.random.default_rng(17)
    src = rng.uniform(0.05, 0.95, (N, 3))
    d1 = rng.uniform(-0.1, 1.1, (N, 3))
    d2 = rng.uniform(0.05, 0.95, (N, 3))
    for t in (ref, port):
        t.CopyInitialPosition(_flat(src))
        t.MoveToNextLocation(_flat(src), _flat(d1), np.ones(N, np.int8),
                             np.ones(N))
        t.MoveToNextLocation(None, _flat(d2))
    np.testing.assert_array_equal(port.elem_ids, np.asarray(ref.elem_ids))
    np.testing.assert_allclose(port.positions, np.asarray(ref.positions),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(port.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-13)
    for pe, je in zip(port.engines, ref.engines):
        for k in INT_ROWS:
            np.testing.assert_array_equal(pe.state[k].numpy(),
                                          np.asarray(je.state[k]),
                                          err_msg=k)
