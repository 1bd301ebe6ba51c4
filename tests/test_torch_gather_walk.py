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
from pumiumtally_tpu_torch.parallel import partition
from pumiumtally_tpu_torch.parallel.partition import (
    PartitionedEngine,
    _frontier_migrate_impl,
    _migrate_round,
    build_partition,
    walk_local,
    walk_local_blocks_plain,
    walk_local_list,
    walk_local_plain,
    work_list,
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


def _stacked_inputs(seed: int = 5, cb: int = 60):
    """Slots of the NPARTS-block partition of the 4^3 box, ``cb`` a
    block, in real elements of their blocks, a tenth of them done (and
    a few of those exited), heading anywhere: they finish, exit or pause.
    Returns (part, cb, [x, lelem, dest, fly, w, done, exited])."""
    part = build_partition(_MESH, NPARTS)
    L = part.L
    rng = np.random.default_rng(seed)
    n = NPARTS * cb
    lelem = torch.zeros(n, dtype=torch.int32)
    valid = part.orig_of_glid.view(NPARTS, L).numpy()
    for b in range(NPARTS):
        ok = np.flatnonzero(valid[b] >= 0)
        lelem[b * cb:(b + 1) * cb] = torch.tensor(rng.choice(ok, cb))
    glid = (torch.arange(n) // cb) * L + lelem.long()
    orig = part.orig_of_glid[glid].long()
    x = _MESH.coords[_MESH.tet2vert[orig]].mean(dim=1)
    dest = x + torch.tensor(rng.normal(scale=0.3, size=(n, 3)))
    done = torch.tensor(rng.random(n) < 0.1)
    exited = done & torch.tensor(rng.random(n) < 0.3)
    # Done and not exited: at its destination, as the engine keeps it.
    dest = torch.where((done & ~exited)[:, None], x, dest)
    args = [x, lelem, dest, torch.ones(n, dtype=torch.int8),
            torch.tensor(rng.uniform(0.5, 2.0, n)), done, exited]
    return part, cb, args


@pytest.mark.parametrize("walked", [None, (0, 2), (), (1, 2, 3)])
def test_work_list_from_done_matches_numpy(walked):
    """The list a later round builds from ``done``: the not-done slots
    of the walked blocks, in slot order, its length a device tensor; an
    empty front has length 0."""
    _, cb, args = _stacked_inputs()
    done = args[5].clone()
    if walked == ():
        done[:] = True  # an empty front
        walked = None
    mask = None
    if walked is not None:
        mask = torch.zeros(NPARTS, dtype=torch.bool)
        mask[list(walked)] = True
    work, n_work = work_list(done, mask)
    todo = ~done.numpy()
    if mask is not None:
        todo &= np.repeat(mask.numpy(), cb)
    want = np.flatnonzero(todo)
    assert work.dtype == n_work.dtype == torch.int32
    assert tuple(n_work.shape) == (1,) and int(n_work) == want.size
    np.testing.assert_array_equal(work[:want.size].numpy(), want)
    assert sorted(work.numpy()) == list(range(done.numel()))


def _migrate_inputs(seed: int, nparts: int = 5, cap_b: int = 16,
                    part_L: int = 50):
    rng = np.random.default_rng(seed)
    cap = nparts * cap_b
    alive = rng.uniform(size=cap) < 0.6
    pend = np.full(cap, -1, np.int32)
    movers = alive & (rng.uniform(size=cap) < 0.2)
    pend[movers] = rng.integers(0, nparts * part_L, movers.sum())
    # Not done: the movers, and some stayers a walk stopped at max_iters.
    done = ~(movers | (alive & (rng.uniform(size=cap) < 0.15)))
    return {
        "x": torch.tensor(rng.random((cap, 3))),
        "lelem": torch.tensor(rng.integers(0, part_L, cap), dtype=torch.int32),
        "pending": torch.tensor(pend),
        "pid": torch.tensor(np.where(alive, np.arange(cap), -1),
                            dtype=torch.int32),
        "alive": torch.tensor(alive),
        "done": torch.tensor(done),
        "exited": torch.zeros(cap, dtype=torch.bool),
    }


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_frontier_migrate_work_list_matches_numpy(seed):
    """A frontier round's list is the migrate's by-product: the
    arrivals' new slots, in slab order (by source slot), then the
    not-done stayers (max_iters leftovers) in slot order; together, the
    new state's not-done slots. A full-migrate fallback round builds it
    from ``done``."""
    nparts, cap_b, part_L = 5, 16, 50
    st = _migrate_inputs(seed, nparts, cap_b, part_L)
    old = {k: v.numpy().copy() for k, v in st.items()}
    new, overflow, _, _, work = _frontier_migrate_impl(
        part_L, nparts, cap_b, nparts * cap_b, st)
    assert not overflow
    moving = np.flatnonzero(old["pending"] >= 0)
    arrivals = [int(np.flatnonzero(new["pid"].numpy() == old["pid"][s])[0])
                for s in moving]
    leftovers = np.flatnonzero(~old["done"] & (old["pending"] < 0))
    assert leftovers.size > 0 and moving.size > 0
    want = np.concatenate([arrivals, leftovers])
    ids, n_work = work
    assert int(n_work) == want.size
    np.testing.assert_array_equal(ids[:want.size].numpy(), want)
    assert sorted(want) == list(np.flatnonzero(~new["done"].numpy()))
    # The fallback: the full migrate's state, its list from done.
    st2, ovf, _, _, fellback, work2 = _migrate_round(
        part_L, nparts, cap_b, None, _migrate_inputs(seed, nparts, cap_b,
                                                     part_L), 1)
    assert fellback and not ovf
    todo = np.flatnonzero(~st2["done"].numpy())
    assert int(work2[1]) == todo.size
    np.testing.assert_array_equal(work2[0][:todo.size].numpy(), todo)


@pytest.mark.parametrize("listing", ["shuffled", "none"])
def test_walk_local_list_plain_matches_sweep_and_jax(listing):
    """The list walk in place: the listed slots (done ones too, in any
    order) equal the full-sweep ``walk_local_blocks_plain`` and the JAX
    ``walk_local`` on their block; every other slot keeps its carries
    and gets pending -1. Without a list every not-done slot walks."""
    part, cb, args = _stacked_inputs(seed=9)
    n, L = args[0].shape[0], part.L
    rng = np.random.default_rng(2)
    if listing == "none":
        sel, work = np.flatnonzero(~args[5].numpy()), None
    else:
        sel = rng.permutation(n)[: n // 2]
        work = (torch.tensor(np.concatenate([sel, [0] * 7]),
                             dtype=torch.int32),
                torch.tensor([sel.size], dtype=torch.int32))
    kw = dict(tally=True, tol=TOL, max_iters=4096, blocks=NPARTS)
    flux_l = torch.zeros(NPARTS * L, dtype=F64)
    rows = [a.clone() for a in args]
    counts = torch.zeros(1, dtype=torch.int32)
    got = walk_local_list(part.table, *rows, flux_l, work, counts=counts,
                          **kw)
    assert int(counts) == sel.size
    for k in range(4):
        assert got[k] is rows[(0, 1, 5, 6)[k]]
    want = walk_local_blocks_plain(part.table, *args,
                                   torch.zeros(NPARTS * L, dtype=F64), **kw)
    off = np.setdiff1d(np.arange(n), sel)
    for k, a in zip(range(4), (0, 1, 5, 6)):
        np.testing.assert_array_equal(got[k][sel].numpy(),
                                      want[k][sel].numpy())
        np.testing.assert_array_equal(got[k][off].numpy(),
                                      args[a][off].numpy())
    np.testing.assert_array_equal(got[4][sel].numpy(), want[4][sel].numpy())
    assert (got[4][off] == -1).all()
    keys = ("x", "lelem", "dest", "fly", "w", "done", "exited")
    for b in range(NPARTS):
        mine = sel[sel // cb == b]
        r = jax_walk_local(
            jnp.asarray(part.table[b * L:(b + 1) * L].numpy()),
            *(jnp.asarray(a[mine].numpy()) for a in args),
            jnp.zeros(L), tally=True, tol=TOL, max_iters=4096)
        for k in (1, 2, 3, 4):
            np.testing.assert_array_equal(got[k][mine].numpy(),
                                          np.asarray(r[k]), err_msg=keys[k])
        np.testing.assert_allclose(got[0][mine].numpy(), np.asarray(r[0]),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(flux_l[b * L:(b + 1) * L].numpy(),
                                   np.asarray(r[5]), rtol=1e-10, atol=1e-13)
    assert (got[4][sel] >= 0).any() and got[3][sel].any()



def test_walk_local_list_plain_empty_list():
    """A list whose length is 0 walks nothing: every slot keeps its
    carries, pending is -1, iters 0, the count 0, flux untouched."""
    part, _, args = _stacked_inputs(seed=9)
    n = args[0].shape[0]
    rows = [a.clone() for a in args]
    flux = torch.zeros(NPARTS * part.L, dtype=F64)
    counts = torch.zeros(1, dtype=torch.int32)
    work = (torch.zeros(n, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    got = walk_local_list(part.table, *rows, flux, work, counts=counts,
                          tally=True, tol=TOL, max_iters=4096,
                          blocks=NPARTS)
    for k, a in zip(range(4), (0, 1, 5, 6)):
        assert torch.equal(got[k], args[a])
    assert (got[4] == -1).all() and int(got[6]) == 0 and int(counts) == 0
    assert (flux == 0).all()


def _engine(n: int, **knobs):
    """A float64 engine on the 4^3 box with ``n`` particles localized at
    seeded points."""
    eng = PartitionedEngine(_MESH.to(dtype=F64), n, tol=TOL, max_iters=64,
                            **knobs)
    rng = np.random.default_rng(4)
    eng.localize(torch.tensor(rng.uniform(0.05, 0.95, (n, 3))))
    return eng, rng


@pytest.mark.parametrize("cap_frontier", [None, 40])
def test_engine_rounds_take_their_lists(cap_frontier, monkeypatch):
    """A phase's first round walks without a list; each later round
    walks the list its migrate hands over (the frontier slab's arrivals
    and leftovers, or ``work_list`` after a full migrate): exactly the
    round's not-done slots, its length a tensor."""
    n = 300
    eng, rng = _engine(n, vmem_walk_max_elems=100, block_kernel="gather",
                       cap_frontier=cap_frontier)
    assert eng.nparts > 1
    calls = []
    walk = partition.walk_local_list

    def spy(table, x, lelem, dest, fly, w, done, exited, flux, work=None,
            **kw):
        calls.append((work, done.clone()))
        return walk(table, x, lelem, dest, fly, w, done, exited, flux, work,
                    **kw)

    monkeypatch.setattr(partition, "walk_local_list", spy)
    dests = torch.tensor(rng.uniform(-0.2, 1.2, (n, 3)))
    eng.move(None, dests, torch.ones(n, dtype=torch.int8),
             torch.ones(n, dtype=F64))
    assert calls[0][0] is None and eng.last_walk_rounds > 1
    assert len(calls) == eng.last_walk_rounds
    for work, done in calls[1:]:
        ids, n_work = work
        assert isinstance(n_work, torch.Tensor) and n_work.shape == (1,)
        todo = np.flatnonzero(~done.numpy())
        assert int(n_work) == todo.size
        np.testing.assert_array_equal(np.sort(ids[:todo.size].numpy()), todo)


@pytest.mark.parametrize("knobs,copies", [
    ({}, True),  # W4 walks in place
    (dict(vmem_walk_max_elems=100), False),  # W1 writes new tensors
])
def test_writable_copies_the_committed_rows(knobs, copies):
    """A W4 engine's first round works on copies of the committed rows
    it writes in place, and keeps rows that are already its own; a W1
    engine's rounds need none."""
    eng, _ = _engine(300, **knobs)
    fresh = eng.state["x"].clone()
    st = dict(eng.state, x=fresh)
    got = eng._writable(st)
    if not copies:
        assert got is st
        return
    assert got["x"] is fresh
    for k in partition.WALKED_ROWS[1:]:
        assert got[k] is not eng.state[k]
        assert torch.equal(got[k], eng.state[k])
    assert got["dest"] is eng.state["dest"]


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
