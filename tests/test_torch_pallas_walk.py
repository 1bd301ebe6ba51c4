"""PyTorch port, kernel W2's contract: ``pallas_walk_local`` (on CPU
tensors its plain version ``pallas_walk_local_plain``) against the JAX
package's Pallas ``pallas_walk_local`` run in interpret mode, as the
JAX package's own tests run it on the CPU; and the partitioned facade
with ``walk_kernel="pallas"`` against its JAX twin on one device.

Tolerances, float64: lelem, done, exited, pending and iters exact;
positions to 1e-12 absolute; flux to rtol 1e-10 (per-tile matmul
partials there, scatter-adds here); facades with element ids and every
integer slot row exact, positions 1e-12, flux rtol 1e-10, in-box
conservation at 1e-9."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from pumiumtally_tpu import PartitionedPumiTally as JaxPartitioned
from pumiumtally_tpu import TallyConfig as JaxTallyConfig
from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu.ops.pallas_walk import (
    modeled_walk_bytes as jax_modeled_walk_bytes,
)
from pumiumtally_tpu.ops.pallas_walk import pallas_walk_local as jax_pallas
from pumiumtally_tpu.parallel import make_device_mesh
from pumiumtally_tpu.parallel.partition import (
    build_partition as jax_build_partition,
)
from pumiumtally_tpu_torch import PartitionedPumiTally, TallyConfig, convert
from pumiumtally_tpu_torch.ops import pallas_walk as port_pallas_walk
from pumiumtally_tpu_torch.ops.pallas_walk import (
    modeled_walk_bytes,
    pallas_walk_local,
    pallas_walk_local_plain,
    w2_uses_shared,
)

TOL = 1e-8
BF16 = "bfloat16"
CAP_BLOCKED = 1024  # the JAX blocked kernel needs whole 1024-slot tiles
KEYS = ("lo", "hi", "x", "lelem", "dest", "fly", "w", "done", "exited",
        "flux")
INT_ROWS = ("lelem", "pending", "pid", "alive", "done", "exited", "lost",
            "fly")


def _workload(seed, blocks, n_single=700, nparts=4, div=4, active=0.9):
    """``blocks`` consecutive chips' slices of a two-tier partition (as
    tests/test_pallas_walk.py's ``_chip_workload``): each slot at the
    centroid of an owned element of its block, walking a random step —
    short hops stay, long ones pause at block faces or leave the box;
    some hold, some slots are dead (done on entry). ``active`` is the
    share of slots that walk: 0.03 is a later round's input, the few
    particles that just migrated scattered among finished stayers."""
    mesh = jax_build_box(1, 1, 1, div, div, div)
    part = convert.partition_arrays(
        jax_build_partition(mesh, nparts, table_dtype=BF16))
    L = part["L"]
    cap = n_single if blocks == 1 else CAP_BLOCKED
    rng = np.random.default_rng(seed)
    orig = part["orig_of_glid"].reshape(nparts, L)
    coords, tets = np.asarray(mesh.coords), np.asarray(mesh.tet2vert)
    lelem, x = [], []
    for b in range(1, 1 + blocks):
        le = rng.choice(np.flatnonzero(orig[b] >= 0), size=cap)
        lelem.append(le)
        x.append(coords[tets[orig[b][le]]].mean(axis=1))
    lelem = np.concatenate(lelem).astype(np.int32)
    x = np.concatenate(x)
    n = x.shape[0]
    fly = (rng.random(n) > 0.15).astype(np.int8)
    dest = np.where(fly[:, None] == 1,
                    x + rng.normal(scale=0.25, size=(n, 3)), x)
    return dict(
        lo=part["table"][L:(1 + blocks) * L],
        hi=part["table_hi"][4 * L:4 * (1 + blocks) * L],
        x=x, lelem=lelem, dest=dest, fly=fly, w=rng.uniform(0.5, 2.0, n),
        done=rng.random(n) >= active, exited=np.zeros(n, bool),
        flux=np.zeros(blocks * L))


def _run(fn, d, blocks, tally):
    if fn is jax_pallas:
        args = [jnp.asarray(d[k]) for k in KEYS]
        args[0] = lax.bitcast_convert_type(args[0], jnp.bfloat16)
        out = fn(*args, tally=tally, tol=TOL, max_iters=4096, blocks=blocks,
                 interpret=True)
    else:
        args = [torch.tensor(d[k]) for k in KEYS]
        args[0] = convert.bf16_from_bits(d["lo"])
        if not tally:
            args[-1] = None
        out = fn(*args, tally=tally, tol=TOL, max_iters=4096, blocks=blocks)
    return [None if o is None else convert.host(o) for o in out]


def _assert_same(port, ref, tally):
    for i, k in ((1, "lelem"), (2, "done"), (3, "exited"), (4, "pending"),
                 (6, "iters")):
        np.testing.assert_array_equal(port[i], ref[i], err_msg=k)
    np.testing.assert_allclose(port[0], ref[0], rtol=0, atol=1e-12)
    if tally:
        np.testing.assert_allclose(port[5], ref[5], rtol=1e-10, atol=1e-13)
    else:
        assert port[5] is None and not ref[5].any()
    # The workload must exercise pauses, boundary exits and dead slots.
    assert (ref[4] >= 0).sum() > 0 and ref[3].sum() > 0 and ref[2].sum() > 0


@pytest.mark.parametrize("blocks,tally,seed,active", [
    (1, True, 5, 0.9), (1, False, 5, 0.9), (2, True, 105, 0.9),
    (2, True, 206, 0.9), (2, False, 307, 0.9), (2, True, 408, 0.03),
], ids=["1-True-5", "1-False-5", "2-True-105", "2-True-206", "2-False-307",
        "sparse-2-True-408"])
def test_pallas_walk_local_matches_jax(blocks, tally, seed, active):
    d = _workload(seed=seed, blocks=blocks, active=active)
    ref = _run(jax_pallas, d, blocks, tally)
    port = _run(pallas_walk_local, d, blocks, tally)
    _assert_same(port, ref, tally)
    # Cross-block pauses carry the target's padded glid of the whole
    # (4-part) partition.
    assert ref[4].max() < 4 * d["lo"].shape[0] // blocks


def test_wrapper_picks_the_plain_version_only_for_cpu_tensors():
    d = _workload(seed=7, blocks=1, n_single=64)
    a = _run(pallas_walk_local, d, 1, True)
    b = _run(pallas_walk_local_plain, d, 1, True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    args = [torch.tensor(d[k]) for k in KEYS]
    args[0] = convert.bf16_from_bits(d["lo"])
    kw = dict(tally=True, tol=TOL, max_iters=8, blocks=1)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pallas_walk_local(*args[:2], *(a.to("meta") for a in args[2:]),
                          **kw)
    # The CUDA path refuses an unsupported input before any build.
    with pytest.raises(TypeError, match="table_hi"):
        port_pallas_walk._pallas_walk_cuda(args[0], args[1].float(),
                                           *args[2:], **kw)
    with pytest.raises(ValueError, match="bf16 SELECT tier"):
        pallas_walk_local(args[0].double(), *args[1:], **kw)
    with pytest.raises(ValueError, match="divisible"):
        pallas_walk_local(*args, tally=True, tol=TOL, max_iters=8, blocks=3)


@pytest.mark.parametrize("kernel,table_dtype", [
    ("gather", "float32"), ("gather", BF16), ("pallas", BF16),
    ("vmem", "float32"), ("pallas", "float32"), ("vmem", BF16),
    ("mxu", "float32"), ("gather", "float16"),
])
def test_modeled_walk_bytes_matches_jax(kernel, table_dtype):
    try:
        want = jax_modeled_walk_bytes(kernel, table_dtype)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            modeled_walk_bytes(kernel, table_dtype)
        assert str(got.value) == str(e)
    else:
        assert modeled_walk_bytes(kernel, table_dtype) == want


def test_shared_memory_regime_threshold():
    # 232,448 B of dynamic shared memory per CUDA block; 32 B of bf16
    # select row plus the flux partial per element, a 32 B header and one
    # pass of work list (512 slot ids).
    for dt, top in ((torch.float32, 6399), (torch.float64, 5759)):
        assert w2_uses_shared(top, dt) and not w2_uses_shared(top + 1, dt)
    # bench.py's bound (1024, doubled for bf16): 24 blocks of 2,000.
    assert w2_uses_shared(2000, torch.float32)
    assert not w2_uses_shared(48000, torch.float32)


# -- the partitioned facade with walk_kernel="pallas" -------------------------

def _pair(n, bound, capacity_factor=3.0, div=5):
    jmesh = jax_build_box(1, 1, 1, div, div, div)
    mesh = convert.tetmesh_from_arrays(convert.mesh_arrays(jmesh))
    kw = dict(walk_table_dtype=BF16, walk_kernel="pallas",
              capacity_factor=capacity_factor, walk_vmem_max_elems=bound)
    ref = JaxPartitioned(jmesh, n, JaxTallyConfig(
        device_mesh=make_device_mesh(1), **kw))
    port = PartitionedPumiTally(mesh, n, TallyConfig(**kw), device="cpu")
    return ref, port


def _assert_facades_same(port, ref):
    np.testing.assert_array_equal(port.elem_ids, ref.elem_ids)
    np.testing.assert_allclose(port.positions, ref.positions, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(port.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-10, atol=1e-13)
    ps, rs = convert.facade_state(port), convert.facade_state(ref)
    for k in INT_ROWS:  # the JAX engine's slot layout, slot by slot
        np.testing.assert_array_equal(ps[k], rs[k], err_msg=k)
    np.testing.assert_allclose(ps["x"], rs["x"], rtol=0, atol=1e-12)


@pytest.mark.parametrize("bound", [None, 60])
def test_partitioned_pallas_matches_jax_and_conserves(bound):
    n = 400
    ref, port = _pair(n, bound)
    eng, jeng = port.engine, ref.engine
    assert eng.use_pallas_walk and jeng.use_pallas_walk
    assert (eng.nparts, eng.part.L, eng.cap_per_block) == \
        (jeng.nparts, jeng.part.L, jeng.cap_per_block)
    if bound is None:  # one block holds the whole mesh
        assert eng.nparts == 1 and eng.part.L == 750
    else:  # the bf16 tier doubles the bound: 750 tets -> 7 blocks
        assert eng.nparts == jeng.blocks_per_chip == 7 > 1
    rng = np.random.default_rng(0 if bound is None else 1)
    src = rng.uniform(0.05, 0.95, (n, 3))
    d1 = rng.uniform(0.05, 0.95, (n, 3))
    d2 = np.clip(d1 + rng.normal(scale=0.3, size=(n, 3)), -0.2, 1.2)
    for t in (ref, port):
        t.CopyInitialPosition(np.ascontiguousarray(src.reshape(-1)))
    _assert_facades_same(port, ref)
    for t in (ref, port):
        t.MoveToNextLocation(np.ascontiguousarray(src.reshape(-1)),
                             np.ascontiguousarray(d1.reshape(-1)),
                             np.ones(n, np.int8), np.ones(n))
    _assert_facades_same(port, ref)
    np.testing.assert_allclose(port.flux.sum().item(),
                               np.linalg.norm(d1 - src, axis=1).sum(),
                               rtol=1e-9)
    if bound is not None:
        assert eng.last_walk_rounds == jeng.last_walk_rounds > 1
    for t in (ref, port):
        t.MoveToNextLocation(None, np.ascontiguousarray(d2.reshape(-1)))
    _assert_facades_same(port, ref)
