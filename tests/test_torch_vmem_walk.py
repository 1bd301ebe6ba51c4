"""PyTorch port, kernel W1's contract: ``vmem_walk_local`` (on CPU tensors
its plain version ``vmem_walk_local_plain``) against the JAX package's
Pallas ``vmem_walk_local`` run in interpret mode, as the JAX package's
own tests run it on the CPU.

Tolerances, float64: lelem, done, exited, pending and iters exact;
positions to 1e-12 absolute (the JAX kernel fetches rows by a one-hot
matmul and tiles the slots; both compute the same column-wise
projections); flux to rtol 1e-10 (per-tile matmul partials there,
scatter-adds here)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pumiumtally_tpu.mesh.box import build_box as jax_build_box
from pumiumtally_tpu.ops.vmem_walk import vmem_walk_local as jax_vmem_walk
from pumiumtally_tpu.parallel.partition import (
    build_partition as jax_build_partition,
)
from pumiumtally_tpu_torch import convert
from pumiumtally_tpu_torch.ops.vmem_walk import (
    effective_vmem_bound,
    smem_ceiling_elems,
    vmem_walk_local,
    vmem_walk_local_plain,
)

TOL = 1e-8
CAP_BLOCKED = 1024  # the JAX blocked kernel needs whole 1024-slot tiles


def _workload(seed, blocks, nparts=6, div=4, n_single=700):
    """Slots grouped by block, each particle at the centroid of an owned
    element of its block, walking a random step: short hops stay,
    long ones cross block faces (pause) or leave the box; some hold,
    some slots are dead (done on entry)."""
    mesh = jax_build_box(1, 1, 1, div, div, div)
    part = jax_build_partition(mesh, nparts if blocks == 1 else blocks)
    L = part.L
    cap = n_single if blocks == 1 else CAP_BLOCKED
    rng = np.random.default_rng(seed)
    orig = np.asarray(part.orig_of_glid).reshape(-1, L)
    coords = np.asarray(mesh.coords)
    tets = np.asarray(mesh.tet2vert)
    first = 1 if blocks == 1 else 0  # blocks=1: one chip's slice
    lelem, x = [], []
    for b in range(first, first + blocks):
        le = rng.choice(np.flatnonzero(orig[b] >= 0), size=cap)
        lelem.append(le)
        x.append(coords[tets[orig[b][le]]].mean(axis=1))
    lelem = np.concatenate(lelem).astype(np.int32)
    x = np.concatenate(x)
    n = x.shape[0]
    fly = (rng.random(n) > 0.15).astype(np.int8)
    dest = np.where(fly[:, None] == 1,
                    x + rng.normal(scale=0.25, size=(n, 3)), x)
    table = convert.host(part.table)[first * L:(first + blocks) * L]
    return dict(table=table, x=x, lelem=lelem, dest=dest, fly=fly,
                w=rng.uniform(0.5, 2.0, n), done=rng.random(n) < 0.1,
                exited=np.zeros(n, bool), flux=np.zeros(blocks * L))


def _run(fn, d, blocks, tally, **kw):
    keys = ("table", "x", "lelem", "dest", "fly", "w", "done", "exited",
            "flux")
    if fn is jax_vmem_walk:
        args = [jnp.asarray(d[k]) for k in keys]
        out = fn(*args, tally=tally, tol=TOL, max_iters=4096, blocks=blocks,
                 interpret=True, **kw)
    else:
        args = [torch.tensor(d[k]) for k in keys]
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


@pytest.mark.parametrize("tally", [True, False])
def test_single_block_matches_jax(tally):
    d = _workload(seed=5, blocks=1)
    ref = _run(jax_vmem_walk, d, 1, tally, w_tile=128)
    port = _run(vmem_walk_local, d, 1, tally)
    _assert_same(port, ref, tally)
    # The workload must exercise pauses, exits and dead slots.
    assert (ref[4] >= 0).sum() > 0 and ref[3].sum() > 0 and ref[2].sum() > 0


@pytest.mark.parametrize("seed", [105, 206, 307])
def test_blocked_seed_sweep_matches_jax(seed):
    d = _workload(seed=seed, blocks=4)
    ref = _run(jax_vmem_walk, d, 4, True)
    port = _run(vmem_walk_local, d, 4, True)
    _assert_same(port, ref, True)
    # Cross-block pauses carry the target's padded glid.
    assert (ref[4] >= 0).sum() > 0
    assert ref[4].max() < d["table"].shape[0]


def test_wrapper_runs_the_plain_version_on_cpu():
    d = _workload(seed=7, blocks=1, n_single=64)
    a = _run(vmem_walk_local, d, 1, True)
    b = _run(vmem_walk_local_plain, d, 1, True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_shared_memory_ceiling_and_clamp(caplog):
    # 232,448 B of dynamic shared memory per CUDA block, 21 values per
    # element (the 20-wide row plus the flux partial).
    assert smem_ceiling_elems(torch.float32) == 2767
    assert smem_ceiling_elems(torch.float64) == 1383
    cuda = torch.device("cuda")
    cpu = torch.device("cpu")
    # The CPU clamps nothing (JAX's interpret mode neither), so both
    # packages build the same blocks in the CPU tests.
    assert effective_vmem_bound(100_000, torch.float32, cpu) == 100_000
    assert effective_vmem_bound(1024, torch.float32, cuda) == 1024
    assert effective_vmem_bound(None, torch.float32, cuda) is None
    from pumiumtally_tpu_torch.utils.logging import get_logger

    get_logger().propagate = True  # let caplog see the warning
    try:
        assert effective_vmem_bound(5000, torch.float64, cuda) == 1383
    finally:
        get_logger().propagate = False
    assert "clamping" in caplog.text
