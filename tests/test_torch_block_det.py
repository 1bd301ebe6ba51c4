"""PyTorch port, the deterministic commit of the block walks W1
(``vmem_walk_local``) and W2 (``pallas_walk_local``, with and without
scoring lanes): on CPU tensors their plain versions with
``deterministic=True`` build the records the kernels' kDet instantiations
write, keyed (block-padded row or lane, step, slot), and commit them
with ``det_commit_plain``.

Held to two references on the same seeded inputs:

- the plain versions' own serial ``index_add_`` (one CPU thread: torch
  splits a large CPU ``index_add_`` across threads, which is then no
  serial sum): flux and lanes bitwise, every other output equal;
- the JAX package's Pallas kernels in interpret mode, as the JAX
  package's own tests run them on the CPU: lelem, done, exited, pending
  and iters exact, positions to 1e-12 absolute, flux and lanes to rtol
  1e-10 (per-tile matmul partials there, a serial sum here)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from pumiumtally_tpu.ops.pallas_walk import pallas_walk_local as jax_pallas
from pumiumtally_tpu.ops.vmem_walk import vmem_walk_local as jax_vmem_walk
from pumiumtally_tpu.scoring.binding import ScoreOps
from pumiumtally_tpu_torch import convert
from pumiumtally_tpu_torch.ops import walk as walk_mod
from pumiumtally_tpu_torch.ops.det_commit import DetWorkspace
from pumiumtally_tpu_torch.ops.pallas_walk import pallas_walk_local
from pumiumtally_tpu_torch.ops.vmem_walk import vmem_walk_local

from test_torch_pallas_walk import KEYS as W2_KEYS
from test_torch_pallas_walk import _workload as w2_workload
from test_torch_vmem_walk import _workload as w1_workload

TOL = 1e-8
F64 = torch.float64
W1_KEYS = ("table", "x", "lelem", "dest", "fly", "w", "done", "exited",
           "flux")
SCORE_KINDS = ("track", "track", "count")


@pytest.fixture
def serial():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def commits(monkeypatch):
    """The number of ``det_commit_plain`` calls the walks make."""
    calls = []
    real = walk_mod.det_commit_plain

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(walk_mod, "det_commit_plain", counted)
    return calls


def _w1_args(d):
    return [torch.tensor(d[k]) for k in W1_KEYS]


def _w2_args(d):
    args = [torch.tensor(d[k]) for k in W2_KEYS]
    args[0] = convert.bf16_from_bits(d["lo"])
    return args


def _w2_scoring(d, blocks, nbins=4, seed=3):
    """W2's scoring bundle over the block slice's bank: every bin, and
    every 13th slot the DROP sentinel of the whole 4-part bank."""
    n = d["x"].shape[0]
    L = d["flux"].shape[0] // blocks
    stride = nbins * len(SCORE_KINDS)
    rng = np.random.default_rng(seed)
    bin_off = (rng.integers(0, nbins, n) * len(SCORE_KINDS)).astype(np.int32)
    bin_off[::13] = 4 * L * stride
    fac = np.stack([np.ones(n), rng.uniform(0.5, 3.0, n), np.ones(n)], 1)
    return stride, bin_off, fac


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("blocks,seed,active", [
    (1, 5, 0.9), (4, 105, 0.9), (4, 408, 0.03),
], ids=["1-5", "4-105", "sparse-4-408"])
def test_w1_deterministic_is_the_serial_index_add(blocks, seed, active,
                                                  serial, commits):
    d = w1_workload(seed=seed, blocks=blocks, active=active)
    ref = vmem_walk_local(*_w1_args(d), tally=True, tol=TOL, max_iters=4096,
                          blocks=blocks)
    assert not commits
    det = vmem_walk_local(*_w1_args(d), tally=True, tol=TOL, max_iters=4096,
                          blocks=blocks, deterministic=True)
    assert commits
    _equal(det, ref)
    assert det[5].abs().sum() > 0


@pytest.mark.parametrize("blocks,seed,active", [
    (1, 5, 0.9), (4, 206, 0.9),
], ids=["1-5", "4-206"])
def test_w1_deterministic_matches_jax(blocks, seed, active):
    d = w1_workload(seed=seed, blocks=blocks, active=active)
    ref = jax_vmem_walk(*(jnp.asarray(d[k]) for k in W1_KEYS), tally=True,
                        tol=TOL, max_iters=4096, blocks=blocks,
                        interpret=True,
                        **({"w_tile": 128} if blocks == 1 else {}))
    ref = [np.asarray(o) for o in ref]
    port = vmem_walk_local(*_w1_args(d), tally=True, tol=TOL,
                           max_iters=4096, blocks=blocks,
                           deterministic=DetWorkspace())
    for i, k in ((1, "lelem"), (2, "done"), (3, "exited"), (4, "pending"),
                 (6, "iters")):
        np.testing.assert_array_equal(port[i].numpy(), ref[i], err_msg=k)
    np.testing.assert_allclose(port[0].numpy(), ref[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(port[5].numpy(), ref[5], rtol=1e-10,
                               atol=1e-13)
    assert (ref[4] >= 0).sum() > 0


@pytest.mark.parametrize("scored", [False, True])
@pytest.mark.parametrize("blocks,seed,active", [
    (1, 5, 0.9), (2, 105, 0.9), (2, 408, 0.03),
], ids=["1-5", "2-105", "sparse-2-408"])
def test_w2_deterministic_is_the_serial_index_add(blocks, seed, active,
                                                  scored, serial, commits):
    d = w2_workload(seed=seed, blocks=blocks, active=active)
    kw = dict(tally=True, tol=TOL, max_iters=4096, blocks=blocks)
    banks = []

    def run(deterministic):
        args = _w2_args(d)
        scoring = None
        if scored:
            stride, bin_off, fac = _w2_scoring(d, blocks)
            banks.append(torch.zeros(args[-1].numel() * stride, dtype=F64))
            scoring = (SCORE_KINDS, banks[-1], torch.tensor(bin_off),
                       torch.tensor(fac))
        return pallas_walk_local(*args, scoring=scoring,
                                 deterministic=deterministic, **kw)

    ref = run(False)
    assert not commits
    det = run(True)
    assert len(commits) == (2 if scored else 1)
    _equal(det, ref)
    assert det[5].abs().sum() > 0
    if scored:
        assert torch.equal(banks[1], banks[0]) and banks[1].abs().sum() > 0


@pytest.mark.parametrize("scored", [False, True])
@pytest.mark.parametrize("blocks,seed", [(1, 5), (2, 206)],
                         ids=["1-5", "2-206"])
def test_w2_deterministic_matches_jax(blocks, seed, scored):
    d = w2_workload(seed=seed, blocks=blocks)
    jargs = [jnp.asarray(d[k]) for k in W2_KEYS]
    jargs[0] = lax.bitcast_convert_type(jargs[0], jnp.bfloat16)
    args = _w2_args(d)
    jkw, scoring = {}, None
    if scored:
        stride, bin_off, fac = _w2_scoring(d, blocks)
        bank = torch.zeros(args[-1].numel() * stride, dtype=F64)
        scoring = (SCORE_KINDS, bank, torch.tensor(bin_off),
                   torch.tensor(fac))
        jkw["scoring"] = ScoreOps(SCORE_KINDS, jnp.zeros(bank.numel()),
                                  jnp.asarray(bin_off), jnp.asarray(fac))
    ref = jax_pallas(*jargs, tally=True, tol=TOL, max_iters=4096,
                     blocks=blocks, interpret=True, **jkw)
    ref = [np.asarray(o) for o in ref]
    port = pallas_walk_local(*args, tally=True, tol=TOL, max_iters=4096,
                             blocks=blocks, scoring=scoring,
                             deterministic=True)
    for i, k in ((1, "lelem"), (2, "done"), (3, "exited"), (4, "pending"),
                 (6, "iters")):
        np.testing.assert_array_equal(port[i].numpy(), ref[i], err_msg=k)
    np.testing.assert_allclose(port[0].numpy(), ref[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(port[5].numpy(), ref[5], rtol=1e-10,
                               atol=1e-13)
    if scored:
        np.testing.assert_allclose(bank.numpy(), ref[7], rtol=1e-10,
                                   atol=1e-13)
        assert bank.abs().sum() > 0


def test_untallied_block_walks_ignore_deterministic(commits):
    """A phase-A (untallied) round makes no records."""
    d = w1_workload(seed=7, blocks=1, n_single=64)
    args = _w1_args(d)
    args[-1] = None
    a = vmem_walk_local(*args, tally=False, tol=TOL, max_iters=4096,
                        deterministic=True)
    b = vmem_walk_local(*args, tally=False, tol=TOL, max_iters=4096)
    _equal(a[:5], b[:5])
    assert not commits
