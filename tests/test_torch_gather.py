"""PyTorch port, kernel G1's contract: ``gather`` (on CPU tensors its plain
version ``gather_plain``) against the two Pallas row-gather probes it
ports, tools/exp_pallas_gather.py (``jnp.take``, fill 0) and
tools/exp_pallas_gather2.py (``jnp.take_along_axis``, fill NaN), their
kernels run through ``pl.pallas_call(..., interpret=True)`` with the
probes' VMEM specs. The probe files are loaded by file path; importing
one runs its probe, which on the CPU reports that only interpret mode
is supported and carries on.

Tolerance: bitwise. A gather moves values without arithmetic, so the
non-NaN values must have equal bits and the NaN fills the same
positions."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pumiumtally_tpu_torch.experiments import pallas_gather
from pumiumtally_tpu_torch.experiments.pallas_gather import (
    gather,
    gather_plain,
)

ROOT = Path(__file__).resolve().parent.parent
PROBES = {"take": ("exp_pallas_gather", 0.0),
          "take_along_axis": ("exp_pallas_gather2", float("nan"))}


def _probe(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret(mod, tab, idx):
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        mod.kern,
        out_shape=jax.ShapeDtypeStruct((idx.shape[0], tab.shape[1]),
                                       jnp.float32),
        in_specs=[vmem, vmem], out_specs=vmem, interpret=True,
    )(jnp.asarray(tab), jnp.asarray(idx))
    return np.asarray(out)


def _assert_bitwise(got, want):
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


def _indices(rng, n_rows, n, wild):
    """In-range indices or, with ``wild``, a mix of in-range, wrapped
    negative ([-E, 0)) and out-of-range (>= E, < -E) ones, including
    each edge."""
    if not wild:
        return rng.integers(0, n_rows, n).astype(np.int32)
    idx = rng.integers(-2 * n_rows, 2 * n_rows, n)
    idx[:6] = [0, n_rows - 1, -1, -n_rows, n_rows, -n_rows - 1]
    return idx.astype(np.int32)


def _port(tab, idx, fill):
    return gather(torch.from_numpy(tab), torch.from_numpy(idx), fill).numpy()


@pytest.mark.parametrize("variant", ["take", "take_along_axis"])
@pytest.mark.parametrize("wild", [False, True])
def test_gather_matches_probe_kernel_at_probe_shape(variant, wild):
    name, fill = PROBES[variant]
    mod = _probe(name)
    assert (mod.E, mod.W, mod.T) == (pallas_gather.E, pallas_gather.W,
                                     pallas_gather.T)
    rng = np.random.default_rng(3)
    tab = rng.normal(size=(mod.E, mod.W)).astype(np.float32)
    idx = _indices(rng, mod.E, mod.T, wild)
    want = _interpret(mod, tab, idx)
    got = _port(tab, idx, fill)
    _assert_bitwise(got, want)
    bad = (idx < -mod.E) | (idx >= mod.E)
    assert bad.any() == wild
    if wild:  # the fill rows are the probe's: 0 for take, NaN otherwise
        np.testing.assert_array_equal(got[bad], np.full_like(got[bad], fill))
        assert np.isnan(got[bad]).all() == np.isnan(fill)


@pytest.mark.parametrize("shape", [(50, 8), (7, 4), (1000, 12)])
def test_take_probe_kernel_at_other_shapes(shape):
    # K4's kernel is shape-generic (K5's closes over the module's T, W).
    mod = _probe(PROBES["take"][0])
    rng = np.random.default_rng(shape[0])
    tab = rng.normal(size=shape).astype(np.float32)
    idx = _indices(rng, shape[0], 40, wild=True)
    _assert_bitwise(_port(tab, idx, 0.0), _interpret(mod, tab, idx))


def test_wrapper_runs_the_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    tab = torch.from_numpy(rng.normal(size=(30, 8)).astype(np.float32))
    idx = torch.from_numpy(_indices(rng, 30, 25, wild=True))
    for fill in (0.0, float("nan"), 2.5):
        a, b = gather(tab, idx, fill), gather_plain(tab, idx, fill)
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("variant", ["take", "take_along_axis"])
def test_probe_entry_point_on_cpu(variant, capsys):
    res = pallas_gather.main(variant, device="cpu", reps=2)
    assert res["ok"] and res["us"] > 0
    out = capsys.readouterr().out
    assert "gather works: True" in out and "8192 rows x 32 f32" in out
