"""PyTorch port, ``utils/autotune.py`` and ``utils/postprocess.py``
against the JAX package's, on the CPU in float64.

``block_length_candidates`` must give the JAX package's grid on the same
mesh and step; ``autotune_blocked`` adopts a candidate only when it
measured strictly faster (rates injected, so the contract is tested, not
the CPU's mood) and reports as the JAX one does on the same rates;
``autotune_walk`` measures both table tiers and adopts the two-tier one
only on request; ``label_totals`` / ``label_averages`` equal the JAX
package's, from tensors as from arrays, with the same refusals.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pumiumtally_tpu as jx
from pumiumtally_tpu.mesh.pincell import lattice_arrays as jax_lattice_arrays
from pumiumtally_tpu.utils import autotune as jax_autotune
from pumiumtally_tpu.utils import postprocess as jax_post
from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
from pumiumtally_tpu_torch.mesh.pincell import build_lattice
from pumiumtally_tpu_torch.utils import autotune, postprocess

F64 = torch.float64


@pytest.mark.parametrize("dims,step,bound", [
    ((1, 1, 1, 10, 10, 10), 0.1, None),
    ((1, 1, 1, 10, 10, 10), 0.5, None),
    ((1, 1, 1, 10, 10, 10), 0.5, 3072),
    ((2.0, 1.0, 0.5, 12, 6, 4), 0.25, 1000),
    ((1, 1, 1, 6, 6, 6), 1.0, 300),
])
def test_block_length_candidates_equal_jax(dims, step, bound):
    mesh = build_box(*dims, dtype=F64)
    got = autotune.block_length_candidates(mesh, step, base_bound=bound)
    want = jax_autotune.block_length_candidates(
        jx.build_box(*dims), step, base_bound=bound)
    assert got == want
    assert min(got) >= 256 and max(got) <= max(256, mesh.nelems // 2)


def test_block_length_candidates_on_the_lattice_equal_jax():
    kw = dict(n_theta=8, n_rings_fuel=2, n_rings_pad=2, nz=2)
    mesh, _, _ = build_lattice(3, 2, dtype=F64, **kw)
    want = jax_autotune.block_length_candidates(
        jx.build_lattice(3, 2, **kw)[0], 0.3)
    assert autotune.block_length_candidates(mesh, 0.3) == want


def _rates(table):
    return lambda cfg: table[cfg.walk_vmem_max_elems]


@pytest.mark.parametrize("table,adopted", [
    ({128: 3e5, 256: 1e5, 300: 2e5}, 128),   # a faster candidate
    ({128: 1e5, 256: 1e5, 300: 3e5}, None),  # incumbent fastest: wash
    ({128: 3e5, 256: 1e5, 300: 3e5}, None),  # a tie keeps the incumbent
])
def test_autotune_blocked_adopts_only_when_faster(table, adopted):
    mesh = build_box(1, 1, 1, 6, 6, 6, dtype=F64)
    base = TallyConfig(walk_vmem_max_elems=300, walk_block_kernel="gather",
                       check_found_all=False)
    cfg, report = autotune.autotune_blocked(
        mesh, candidates=[128, 256], base=base, _measure=_rates(table))
    jbase = jx.TallyConfig(walk_vmem_max_elems=300,
                           walk_block_kernel="gather", check_found_all=False)
    jcfg, jreport = jax_autotune.autotune_blocked(
        jx.build_box(1, 1, 1, 6, 6, 6), candidates=[128, 256], base=jbase,
        _measure=_rates(table))
    assert report == jreport
    assert cfg.walk_vmem_max_elems == jcfg.walk_vmem_max_elems
    assert cfg.walk_block_kernel == jcfg.walk_block_kernel
    if adopted is None:
        assert cfg == dataclasses.replace(base)
        assert not any(r.get("adopted") for r in report)
    else:
        assert cfg.walk_vmem_max_elems == adopted
        assert cfg.walk_block_kernel == "gather"
        assert report[0]["adopted"]
    assert sum(bool(r.get("incumbent")) for r in report) == 1


def test_autotune_blocked_measured_sweep_on_the_cpu():
    """One real (tiny) measured sweep: a rate for every bound, the
    one-block incumbent among them, and a usable config."""
    mesh = build_box(1, 1, 1, 6, 6, 6, dtype=F64)
    cfg, report = autotune.autotune_blocked(
        mesh, n_particles=600, moves=1, candidates=[300],
        base=TallyConfig(check_found_all=False), device="cpu")
    assert len(report) == 2
    assert all(r["moves_per_sec"] > 0 for r in report)
    assert cfg.walk_vmem_max_elems in (None, 300)


def test_autotune_walk_measures_both_tiers_and_adopts_float32():
    mesh = build_box(1, 1, 1, 3, 3, 3, dtype=F64)
    base = TallyConfig(check_found_all=False)
    cfg, report = autotune.autotune_walk(mesh, n_particles=400, moves=1,
                                         base=base, device="cpu")
    assert sorted(r["knobs"]["walk_table_dtype"] for r in report) == [
        "bfloat16", "float32"]
    assert report[0]["moves_per_sec"] >= report[1]["moves_per_sec"] > 0
    adopted = [r for r in report if r.get("adopted")]
    assert [r["knobs"] for r in adopted] == [{"walk_table_dtype": "float32"}]
    # The float32 winner is the untuned walk: the defaults come back.
    assert cfg == base and autotune.walk_kwargs(cfg) == ()
    cfg2, report2 = autotune.autotune_walk(
        mesh, n_particles=400, moves=1, base=base, device="cpu",
        candidates=[{"walk_table_dtype": "bfloat16"}],
        allow_approximate=True)
    assert cfg2.walk_table_dtype == "bfloat16" and report2[0]["adopted"]
    assert autotune.walk_kwargs(cfg2) == (("table_dtype", "bfloat16"),)
    cfg3, report3 = autotune.autotune_walk(
        mesh, n_particles=400, moves=1, base=base, device="cpu",
        candidates=[{"walk_table_dtype": "bfloat16"}])
    assert cfg3 == base and not any(r.get("adopted") for r in report3)


def test_walk_kwargs_table_tier_matches_jax():
    for td in (None, "float32", "bfloat16"):
        got = autotune.walk_kwargs(TallyConfig(walk_table_dtype=td))
        want = tuple(kv for kv in jx.TallyConfig(
            walk_table_dtype=td).walk_kwargs() if kv[0] == "table_dtype")
        assert got == want, td


def test_tuned_config_reproduces_the_untuned_flux():
    mesh = build_box(1, 1, 1, 3, 3, 3, dtype=F64)
    cfg, _ = autotune.autotune_walk(mesh, n_particles=300, moves=1,
                                    device="cpu")
    n = 200
    rng = np.random.default_rng(41)
    src = rng.uniform(0.05, 0.95, (n, 3))
    d1 = rng.uniform(0.05, 0.95, (n, 3))
    out = []
    for c in (TallyConfig(), cfg):
        t = PumiTally(mesh, n, c, device="cpu")
        t.CopyInitialPosition(src.reshape(-1).copy())
        t.MoveToNextLocation(None, d1.reshape(-1).copy())
        out.append(t.flux.numpy())
    np.testing.assert_allclose(out[0], out[1], rtol=1e-12, atol=1e-12)


def _lattice_labels():
    kw = dict(n_theta=8, n_rings_fuel=2, n_rings_pad=2, nz=2)
    mesh, region, cell_id = build_lattice(2, 2, dtype=F64, **kw)
    _, _, jregion, jcell_id = jax_lattice_arrays(2, 2, **kw)
    np.testing.assert_array_equal(region, jregion)
    np.testing.assert_array_equal(cell_id, jcell_id)
    return mesh, region, cell_id


@pytest.mark.parametrize("as_tensor", [False, True])
def test_label_reductions_equal_jax(as_tensor):
    mesh, region, cell_id = _lattice_labels()
    rng = np.random.default_rng(7)
    flux = rng.uniform(0.0, 2.0, mesh.nelems)
    vols = mesh.volumes.numpy()
    conv = (lambda a: torch.as_tensor(a)) if as_tensor else (lambda a: a)
    for labels, k in ((cell_id, 6), (region, 0)):
        got = postprocess.label_totals(conv(flux), conv(vols),
                                       conv(labels), num_labels=k)
        want = jax_post.label_totals(flux, vols, labels, num_labels=k)
        np.testing.assert_array_equal(got, want)
        mean, vsum = postprocess.label_averages(conv(flux), conv(vols),
                                                conv(labels), num_labels=k)
        jmean, jvsum = jax_post.label_averages(flux, vols, labels,
                                               num_labels=k)
        np.testing.assert_array_equal(mean, jmean)
        np.testing.assert_array_equal(vsum, jvsum)
    assert len(postprocess.label_totals(flux, vols, cell_id,
                                        num_labels=6)) == 6


def test_label_reductions_refuse_as_jax_does():
    flux, vol = np.array([1.0, 2.0]), np.array([0.5, 0.5])
    for fn in (postprocess.label_totals, jax_post.label_totals):
        with pytest.raises(ValueError, match="entries for 2 elements"):
            fn(flux, vol, np.array([0]))
        with pytest.raises(ValueError, match="non-negative"):
            fn(flux, vol, np.array([0, -1]))
        with pytest.raises(ValueError, match="integral"):
            fn(flux, vol, np.array([0.0, 1.5]))
        with pytest.raises(ValueError, match="volumes has 1 entries"):
            fn(flux, vol[:1], np.array([0, 1]))
    np.testing.assert_array_equal(
        postprocess.label_totals(torch.tensor(flux), torch.tensor(vol),
                                 torch.tensor([0.0, 1.0])), [0.5, 1.0])
    mean, _ = postprocess.label_averages(flux, vol, np.array([0, 2]))
    np.testing.assert_array_equal(mean, [1.0, 0.0, 2.0])
