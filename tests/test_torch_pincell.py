"""PyTorch port, the pincell / lattice geometry (``mesh/pincell.py``):
the generators against the JAX package's, and a small assembly through
the three-call protocol in both packages.

Tolerances: generated arrays bit for bit (the same numpy code); mesh
arrays exact; through the protocol in float64 on the CPU, element ids
exact, positions within 1e-12, flux within rtol 1e-10 (another addition
order), and track length conserved within rtol 1e-12 (the JAX package's
tests/test_pincell.py bound)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pumiumtally_tpu import PumiTally as JaxPumiTally
from pumiumtally_tpu import TallyConfig as JaxTallyConfig
from pumiumtally_tpu.mesh import pincell as jax_pincell
from pumiumtally_tpu_torch import (
    PumiTally,
    TallyConfig,
    build_lattice,
    build_pincell,
    convert,
)
from pumiumtally_tpu_torch.mesh import pincell

PARAMS = [
    dict(),
    dict(pitch=1.26, height=1.0, n_theta=32, n_rings_fuel=5, n_rings_pad=5,
         nz=2),
]
F64 = torch.float64


def _equal_tuples(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("params", PARAMS)
def test_pincell_arrays_equal_jax(params):
    _equal_tuples(pincell.pincell_arrays(**params),
                  jax_pincell.pincell_arrays(**params))


@pytest.mark.parametrize("params", PARAMS)
def test_lattice_arrays_equal_jax(params):
    _equal_tuples(pincell.lattice_arrays(3, 2, **params),
                  jax_pincell.lattice_arrays(3, 2, **params))


def test_flagship_and_meshes_equal_jax():
    assert pincell.FLAGSHIP_PINCELL == jax_pincell.FLAGSHIP_PINCELL
    mesh, region, cell = build_lattice(2, 2, nz=2, dtype=F64)
    jmesh, jregion, jcell = jax_pincell.build_lattice(2, 2, nz=2,
                                                      dtype=jnp.float64)
    a, b = convert.mesh_arrays(mesh), convert.mesh_arrays(jmesh)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(region, jregion)
    np.testing.assert_array_equal(cell, jcell)
    pmesh, preg = build_pincell(nz=2, dtype=F64)
    jpmesh, jpreg = jax_pincell.build_pincell(nz=2, dtype=jnp.float64)
    np.testing.assert_array_equal(convert.host(pmesh.walk_table),
                                  convert.host(jpmesh.walk_table))
    np.testing.assert_array_equal(preg, jpreg)


@pytest.mark.parametrize("localization", ["walk", "locate"])
def test_small_lattice_through_the_protocol_matches_jax(localization):
    # The assembly of tests/test_pincell.py: 3 x 2 cells, nz = 3.
    nx, ny, nz, n_theta, pitch, height = 3, 2, 3, 16, 1.26, 1.0
    kw = dict(pitch=pitch, height=height, n_theta=n_theta, n_rings_fuel=2,
              n_rings_pad=2, nz=nz)
    mesh, _, _ = build_lattice(nx, ny, dtype=F64, **kw)
    jmesh, _, _ = jax_pincell.build_lattice(nx, ny, dtype=jnp.float64, **kw)
    n = 500
    rng = np.random.default_rng(31)
    box = np.array([nx * pitch, ny * pitch, height])
    src = rng.uniform(0.03, 0.97, (n, 3)) * box
    dest = rng.uniform(0.03, 0.97, (n, 3)) * box  # flights across cells
    port = PumiTally(mesh, n, TallyConfig(localization=localization),
                     device="cpu")
    ref = JaxPumiTally(jmesh, n, JaxTallyConfig(localization=localization))
    for t in (port, ref):
        t.CopyInitialPosition(src.reshape(-1).copy())
    np.testing.assert_array_equal(port.elem_ids, ref.elem_ids)
    for t in (port, ref):
        t.MoveToNextLocation(None, dest.reshape(-1).copy())
    np.testing.assert_array_equal(port.elem_ids, ref.elem_ids)
    np.testing.assert_allclose(port.positions, ref.positions, rtol=0,
                               atol=1e-12)
    flux = port.flux.numpy()
    np.testing.assert_allclose(flux, np.asarray(ref.flux), rtol=1e-10,
                               atol=1e-13)
    want = float(np.linalg.norm(dest - src, axis=1).sum())
    assert abs(float(flux.sum()) - want) / want < 1e-12


def test_two_tier_flux_on_the_lattice_matches_jax():
    """The bf16 select tier on the 3 x 3 flagship assembly (nz = 2),
    float32, 3,000 particles over three continue moves: the port's
    two-tier flux equals the JAX package's within L1 1e-3 of the total
    (measured 3.1e-5: the projections round in another order), and both
    packages move the same share of the track length off the float32
    flux: 6.05e-2, above the 1e-2 tie-class band the box holds. The
    plane offsets reach 3.78 here, where a bf16 ulp is 2^-6, against
    layers 0.5 thick at this depth (1/60 at the full depth)."""
    params = dict(pincell.FLAGSHIP_PINCELL, nz=2)
    mesh, _, _ = build_lattice(3, 3, dtype=torch.float32, **params)
    jmesh, _, _ = jax_pincell.build_lattice(3, 3, dtype=jnp.float32,
                                            **params)
    n = 3000
    box = np.array([3 * params["pitch"], 3 * params["pitch"],
                    params["height"]])
    rng = np.random.default_rng(1)
    pts = [rng.uniform(0.05, 0.95, (n, 3)) * box]
    for _ in range(3):
        step = rng.normal(scale=0.25 / np.sqrt(3.0), size=(n, 3))
        pts.append(np.clip(pts[-1] + step, 0.02 * box, 0.98 * box))

    def drive(t):
        t.CopyInitialPosition(pts[0].reshape(-1).copy())
        for p in pts[1:]:
            t.MoveToNextLocation(None, p.reshape(-1).copy())
        return np.asarray(t.flux, np.float64)

    flux = {}
    for tier in ("float32", "bfloat16"):
        flux["jax", tier] = drive(JaxPumiTally(jmesh, n, JaxTallyConfig(
            dtype=jnp.float32, walk_table_dtype=tier)))
        flux["port", tier] = drive(PumiTally(mesh, n, TallyConfig(
            dtype=torch.float32, walk_table_dtype=tier), device="cpu"))
    total = float(flux["jax", "float32"].sum())
    want = sum(float(np.linalg.norm(b - a, axis=1).sum())
               for a, b in zip(pts, pts[1:]))
    for key, f in flux.items():
        assert abs(float(f.sum()) - want) / want < 1e-6, key  # conserved
    l1 = {pkg: np.abs(flux[pkg, "bfloat16"] - flux[pkg, "float32"]).sum()
          / total for pkg in ("jax", "port")}
    assert np.abs(flux["port", "bfloat16"]
                  - flux["jax", "bfloat16"]).sum() / total < 1e-3
    assert abs(l1["port"] - l1["jax"]) < 1e-3
    assert 0.05 < l1["jax"] < 0.07
