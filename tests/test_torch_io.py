"""PyTorch port, mesh IO (``io/osh.py``, ``io/gmsh.py``, ``io/load.py``):
the JAX package's osh and gmsh checks (tests/test_io.py) mirrored on the
port, with both packages reading the same files.

Tolerances: arrays read from a file exact (both packages run the same
numpy code); written files byte-identical; facades built from a path,
float64 on the CPU: element ids exact, positions within 1e-12, flux
within rtol 1e-10 (another addition order, or a tet whose vertices the
file stores in another order: the face planes round differently)."""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pumiumtally_tpu import PumiTally as JaxPumiTally
from pumiumtally_tpu.io import gmsh as jax_gmsh
from pumiumtally_tpu.io import osh as jax_osh
from pumiumtally_tpu.io.load import load_mesh as jax_load_mesh
from pumiumtally_tpu.mesh.box import box_arrays
from pumiumtally_tpu_torch import (
    PartitionedPumiTally,
    PumiTally,
    TallyConfig,
    TetMesh,
    convert,
)
from pumiumtally_tpu_torch.io import gmsh, osh
from pumiumtally_tpu_torch.io.load import load_mesh

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
FIXTURES = ("cube_omega1.osh", "cube_omega2.osh", "cube_omega_cpp.osh",
            "cube_omega_cpp_raw.osh")
F64 = torch.float64
N = 200


def _test_io():
    """tests/test_io.py, for its four .msh writers (v2/v4, ASCII and
    binary)."""
    spec = importlib.util.spec_from_file_location("_jax_test_io",
                                                  DATA.parent / "test_io.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_mesh(port_mesh, jax_mesh):
    a, b = convert.mesh_arrays(port_mesh), convert.mesh_arrays(jax_mesh)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", FIXTURES)
def test_osh_fixtures_load_equal_in_both_packages(name):
    path = str(DATA / name)
    c, t = osh.read_osh(path)
    cj, tj = jax_osh.read_osh(path)
    np.testing.assert_array_equal(c, cj)
    np.testing.assert_array_equal(t, tj)
    _, _, tags = osh.read_osh(path, with_tags=True)
    _, _, tags_j = jax_osh.read_osh(path, with_tags=True)
    assert sorted(tags) == sorted(tags_j)
    for k in tags:
        np.testing.assert_array_equal(tags[k], tags_j[k])
    _same_mesh(load_mesh(path, dtype=F64),
               jax_load_mesh(path, dtype=jnp.float64))


@pytest.mark.parametrize("nparts", [1, 4])
def test_write_osh_round_trip_and_bytes(tmp_path, nparts):
    coords, tets = box_arrays(2, 1, 1, 3, 2, 2)
    coords = np.vstack([coords, [[5.0, 5.0, 5.0]]])  # an orphan node
    tags = {"region": np.arange(tets.shape[0]) % 3}
    port, ref = str(tmp_path / "p.osh"), str(tmp_path / "j.osh")
    osh.write_osh(port, coords, tets, nparts=nparts, elem_tags=tags)
    jax_osh.write_osh(ref, coords, tets, nparts=nparts, elem_tags=tags)
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    for f in os.listdir(port):
        assert (Path(port) / f).read_bytes() == (Path(ref) / f).read_bytes()
    for read in (osh.read_osh, jax_osh.read_osh):
        c2, t2, tags2 = read(port, with_tags=True)
        np.testing.assert_array_equal(c2, coords)
        np.testing.assert_array_equal(np.sort(t2, axis=1),
                                      np.sort(tets, axis=1))
        np.testing.assert_array_equal(tags2["region"], tags["region"])


def test_write_gmsh_round_trip_and_bytes(tmp_path):
    coords, tets = box_arrays(1, 1, 1, 2, 2, 2)
    phys = np.arange(tets.shape[0]) % 2
    port, ref = str(tmp_path / "p.msh"), str(tmp_path / "j.msh")
    gmsh.write_gmsh(port, coords, tets, physical=phys)
    jax_gmsh.write_gmsh(ref, coords, tets, physical=phys)
    assert Path(port).read_bytes() == Path(ref).read_bytes()
    c2, t2 = gmsh.read_gmsh(port)
    np.testing.assert_array_equal(c2, coords)
    np.testing.assert_array_equal(t2, tets)


@pytest.mark.parametrize("writer", ["_write_msh_v2", "_write_msh_v4",
                                    "_write_msh_v2_binary",
                                    "_write_msh_v4_binary"])
def test_gmsh_formats_load_equal_in_both_packages(tmp_path, writer):
    coords, tets = box_arrays(1, 1, 1, 2, 2, 2)
    path = str(tmp_path / "m.msh")
    getattr(_test_io(), writer)(path, coords, tets)
    c, t = gmsh.read_gmsh(path)
    cj, tj = jax_gmsh.read_gmsh(path)
    np.testing.assert_array_equal(c, cj)
    np.testing.assert_array_equal(t, tj)
    mesh = load_mesh(path, dtype=F64)
    assert mesh.nelems == 48
    np.testing.assert_allclose(float(mesh.volumes.sum()), 1.0, atol=1e-12)
    _same_mesh(mesh, jax_load_mesh(path, dtype=jnp.float64))


def _mesh_files(tmp_path):
    coords, tets = box_arrays(1, 1, 1, 3, 3, 3)
    paths = {"osh": str(tmp_path / "cube.osh"),
             "msh": str(tmp_path / "cube.msh")}
    osh.write_osh(paths["osh"], coords, tets)
    gmsh.write_gmsh(paths["msh"], coords, tets)
    return coords, tets, paths


def _drive(t, seed=4):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.05, 0.95, (N, 3))
    d1 = rng.uniform(-0.1, 1.1, (N, 3))  # some leave the box
    t.CopyInitialPosition(src.reshape(-1).copy())
    t.MoveToNextLocation(src.reshape(-1).copy(), d1.reshape(-1).copy(),
                         (rng.random(N) > 0.2).astype(np.int8),
                         rng.uniform(0.5, 2.0, N))
    t.MoveToNextLocation(None, rng.uniform(0.05, 0.95, (N, 3)).reshape(-1))
    return t.elem_ids, t.positions, convert.host(t.flux)


def _assert_same_run(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], rtol=0, atol=1e-12)
    np.testing.assert_allclose(a[2], b[2], rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("fmt", ["osh", "msh"])
def test_facades_from_a_path_match_arrays_and_jax(tmp_path, fmt):
    coords, tets, paths = _mesh_files(tmp_path)
    f64 = TallyConfig(dtype=F64)
    arrays = _drive(PumiTally(TetMesh.from_arrays(coords, tets, dtype=F64),
                              N, f64, device="cpu"))
    mono = PumiTally(paths[fmt], N, f64, device="cpu")
    assert mono.dtype == F64 and mono.mesh.nelems == tets.shape[0]
    part = PartitionedPumiTally(
        paths[fmt], N, TallyConfig(dtype=F64, walk_vmem_max_elems=40),
        device="cpu")
    ref = _drive(JaxPumiTally(paths[fmt], N))  # float64 under x64
    for t in (mono, part):
        run = _drive(t)
        _assert_same_run(run, arrays)
        _assert_same_run(run, ref)


def test_path_takes_the_config_dtype_or_float32(tmp_path):
    _, _, paths = _mesh_files(tmp_path)
    assert PumiTally(paths["osh"], 4, device="cpu").dtype == torch.float32
    t = PumiTally(paths["msh"], 4, TallyConfig(walk_table_dtype="bfloat16"),
                  device="cpu")
    assert t.dtype == torch.float32 and t.mesh.two_tier


def _raised(fn, path):
    try:
        fn(path)
    except Exception as e:  # noqa: BLE001 -- the type is what is compared
        return type(e)
    return None


def _truncate(path, keep):
    data = Path(path).read_bytes()
    Path(path).write_bytes(data[: int(len(data) * keep)])


def test_bad_files_raise_what_the_jax_package_raises(tmp_path):
    coords, tets, paths = _mesh_files(tmp_path)
    foreign = tmp_path / "omega.osh"
    foreign.mkdir()
    (foreign / "nparts").write_text("1\n")
    (foreign / "0.osh").write_bytes(b"\xa1\x1a" + b"\x00" * 64)
    cut_osh = str(tmp_path / "cut.osh")
    osh.write_osh(cut_osh, coords, tets)
    _truncate(os.path.join(cut_osh, "0.osh"), 0.5)
    cut_msh = str(tmp_path / "cut.msh")
    gmsh.write_gmsh(cut_msh, coords, tets)
    _truncate(cut_msh, 0.5)
    cut_bin = str(tmp_path / "cut_bin.msh")
    _test_io()._write_msh_v4_binary(cut_bin, coords, tets)
    _truncate(cut_bin, 0.6)
    cases = ["mesh.stl", str(tmp_path / "missing.osh"), str(foreign),
             cut_osh, cut_msh, cut_bin]
    for path in cases:
        want = _raised(jax_load_mesh, path)
        assert want is not None, path
        assert _raised(load_mesh, path).__name__ == want.__name__, path
        with pytest.raises(ValueError):  # every one of them a ValueError
            load_mesh(path)
    with pytest.raises(ValueError, match="msh2osh"):
        load_mesh(str(foreign))
