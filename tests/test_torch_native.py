"""PyTorch port, the C ABI (``pumiumtally_tpu_torch/native/``) against the
JAX package's (``native/``), on the CPU in float64.

Both libraries are loaded into this process through ctypes (each with
the default ``RTLD_LOCAL``, so their equal C symbols stay apart) and
driven with the same calls on the same inputs: the reference's oracle
sequence, a continue move with the accessors, and the echo-dedup host
loop with fenced and unfenced dispatch. Element ids must be equal and
flux within rtol 1e-10. The port's pure-C oracle host runs as a
subprocess (an embedded interpreter of its own), and the environment
switches of ``api/native.py`` are checked one by one: engine routing,
the multi-device refusals, the device policy (no GPU here: the default
refuses, ``PUMIUMTALLY_ALLOW_CPU_FALLBACK=1`` runs and warns) and
``PUMIUMTALLY_DTYPE``.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pumiumtally_tpu_torch.config import ROADMAP_MULTI_DEVICE
from pumiumtally_tpu_torch.io.gmsh import write_gmsh
from pumiumtally_tpu_torch.mesh.box import box_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = os.path.join(ROOT, "native")

_ENV = ("PUMIUMTALLY_ENGINE", "PUMIUMTALLY_DEVICE", "PUMIUMTALLY_DTYPE",
        "PUMIUMTALLY_ALLOW_CPU_FALLBACK", "PUMIUMTALLY_DEVICES",
        "PUMIUMTALLY_DEVICE_GROUPS", "PUMIUMTALLY_CHUNK_SIZE",
        "PUMIUMTALLY_CAPACITY_FACTOR", "PUMIUMTALLY_VMEM_MAX_ELEMS",
        "PUMIUMTALLY_BLOCK_KERNEL", "PUMIUMTALLY_TOLERANCE",
        "PUMIUMTALLY_OUTPUT", "PUMIUMTALLY_LOCALIZATION",
        "PUMIUMTALLY_AUTO_CONTINUE", "PUMIUMTALLY_FENCED_TIMING",
        "PUMIUMTALLY_CHECK_FOUND_ALL")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Every test starts from no PUMIUMTALLY_* switch but the CPU and
    float64 (the parity precision); a test changes what it checks."""
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PUMIUMTALLY_DEVICE", "cpu")
    monkeypatch.setenv("PUMIUMTALLY_DTYPE", "float64")


def _bind(lib):
    c_p, c_d = ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)
    c_i8, c_i32 = ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int32)
    sig = {
        "pumiumtally_create": (c_p, [ctypes.c_char_p, ctypes.c_int32]),
        "pumiumtally_copy_initial_position": (
            ctypes.c_int, [c_p, c_d, ctypes.c_int32]),
        "pumiumtally_move_to_next_location": (
            ctypes.c_int, [c_p, c_d, c_d, c_i8, c_d, ctypes.c_int32]),
        "pumiumtally_move_continue": (
            ctypes.c_int, [c_p, c_d, c_i8, c_d, ctypes.c_int32]),
        "pumiumtally_write_tally_results": (ctypes.c_int,
                                            [c_p, ctypes.c_char_p]),
        "pumiumtally_get_flux": (ctypes.c_int64, [c_p, c_d, ctypes.c_int64]),
        "pumiumtally_get_positions": (ctypes.c_int64,
                                      [c_p, c_d, ctypes.c_int64]),
        "pumiumtally_get_elem_ids": (ctypes.c_int64,
                                     [c_p, c_i32, ctypes.c_int64]),
        "pumiumtally_destroy": (None, [c_p]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


@pytest.fixture(scope="module")
def port_native():
    """The port's library and hosts, built by ``build_native`` (a failed
    build fails the test; only a missing compiler skips)."""
    from pumiumtally_tpu_torch.native import build

    if shutil.which("g++") is None or shutil.which("cc") is None:
        pytest.skip("the C ABI is built with g++ and cc")
    build.build_native()
    return build.native_dir()


@pytest.fixture(scope="module")
def libs(port_native, tmp_path_factory):
    """(JAX library, port library). The JAX one is built by its own
    Makefile, in a copy of native/'s sources so that no other test's
    build of native/ races this one."""
    src = tmp_path_factory.mktemp("jax_native")
    for f in ("Makefile", "pumiumtally_c.cpp", "pumiumtally_c.h"):
        shutil.copy(os.path.join(JAX_NATIVE, f), src / f)
    r = subprocess.run(["make", "-C", str(src), "-s", f"PY={sys.executable}",
                        "libpumiumtally_c.so"], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    jax_lib = _bind(ctypes.CDLL(str(src / "libpumiumtally_c.so")))
    port_lib = _bind(ctypes.CDLL(str(port_native / "libpumiumtally_c.so")))
    return {"jax": jax_lib, "port": port_lib}


@pytest.fixture
def box_msh(tmp_path):
    """The unit cube's 6-tet mesh as a Gmsh 2.2 file."""
    path = str(tmp_path / "box.msh")
    write_gmsh(path, *box_arrays(1, 1, 1, 1, 1, 1))
    return path


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _i8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


class _Handle:
    """One engine behind a library's C ABI."""

    def __init__(self, lib, msh: str, n: int):
        self.lib, self.n = lib, n
        self.h = lib.pumiumtally_create(msh.encode(), n)
        assert self.h, "pumiumtally_create returned NULL"

    def source(self, pts):
        a = np.ascontiguousarray(pts, np.float64).reshape(-1)
        assert self.lib.pumiumtally_copy_initial_position(
            self.h, _dp(a), a.size) == 0

    def move(self, origins, dests, flying, weights):
        assert self.lib.pumiumtally_move_to_next_location(
            self.h, _dp(origins), _dp(dests), _i8(flying), _dp(weights),
            dests.size) == 0

    def move_continue(self, dests):
        assert self.lib.pumiumtally_move_continue(
            self.h, _dp(dests), ctypes.POINTER(ctypes.c_int8)(),
            ctypes.POINTER(ctypes.c_double)(), dests.size) == 0

    def flux(self):
        ne = self.lib.pumiumtally_get_flux(self.h, None, 0)
        out = np.zeros(ne)
        assert self.lib.pumiumtally_get_flux(self.h, _dp(out), ne) == ne
        return out

    def positions(self):
        out = np.zeros(3 * self.n)
        assert self.lib.pumiumtally_get_positions(
            self.h, _dp(out), out.size) == out.size
        return out

    def elem_ids(self):
        out = np.zeros(self.n, np.int32)
        assert self.lib.pumiumtally_get_elem_ids(
            self.h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.n) == self.n
        return out

    def close(self):
        self.lib.pumiumtally_destroy(self.h)


def _both(libs, msh, n):
    return {k: _Handle(lib, msh, n) for k, lib in libs.items()}


def _check_parity(hs):
    j, p = hs["jax"], hs["port"]
    np.testing.assert_array_equal(p.elem_ids(), j.elem_ids())
    np.testing.assert_allclose(p.flux(), j.flux(), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(p.positions(), j.positions(), rtol=1e-10,
                               atol=1e-14)


def test_c_abi_oracle_sequence_parity(libs, box_msh, tmp_path):
    """The reference's oracle through both libraries: localization in
    element 2, move 1 to x = 1.2 (flux 1.5/0.5/2.5, flying zeroed across
    the boundary, positions clamped), move 2 with mixed flying and
    weights; then the VTK file."""
    n = 5
    hs = _both(libs, box_msh, n)
    try:
        init = np.tile([0.1, 0.4, 0.5], (n, 1)).reshape(-1)
        for h in hs.values():
            h.source(init)
            np.testing.assert_array_equal(h.elem_ids(), np.full(n, 2))
        dests = np.tile([1.2, 0.4, 0.5], (n, 1)).reshape(-1)
        for h in hs.values():
            flying = np.ones(n, np.int8)
            h.move(init, dests, flying, np.ones(n))
            np.testing.assert_array_equal(flying, np.zeros(n, np.int8))
            np.testing.assert_allclose(
                h.flux(), [0.0, 0.0, 0.3 * n, 0.1 * n, 0.5 * n, 0.0],
                atol=1e-8)
        _check_parity(hs)
        origins2 = np.tile([1.0, 0.4, 0.5], (n, 1)).reshape(-1)
        dests2 = origins2.copy()
        dests2[0:3] = [0.15, 0.05, 0.20]
        dests2[6:9] = [0.85, 0.05, 0.10]
        flying2 = np.array([1, 0, 1, 0, 0], np.int8)
        weights2 = np.array([2.0, 1.0, 0.5, 1.0, 1.0])
        for h in hs.values():
            h.move(origins2, dests2, flying2.copy(), weights2)
            np.testing.assert_array_equal(h.elem_ids(), [3, 4, 4, 4, 4])
            np.testing.assert_allclose(h.positions(), dests2, atol=1e-8)
        _check_parity(hs)
        out = str(tmp_path / "flux.vtk")
        assert libs["port"].pumiumtally_write_tally_results(
            hs["port"].h, out.encode()) == 0
        assert os.path.getsize(out) > 0
    finally:
        for h in hs.values():
            h.close()


def test_c_abi_continue_and_accessors_parity(libs, box_msh):
    """A continue move (NULL flying and weights) and the three
    accessors, equal across the two libraries."""
    n = 4
    hs = _both(libs, box_msh, n)
    try:
        init = np.tile([0.2, 0.4, 0.5], (n, 1)).reshape(-1)
        dests = np.tile([0.4, 0.4, 0.5], (n, 1)).reshape(-1)
        for h in hs.values():
            h.source(init)
            h.move_continue(dests)
            np.testing.assert_allclose(h.positions(), dests, atol=1e-8)
            np.testing.assert_array_equal(h.elem_ids(), np.full(n, 2))
            np.testing.assert_allclose(h.flux().sum(), 0.2 * n, atol=1e-8)
        _check_parity(hs)
    finally:
        for h in hs.values():
            h.close()


@pytest.mark.parametrize("fenced", ["1", "0"])
def test_c_abi_echo_protocol_dedup_parity(libs, box_msh, monkeypatch,
                                          fenced):
    """The reference-style host loop: origins echo the previous
    destinations every move, in the same recycled buffers a C host
    reuses, fenced and unfenced. The staging dedup keeps conservation
    exact across the boundary, and both libraries agree."""
    monkeypatch.setenv("PUMIUMTALLY_FENCED_TIMING", fenced)
    n = 64
    hs = _both(libs, box_msh, n)
    try:
        rng = np.random.default_rng(17)
        origins = rng.uniform(0.1, 0.9, (n, 3)).reshape(-1)
        obuf = origins.copy()
        dbuf = np.empty(3 * n)
        flying = np.empty(n, np.int8)
        weights = np.ones(n)
        for h in hs.values():
            h.source(origins)
        expect = 0.0
        for _ in range(4):
            dests = rng.uniform(0.1, 0.9, (n, 3)).reshape(-1)
            dbuf[:] = dests
            for h in hs.values():
                flying[:] = 1
                h.move(obuf, dbuf, flying, weights)
            expect += float(np.linalg.norm(
                (dests - obuf).reshape(n, 3), axis=1).sum())
            obuf[:] = dests  # echo: the recycled origin buffer
            dbuf[:] = -1.0   # the host scribbles over its buffer at once
        for h in hs.values():
            assert abs(h.flux().sum() - expect) / expect < 1e-9
        _check_parity(hs)
    finally:
        for h in hs.values():
            h.close()


@pytest.mark.parametrize("engine", ["streaming", "partitioned",
                                    "streaming_partitioned"])
def test_c_abi_engines_match_the_jax_library(libs, box_msh, monkeypatch,
                                             engine):
    """Each engine through the port's ABI equals the JAX library's
    default engine on the same moves (ids exact, flux rtol 1e-10)."""
    n = 48
    rng = np.random.default_rng(5)
    pts = [rng.uniform(0.05, 0.95, (n, 3)).reshape(-1) for _ in range(3)]
    j = _Handle(libs["jax"], box_msh, n)
    monkeypatch.setenv("PUMIUMTALLY_ENGINE", engine)
    monkeypatch.setenv("PUMIUMTALLY_CHUNK_SIZE", "20")
    p = _Handle(libs["port"], box_msh, n)
    hs = {"jax": j, "port": p}
    try:
        for h in hs.values():
            h.source(pts[0])
            h.move(pts[0], pts[1], np.ones(n, np.int8), np.ones(n))
            h.move_continue(pts[2])
        _check_parity(hs)
    finally:
        for h in hs.values():
            h.close()


def _host_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in _ENV}
    env.update(extra)
    return env


def test_c_host_oracle_binary(port_native, box_msh):
    """The port's pure-C host drives the 6-tet cube through its library
    in an embedded interpreter and asserts the reference's oracle to
    1e-8; ``--corrupt`` perturbs one expectation and must fail."""
    binary = str(port_native / "test_host")
    env = _host_env(PUMIUMTALLY_DEVICE="cpu", PUMIUMTALLY_DTYPE="float64")
    r = subprocess.run([binary, box_msh], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, f"oracle host failed:\n{r.stdout}\n{r.stderr}"
    assert "test_host OK" in r.stdout
    r = subprocess.run([binary, box_msh, "--corrupt"], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert "MISMATCH" in r.stderr


@pytest.mark.slow
def test_cpp_demo_host(port_native, box_msh, tmp_path):
    """The pure-C++ demo host through ``PumiumTally.hpp``."""
    r = subprocess.run(
        [str(port_native / "demo_host"), box_msh, "200"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=300,
        env=_host_env(PUMIUMTALLY_DEVICE="cpu", PUMIUMTALLY_DTYPE="float64"),
    )
    assert r.returncode == 0, f"demo failed:\n{r.stdout}\n{r.stderr}"
    assert "demo OK" in r.stdout
    assert os.path.exists(str(tmp_path / "demo_fluxresult.vtk"))


def test_native_env_selects_block_kernel(box_msh, monkeypatch):
    """PUMIUMTALLY_BLOCK_KERNEL reaches TallyConfig.walk_block_kernel for
    the partitioned engines and is refused for the others, as the JAX
    factory does."""
    from pumiumtally_tpu_torch.api.native import native_create

    monkeypatch.setenv("PUMIUMTALLY_ENGINE", "partitioned")
    monkeypatch.setenv("PUMIUMTALLY_VMEM_MAX_ELEMS", "2")
    monkeypatch.setenv("PUMIUMTALLY_BLOCK_KERNEL", "gather")
    monkeypatch.setenv("PUMIUMTALLY_CAPACITY_FACTOR", "8.0")
    t = native_create(box_msh, 16)
    assert t.engine.nparts > 1 and not t.engine.use_vmem_walk
    assert t.config.walk_block_kernel == "gather"
    assert t.config.capacity_factor == 8.0 and t.dtype == torch.float64
    monkeypatch.setenv("PUMIUMTALLY_ENGINE", "mono")
    monkeypatch.delenv("PUMIUMTALLY_VMEM_MAX_ELEMS")
    with pytest.raises(ValueError, match="BLOCK_KERNEL"):
        native_create(box_msh, 16)
    monkeypatch.delenv("PUMIUMTALLY_BLOCK_KERNEL")
    monkeypatch.setenv("PUMIUMTALLY_VMEM_MAX_ELEMS", "2")
    with pytest.raises(ValueError, match="VMEM_MAX_ELEMS"):
        native_create(box_msh, 16)


def test_native_env_knobs_reach_the_config(box_msh, monkeypatch):
    """The remaining switches map onto the config as in the JAX factory:
    FENCED_TIMING=0 implies CHECK_FOUND_ALL=0 unless that is set."""
    from pumiumtally_tpu_torch.api.native import native_create

    monkeypatch.setenv("PUMIUMTALLY_TOLERANCE", "1e-9")
    monkeypatch.setenv("PUMIUMTALLY_OUTPUT", "out.vtk")
    monkeypatch.setenv("PUMIUMTALLY_LOCALIZATION", "Locate")
    monkeypatch.setenv("PUMIUMTALLY_AUTO_CONTINUE", "0")
    monkeypatch.setenv("PUMIUMTALLY_FENCED_TIMING", "0")
    c = native_create(box_msh, 4).config
    assert (c.tolerance, c.output_filename, c.localization) == (
        1e-9, "out.vtk", "locate")
    assert not c.auto_continue and not c.fenced_timing
    assert not c.check_found_all
    monkeypatch.setenv("PUMIUMTALLY_CHECK_FOUND_ALL", "1")
    assert native_create(box_msh, 4).config.check_found_all
    monkeypatch.setenv("PUMIUMTALLY_ENGINE", "streaming")
    monkeypatch.setenv("PUMIUMTALLY_CHUNK_SIZE", "3")
    assert native_create(box_msh, 4).chunk_size == 3
    monkeypatch.setenv("PUMIUMTALLY_ENGINE", "nope")
    with pytest.raises(ValueError, match="expected mono"):
        native_create(box_msh, 4)


@pytest.mark.parametrize("var,engine", [
    ("PUMIUMTALLY_DEVICES", "mono"),
    ("PUMIUMTALLY_DEVICES", "partitioned"),
    ("PUMIUMTALLY_DEVICE_GROUPS", "streaming_partitioned"),
])
def test_native_refuses_several_devices(box_msh, monkeypatch, var, engine):
    """The port runs on one device: PUMIUMTALLY_DEVICES=2 and
    PUMIUMTALLY_DEVICE_GROUPS=2 are refused naming the ROADMAP item; the
    value 1 is accepted."""
    from pumiumtally_tpu_torch.api.native import native_create

    monkeypatch.setenv("PUMIUMTALLY_ENGINE", engine)
    monkeypatch.setenv(var, "2")
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        native_create(box_msh, 8)
    assert "Multi-device" in ROADMAP_MULTI_DEVICE
    monkeypatch.setenv(var, "1")
    assert native_create(box_msh, 8).num_particles == 8


def test_native_dtype_switch(box_msh, monkeypatch):
    """PUMIUMTALLY_DTYPE picks the mesh file's working dtype: float32
    unless asked, float64 on request; anything else is refused."""
    from pumiumtally_tpu_torch.api.native import native_create

    monkeypatch.delenv("PUMIUMTALLY_DTYPE")
    assert native_create(box_msh, 4).dtype == torch.float32
    monkeypatch.setenv("PUMIUMTALLY_DTYPE", "float64")
    assert native_create(box_msh, 4).dtype == torch.float64
    monkeypatch.setenv("PUMIUMTALLY_DTYPE", "bfloat16")
    with pytest.raises(ValueError, match="PUMIUMTALLY_DTYPE"):
        native_create(box_msh, 4)
    monkeypatch.setenv("PUMIUMTALLY_DTYPE", "float64")
    monkeypatch.setenv("PUMIUMTALLY_DEVICE", "tpu")
    with pytest.raises(ValueError, match="PUMIUMTALLY_DEVICE"):
        native_create(box_msh, 4)


def test_native_refuses_without_gpu(libs, box_msh, monkeypatch, capfd):
    """With no device request and no CUDA device, the factory refuses
    rather than run on the CPU, and the C create returns NULL."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from pumiumtally_tpu_torch.api.native import native_create

    monkeypatch.delenv("PUMIUMTALLY_DEVICE")
    with pytest.raises(RuntimeError,
                       match="Refusing to run the tally silently on CPU"):
        native_create(box_msh, 4)
    assert not libs["port"].pumiumtally_create(box_msh.encode(), 4)
    assert "Refusing to run the tally silently on CPU" in capfd.readouterr().err


def test_native_cpu_fallback_opt_in(libs, box_msh, monkeypatch, capfd):
    """PUMIUMTALLY_ALLOW_CPU_FALLBACK=1 is the caller accepting the CPU
    in place of a missing GPU: the engine runs, with a loud warning."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing falls back")
    from pumiumtally_tpu_torch.api.native import native_create

    monkeypatch.delenv("PUMIUMTALLY_DEVICE")
    monkeypatch.setenv("PUMIUMTALLY_ALLOW_CPU_FALLBACK", "1")
    t = native_create(box_msh, 8)
    assert t.device.type == "cpu"
    assert "ACCELERATOR FALLBACK" in capfd.readouterr().err
    h = _Handle(libs["port"], box_msh, 8)
    try:
        src = np.full((8, 3), 0.3) + np.arange(8)[:, None] * 0.05
        h.source(src)
        h.move(src.reshape(-1).copy(), (src + 0.1).reshape(-1).copy(),
               np.ones(8, np.int8), np.ones(8))
        want = float(np.linalg.norm(np.full((8, 3), 0.1), axis=1).sum())
        assert abs(h.flux().sum() - want) < 1e-9
    finally:
        h.close()
    assert "ACCELERATOR FALLBACK" in capfd.readouterr().err


def test_host_array_copies_tensors_and_arrays():
    """The accessors' helper: a contiguous 1-D copy in the asked dtype,
    from a tensor (through the host) or an ndarray."""
    from pumiumtally_tpu_torch.api.native import host_array

    class T:
        flux = torch.arange(6, dtype=torch.float32)[::2]
        positions = np.arange(12.0).reshape(4, 3)
        elem_ids = np.arange(4, dtype=np.int64)

    f = host_array(T, "flux", "float64")
    assert f.dtype == np.float64 and f.flags.c_contiguous
    np.testing.assert_array_equal(f, [0.0, 2.0, 4.0])
    p = host_array(T, "positions", "float64")
    assert p.shape == (12,) and p.flags.c_contiguous
    e = host_array(T, "elem_ids", "int32")
    assert e.dtype == np.int32
    np.testing.assert_array_equal(e, np.arange(4))


def test_build_keys_on_sources_and_refuses_without_libpython(monkeypatch,
                                                              tmp_path):
    """The build directory is keyed by the sources; a missing libpython
    raises rather than build something else."""
    from pumiumtally_tpu_torch.native import build

    d = build.native_dir()
    assert d.parent == build.BUILD_DIR and d.name.startswith("native_")
    monkeypatch.setattr(build, "HOSTS", {})
    assert build.native_dir() != d
    monkeypatch.setattr(build.sysconfig, "get_config_var",
                        lambda name: str(tmp_path) if name == "LIBDIR"
                        else "3.12")
    with pytest.raises(RuntimeError, match="libpython"):
        build.build_native()


def test_bridge_imports_only_the_ports_factory():
    """The port's bridge imports pumiumtally_tpu_torch.api.native and no
    module of the JAX package; its header declares the JAX library's ABI
    declaration for declaration (comments aside)."""
    import re
    from pathlib import Path

    here = Path(ROOT) / "pumiumtally_tpu_torch" / "native"
    src = (here / "pumiumtally_c.cpp").read_text()
    modules = set(re.findall(r'"(pumiumtally_tpu[\w.]*)"', src))
    assert modules == {"pumiumtally_tpu_torch.api.native"}

    def declarations(path):
        text = re.sub(r"/\*.*?\*/", "", Path(path).read_text(), flags=re.S)
        return [ln.strip() for ln in text.splitlines() if ln.strip()]

    assert declarations(here / "pumiumtally_c.h") == declarations(
        os.path.join(JAX_NATIVE, "pumiumtally_c.h"))
