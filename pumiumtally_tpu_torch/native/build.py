"""Build the port's C ABI library and its host programs.

    python -m pumiumtally_tpu_torch.native.build     # prints the directory

``build_native()`` compiles ``pumiumtally_c.cpp`` into
``libpumiumtally_c.so`` (embedding the interpreter that runs the build,
with numpy's C API) and the three hosts beside it: ``test_host`` (the
reference's 5-particle oracle, pure C), ``demo_host`` and
``bench_host`` (C++, through ``PumiumTally.hpp`` / the C header). The
flags are those of the JAX package's ``native/Makefile``. Outputs go to
``_build/native_<hash>/`` beside the kernels, keyed by a hash of the
sources, the flags and the interpreter, built in a directory of their
own and renamed into place, so concurrent builds (pytest workers) never
see a half-written library. A failed compile, or an interpreter without
its shared ``libpython``, raises with the compiler's output; nothing
falls back.

A host links ``-L<dir> -lpumiumtally_c`` (the library carries the rpath
of ``libpython``) and needs nothing of Python at build time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import time
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
PACKAGE_ROOT = HERE.parent.parent  # the checkout holding the package
BUILD_DIR = HERE.parent / "_build"
LIBRARY = "libpumiumtally_c.so"
SOURCES = ("pumiumtally_c.h", "pumiumtally_c.cpp", "PumiumTally.hpp",
           "test_host.c", "demo_host.cpp", "bench_host.cpp")
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
CFLAGS = ("-O2", "-std=c99", "-Wall", "-Wextra")
# host -> (compiler, flags, source, extra libraries)
HOSTS = {
    "test_host": ("cc", CFLAGS, "test_host.c", ("-lm",)),
    "demo_host": ("g++", CXXFLAGS, "demo_host.cpp", ()),
    "bench_host": ("g++", CXXFLAGS, "bench_host.cpp", ()),
}


def _python_paths() -> Dict[str, str]:
    """Where the building interpreter's headers and shared library are;
    raises when either is missing."""
    import numpy as np

    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldver = sysconfig.get_config_var("LDVERSION") or ""
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise RuntimeError(f"Python.h not found in {inc}: the C ABI "
                           "embeds the interpreter and needs its headers")
    lib = os.path.join(libdir, f"libpython{ldver}.so")
    if not os.path.exists(lib):
        raise RuntimeError(
            f"{lib} not found: the C ABI embeds the interpreter and needs "
            "its shared libpython (an interpreter built with "
            "--enable-shared)"
        )
    return {"include": inc, "numpy": np.get_include(), "libdir": libdir,
            "ldversion": ldver, "python": sys.executable,
            "root": str(PACKAGE_ROOT)}


def _compiler(name: str) -> str:
    """``$CXX`` / ``$CC`` where set (as in native/Makefile), else ``name``."""
    name = os.environ.get("CXX" if name == "g++" else "CC", name)
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(f"{name} not found on PATH: the C ABI library "
                           "and its hosts are built with it")
    return path


def _library_cmd(py: Dict[str, str], out: Path) -> List[str]:
    defs = [f'-DPUMIUMTALLY_PYTHON="{py["python"]}"',
            f'-DPUMIUMTALLY_ROOT="{py["root"]}"']
    return [_compiler("g++"), *CXXFLAGS, *defs, f"-I{py['include']}",
            f"-I{py['numpy']}", str(HERE / "pumiumtally_c.cpp"), "-o",
            str(out), "-shared", f"-L{py['libdir']}",
            f"-Wl,-rpath,{py['libdir']}", f"-lpython{py['ldversion']}"]


def _host_cmd(name: str, out_dir: Path) -> List[str]:
    cc, flags, src, libs = HOSTS[name]
    return [_compiler(cc), *flags, f"-I{HERE}", str(HERE / src), "-o",
            str(out_dir / name), f"-L{out_dir}", "-Wl,-rpath,$ORIGIN",
            "-lpumiumtally_c", *libs]


def native_dir() -> Path:
    """The directory ``build_native`` writes for these sources, flags
    and interpreter."""
    py = _python_paths()
    h = hashlib.sha256(repr((sorted(py.items()), CXXFLAGS, CFLAGS,
                             sorted(HOSTS.items()))).encode())
    for src in SOURCES:
        h.update((HERE / src).read_bytes())
    return BUILD_DIR / f"native_{h.hexdigest()[:16]}"


def library_path() -> Path:
    return native_dir() / LIBRARY


def _run(cmd: List[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_native() -> float:
    """Build the library and the hosts unless they are built already.
    Returns the wall seconds of the build (0.0 when cached); raises
    with the compiler's output when a compile fails."""
    final = native_dir()
    if (final / LIBRARY).exists():
        return 0.0
    py = _python_paths()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{final.name}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    try:
        steps = [{LIBRARY: _library_cmd(py, tmp / LIBRARY)},
                 {name: _host_cmd(name, tmp) for name in HOSTS}]
        for step in steps:  # the hosts link the library
            procs = {name: _run(cmd) for name, cmd in step.items()}
            failures = []
            for name, proc in procs.items():
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"{name}: {' '.join(step[name])}\n{out}")
            if failures:
                raise RuntimeError("C ABI build failed:\n"
                                   + "\n".join(failures))
        try:
            os.rename(tmp, final)
        except OSError:
            if not (final / LIBRARY).exists():  # no other build won the race
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return time.perf_counter() - t0


if __name__ == "__main__":
    secs = build_native()
    print(f"{native_dir()} ({secs:.1f} s)")
