"""The staging fill (``host_fill.cpp``): build, load and call.

``fill(dst, src, prev)`` writes the float64 array ``src`` into ``dst``
(float32 or float64) as ``np.copyto(dst, src, casting="unsafe")`` would,
in one pass that also reports whether a written value is Inf or NaN and,
given ``prev``, whether ``dst`` now equals it (``np.array_equal``).
``check(src, dtype)`` is the same pass with nothing written: each
value is cast to ``dtype`` in registers, so in float32 a finite float64
value past float32's range reads as non-finite. Arrays of
``inline_below()`` elements or more are split over the calling thread and
up to ``MAX_THREADS - 1`` pool threads, as many as the process's CPU
affinity allows; smaller ones run on the calling thread.

The library is built with the host C++ compiler at first use into
``_build/`` beside the kernels, keyed by a hash of the source and the
flags, written under a temporary name and renamed into place, so a
checkout builds it once and concurrent builds (pytest workers) never see
a half-written file. A failed compile raises with the compiler's output;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from pumiumtally_tpu_torch.native.build import BUILD_DIR, HERE, _compiler

SOURCE = HERE / "host_fill.cpp"
# No fast-math (no flush of subnormals) and no -march: the cast must be
# numpy's, bit for bit, on any x86-64 host.
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread",
            "-shared")
# Most threads a fill uses, the caller's included. A move's fills (3M
# positions and 1M weights) on the 8-core host of an H100 read a median of
# 6.6-8.0 ms on one thread, 3.3-4.3 on two, 1.8-2.2 on four, 1.3 on six
# and 0.8-1.1 on eight.
MAX_THREADS = 8

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(repr(CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libhost_fill_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; raises with the
    compiler's output when the compile fails."""
    path = library_path()
    if path.exists():
        return path
    # Imported here: utils.profiling imports the kernels module.
    from pumiumtally_tpu_torch.utils.profiling import span

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_compiler("g++"), *CXXFLAGS, str(SOURCE), "-o", str(tmp)]
    with span("ptt.build"):
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host fill build failed: {' '.join(cmd)}\n"
                           f"{proc.stdout}")
    os.replace(tmp, path)
    return path


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.pumi_host_fill.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            lib.pumi_host_fill.restype = ctypes.c_int
            lib.pumi_host_check.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            lib.pumi_host_check.restype = ctypes.c_int
            lib.pumi_host_fill_inline_below.argtypes = []
            lib.pumi_host_fill_inline_below.restype = ctypes.c_int64
            _lib = lib
        return _lib


def inline_below() -> int:
    """Arrays shorter than this run on the calling thread."""
    return int(_library().pumi_host_fill_inline_below())


def threads() -> int:
    """Threads a large fill may use: the process's CPUs, capped."""
    return min(len(os.sched_getaffinity(0)), MAX_THREADS)


def fill(dst: np.ndarray, src: np.ndarray,
         prev: Optional[np.ndarray] = None) -> Tuple[bool, bool, bool]:
    """Write ``src`` into ``dst`` (same size). Returns whether every
    written value is finite, whether ``dst`` equals ``prev`` (False
    without one) and whether pool threads ran the fill."""
    if dst.dtype not in (np.float32, np.float64):
        raise TypeError(f"fill writes float32 or float64, got {dst.dtype}")
    if not (dst.flags.c_contiguous and dst.flags.writeable):
        raise ValueError("fill needs a contiguous, writeable destination")
    src = np.ascontiguousarray(src, dtype=np.float64)
    if src.size != dst.size:
        raise ValueError(f"fill of {dst.size} values from {src.size}")
    if prev is not None and (prev.dtype != dst.dtype
                             or prev.size != dst.size
                             or not prev.flags.c_contiguous):
        raise ValueError("fill's snapshot must match the destination")
    r = _library().pumi_host_fill(
        src.ctypes.data, dst.ctypes.data,
        None if prev is None else prev.ctypes.data, dst.size,
        dst.itemsize, threads())
    if r < 0:
        raise RuntimeError(f"pumi_host_fill refused its arguments ({r})")
    return not r & 1, prev is not None and not r & 2, bool(r & 4)


def check(src: np.ndarray, dtype) -> Tuple[bool, bool]:
    """``fill``'s finite flag for ``src`` cast to ``dtype`` (float32 or
    float64), with nothing written: whether every cast value is finite and
    whether pool threads ran the pass. A contiguous float64 ``src`` is
    read in place."""
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise TypeError(f"check casts to float32 or float64, got {dtype}")
    src = np.ascontiguousarray(src, dtype=np.float64)
    r = _library().pumi_host_check(src.ctypes.data, src.size,
                                   dtype.itemsize, threads())
    if r < 0:
        raise RuntimeError(f"pumi_host_check refused its arguments ({r})")
    return not r & 1, bool(r & 4)
