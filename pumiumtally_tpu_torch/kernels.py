"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``
(every pointer and the stream are ``c_void_p``; each entry point returns
``cudaGetLastError()``). Libraries are built at first use, all sources
at once (one ``nvcc`` per source, started together), into ``_build/``
beside this file, keyed by a hash of the sources and flags, so a fresh
checkout builds them itself and an edited source rebuilds.

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` or a GPU, where only the plain PyTorch versions run.

Launch counters: each wrapper adds one to ``launch_counts[entry]`` where
it launches its kernel, and nowhere else, so a caller can show that a
path really went through the kernels (``reset_launch_counts`` first).
An entry is one C entry point of a library: ``walk`` (W0),
``walk_twotier`` (W0's two-tier variant, in the same library),
``walk_unpacked`` (W0 on the unpacked planes and int32 ids: meshes past
the float lanes' exact ids, and the float32 tier of a two-tier mesh),
``block_walk`` (W1), ``twotier_block_walk`` (W2), ``resident_walk`` (W3),
the two entries of the row gather G1, ``row_gather_take`` (K4's
counterpart) and ``row_gather_take_along_axis`` (K5's), and the gather
block walk W4, ``gather_block_walk`` (packed rows, adjacency in the rows
or in the int32 sidecar) and ``gather_block_walk_twotier``. The scoring
instantiations of W0, W2 and W4 are entries of their own, counted apart:
``walk_scored``, ``walk_twotier_scored``, ``walk_unpacked_scored``,
``twotier_block_walk_scored``,
``gather_block_walk_scored`` and ``gather_block_walk_twotier_scored``
(each takes its scoring arguments ahead of the plain entry's). W4's
work list of a later round is built by ``gather_work_list``. W0's, W1's,
W2's and W4's entries take a last pointer, ``det``: null for the atomic
commit, else the host address of the deterministic commit's record
description (``ops/det_commit.py``), which launches the kDet
instantiation in the same entry; ``det_commit`` (csrc/det_commit.cu, the seventh library) adds
those records in order. W0's entries take ``seg`` and the flux's length
before ``det``: a null ``seg`` for the plain commit, else the segmented
commit's per-particle flux offsets (``ops/walk.py`` ``tally_seg``).

Build and load counters (read by ``utils/profiling.build_guard``):
``build_counts[library]`` adds one where nvcc really compiled the library
(a cached build counts nothing) and ``load_counts[library]`` where ctypes
really loaded it. ``_lib`` keeps each loaded library for the life of the
process (under ``_lock``), so a load count passes 1 only where that cache
was emptied; it shows which libraries a run used, and has no budget.
On the profiler's timeline an nvcc run is a ``ptt.build`` span and a
ctypes load a ``ptt.load`` one, so a build or a late load inside a
traced window names its own stretch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
HEADERS = ("walk_step.cuh", "twotier_step.cuh", "block_walk_sched.cuh",
           "occupancy.cuh", "det_records.cuh")
SOURCES = {
    "walk": "walk.cu",
    "block_walk": "block_walk.cu",
    "twotier_block_walk": "twotier_block_walk.cu",
    "resident_walk": "resident_walk.cu",
    "row_gather": "row_gather.cu",
    "gather_block_walk": "gather_block_walk.cu",
    "det_commit": "det_commit.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_BOTH = ("f32", "f64")
# A scoring entry's leading arguments: bank, bin_off, fac, stride,
# nscores, kinds, and for W0 bank_size (W2 drops by its slice's stride).
_W2_SCORE = [_P] * 3 + [_I] * 3
_SCORE = _W2_SCORE + [_I]
# W4's arguments after its two tables: 13 pointers (the slot state,
# written in place, flux, pending, iters, counts, the work list and its
# length), the list's capacity, L, cb, tol, max_iters, tally, det.
_W4 = [_P] * 15 + [_I, _I, _I, _D, _I, _I, _P, _P]
# W0's arguments after its tables: 16 pointers (the particles, flux, the
# outputs, iters, the counter, counts, skip), n, tol, max_iters, tally,
# the segmented commit's offsets and flux length, det.
_W0 = [_P] * 16 + [_I, _D, _I, _I, _P, _I, _P, _P]
# W1's and W2's last arguments: tol, max_iters, tally, (W2: use_shared,)
# det.
_W1 = [_P] * 16 + [_I, _I, _I, _D, _I, _I, _P, _P]
_W2 = [_P] * 17 + [_I, _I, _I, _D, _I, _I, _I, _P, _P]
# W0's unpacked tables: the plane rows, the ids, and the rows' width (16
# or 20, the layout).
_PLANES = [_P] * 2 + [_I]
# C entry points: entry -> (library, argtypes, dtypes); the entry's
# dtypes share its argtypes (``pumi_<entry>_f32`` / ``pumi_<entry>_f64``).
_ENTRY_ARGS = {
    "walk": ("walk", [_P] + _W0, _BOTH),
    "walk_twotier": ("walk", [_P] * 2 + _W0, _BOTH),
    "walk_unpacked": ("walk", _PLANES + _W0, _BOTH),
    "walk_scored": ("walk", _SCORE + [_P] + _W0, _BOTH),
    "walk_twotier_scored": ("walk", _SCORE + [_P] * 2 + _W0, _BOTH),
    "walk_unpacked_scored": ("walk", _SCORE + _PLANES + _W0, _BOTH),
    "block_walk": ("block_walk", _W1, _BOTH),
    "twotier_block_walk": ("twotier_block_walk", _W2, _BOTH),
    "twotier_block_walk_scored": ("twotier_block_walk", _W2_SCORE + _W2,
                                  _BOTH),
    "resident_walk": (
        "resident_walk", [_P] * 15 + [_I] * 4 + [_D, _I, _P], ("f32",),
    ),
    "row_gather_take": ("row_gather", [_P] * 3 + [_I, _I, _I, _D, _P],
                        ("f32",)),
    "row_gather_take_along_axis": (
        "row_gather", [_P] * 3 + [_I, _I, _I, _D, _P], ("f32",),
    ),
    "gather_block_walk": ("gather_block_walk", _W4, _BOTH),
    "gather_block_walk_twotier": ("gather_block_walk", _W4, _BOTH),
    "gather_block_walk_scored": ("gather_block_walk", _W2_SCORE + _W4,
                                 _BOTH),
    "gather_block_walk_twotier_scored": (
        "gather_block_walk", _W2_SCORE + _W4, _BOTH,
    ),
    # W4's work list from ``done``, in slot order (no float data: one
    # entry).
    "gather_work_list": ("gather_block_walk", [_P] * 5 + [_I, _I, _P],
                         ("f32",)),
    # The deterministic commit: keys, ords, values, their count, the
    # target, its size, the host address of the plan, then the count
    # matrix's scratch, the partitioned records, the over-full count and
    # the stream.
    "det_commit": ("det_commit", [_P] * 3 + [_I, _P, _L] + [_P] * 5,
                   _BOTH),
}

launch_counts: Dict[str, int] = {entry: 0 for entry in _ENTRY_ARGS}
build_counts: Dict[str, int] = {name: 0 for name in SOURCES}
load_counts: Dict[str, int] = {name: 0 for name in SOURCES}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels are built from csrc/ at first use on the GPU machine"
        )
    return nvcc


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (SOURCES[name], *HEADERS):
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> float:
    """Compile every named library that is not built yet, one ``nvcc``
    process per source, all started together. Returns the wall seconds
    of the build (0.0 when everything was cached). Raises with nvcc's
    output when a compile fails. The ptxas report (registers, shared
    memory, spills) lands in ``<lib>.log`` beside each library."""
    todo = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return 0.0
    # Imported here: utils.profiling imports this module.
    from pumiumtally_tpu_torch.utils.profiling import span

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    failures = []
    with span("ptt.build"):
        for n, path in todo.items():
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
            procs[n] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ), tmp, path)
        for n, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            path.with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failures.append(f"{SOURCES[n]}:\n{out}")
            else:
                os.replace(tmp, path)
                build_counts[n] += 1
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The nvcc/ptxas output of the named library's build."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _library_path(name)
            if not path.exists():
                build([name])
            from pumiumtally_tpu_torch.utils.profiling import span

            with span("ptt.load"):
                lib = ctypes.CDLL(str(path))
            load_counts[name] += 1
            for entry, (lib_name, argtypes, dtypes) in _ENTRY_ARGS.items():
                if lib_name != name:
                    continue
                for dt in dtypes:
                    fn = getattr(lib, f"pumi_{entry}_{dt}")
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device pointer of a tensor (None -> a null pointer)."""
    return None if t is None else t.data_ptr()


def launch(entry: str, dtype: torch.dtype, device: torch.device,
           *args) -> None:
    """Call the C entry point ``entry`` for ``dtype`` on the current
    stream of ``device``, count the launch, and raise if the launch was
    refused."""
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    if suffix not in _ENTRY_ARGS[entry][2]:
        raise TypeError(f"CUDA kernel {entry} has no {dtype} entry")
    fn = getattr(_lib(_ENTRY_ARGS[entry][0]), f"pumi_{entry}_{suffix}")
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {entry} failed to launch: error {err}"
        )
    launch_counts[entry] += 1


def check_aligned(where: str, specs, boundary: int = 16) -> None:
    """Raise unless every (name, tensor) pair's data starts on a
    ``boundary``-byte boundary: the kernels read these tables in 16-byte
    words. ``None`` tensors are skipped."""
    for name, t in specs:
        if t is not None and t.data_ptr() % boundary:
            raise ValueError(f"{where}: {name} must start on a "
                             f"{boundary}-byte boundary")


def check_cuda_args(where: str, device: torch.device, specs) -> None:
    """Raise unless every (name, tensor, dtype, shape) spec is a
    contiguous tensor on ``device`` of that dtype and shape (``None``
    entries in ``shape`` match any size)."""
    for name, t, dtype, shape in specs:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{where}: {name} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{where}: {name} is {t.dtype}, needs {dtype}")
        if len(shape) != t.dim() or any(
            s is not None and s != d for s, d in zip(shape, t.shape)
        ):
            raise ValueError(
                f"{where}: {name} has shape {tuple(t.shape)}, needs {shape}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{where}: {name} must be contiguous")
