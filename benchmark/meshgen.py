"""The benchmark's meshes: each mesh kind a module of its own, and the
mesh cache.

A configuration's ``mesh`` names its ``kind``; the kind's generator is
``benchmark/meshes/<kind>.py``, found by that name, with ``arrays(spec)``
-> (coords [V,3] float64, tets [E,4] int32) and ``extent(spec)`` -> the
box's size (its lower corner is the origin). A new kind adds a file and
edits none.

``cached_mesh`` writes a configuration's mesh once per checkout into a
fixed directory under ``benchmark/.cache/``: the ``.osh`` directory the
program loads (written with the program's own ``write_osh``, the mesh IO
layer under test) and ``arrays.npz`` with the same coordinates and tets,
which the reference and the roofline counts read. Every later run only
reads them.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import shutil
from pathlib import Path

import numpy as np

CACHE = Path(__file__).resolve().parent / ".cache"
MESHES = Path(__file__).resolve().parent / "meshes"


def kind(name: str):
    """The module of mesh kind ``name``."""
    path = MESHES / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"unknown mesh kind {name!r}: no {path.name} "
                         f"under benchmark/meshes/")
    spec = importlib.util.spec_from_file_location(
        "benchmark_mesh_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mesh_key(spec: dict) -> str:
    return hashlib.sha256(json.dumps(spec, sort_keys=True).encode()) \
        .hexdigest()[:16]


def build_arrays(spec: dict):
    return kind(spec["kind"]).arrays(spec)


def extent(spec: dict) -> np.ndarray:
    return np.asarray(kind(spec["kind"]).extent(spec), np.float64)


def cached_mesh(spec: dict, cache: Path = CACHE) -> Path:
    """The directory holding ``mesh.osh`` and ``arrays.npz`` for
    ``spec``, generated and written on the first call in a checkout.
    The directory is written beside its final path and renamed into
    place, so a run cut short leaves no half-written mesh."""
    from pumiumtally_tpu_torch.io.osh import write_osh

    final = cache / "mesh" / f"{spec['kind']}-{mesh_key(spec)}"
    if (final / "arrays.npz").exists():
        return final
    tmp = final.with_name(final.name + f".part{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    coords, tets = build_arrays(spec)
    write_osh(str(tmp / "mesh.osh"), coords, tets)
    np.savez(tmp / "arrays.npz", coords=coords, tets=tets)
    try:
        os.rename(tmp, final)
    except OSError:
        # Another process put it in place first.
        shutil.rmtree(tmp, ignore_errors=True)
    return final


def load_arrays(directory: Path):
    with np.load(directory / "arrays.npz") as z:
        return z["coords"], z["tets"]
