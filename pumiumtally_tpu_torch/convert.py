"""Carry state across packages as numpy arrays.

The JAX package's objects and the port's hold the same quantities in the
same layouts; these functions read either package's object into a dict
of host numpy arrays (duck-typed: anything ``np.asarray`` can read, so
no JAX import here) and build the port's object from such a dict:

- a ``TetMesh``: coords, tet2vert, face_normals, face_offsets, face_adj,
  volumes, walk_table;
- a ``MeshPartition``: the block tables and the id maps;
- a facade: its particle state and flux (``PumiTally``: x, elem, flux;
  ``PartitionedPumiTally``: every engine slot row plus the padded flux).

Tests build an input once, hand it to both packages through here, and
compare what comes out.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from pumiumtally_tpu_torch.mesh.tetmesh import (
    WALK_TABLE_ADJ,
    WALK_TABLE_NORMALS,
    WALK_TABLE_OFFSETS,
    WALK_TABLE_WIDTH,
    TetMesh,
)
from pumiumtally_tpu_torch.parallel.partition import MeshPartition

MESH_KEYS = ("coords", "tet2vert", "face_normals", "face_offsets",
             "face_adj", "volumes", "walk_table")
PARTITION_KEYS = ("ndev", "nelems", "L", "owner", "glid_of_orig",
                  "orig_of_glid", "table")


def host(a) -> np.ndarray:
    """A host numpy copy of a torch tensor, a JAX array or an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def mesh_arrays(mesh) -> Dict[str, np.ndarray]:
    """A TetMesh of either package as host arrays."""
    return {k: host(getattr(mesh, k)) for k in MESH_KEYS}


def tetmesh_from_arrays(arrays: Dict[str, Any],
                        dtype: Optional[torch.dtype] = None,
                        device: Any = "cpu") -> TetMesh:
    """The port's TetMesh from ``mesh_arrays``-style host arrays.

    The walk table is reassembled in float64 from the planes and the
    integer adjacency, so neighbour ids stay exact in any dtype."""
    coords = np.asarray(arrays["coords"])
    if dtype is None:
        dtype = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}[coords.dtype]
    adj = np.asarray(arrays["face_adj"], dtype=np.int32)
    ne = adj.shape[0]
    table = np.empty((ne, WALK_TABLE_WIDTH), dtype=np.float64)
    table[:, WALK_TABLE_NORMALS] = np.asarray(
        arrays["face_normals"], dtype=np.float64).reshape(ne, 12)
    table[:, WALK_TABLE_OFFSETS] = np.asarray(arrays["face_offsets"],
                                              dtype=np.float64)
    table[:, WALK_TABLE_ADJ] = adj
    return TetMesh.from_numpy(coords, arrays["tet2vert"], adj,
                              arrays["volumes"], table, dtype=dtype,
                              device=device)


def partition_arrays(part) -> Dict[str, Any]:
    """A MeshPartition of either package as host values."""
    out = {k: host(getattr(part, k)) for k in PARTITION_KEYS}
    for k in ("ndev", "nelems", "L"):
        out[k] = int(out[k])
    return out


def partition_from_arrays(arrays: Dict[str, Any],
                          device: Any = "cpu") -> MeshPartition:
    """The port's MeshPartition from ``partition_arrays`` values (the
    table's local-encoded adjacency floats are exact in its dtype)."""
    table = host(arrays["table"])
    dtype = {np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64}[table.dtype]

    def ids(k):
        return torch.tensor(np.asarray(arrays[k], dtype=np.int32),
                            device=device)

    return MeshPartition(
        ndev=int(arrays["ndev"]), nelems=int(arrays["nelems"]),
        L=int(arrays["L"]), owner=np.asarray(arrays["owner"], np.int32),
        glid_of_orig=ids("glid_of_orig"), orig_of_glid=ids("orig_of_glid"),
        table=torch.tensor(table, dtype=dtype, device=device),
    )


def facade_state(tally) -> Dict[str, np.ndarray]:
    """A facade's particle state and flux as host arrays: the engine's
    slot rows plus ``flux_padded`` for a partitioned facade, else
    ``x``, ``elem`` and ``flux``."""
    engine = getattr(tally, "engine", None)
    if engine is not None:
        out = {k: host(v) for k, v in engine.state.items()}
        out["flux_padded"] = host(engine.flux_padded)
        return out
    return {"x": host(tally.x), "elem": host(tally.elem),
            "flux": host(tally.flux)}


def load_facade_state(tally, arrays: Dict[str, np.ndarray]) -> None:
    """Overwrite a port facade's particle state and flux with
    ``facade_state`` arrays (of the same facade kind and capacity) and
    mark it initialized, so a campaign can continue in the port from
    where the other package left it."""
    dev = tally.device

    def t(a, dtype):
        return torch.tensor(np.asarray(a), device=dev).to(dtype)

    engine = getattr(tally, "engine", None)
    if engine is not None:
        for k, v in engine.state.items():
            engine.state[k] = t(arrays[k], v.dtype).reshape(v.shape)
        engine.flux_padded = t(arrays["flux_padded"], tally.dtype)
        engine.n_lost = int(np.sum(arrays["lost"]))
    else:
        tally.x = t(arrays["x"], tally.dtype).reshape(-1, 3)
        tally.elem = t(arrays["elem"], torch.int32)
        tally.flux = t(arrays["flux"], tally.dtype)
    tally.is_initialized = True
