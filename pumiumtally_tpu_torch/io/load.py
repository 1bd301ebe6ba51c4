"""Mesh loading dispatch (.msh Gmsh / .osh Omega_h), the port of
``pumiumtally_tpu/io/load.py``.

The reference constructor takes an ``.osh`` path
(reference PumiTally.h:45-47, Omega_h::binary::read at
PumiTallyImpl.cpp:562); its README's tool flow converts Gmsh meshes with
``msh2osh`` (README.md:115-125). We accept both formats directly.
"""

from __future__ import annotations

from typing import Optional

import torch

from pumiumtally_tpu_torch.mesh.tetmesh import TetMesh


def load_mesh(path: str, dtype: Optional[torch.dtype] = None) -> TetMesh:
    p = path.rstrip("/")
    if p.endswith(".msh"):
        from pumiumtally_tpu_torch.io.gmsh import read_gmsh

        coords, tets = read_gmsh(p)
    elif p.endswith(".osh"):
        from pumiumtally_tpu_torch.io.osh import read_osh

        coords, tets = read_osh(p)
    else:
        raise ValueError(
            f"unsupported mesh format: {path!r} (expected .msh or .osh)"
        )
    return TetMesh.from_arrays(coords, tets, dtype=dtype)
