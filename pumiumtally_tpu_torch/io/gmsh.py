"""Gmsh ``.msh`` reader (formats 2.2 and 4.1, ASCII and binary), tets only.
A copy of ``pumiumtally_tpu/io/gmsh.py`` (numpy only).

The reference's mesh pipeline is Gmsh → ``msh2osh`` → ``.osh``
(reference README.md:115-125); we read the Gmsh file directly and keep
an ``.osh`` reader separately for meshes already converted.
Only what the tally needs is parsed: node coordinates and 4-node
tetrahedra (Gmsh element type 4). Binary files follow the layouts in
Gmsh's MSH documentation: little/big endianness is detected from the
``$MeshFormat`` probe int; v2 stores int32 records, v4 stores size_t
(8-byte) tags with int32 block headers.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

# Node counts per Gmsh element type (type 4 = 4-node tetrahedron). The
# binary readers need these to SKIP non-tet blocks (the record stride
# depends on the node count), so the table carries the full standard
# set; a type outside it is unskippable and must error.
_NODES_PER_ELEM_TYPE = {
    1: 2, 2: 3, 3: 4, 4: 4, 5: 8, 6: 6, 7: 5, 8: 3, 9: 6, 10: 9,
    11: 10, 12: 27, 13: 18, 14: 14, 15: 1, 16: 8, 17: 20, 18: 15,
    19: 13, 20: 9, 21: 10, 22: 12, 23: 15, 24: 15, 25: 21, 26: 4,
    27: 5, 28: 6, 29: 20, 30: 35, 31: 56, 92: 64, 93: 125,
}


def _section(data: bytes, name: str) -> bytes:
    """Byte content between ``$name\\n`` and ``\\n$Endname``."""
    start_tag = b"$" + name.encode()
    p = data.find(start_tag)
    if p < 0:
        raise ValueError(f"missing ${name} section")
    p = data.find(b"\n", p) + 1
    q = data.find(b"$End" + name.encode(), p)
    if q < 0:
        raise ValueError(f"unterminated ${name} section")
    return data[p:q]


def read_gmsh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Return (coords[V,3] float64, tet2vert[E,4] int32, 0-based)."""
    with open(path, "rb") as f:
        data = f.read()
    fmt = _section(data, "MeshFormat")
    head = fmt.split(b"\n")[0].split()
    if len(head) < 3:
        raise ValueError(f"{path}: malformed $MeshFormat")
    version = float(head[0])
    file_type = int(head[1])
    if 4.0 <= version < 4.1:
        # MSH 4.0 interleaves node tags with coordinates and orders
        # block headers differently; parsing it with the 4.1 layout
        # yields garbage tags and a misleading error.
        raise ValueError(
            f"{path}: MSH format {head[0].decode()} (4.0) not supported; "
            "re-export as 4.1 or 2.2"
        )
    try:
        if file_type == 0:
            text = data.decode("utf-8", "replace")
            sections = _text_sections(text)
            if version >= 4.0:
                return _parse_v4(sections)
            return _parse_v2(sections)
        # Binary: endianness from the probe int after the format line.
        nl = fmt.find(b"\n")
        probe = fmt[nl + 1: nl + 5]
        if len(probe) < 4:
            raise ValueError(f"{path}: truncated binary $MeshFormat")
        if struct.unpack("<i", probe)[0] == 1:
            end = "<"
        elif struct.unpack(">i", probe)[0] == 1:
            end = ">"
        else:
            raise ValueError(f"{path}: cannot determine binary endianness")
        if version >= 4.0:
            return _parse_v4_binary(data, end)
        return _parse_v2_binary(data, end)
    except (IndexError, KeyError, struct.error) as e:
        # Truncated/corrupt files must fail with the documented clean
        # error, not a raw parser exception (fuzz-found: a cut ASCII
        # $Nodes line raised bare IndexError; a cut-off section raised
        # bare KeyError).
        raise ValueError(f"{path}: malformed .msh stream: {e!r}") from e


def _text_sections(text: str) -> dict:
    lines = text.splitlines()
    sections = {}
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("$") and not line.startswith("$End"):
            name = line[1:]
            j = i + 1
            while j < len(lines) and lines[j].strip() != f"$End{name}":
                j += 1
            sections[name] = lines[i + 1: j]
            i = j + 1
        else:
            i += 1
    if "MeshFormat" not in sections:
        raise ValueError("not a Gmsh mesh (no $MeshFormat)")
    return sections


def _finish(coords: np.ndarray, ids: np.ndarray, tet_ids: np.ndarray):
    """Remap 1-based/sparse node tags to dense 0-based indices."""
    if tet_ids.size == 0:
        raise ValueError("no tetrahedra (type 4) found in mesh")
    order = np.argsort(ids)
    pos = np.searchsorted(ids[order], tet_ids.reshape(-1))
    if np.any(pos >= ids.size) or np.any(
        ids[order][np.clip(pos, 0, ids.size - 1)] != tet_ids.reshape(-1)
    ):
        raise ValueError("element references unknown node tag")
    remap = order[pos].reshape(tet_ids.shape)
    return coords, remap.astype(np.int32)


# ---------------------------------------------------------------------------
# ASCII
# ---------------------------------------------------------------------------

def _check_count(n, bound, what: str) -> int:
    """Validate a count field parsed from the stream: non-negative and
    plausible against the data actually present, so a corrupt header
    raises cleanly instead of allocating gigabytes or looping forever
    (fuzz-found classes)."""
    n = int(n)
    if n < 0 or n > bound:
        raise ValueError(
            f"implausible {what} count {n} (bound {bound}) in .msh stream"
        )
    return n


def _parse_v2(sections) -> Tuple[np.ndarray, np.ndarray]:
    nodes = sections["Nodes"]
    nn = _check_count(nodes[0], len(nodes), "node")
    ids = np.empty(nn, np.int64)
    coords = np.empty((nn, 3), np.float64)
    for k in range(nn):
        parts = nodes[1 + k].split()
        ids[k] = int(parts[0])
        coords[k] = [float(parts[1]), float(parts[2]), float(parts[3])]

    elems = sections["Elements"]
    ne = _check_count(elems[0], len(elems), "element")
    tets: List[List[int]] = []
    for k in range(ne):
        parts = elems[1 + k].split()
        etype = int(parts[1])
        if etype != 4:  # 4-node tetrahedron
            continue
        ntags = int(parts[2])
        vs = parts[3 + ntags: 7 + ntags]
        tets.append([int(v) for v in vs])
    return _finish(coords, ids, np.asarray(tets, np.int64))


def _parse_v4(sections) -> Tuple[np.ndarray, np.ndarray]:
    nodes = sections["Nodes"]
    header = nodes[0].split()
    num_blocks = _check_count(header[0], len(nodes), "node block")
    nn = _check_count(header[1], len(nodes), "node")
    ids = np.empty(nn, np.int64)
    coords = np.empty((nn, 3), np.float64)
    row, k = 1, 0
    for _ in range(num_blocks):
        bh = nodes[row].split()
        nblock = _check_count(bh[3], len(nodes), "node block size")
        row += 1
        for b in range(nblock):
            ids[k + b] = int(nodes[row + b])
        row += nblock
        for b in range(nblock):
            parts = nodes[row + b].split()
            coords[k + b] = [float(parts[0]), float(parts[1]), float(parts[2])]
        row += nblock
        k += nblock

    elems = sections["Elements"]
    header = elems[0].split()
    num_blocks = _check_count(header[0], len(elems), "element block")
    row = 1
    tets: List[List[int]] = []
    for _ in range(num_blocks):
        bh = elems[row].split()
        etype = int(bh[2])
        nblock = _check_count(bh[3], len(elems), "element block size")
        row += 1
        if etype == 4:
            for b in range(nblock):
                parts = elems[row + b].split()
                tets.append([int(v) for v in parts[1:5]])
        row += nblock
    return _finish(coords, ids, np.asarray(tets, np.int64))


# ---------------------------------------------------------------------------
# Binary
# ---------------------------------------------------------------------------

def _parse_v2_binary(data: bytes, end: str) -> Tuple[np.ndarray, np.ndarray]:
    sec = _section(data, "Nodes")
    nl = sec.find(b"\n")
    rec = np.dtype([("id", end + "i4"), ("xyz", end + "f8", (3,))])
    nn = _check_count(sec[:nl], len(sec) // rec.itemsize, "node")
    body = sec[nl + 1: nl + 1 + nn * rec.itemsize]
    nodes = np.frombuffer(body, dtype=rec, count=nn)
    ids = nodes["id"].astype(np.int64)
    coords = np.asarray(nodes["xyz"], np.float64)

    sec = _section(data, "Elements")
    nl = sec.find(b"\n")
    ne = _check_count(sec[:nl], len(sec) // 4, "element")
    off = nl + 1
    i4 = np.dtype(end + "i4")
    tets: List[np.ndarray] = []
    seen = 0
    while seen < ne:
        etype, nfollow, ntags = struct.unpack_from(end + "iii", sec, off)
        off += 12
        if etype not in _NODES_PER_ELEM_TYPE:
            raise ValueError(f"unsupported binary v2 element type {etype}")
        npn = _NODES_PER_ELEM_TYPE[etype]
        nfollow = _check_count(nfollow, (len(sec) - off) // 4, "block")
        ntags = _check_count(ntags, 1024, "tag")
        if nfollow == 0:
            # Spec-legal empty block: skip it. A pathological stream of
            # endless empty blocks still terminates — off advances 12
            # bytes per header until unpack_from runs out of section
            # and raises (wrapped into the clean ValueError).
            continue
        stride = 1 + ntags + npn
        block = np.frombuffer(
            sec, dtype=i4, count=nfollow * stride, offset=off
        ).reshape(nfollow, stride)
        off += nfollow * stride * 4
        if etype == 4:
            tets.append(block[:, 1 + ntags:].astype(np.int64))
        seen += nfollow
    all_tets = (
        np.concatenate(tets, axis=0) if tets else np.zeros((0, 4), np.int64)
    )
    return _finish(coords, ids, all_tets)


def _parse_v4_binary(data: bytes, end: str) -> Tuple[np.ndarray, np.ndarray]:
    sec = _section(data, "Nodes")
    off = 0
    num_blocks, nn, _minT, _maxT = struct.unpack_from(end + "4q", sec, off)
    off += 32
    num_blocks = _check_count(num_blocks, len(sec) // 20, "node block")
    nn = _check_count(nn, len(sec) // 32, "node")
    ids = np.empty(nn, np.int64)
    coords = np.empty((nn, 3), np.float64)
    k = 0
    for _ in range(num_blocks):
        _dim, _tag, parametric, nblock = struct.unpack_from(
            end + "iiiq", sec, off
        )
        off += 20
        if parametric:
            raise ValueError("parametric nodes not supported")
        nblock = _check_count(nblock, (len(sec) - off) // 32, "node block size")
        ids[k: k + nblock] = np.frombuffer(
            sec, dtype=end + "i8", count=nblock, offset=off
        )
        off += 8 * nblock
        coords[k: k + nblock] = np.frombuffer(
            sec, dtype=end + "f8", count=3 * nblock, offset=off
        ).reshape(nblock, 3)
        off += 24 * nblock
        k += nblock

    sec = _section(data, "Elements")
    off = 0
    num_blocks, _ne, _minT, _maxT = struct.unpack_from(end + "4q", sec, off)
    off += 32
    num_blocks = _check_count(num_blocks, len(sec) // 20, "element block")
    tets: List[np.ndarray] = []
    for _ in range(num_blocks):
        _dim, _tag, etype, nblock = struct.unpack_from(end + "iiiq", sec, off)
        off += 20
        if etype not in _NODES_PER_ELEM_TYPE:
            raise ValueError(f"unsupported binary v4 element type {etype}")
        stride = 1 + _NODES_PER_ELEM_TYPE[etype]
        nblock = _check_count(
            nblock, (len(sec) - off) // (8 * stride), "element block size"
        )
        block = np.frombuffer(
            sec, dtype=end + "i8", count=nblock * stride, offset=off
        ).reshape(nblock, stride)
        off += 8 * nblock * stride
        if etype == 4:
            tets.append(block[:, 1:].astype(np.int64))
    all_tets = (
        np.concatenate(tets, axis=0) if tets else np.zeros((0, 4), np.int64)
    )
    return _finish(coords, ids, all_tets)


def write_gmsh(
    path: str,
    coords: np.ndarray,
    tet2vert: np.ndarray,
    physical: np.ndarray | None = None,
) -> None:
    """Write a Gmsh MSH 2.2 ASCII file (tets only, 1-based node ids).

    The inverse of the v2 reader above — lets the mesh generators emit
    ``.msh`` for Gmsh-toolchain interop (the reference consumes Gmsh
    output, README.md:115-125; this writer produces it). ``physical``
    optionally carries a per-element integer id into the standard
    physical-group tag (how Gmsh meshes carry material classification).
    """
    coords = np.asarray(coords, np.float64)
    tets = np.asarray(tet2vert, np.int64) + 1
    phys = (
        np.zeros(tets.shape[0], np.int64)
        if physical is None
        else np.asarray(physical, np.int64).reshape(-1)
    )
    if phys.shape[0] != tets.shape[0]:
        raise ValueError(
            f"physical has {phys.shape[0]} values for {tets.shape[0]} tets"
        )
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat",
             "$Nodes", str(coords.shape[0])]
    lines.extend(
        f"{i + 1} {x!r} {y!r} {z!r}"
        for i, (x, y, z) in enumerate(coords.tolist())
    )
    lines.extend(["$EndNodes", "$Elements", str(tets.shape[0])])
    lines.extend(
        f"{i + 1} 4 2 {int(p)} {int(p)} {a} {b} {c} {d}"
        for i, ((a, b, c, d), p) in enumerate(zip(tets.tolist(), phys.tolist()))
    )
    lines.extend(["$EndElements", ""])
    with open(path, "w") as f:
        f.write("\n".join(lines))
