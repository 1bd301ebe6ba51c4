"""VTK writers for tet meshes with cell data: legacy ``.vtk`` (binary
by default, ASCII on request) and XML ``.vtu`` (raw-appended binary).

Replaces ``Omega_h::vtk::write_parallel`` (reference
PumiTallyImpl.cpp:415). The reference writes Omega_h's ``.vtu`` piece
directory; we write either a single legacy-format ``.vtk`` file or a
single ``.vtu`` — both readable by ParaView/VisIt — carrying the same
payload: the mesh plus "flux" and "volume" cell arrays (reference tags
added at PumiTallyImpl.cpp:407,414).

Binary is the default because ASCII ``np.savetxt`` does not scale: a
1M-tet mesh is ~300 MB of text and minutes of formatting, vs seconds
for the raw-bytes paths (VERDICT round-1, "rank-aware / scalable
output").
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Optional

import numpy as np


def _prep(path, coords, tet2vert):
    coords = np.asarray(coords, dtype=np.float64)
    tet2vert = np.asarray(tet2vert, dtype=np.int64)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return coords, tet2vert


def _xml_name(name: str) -> str:
    """Escape a data-array name for interpolation into an XML attribute
    (a name containing '"', '<' or '&' would otherwise produce a file
    every reader rejects)."""
    from xml.sax.saxutils import escape

    return escape(name, {'"': "&quot;"})


def _check_len(name: str, arr: np.ndarray, n: int, kind: str) -> np.ndarray:
    arr = np.asarray(arr, dtype=np.float64).reshape(-1)
    if arr.shape[0] != n:
        raise ValueError(
            f"{kind} data {name!r} has {arr.shape[0]} values, need {n}"
        )
    return arr


def stats_cell_data(stats, volumes: np.ndarray) -> Dict[str, np.ndarray]:
    """Optional batch-statistics cell arrays for the tally writers
    (``stats`` is a ``stats.BatchStatistics`` whose fields numpy can
    read: host tensors or arrays):

    - ``flux_mean``: per-batch mean flux, volume-normalized exactly
      like the ``flux`` array (so flux == flux_mean * num_batches for
      a run whose batches all closed) — present from 1 closed batch;
    - ``rel_err``: relative error of the mean (dimensionless;
      volume normalization cancels) — present from 2 closed batches
      (the sample variance needs them). Unscored elements (zero mean,
      estimator ``inf``) write 0.0: the OpenMC statepoint convention,
      and a file of infs breaks most readers' color mapping.

    Returns {} when stats is None or has no closed batch, keeping the
    default payload byte-identical to the reference's flux+volume
    layout.
    """
    out: Dict[str, np.ndarray] = {}
    if stats is None or stats.num_batches < 1:
        return out
    vol = np.asarray(volumes, dtype=np.float64)
    out["flux_mean"] = np.asarray(stats.mean, dtype=np.float64) / vol
    if stats.num_batches >= 2:
        re = np.asarray(stats.rel_err, dtype=np.float64)
        out["rel_err"] = np.where(np.isfinite(re), re, 0.0)
    return out


def merge_cell_data(*groups: Optional[Dict[str, np.ndarray]]) -> dict:
    """Merge cell-data dicts for the tally writers, REFUSING name
    collisions: a plain ``{**a, **b}`` silently lets a later group
    shadow an earlier one — a scoring lane named ``flux_mean`` would
    overwrite the statistics array and the file would carry wrong data
    under a trusted name. Raises a ValueError naming the colliding
    array and both groups' positions instead. ``None`` groups are
    skipped."""
    out: dict = {}
    owner: dict = {}
    for gi, g in enumerate(groups):
        if not g:
            continue
        for name, arr in g.items():
            if name in out:
                raise ValueError(
                    f"cell-data array name collision: {name!r} appears "
                    f"in payload group {owner[name]} and again in group "
                    f"{gi} — rename one (a silent overwrite would ship "
                    "wrong data under a trusted array name)"
                )
            out[name] = arr
            owner[name] = gi
    return out


def health_field_data(report) -> Dict[str, np.ndarray]:
    """Sentinel health report as VTK FIELD arrays (``report`` is a
    ``pumiumtally_tpu.sentinel.HealthReport``): campaign-level scalars
    — audited/anomalous move counts, the anomaly-mask union, the worst
    conservation residual, straggler and overflow ladder outcomes —
    riding the same FIELD block as ``lost_particles`` in every writer
    (legacy leading FIELD, .vtu <FieldData>, every .pvtu piece), so a
    result file carries its own health record. Returns {} for None,
    keeping sentinel-off files byte-identical."""
    if report is None:
        return {}
    return report.as_field_data()


def write_vtk(
    path: str,
    coords: np.ndarray,
    tet2vert: np.ndarray,
    cell_data: Optional[Dict[str, np.ndarray]] = None,
    point_data: Optional[Dict[str, np.ndarray]] = None,
    title: str = "pumiumtally_tpu flux result",
    ascii: bool = False,  # noqa: A002 — matches the VTK keyword
    field_data: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Write a legacy ``.vtk`` unstructured grid. Dispatches to the XML
    ``.vtu`` writer when ``path`` ends in ``.vtu``.

    Binary mode (default) emits the legacy BINARY encoding: the usual
    ASCII headers with big-endian raw payloads — seconds for a 1M-tet
    mesh. ``ascii=True`` restores the all-text variant.

    ``field_data`` holds DATASET-level scalar arrays (campaign
    metadata such as ``lost_particles`` — arbitrary length, not tied
    to cell/point counts); written as a leading ``FIELD FieldData``
    block in the legacy format and a ``<FieldData>`` element in
    ``.vtu``.
    """
    if path.endswith(".pvtu"):
        raise ValueError(
            ".pvtu (multi-piece parallel) output needs per-element "
            "ownership — use write_pvtu, or WriteTallyResults on a "
            "PartitionedPumiTally"
        )
    if path.endswith(".vtu"):
        if ascii:
            raise ValueError(
                ".vtu output is always raw-appended binary; use a .vtk "
                "path for the ASCII legacy format"
            )
        write_vtu(path, coords, tet2vert, cell_data, point_data,
                  title=title, field_data=field_data)
        return
    coords, tet2vert = _prep(path, coords, tet2vert)
    nv, ne = coords.shape[0], tet2vert.shape[0]
    cells = np.hstack([np.full((ne, 1), 4, dtype=np.int64), tet2vert])
    with open(path, "wb") as f:
        def w(s: str) -> None:
            f.write(s.encode("ascii"))

        w("# vtk DataFile Version 3.0\n")
        w(title + "\n")
        w(("ASCII" if ascii else "BINARY") + "\n")
        if field_data:
            # Dataset field data leads the geometry (the placement
            # vtkDataReader attaches to the dataset itself).
            w(f"FIELD FieldData {len(field_data)}\n")
            for name, arr in field_data.items():
                arr = np.asarray(arr, dtype=np.float64).reshape(-1)
                w(f"{name} 1 {arr.shape[0]} double\n")
                if ascii:
                    np.savetxt(f, arr, fmt="%.17g")
                else:
                    f.write(arr.astype(">f8").tobytes())
                    w("\n")
        w("DATASET UNSTRUCTURED_GRID\n")
        w(f"POINTS {nv} double\n")
        if ascii:
            np.savetxt(f, coords, fmt="%.17g")
        else:
            f.write(coords.astype(">f8").tobytes())
            w("\n")
        w(f"CELLS {ne} {ne * 5}\n")
        if ascii:
            np.savetxt(f, cells, fmt="%d")
        else:
            f.write(cells.astype(">i4").tobytes())
            w("\n")
        w(f"CELL_TYPES {ne}\n")
        if ascii:
            np.savetxt(f, np.full(ne, 10, dtype=np.int64), fmt="%d")
        else:
            f.write(np.full(ne, 10, dtype=">i4").tobytes())  # VTK_TETRA
            w("\n")
        for kind, n, data in (
            ("CELL_DATA", ne, cell_data), ("POINT_DATA", nv, point_data)
        ):
            if not data:
                continue
            w(f"{kind} {n}\n")
            for name, arr in data.items():
                arr = _check_len(name, arr, n, kind)
                w(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                if ascii:
                    np.savetxt(f, arr, fmt="%.17g")
                else:
                    f.write(arr.astype(">f8").tobytes())
                    w("\n")


def write_vtu(
    path: str,
    coords: np.ndarray,
    tet2vert: np.ndarray,
    cell_data: Optional[Dict[str, np.ndarray]] = None,
    point_data: Optional[Dict[str, np.ndarray]] = None,
    title: str = "pumiumtally_tpu flux result",
    field_data: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Write an XML ``.vtu`` UnstructuredGrid with raw appended binary
    data (the same file family Omega_h's vtk::write_parallel emits as
    pieces, reference PumiTallyImpl.cpp:415), little-endian, UInt64
    headers — loadable by ParaView/VisIt/meshio."""
    coords, tet2vert = _prep(path, coords, tet2vert)
    nv, ne = coords.shape[0], tet2vert.shape[0]

    blocks: list = []  # (xml name, DataArray attrs, bytes)

    def add(name: str, arr: np.ndarray, vtype: str, ncomp: int) -> int:
        blocks.append((name, vtype, ncomp, np.ascontiguousarray(arr).tobytes()))
        return len(blocks) - 1

    add("Points", coords.astype("<f8"), "Float64", 3)
    add("connectivity", tet2vert.astype("<i8").reshape(-1), "Int64", 1)
    add("offsets", (4 * np.arange(1, ne + 1, dtype="<i8")), "Int64", 1)
    add("types", np.full(ne, 10, dtype="<u1"), "UInt8", 1)
    cell_names, point_names, field_names = [], [], []
    for name, arr in (cell_data or {}).items():
        cell_names.append(name)
        add(name, _check_len(name, arr, ne, "cell").astype("<f8"),
            "Float64", 1)
    for name, arr in (point_data or {}).items():
        point_names.append(name)
        add(name, _check_len(name, arr, nv, "point").astype("<f8"),
            "Float64", 1)
    for name, arr in (field_data or {}).items():
        field_names.append(name)
        add(name,
            np.asarray(arr, dtype=np.float64).reshape(-1).astype("<f8"),
            "Float64", 1)

    offsets = []
    off = 0
    for _, _, _, payload in blocks:
        offsets.append(off)
        off += 8 + len(payload)  # UInt64 byte-count header + payload

    def da(i: int, extra: str = "") -> str:
        name, vtype, ncomp, _ = blocks[i]
        comps = f' NumberOfComponents="{ncomp}"' if ncomp > 1 else ""
        return (
            f'<DataArray type="{vtype}" Name="{_xml_name(name)}"{comps} '
            f'format="appended" offset="{offsets[i]}"{extra}/>'
        )

    xml: list = []
    xml.append('<?xml version="1.0"?>')
    safe_title = title
    while "--" in safe_title:  # XML forbids '--' inside comments
        safe_title = safe_title.replace("--", "- -")
    xml.append(f"<!-- {safe_title} -->")
    xml.append(
        '<VTKFile type="UnstructuredGrid" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt64">'
    )
    xml.append("<UnstructuredGrid>")
    if field_names:
        # Dataset-level field data (campaign metadata): lives on the
        # grid, outside any piece.
        xml.append("<FieldData>")
        nfield = 4 + len(cell_names) + len(point_names)
        for j, name in enumerate(field_names):
            i = nfield + j
            ntup = len(blocks[i][3]) // 8
            xml.append(da(i, extra=f' NumberOfTuples="{ntup}"'))
        xml.append("</FieldData>")
    xml.append(f'<Piece NumberOfPoints="{nv}" NumberOfCells="{ne}">')
    xml.append("<Points>")
    xml.append(da(0))
    xml.append("</Points>")
    xml.append("<Cells>")
    xml.append(da(1))
    xml.append(da(2))
    xml.append(da(3))
    xml.append("</Cells>")
    idx = 4
    xml.append("<CellData>")
    for _ in cell_names:
        xml.append(da(idx))
        idx += 1
    xml.append("</CellData>")
    xml.append("<PointData>")
    for _ in point_names:
        xml.append(da(idx))
        idx += 1
    xml.append("</PointData>")
    xml.append("</Piece>")
    xml.append("</UnstructuredGrid>")
    xml.append('<AppendedData encoding="raw">')
    with open(path, "wb") as f:
        f.write("\n".join(xml).encode())
        f.write(b"\n_")
        for _, _, _, payload in blocks:
            f.write(struct.pack("<Q", len(payload)))
            f.write(payload)
        f.write(b"\n</AppendedData>\n</VTKFile>\n")


def write_pvtu(
    path: str,
    coords: np.ndarray,
    tet2vert: np.ndarray,
    owner: np.ndarray,
    cell_data: Optional[Dict[str, np.ndarray]] = None,
    title: str = "pumiumtally_tpu flux result",
    nparts: Optional[int] = None,
    field_data: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Parallel multi-piece output: one raw-appended ``.vtu`` per owner
    rank plus a ``.pvtu`` index referencing them — the TPU-native
    analogue of the reference's rank-aware ``Omega_h::vtk::write_parallel``
    (reference PumiTallyImpl.cpp:415). Each piece holds the elements a
    chip owns (with its vertices reindexed locally) and that chip's
    slice of every cell-data array, so a 1M-tet partitioned result
    writes as ndev independent pieces instead of one monolithic file.
    """
    if not path.endswith(".pvtu"):
        raise ValueError(f"write_pvtu needs a .pvtu path, got {path!r}")
    coords = np.asarray(coords, np.float64)
    tet2vert = np.asarray(tet2vert, np.int64)
    ne = tet2vert.shape[0]
    owner = np.asarray(owner, np.int64).reshape(-1)
    if owner.shape[0] != ne:
        raise ValueError(
            f"owner has {owner.shape[0]} entries for {ne} elements"
        )
    if ne and owner.min() < 0:
        raise ValueError(
            "owner ids must be non-negative: every element needs a "
            "piece (-1 sentinels would be silently dropped)"
        )
    cell_data = {
        name: _check_len(name, np.asarray(arr), ne, "cell")
        for name, arr in (cell_data or {}).items()
    }
    # Explicit nparts keeps one piece per RANK even when the trailing
    # ranks own zero elements (consumers enumerate pieces per rank).
    inferred = int(owner.max()) + 1 if ne else 1
    if nparts is None:
        nparts = inferred
    elif nparts < inferred:
        raise ValueError(
            f"nparts={nparts} but owner ids reach {inferred - 1}"
        )

    base = os.path.basename(path)[: -len(".pvtu")]
    outdir = os.path.dirname(os.path.abspath(path))
    piece_files = []
    for r in range(nparts):
        sel = np.flatnonzero(owner == r)
        tets_r = tet2vert[sel]
        verts_r = np.unique(tets_r)
        local = np.full(coords.shape[0], -1, np.int64)
        local[verts_r] = np.arange(verts_r.shape[0])
        piece = f"{base}_p{r}.vtu"
        piece_files.append(piece)
        write_vtu(
            os.path.join(outdir, piece),
            coords[verts_r],
            local[tets_r],
            cell_data={k: v[sel] for k, v in cell_data.items()},
            title=f"{title} (piece {r}/{nparts})",
            # Field data is dataset-global (not per-cell): replicated
            # into every piece so any single piece accounts for the
            # whole campaign.
            field_data=field_data,
        )

    xml = ['<?xml version="1.0"?>']
    xml.append(
        '<VTKFile type="PUnstructuredGrid" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt64">'
    )
    xml.append('<PUnstructuredGrid GhostLevel="0">')
    xml.append("<PPoints>")
    xml.append('<PDataArray type="Float64" Name="Points" NumberOfComponents="3"/>')
    xml.append("</PPoints>")
    xml.append("<PCellData>")
    for name in cell_data:
        xml.append(f'<PDataArray type="Float64" Name="{_xml_name(name)}"/>')
    xml.append("</PCellData>")
    for piece in piece_files:
        xml.append(f'<Piece Source="{piece}"/>')
    xml.append("</PUnstructuredGrid>")
    xml.append("</VTKFile>")
    with open(path, "w") as f:
        f.write("\n".join(xml) + "\n")


# ---------------------------------------------------------------------------
# Round-trip readers (tests + downstream tooling)
# ---------------------------------------------------------------------------

def read_vtk_cell_scalars(path: str, name: str) -> np.ndarray:
    """Pull one cell scalar array from a legacy ``.vtk`` (ASCII or
    BINARY) or ``.vtu`` file written by this module."""
    if path.endswith(".vtu"):
        return _read_vtu_array(path, name)
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"\n", data.find(b"\n") + 1)
    mode_line = data[header_end + 1: data.find(b"\n", header_end + 1)]
    if mode_line.strip() == b"ASCII":
        return _read_vtk_ascii_scalars(data.decode(), name)
    return _read_vtk_binary_scalars(data, name)


def _clean_errors(fn):
    """Truncated/corrupt files must fail with ValueError/KeyError, not
    raw parser exceptions (fuzz-found: IndexError from a cut ASCII
    stream, struct.error from a cut .vtu header, and a silently SHORT
    binary array)."""
    import functools

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        try:
            return fn(*a, **kw)
        except (IndexError, struct.error) as e:
            raise ValueError(f"malformed VTK stream: {e!r}") from e

    return wrapped


def read_vtk_field_scalars(path: str, name: str) -> np.ndarray:
    """Pull one dataset-level FIELD array (see ``write_vtk``'s
    ``field_data``) from a legacy ``.vtk`` (ASCII or BINARY) or
    ``.vtu`` file written by this module."""
    if path.endswith(".vtu"):
        return _read_vtu_array(path, name)
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"\n", data.find(b"\n") + 1)
    mode_line = data[header_end + 1: data.find(b"\n", header_end + 1)]
    return _read_vtk_field(data, name, ascii=mode_line.strip() == b"ASCII")


@_clean_errors
def _read_vtk_field(data: bytes, name: str, ascii: bool) -> np.ndarray:  # noqa: A002
    """Sequentially parse the leading ``FIELD FieldData`` block (each
    array must be walked to find the next one's header)."""
    marker = b"FIELD FieldData "
    p = data.find(marker)
    if p < 0:
        raise KeyError(f"field array {name!r} not found (no FIELD block)")
    eol = data.find(b"\n", p)
    narrays = int(data[p + len(marker): eol])
    pos = eol + 1
    for _ in range(narrays):
        eol = data.find(b"\n", pos)
        if eol < 0:
            raise ValueError("truncated FIELD array header")
        aname, ncomp, ntup, _dtype = data[pos:eol].decode("ascii").split()
        count = int(ncomp) * int(ntup)
        pos = eol + 1
        if ascii:
            vals: list = []
            while len(vals) < count:
                eol = data.find(b"\n", pos)
                if eol < 0:
                    raise ValueError("truncated FIELD ASCII values")
                vals.extend(float(v) for v in data[pos:eol].split())
                pos = eol + 1
            if aname == name:
                return np.array(vals[:count])
        else:
            payload = data[pos: pos + 8 * count]
            if len(payload) != 8 * count:
                raise ValueError(
                    f"truncated FIELD binary values for {aname!r}"
                )
            pos += 8 * count + 1  # trailing newline after the payload
            if aname == name:
                return np.frombuffer(payload, dtype=">f8").astype(
                    np.float64
                )
    raise KeyError(f"field array {name!r} not found")


@_clean_errors
def _read_vtk_ascii_scalars(text: str, name: str) -> np.ndarray:
    lines = text.splitlines()
    ncells = None
    for i, line in enumerate(lines):
        if line.startswith("CELL_DATA"):
            ncells = int(line.split()[1])
        if line.startswith(f"SCALARS {name} ") and ncells is not None:
            vals: list = []
            j = i + 2  # skip LOOKUP_TABLE line
            while len(vals) < ncells:
                vals.extend(float(v) for v in lines[j].split())
                j += 1
            if j - 1 == len(lines) - 1 and not text.endswith("\n"):
                # The final value came from a line with no trailing
                # newline: a truncation can cut digits off a number
                # that still parses ('47' -> '4') and is then
                # indistinguishable from real data. DELIBERATE
                # strictness: a complete third-party file that merely
                # lacks its final newline is rejected too — append one
                # to load it; silent corruption is the worse failure.
                raise ValueError(
                    "ASCII scalars end on an unterminated line — "
                    "truncated file? (if the file is complete, append "
                    "a trailing newline)"
                )
            return np.array(vals[:ncells])
    raise KeyError(f"cell scalar {name!r} not found")


@_clean_errors
def _read_vtk_binary_scalars(data: bytes, name: str) -> np.ndarray:
    marker = b"CELL_DATA "
    p = data.find(marker)
    if p < 0:
        raise KeyError(f"cell scalar {name!r} not found (no CELL_DATA)")
    eol = data.find(b"\n", p)
    ncells = int(data[p + len(marker): eol])
    tag = f"SCALARS {name} ".encode()
    q = data.find(tag, p)
    if q < 0:
        raise KeyError(f"cell scalar {name!r} not found")
    # Skip the SCALARS line and the LOOKUP_TABLE line — each newline
    # must exist (find() returning -1 would silently rewind start to
    # offset 0 and parse header bytes as data).
    nl1 = data.find(b"\n", q)
    if nl1 < 0:
        raise ValueError("truncated SCALARS header line")
    nl2 = data.find(b"\n", nl1 + 1)
    if nl2 < 0:
        raise ValueError("truncated LOOKUP_TABLE line")
    start = nl2 + 1
    payload = data[start: start + 8 * ncells]
    if len(payload) != 8 * ncells:
        raise ValueError(
            f"truncated binary scalars: {len(payload)} bytes for "
            f"{ncells} cells"
        )
    return np.frombuffer(payload, dtype=">f8").astype(np.float64)


@_clean_errors
def _read_vtu_array(path: str, name: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    tag = f'Name="{_xml_name(name)}"'.encode()
    p = data.find(tag)
    if p < 0:
        raise KeyError(f"array {name!r} not found in {path}")
    # Parse the offset attribute from THIS DataArray element.
    off_tag = b'offset="'
    elem_start = data.rfind(b"<DataArray", 0, p)
    elem_end = data.find(b"/>", p)
    elem = data[elem_start:elem_end]
    o = elem.find(off_tag)
    offset = int(elem[o + len(off_tag): elem.find(b'"', o + len(off_tag))])
    base = data.find(b'<AppendedData encoding="raw">')
    if base < 0:
        raise ValueError("no raw AppendedData section in .vtu")
    base = data.find(b"_", base) + 1
    nbytes = struct.unpack("<Q", data[base + offset: base + offset + 8])[0]
    start = base + offset + 8
    payload = data[start: start + nbytes]
    if len(payload) != nbytes:
        raise ValueError(
            f"truncated .vtu payload: {len(payload)} of {nbytes} bytes"
        )
    return np.frombuffer(payload, dtype="<f8").copy()
