"""Carry state across packages as numpy arrays.

The JAX package's objects and the port's hold the same quantities in the
same layouts; these functions read either package's object into a dict
of host numpy arrays (duck-typed: anything ``np.asarray`` can read, so
no JAX import here) and build the port's object from such a dict:

- a ``TetMesh``: coords, tet2vert, face_normals, face_offsets, face_adj,
  volumes, and its walk tables: walk_table, or the two-tier
  walk_table_lo (as its uint16 bit pattern) and walk_table_hi, or
  neither (the unpacked layout: the planes and face_adj are the walk's
  arrays);
- a ``MeshPartition``: the block tables (``table_hi`` too when two-tier;
  a bf16 ``table`` as its uint16 bits; ``adj_int`` where the partition
  has the int32 adjacency sidecar) and the id maps;
- a facade: its particle state and flux (``PumiTally``: x, elem, flux;
  ``PartitionedPumiTally``: every engine slot row, ``sbin``/``sfac``
  included, plus the padded flux; the partition, its sidecar included,
  is the engine's own and is rebuilt, never carried), its scoring bank (``score_bank``, or
  the engine's ``score_padded``) and its statistics lanes
  (``stats_*`` over the flux, ``sstats_*`` over the bank: the JAX
  checkpoint's names);
- a ``TallyConfig``: the fields both packages have (``tally_config``),
  a JAX ``ScoringSpec``, ``TriggerSpec``, ``SentinelPolicy`` and
  ``CheckpointPolicy`` turned into the port's.

Checkpoints need no conversion: both packages read and write the same
``.npz`` format (utils/checkpoint.py).

Tests build an input once, hand it to both packages through here, and
compare what comes out. A bf16 tensor crosses as its uint16 bit pattern:
numpy has no bf16 of its own (JAX's comes from ``ml_dtypes``, which the
port never imports) and ``torch.from_numpy`` refuses JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from pumiumtally_tpu_torch.config import ROADMAP_MULTI_DEVICE, TallyConfig
from pumiumtally_tpu_torch.mesh.tetmesh import (
    WALK_TABLE_ADJ,
    WALK_TABLE_NORMALS,
    WALK_TABLE_OFFSETS,
    WALK_TABLE_WIDTH,
    TetMesh,
)
from pumiumtally_tpu_torch.parallel.partition import MeshPartition
from pumiumtally_tpu_torch.resilience.policy import CheckpointPolicy
from pumiumtally_tpu_torch.scoring import (
    EnergyFilter,
    ScoringSpec,
    TimeFilter,
)
from pumiumtally_tpu_torch.sentinel.policy import SentinelPolicy
from pumiumtally_tpu_torch.stats import TriggerSpec

MESH_KEYS = ("coords", "tet2vert", "face_normals", "face_offsets",
             "face_adj", "volumes", "walk_table")
TWO_TIER_KEYS = ("walk_table_lo", "walk_table_hi")
PARTITION_KEYS = ("ndev", "nelems", "L", "owner", "glid_of_orig",
                  "orig_of_glid", "table")


def host(a) -> np.ndarray:
    """A host numpy copy of a torch tensor, a JAX array or an array; a
    bf16 one as its uint16 bit pattern."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def bf16_from_bits(bits, device: Any = "cpu") -> torch.Tensor:
    """A torch bf16 tensor from ``host``'s uint16 bit pattern."""
    bits = np.ascontiguousarray(np.asarray(bits, dtype=np.uint16))
    return torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16).to(device)


def mesh_arrays(mesh) -> Dict[str, np.ndarray]:
    """A TetMesh of either package as host arrays (only the walk tables
    it carries)."""
    return {k: host(getattr(mesh, k)) for k in MESH_KEYS + TWO_TIER_KEYS
            if getattr(mesh, k, None) is not None}


def tetmesh_from_arrays(arrays: Dict[str, Any],
                        dtype: Optional[torch.dtype] = None,
                        device: Any = "cpu") -> TetMesh:
    """The port's TetMesh from ``mesh_arrays``-style host arrays.

    The walk table is reassembled in float64 from the planes and the
    integer adjacency, so neighbour ids stay exact in any dtype. Arrays
    holding the two-tier tables give a two-tier mesh: the bf16 tier
    bit for bit, the refinement tier in ``dtype``; arrays with neither
    table an unpacked mesh (the planes in ``dtype``)."""
    coords = np.asarray(arrays["coords"])
    if dtype is None:
        dtype = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}[coords.dtype]
    if "walk_table_lo" in arrays:
        mesh = TetMesh.from_numpy(coords, arrays["tet2vert"],
                                  arrays["face_adj"], arrays["volumes"],
                                  None, dtype=dtype, device=device)
        return dataclasses.replace(
            mesh,
            walk_table_lo=bf16_from_bits(arrays["walk_table_lo"], device),
            walk_table_hi=torch.tensor(
                np.asarray(arrays["walk_table_hi"]), device=device
            ).to(dtype),
        )
    adj = np.asarray(arrays["face_adj"], dtype=np.int32)
    if "walk_table" not in arrays:
        return TetMesh.from_numpy(
            coords, arrays["tet2vert"], adj, arrays["volumes"], None,
            dtype=dtype, device=device,
            face_normals=np.asarray(arrays["face_normals"]),
            face_offsets=np.asarray(arrays["face_offsets"]))
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
    """A MeshPartition of either package as host values (``table_hi``
    only when two-tier, ``table`` then the bf16 tier's bits; ``adj_int``
    only with the sidecar)."""
    out = {k: host(getattr(part, k)) for k in PARTITION_KEYS}
    for k in ("ndev", "nelems", "L"):
        out[k] = int(out[k])
    for k in ("table_hi", "adj_int"):
        if getattr(part, k, None) is not None:
            out[k] = host(getattr(part, k))
    return out


def partition_from_arrays(arrays: Dict[str, Any],
                          device: Any = "cpu") -> MeshPartition:
    """The port's MeshPartition from ``partition_arrays`` values (the
    local-encoded adjacency floats are exact in their dtype)."""
    dtypes = {np.dtype(np.float32): torch.float32,
              np.dtype(np.float64): torch.float64}
    table = host(arrays["table"])
    table_hi = None
    if "table_hi" in arrays:
        table_hi = host(arrays["table_hi"])
        table_hi = torch.tensor(table_hi, dtype=dtypes[table_hi.dtype],
                                device=device)
        table_t = bf16_from_bits(table, device)
    else:
        table_t = torch.tensor(table, dtype=dtypes[table.dtype],
                               device=device)

    def ids(k):
        return torch.tensor(np.asarray(arrays[k], dtype=np.int32),
                            device=device)

    return MeshPartition(
        ndev=int(arrays["ndev"]), nelems=int(arrays["nelems"]),
        L=int(arrays["L"]), owner=np.asarray(arrays["owner"], np.int32),
        glid_of_orig=ids("glid_of_orig"), orig_of_glid=ids("orig_of_glid"),
        table=table_t, table_hi=table_hi,
        adj_int=ids("adj_int") if "adj_int" in arrays else None,
    )


_STATS_LANES = ("flux_sum", "flux_sq_sum")


def _stats_arrays(acc, prefix: str) -> Dict[str, Any]:
    """A BatchAccumulator of either package as host values."""
    out = {f"{prefix}_{k}": host(getattr(acc, k)) for k in _STATS_LANES}
    out[f"{prefix}_num_batches"] = int(acc.num_batches)
    out[f"{prefix}_moves_in_batch"] = int(acc.moves_in_batch)
    if acc.open_flux is not None:
        out[f"{prefix}_open_flux"] = host(acc.open_flux)
    return out


def facade_state(tally) -> Dict[str, np.ndarray]:
    """A facade's particle state, flux, scoring bank and statistics
    lanes as host arrays: the engine's slot rows plus ``flux_padded``
    (and ``score_padded``) for a partitioned facade, else ``x``,
    ``elem`` and ``flux`` (and ``score_bank``); ``stats_*`` and
    ``sstats_*`` where statistics are on."""
    engine = getattr(tally, "engine", None)
    if engine is not None:
        out = {k: host(v) for k, v in engine.state.items()}
        out["flux_padded"] = host(engine.flux_padded)
        if getattr(engine, "score_padded", None) is not None:
            out["score_padded"] = host(engine.score_padded)
    else:
        out = {"x": host(tally.x), "elem": host(tally.elem),
               "flux": host(tally.flux)}
        if getattr(tally, "_score_bank", None) is not None:
            out["score_bank"] = host(tally._score_bank)
    for attr, prefix in (("_stats", "stats"), ("_score_stats", "sstats")):
        if getattr(tally, attr, None) is not None:
            out.update(_stats_arrays(getattr(tally, attr), prefix))
    return out


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
        if engine.score_padded is not None:
            engine.score_padded = t(arrays["score_padded"], tally.dtype)
        engine.n_lost = int(np.sum(arrays["lost"]))
    else:
        tally.x = t(arrays["x"], tally.dtype).reshape(-1, 3)
        tally.elem = t(arrays["elem"], torch.int32)
        tally.flux = t(arrays["flux"], tally.dtype)
        if tally._score_bank is not None:
            tally._score_bank = t(arrays["score_bank"], tally.dtype)
    for attr, prefix in (("_stats", "stats"), ("_score_stats", "sstats")):
        acc = getattr(tally, attr)
        if acc is not None:
            acc.restore(*(arrays[f"{prefix}_{k}"] for k in _STATS_LANES),
                        arrays[f"{prefix}_num_batches"],
                        arrays[f"{prefix}_moves_in_batch"],
                        arrays.get(f"{prefix}_open_flux"))
    tally.is_initialized = True


def tally_config(cfg) -> TallyConfig:
    """The port's ``TallyConfig`` with every field that ``cfg`` (a JAX
    package ``TallyConfig``, read duck-typed) shares with it; the port's
    own validation runs on the values. A field the port does not have
    is refused with ``NotImplementedError`` unless ``cfg`` leaves it at
    its default. The working dtype crosses by name (float32/float64)."""
    port = {f.name for f in dataclasses.fields(TallyConfig)}
    kw = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if f.name in port:
            kw[f.name] = value
            continue
        default = (f.default_factory() if f.default_factory
                   is not dataclasses.MISSING else f.default)
        if value is not default and value != default:
            raise NotImplementedError(
                f"TallyConfig.{f.name}={value!r} has no counterpart in the "
                f"port yet: {ROADMAP_MULTI_DEVICE}"
            )
    if kw.get("dtype") is not None:
        kw["dtype"] = {"float32": torch.float32, "float64": torch.float64,
                       "bfloat16": torch.bfloat16}[np.dtype(kw["dtype"]).name]
    if kw.get("scoring") is not None:
        kw["scoring"] = scoring_spec(kw["scoring"])
    if kw.get("sentinel") is not None:
        kw["sentinel"] = sentinel_policy(kw["sentinel"])
    if kw.get("checkpoint") is not None:
        kw["checkpoint"] = checkpoint_policy(kw["checkpoint"])
    if kw.get("batch_stats_trigger") is not None:
        trig = kw["batch_stats_trigger"]
        kw["batch_stats_trigger"] = TriggerSpec(
            threshold=trig.threshold, metric=trig.metric,
            quantile=trig.quantile)
    return TallyConfig(**kw)


def scoring_spec(spec) -> ScoringSpec:
    """The port's ``ScoringSpec`` from a spec of either package, read
    duck-typed: its filters' edges, its scores and its overflow
    policy."""
    filters = []
    for attr, cls in (("energy_filter", EnergyFilter),
                      ("time_filter", TimeFilter)):
        f = getattr(spec, attr)
        if f is not None:
            filters.append(cls(np.asarray(f.edges)))
    return ScoringSpec(filters, tuple(spec.scores), spec.overflow)


def sentinel_policy(policy) -> SentinelPolicy:
    """The port's ``SentinelPolicy`` from a policy of either package,
    read duck-typed field by field."""
    return SentinelPolicy(**{f.name: getattr(policy, f.name)
                             for f in dataclasses.fields(SentinelPolicy)})


def checkpoint_policy(policy) -> CheckpointPolicy:
    """The port's ``CheckpointPolicy`` from a policy of either package,
    read duck-typed field by field."""
    return CheckpointPolicy(**{f.name: getattr(policy, f.name)
                               for f in dataclasses.fields(CheckpointPolicy)})
