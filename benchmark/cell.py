"""Finding a cell's files by the names in ``BENCHMARK.json``.

A workload names a configuration and a traffic mix. The configuration's
file is the one its ``BENCHMARK.json`` entry gives (under
``benchmark/configs/``); the mix is ``benchmark/traffic/<traffic>.json``;
each metric is read by ``benchmark/metrics/<name>.py``; the mesh's kind
is generated by ``benchmark/meshes/<kind>.py``. Adding a cell, a metric
or a mesh kind adds files and entries and edits none.

A configuration file holds:

- ``mesh``: the mesh kind and its generator's arguments;
- ``facade``: the program's facade class, built as
  ``Facade(<mesh file>, particles, config=TallyConfig(**tally_config),
  **facade_args)`` (``facade_args`` optional, such as
  ``StreamingTally``'s ``{"chunk_size": 1000000}``);
- ``calls`` (optional): the facade's methods called, without arguments,
  once it is built (``["arm_deterministic"]`` commits every walk through
  the deterministic commit);
- ``particles``, ``dtype`` and ``tally_config`` (the ``TallyConfig``
  fields the deployment sets; ``{}`` is the configuration as it ships);
- ``scoring`` (or null): ``scores`` and the filters' edges, each edge
  list given as a NumPy call ``["geomspace", lo, hi, count]`` /
  ``["linspace", ...]`` or as the values;
- ``control``: the ``TallyConfig`` fields of the program's own
  lower-precision path (the check's control, run only on request);
- ``limits``: each number the check compares, with its limit.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    metrics: list  # the metric entries of BENCHMARK.json this run reports
    chips: int


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def edges(spec) -> Optional[np.ndarray]:
    if spec is None:
        return None
    if isinstance(spec[0], str):
        fn = {"geomspace": np.geomspace, "linspace": np.linspace}[spec[0]]
        return fn(float(spec[1]), float(spec[2]), int(spec[3]))
    return np.asarray(spec, np.float64)


def resolved_scoring(config: dict) -> Optional[dict]:
    """The configuration's scoring with its edges as arrays."""
    sc = config.get("scoring")
    if sc is None:
        return None
    return {"scores": list(sc["scores"]),
            "energy_edges": edges(sc.get("energy_edges")),
            "time_edges": edges(sc.get("time_edges")),
            "overflow": sc.get("overflow", "drop")}


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(bench: dict, workload: str, trace: bool,
            root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[w["config"]]["file"])
    traffic = read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in bench[kind] if applies(bench, m, workload)]
    return Cell(workload, config, traffic, metrics, int(w["chips"]))


def applies(bench: dict, metric: dict, workload: str) -> bool:
    """A metric with ``workloads`` is read in those cells; one without
    in every cell that reports the end-to-end metric it moves (or, for
    an end-to-end metric, in every cell)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    return moves in e2e and applies(bench, e2e[moves], workload)


def metric_path(name: str) -> Path:
    return BENCH_DIR / "metrics" / f"{name}.py"
