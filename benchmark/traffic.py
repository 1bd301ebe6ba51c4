"""The one traffic generator: a mix's parameters (a JSON file under
``benchmark/traffic/``) and ``--seed`` -> the pool of batches a run
sends.

The trajectory follows bench.py's ``make_trajectory``: source points
uniform in a box-relative range, then ``moves_per_batch`` Gaussian steps
of mean length ``mean_step`` (each axis with standard deviation
``mean_step / sqrt(3)``). Where bench.py clips a destination into the
box, which piles particles onto the clip planes and, where two axes
clip, onto vertical lines that can lie in a mesh face, a destination
here is reflected at the walls: the reflective boundary of an assembly
cut from a repeating lattice. Every seed gives the same sizes; only the
points, energies and times differ.

Mix parameters:

- ``protocol``: ``"two_phase"`` (``MoveToNextLocation(origins, dests,
  flying, weights)``, the origins echoing the previous destinations) or
  ``"continue"`` (``MoveToNextLocation(None, dests, flying, weights)``);
- ``moves_per_batch``, ``pool_batches`` (distinct batches, sent in turn),
  ``mean_step`` (cm), ``source_range`` (a share of the box, every axis),
  ``walls`` (the [low, high] share of the box, every axis, at which
  destinations reflect), ``weight`` (every particle's weight);
- ``energy`` / ``time`` (read only where the configuration's scoring
  spec bins by them): ``{"kind": "log_uniform", "out_share": s}`` draws
  log-uniformly over the filter's edges, a share ``s`` of the particles
  a decade below or above them (half each); ``{"kind": "uniform"}``
  draws uniformly over the edges.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

PROTOCOLS = ("two_phase", "continue")


@dataclass
class Batch:
    """One batch: ``points[0]`` the sources, ``points[m]`` move m's
    destinations ([n,3] float64 each, C-contiguous), per-move energies
    and times ([n] float64, or None), the weights [n] float64."""

    points: List[np.ndarray]
    energy: Optional[List[np.ndarray]]
    time: Optional[List[np.ndarray]]
    weights: np.ndarray

    @property
    def moves(self) -> int:
        return len(self.points) - 1


def reflect(x: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """``x`` folded into [lo, hi] by mirror walls at both ends (as often
    as it takes: a step longer than the gap folds back again)."""
    w = hi - lo
    y = np.mod(x - lo, 2.0 * w)
    return lo + np.where(y > w, 2.0 * w - y, y)


def trajectory(rng, n: int, moves: int, box, mean_step: float,
               source_range=(0.02, 0.98), walls=(0.02, 0.98)) -> list:
    """Sources and ``moves`` destinations inside the box, each
    destination reflected at the walls."""
    box = np.asarray(box, np.float64)
    lo, hi = walls[0] * box, walls[1] * box
    pts = [rng.uniform(source_range[0], source_range[1], (n, 3)) * box]
    for _ in range(moves):
        step = rng.normal(scale=mean_step / np.sqrt(3.0), size=(n, 3))
        pts.append(reflect(pts[-1] + step, lo, hi))
    return pts


def attribute(rng, n: int, spec: dict, edges: np.ndarray) -> np.ndarray:
    """Per-particle values of one scoring attribute over a filter's
    edges."""
    lo, hi = float(edges[0]), float(edges[-1])
    if spec["kind"] == "uniform":
        return rng.uniform(lo, hi, n)
    if spec["kind"] == "log_uniform":
        vals = 10.0 ** rng.uniform(np.log10(lo), np.log10(hi), n)
        out = float(spec.get("out_share", 0.0))
        pick = rng.random(n)
        vals = np.where(pick < out / 2, lo / 10, vals)
        return np.where(pick > 1 - out / 2, hi * 10, vals)
    raise ValueError(f"unknown attribute kind {spec['kind']!r}")


def make_pool(mix: dict, seed: int, n: int, box, scoring: Optional[dict]):
    """The mix's pool of batches for ``seed``. ``scoring`` is the
    configuration's scoring spec (None: no energies or times)."""
    if mix["protocol"] not in PROTOCOLS:
        raise ValueError(f"unknown protocol {mix['protocol']!r}")
    rng = np.random.default_rng(int(seed))
    pool = []
    for _ in range(int(mix["pool_batches"])):
        moves = int(mix["moves_per_batch"])
        pts = trajectory(rng, n, moves, box, float(mix["mean_step"]),
                         mix["source_range"], mix["walls"])
        energy = time = None
        if scoring is not None and scoring.get("energy_edges") is not None:
            edges = np.asarray(scoring["energy_edges"], np.float64)
            energy = [attribute(rng, n, mix["energy"], edges)
                      for _ in range(moves)]
        if scoring is not None and scoring.get("time_edges") is not None:
            edges = np.asarray(scoring["time_edges"], np.float64)
            time = [attribute(rng, n, mix["time"], edges)
                    for _ in range(moves)]
        pool.append(Batch(points=pts, energy=energy, time=time,
                          weights=np.full(n, float(mix["weight"]))))
    return pool
