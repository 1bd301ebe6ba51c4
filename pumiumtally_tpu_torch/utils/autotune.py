"""Walk autotuner: measure, pick, return a tuned ``TallyConfig``.

The port of ``pumiumtally_tpu/utils/autotune.py``, with the same API and
report format. The JAX walk's tuning grid sweeps its compaction cascade
(``walk_cond_every``, ``walk_perm_mode``, windows); the port's kernels
walk each particle to completion and have no cascade, so those knobs are
validated and change nothing (config.py). The port's default grid holds
only the knob that changes what it launches: the walk-table tier, the
float32 packed row (W0) against the bfloat16 two-tier tables (W0's
two-tier variant). The two-tier tier is not bitwise equal to float32
(tie-class divergence), so, as in the JAX package, it is always measured
and reported but only adopted with ``allow_approximate=True``.

``autotune_walk`` times bench.py's workload shape (uniform interior
sources, clipped gaussian steps) through the raw walk (``ops.walk.walk``,
no facade) for each candidate ON THE GIVEN DEVICE: CUDA events on the
card, the host clock on the CPU. ``autotune_blocked`` sweeps the
partitioned engine's block length (``walk_vmem_max_elems`` with
``walk_block_kernel="gather"``: W4 over the sub-split) against the
incumbent configuration and adopts a candidate only when it measured
strictly faster.

    from pumiumtally_tpu_torch.utils.autotune import autotune_walk
    cfg, report = autotune_walk(mesh, n_particles=200_000)
    tally = PumiTally(mesh, n, cfg)
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pumiumtally_tpu_torch.config import TallyConfig

# Default grid: the table tiers, the one walk knob the port's kernels
# read. Custom grids may hold the JAX cascade knobs too (a JAX grid
# crosses over); they are validated and time the same walk.
DEFAULT_CANDIDATES: Tuple[dict, ...] = (
    {"walk_table_dtype": "float32"},
    {"walk_table_dtype": "bfloat16"},
)

# Knobs that change results beyond bitwise/scatter-order equivalence;
# adopting one as the tuned winner needs the caller's explicit opt-in.
_APPROXIMATE_KNOBS = ("walk_table_dtype",)


def _is_approximate(knobs: dict) -> bool:
    return any(
        knobs.get(k) not in (None, "float32") for k in _APPROXIMATE_KNOBS
    )


def walk_kwargs(cfg: TallyConfig) -> tuple:
    """The config's non-default walk knobs that change what the port
    launches, as (name, value) pairs: the counterpart of the JAX
    config's ``walk_kwargs()`` for the CLI's settings line. The table
    tier is resolved here ("auto" through the environment) and dropped
    when it is both the default and what "auto" resolves to, so an
    untuned config yields ``()``. The cascade knobs have no effect in
    the port and are not listed."""
    from pumiumtally_tpu_torch.ops.walk import (
        TABLE_DTYPE_DEFAULT,
        resolve_table_dtype,
    )

    td = cfg.resolved_table_dtype()
    if td != TABLE_DTYPE_DEFAULT or td != resolve_table_dtype("auto"):
        return (("table_dtype", td),)
    return ()


def _elapsed(device: torch.device, fn: Callable[[], None]) -> float:
    """Seconds ``fn`` takes: CUDA events on the card, the host clock on
    the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _workload(mesh, n: int, moves: int, mean_step: float, seed: int,
              dtype=None, device=None) -> list:
    """bench.py-shaped trajectory strictly inside the mesh's bbox: float64
    numpy arrays, or tensors when ``dtype`` is given."""
    coords = mesh.coords.detach().cpu().numpy().astype(np.float64)
    lo, hi = coords.min(axis=0), coords.max(axis=0)
    span = hi - lo
    rng = np.random.default_rng(seed)
    pts = [lo + rng.uniform(0.05, 0.95, (n, 3)) * span]
    for _ in range(moves + 1):
        step = rng.normal(scale=mean_step / np.sqrt(3.0), size=(n, 3)) * span
        pts.append(np.clip(pts[-1] + step, lo + 0.02 * span, hi - 0.02 * span))
    if dtype is None:
        return pts
    return [torch.as_tensor(p, dtype=dtype, device=device) for p in pts]


def autotune_walk(
    mesh,
    n_particles: int = 200_000,
    moves: int = 3,
    mean_step: float = 0.25,
    candidates: Optional[Sequence[dict]] = None,
    base: Optional[TallyConfig] = None,
    seed: int = 0,
    verbose: bool = False,
    allow_approximate: bool = False,
    device: Any = None,
) -> Tuple[TallyConfig, List[dict]]:
    """Measure each candidate's continue-mode walk rate on ``device``
    (CUDA unless the caller asks for "cpu"); return (best TallyConfig,
    full report).

    ``mesh`` is a ``TetMesh``. The report is a list of ``{"knobs",
    "moves_per_sec"}`` dicts sorted fastest-first; the fastest ADOPTABLE
    entry produced the returned config and carries ``"adopted": True``:
    approximate-tier candidates (walk_table_dtype="bfloat16") are always
    measured and reported, but only adopted when ``allow_approximate``.
    Each candidate runs one warmup move (the kernels' first launch) and
    ``moves`` timed moves of the raw walk."""
    from pumiumtally_tpu_torch.api.tally import _localize_step, resolve_device
    from pumiumtally_tpu_torch.ops.walk import walk

    device = resolve_device(device)
    cands = list(candidates if candidates is not None else DEFAULT_CANDIDATES)
    base = base if base is not None else TallyConfig()
    dtype = mesh.dtype if base.dtype is None else base.dtype
    mesh = mesh.to(dtype=dtype, device=device)
    pts = _workload(mesh, n_particles, moves, mean_step, seed, dtype, device)

    # One shared localization (identical start state for every candidate).
    c0 = mesh.coords[mesh.tet2vert[0].long()].mean(dim=0)
    tol = base.resolved_tolerance(dtype)
    max_iters = base.resolved_max_iters(mesh.nelems)
    x0, e0, done, _ = _localize_step(
        mesh, c0.expand(n_particles, 3).contiguous(),
        torch.zeros((n_particles,), dtype=torch.int32, device=device),
        pts[0], tol=tol, max_iters=max_iters,
    )
    if not bool(done.all()):
        raise RuntimeError("autotune workload failed to localize")
    fly = torch.ones((n_particles,), dtype=torch.int8, device=device)
    w = torch.ones((n_particles,), dtype=dtype, device=device)

    report = []
    mesh_lo = None  # built once, only if a bf16-tier candidate runs
    for knobs in cands:
        cfg = dataclasses.replace(base, **knobs)
        td = cfg.resolved_table_dtype()
        if td == "bfloat16":
            if mesh_lo is None:
                mesh_lo = mesh.with_lowp_tables()
            m_c = mesh_lo
        else:
            m_c = mesh
        g = partial(walk, m_c, tally=True, tol=tol, max_iters=max_iters,
                    table_dtype=td)
        flux = torch.zeros((mesh.nelems,), dtype=dtype, device=device)
        r = g(x0, e0, pts[1], fly, w, flux)  # warmup: first launch
        state = {"x": r.x, "e": r.elem}

        def timed(g=g, state=state, flux=flux):
            for m in range(2, moves + 2):
                r = g(state["x"], state["e"], pts[m], fly, w, flux)
                state["x"], state["e"] = r.x, r.elem

        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rate = n_particles * moves / _elapsed(device, timed)
        report.append({"knobs": dict(knobs), "moves_per_sec": rate})
        if verbose:
            print(f"autotune: {knobs} -> {rate / 1e6:.3f}M moves/s")

    report.sort(key=lambda r: -r["moves_per_sec"])
    adoptable = [
        r for r in report
        if allow_approximate or not _is_approximate(r["knobs"])
    ]
    if not adoptable:
        # Every candidate was approximate and adoption is disallowed:
        # the sweep's rates are still in the report, but the returned
        # config stays the (physics-identical) base.
        return dataclasses.replace(base), report
    # Mark which report entry produced the returned config: with
    # approximate candidates in the sweep, report[0] may NOT be the
    # adopted winner.
    adoptable[0]["adopted"] = True
    best = dataclasses.replace(base, **_drop_defaults(adoptable[0]["knobs"]))
    return best, report


def block_length_candidates(
    mesh, mean_step: float, base_bound: Optional[int] = 3072
) -> List[int]:
    """Block-length (``walk_vmem_max_elems``) candidates for the gather
    sub-split, derived from the workload's mean step length (the JAX
    package's L-vs-mean-free-path law).

    A blocked walk round ends when a particle crosses a block face, so
    the expected migration rounds per move scale with mean_step / ell,
    where ell = (L / density)^(1/3) is the linear size of an L-element
    block at the mesh's element density. The break-even block keeps the
    expected crossings per move near one: L* = density * mean_step^3.
    The grid brackets L* one octave each way, keeps the configured base
    bound as the incumbent, and clips to [256, nelems/2] so every
    candidate actually sub-splits.
    """
    coords = mesh.coords.detach().cpu().numpy().astype(np.float64)
    span = coords.max(axis=0) - coords.min(axis=0)
    vol = float(np.prod(np.maximum(span, 1e-30)))
    density = mesh.nelems / vol
    l_star = density * float(mean_step) ** 3
    lo, hi = 256, max(256, int(mesh.nelems) // 2)
    cands = {int(np.clip(round(l_star * f), lo, hi)) for f in (0.5, 1.0, 2.0)}
    if base_bound is not None:
        cands.add(int(np.clip(int(base_bound), lo, hi)))
    return sorted(cands)


def autotune_blocked(
    mesh,
    n_particles: int = 100_000,
    moves: int = 2,
    mean_step: float = 0.25,
    candidates: Optional[Sequence[int]] = None,
    base: Optional[TallyConfig] = None,
    seed: int = 0,
    verbose: bool = False,
    device: Any = None,
    _measure=None,
) -> Tuple[TallyConfig, List[dict]]:
    """Measure gather-blocked partitioned engines over block-length
    candidates; adopt a candidate ONLY when it beats the incumbent.

    The incumbent is ``base`` itself (its ``walk_vmem_max_elems``, or
    the one-block engine when unset), swept alongside the
    ``block_length_candidates`` grid, so the returned config changes
    only when a candidate measured strictly faster on this device and
    workload; a wash keeps the incumbent. Block length moves the
    walk/migrate round schedule, not the tally.

    Returns (config, report); report rows are
    ``{"walk_vmem_max_elems", "moves_per_sec", ["adopted"|"incumbent"]}``
    sorted fastest-first. ``_measure`` (tests) overrides the per-config
    rate measurement.
    """
    base = base if base is not None else TallyConfig()
    incumbent = (
        None if base.walk_vmem_max_elems is None
        else int(base.walk_vmem_max_elems)
    )
    if candidates is None:
        candidates = block_length_candidates(
            mesh, mean_step, base_bound=incumbent
        )
    bounds = list(dict.fromkeys(
        None if b is None else int(b)
        for b in list(candidates) + [incumbent]
    ))

    if _measure is None:
        _measure = partial(
            _blocked_rate, mesh, n_particles, moves, mean_step, seed, device
        )
    report = []
    for b in bounds:
        cfg = dataclasses.replace(
            base, walk_vmem_max_elems=b,
            walk_block_kernel="gather" if b is not None
            else base.walk_block_kernel,
        )
        rate = _measure(cfg)
        row = {"walk_vmem_max_elems": b, "moves_per_sec": rate}
        if b == incumbent:
            row["incumbent"] = True
        report.append(row)
        if verbose:
            print(f"autotune_blocked: L<={b} -> {rate / 1e6:.3f}M moves/s")
    report.sort(key=lambda r: -r["moves_per_sec"])
    inc_rate = next(
        r["moves_per_sec"] for r in report if r.get("incumbent")
    )
    best = report[0]
    if best.get("incumbent") or best["moves_per_sec"] <= inc_rate:
        return dataclasses.replace(base), report  # wash: keep incumbent
    best["adopted"] = True
    return dataclasses.replace(
        base, walk_vmem_max_elems=best["walk_vmem_max_elems"],
        walk_block_kernel="gather",
    ), report


def _blocked_rate(mesh, n: int, moves: int, mean_step: float, seed: int,
                  device: Any, cfg: TallyConfig) -> float:
    """Continue-mode moves/s of one (possibly blocked) partitioned
    facade on the bench-shaped workload (warmup move excluded)."""
    from pumiumtally_tpu_torch.api.partitioned import PartitionedPumiTally

    cfg = dataclasses.replace(
        cfg, check_found_all=False, fenced_timing=False
    )
    pts = _workload(mesh, n, moves, mean_step, seed)
    t = PartitionedPumiTally(mesh, n, cfg, device=device)
    t.CopyInitialPosition(pts[0].reshape(-1).copy())
    t.MoveToNextLocation(None, pts[1].reshape(-1).copy())
    float(t.flux.sum())  # first launches + sync

    def timed():
        for m in range(2, moves + 2):
            t.MoveToNextLocation(None, pts[m].reshape(-1).copy())

    return n * moves / _elapsed(t.device, timed)


def _drop_defaults(knobs: dict) -> dict:
    """Strip a table tier equal to the default, so a tuned config whose
    winner is the untuned walk keeps ``walk_kwargs(cfg) == ()``."""
    from pumiumtally_tpu_torch.ops.walk import TABLE_DTYPE_DEFAULT

    out = dict(knobs)
    if out.get("walk_table_dtype") == TABLE_DTYPE_DEFAULT:
        out.pop("walk_table_dtype")
    return out
