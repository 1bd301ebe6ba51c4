"""One run of one cell: set-up, warm-up, the traced stretch (``--trace
1`` only), the measured window, then the check against the reference and
the metrics.

The order of a run:

1. the mesh file (written on a checkout's first run), the traffic pool
   from the seed, the facade built from the mesh file (``mesh_load_s``);
2. warm-up: every pool batch once, which builds (first run) and loads
   the kernels and sizes every buffer the window uses;
3. with ``trace``: one profiler window over every pool batch once;
4. the window: whole pool cycles until ``seconds`` have passed
   (``setup_s`` ends at its first call);
5. the device's memory peak, the facade's answers copied off it, the
   facade freed;
6. the reference of each pool batch, the check, the metric readers.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import sys
import time
from collections import Counter
from typing import Optional

from benchmark import check, meshgen, roofline, traffic
from benchmark.cell import Cell, metric_path, resolved_scoring
from benchmark.drive import Driver, Tally
from benchmark.readers import Context, Launch, p95


def tally_config(cell: Cell, control: bool):
    """The facade's ``TallyConfig`` for the cell (the program's own
    lower-precision path with ``control``)."""
    import torch

    import pumiumtally_tpu_torch as ptt

    cfg = cell.config
    kw = dict(cfg.get("tally_config", {}))
    if control:
        kw.update(cfg["control"])
    kw["dtype"] = getattr(torch, cfg["dtype"])
    sc = resolved_scoring(cfg)
    if sc is not None:
        filters = []
        if sc["energy_edges"] is not None:
            filters.append(ptt.EnergyFilter(sc["energy_edges"]))
        if sc["time_edges"] is not None:
            filters.append(ptt.TimeFilter(sc["time_edges"]))
        kw["scoring"] = ptt.ScoringSpec(filters, tuple(sc["scores"]),
                                        overflow=sc["overflow"])
    return ptt.TallyConfig(**kw)


def read_metric(entry: dict, ctx: Context) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + entry["name"].replace(".", "_"),
        metric_path(entry["name"]))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def traced_launches(refs, traced: Tally, n: int, scored: bool) -> list:
    """The walks of the traced stretch, each with its bound."""
    out = []
    for p in traced.batches:
        r = refs[p]
        out.append(Launch("localize", False,
                          roofline.walk_bound_ms(r.localize, n, False)))
        for t in r.relocate:
            out.append(Launch("relocate", False,
                              roofline.walk_bound_ms(t, n, False)))
        for t in r.moves:
            out.append(Launch("move", scored,
                              roofline.walk_bound_ms(t, n, True)))
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False,
             t_start: Optional[float] = None, cache=meshgen.CACHE) -> tuple:
    """Run the cell once; returns the result (the keys of the result
    line) and the numbers the check computed."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    import pumiumtally_tpu_torch as ptt
    from benchmark.reference.tally import reference_pool
    from benchmark.reference.walk import RefMesh

    cfg = cell.config
    scoring = resolved_scoring(cfg)
    marks = {"start": t_start}

    def mark(name: str) -> None:
        marks[name] = time.perf_counter()

    mark("imports")
    mesh_dir = meshgen.cached_mesh(cfg["mesh"], cache)
    mark("mesh_file")
    n = int(cfg["particles"])
    pool = traffic.make_pool(cell.traffic, seed, n,
                             meshgen.extent(cfg["mesh"]), scoring)
    mark("traffic")
    tc = tally_config(cell, control)
    facade_cls = getattr(ptt, cfg["facade"])
    t0 = time.perf_counter()
    facade = facade_cls(str(mesh_dir / "mesh.osh"), n, config=tc,
                        device=device, **cfg.get("facade_args", {}))
    mesh_load_s = time.perf_counter() - t0
    for name in cfg.get("calls", []):
        getattr(facade, name)()
    drv = Driver(facade, pool, cell.traffic["protocol"], tc.batch_stats)
    mark("facade")
    warm = Tally()
    drv.cycle(warm)
    mark("warm_up")
    traced, traces = None, []
    if trace:
        from torch.profiler import record_function

        from benchmark.trace import profiled

        traced = Tally()
        drv.span = record_function
        with profiled(traces):
            drv.cycle(traced)
        drv.span = lambda name: contextlib.nullcontext()
        if not traces[0].kernels():
            raise RuntimeError("the profiler window holds no device kernel: "
                               "no per-layer number can be read")
        mark("traced")
    win = drv.window(seconds)
    mark("window")
    setup_s = win.start - t_start
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ans = check.read_answers(facade, device)
    del facade, drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    coords, tets = meshgen.load_arrays(mesh_dir)
    mesh = RefMesh(coords, tets, device)
    refs = reference_pool(mesh, pool, cell.traffic["protocol"], scoring)
    mark("reference")
    runs = warm.batches + (traced.batches if traced else []) + win.batches
    counts = Counter(runs)
    nums = check.numbers(ans, refs, [counts[p] for p in range(len(pool))],
                         mesh, win.batches[-1],
                         None if scoring is None else scoring["scores"])
    ok, compared = check.judge(nums, cfg["limits"])
    mark("check")
    names = list(marks)
    print("# seconds: " + ", ".join(
        f"{b} {marks[b] - marks[a]:.3f}" for a, b in zip(names, names[1:])),
        file=sys.stderr)
    ms = sorted(x * 1e3 for x in win.move_s)
    q = len(win.move_s) // 4
    print(f"# window: {win.moves} moves, {len(win.batches)} batches, move ms "
          f"min {ms[0]:.2f} median {ms[len(ms) // 2]:.2f} p95 "
          f"{p95(win.move_s) * 1e3:.2f} max {ms[-1]:.2f}; "
          "mean ms a quarter: " + " ".join(
              f"{sum(win.move_s[i * q:(i + 1) * q]) / max(q, 1) * 1e3:.2f}"
              for i in range(4)), file=sys.stderr)

    ctx = Context(setup_s=setup_s, mesh_load_s=mesh_load_s, window=win,
                  traced=traced, trace=traces[0] if traces else None)
    if trace:
        ctx.launches = traced_launches(refs, traced, n, scoring is not None)
    metrics = {}
    for entry in cell.metrics:
        v = read_metric(entry, ctx)
        if v is not None:
            metrics[entry["name"]] = {"value": v, "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": win.moves, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        from benchmark.trace import device_busy, idle_gaps, top_device_ops

        busy, window = device_busy(ctx.trace)
        dev["busy_s"], dev["window_s"] = busy, window
        result["breakdown"] = {"device_ops": top_device_ops(ctx.trace),
                               "idle_gaps": idle_gaps(ctx.trace)}
    result["check"] = compared
    return result, nums
