#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name, and its name and power limit as nvidia-smi
   reports them.
2. Build: every kernel of the port, compiled from csrc/ with nvcc for
   sm_90a (build seconds and the ptxas register/shared-memory report).
3. W0 (csrc/walk.cu) against its plain PyTorch version ``walk_plain`` on
   the card: a 48,000-tet box, 500,000 particles on bench.py's random
   trajectory, float32, tallying.
4. W1 (csrc/block_walk.cu) against ``vmem_walk_local_plain``: the same
   mesh sub-split into blocks of at most 1024 elements, one round, with
   particles pausing at block faces.
5. Oracle: the reference's 6-tet unit-cube oracle in float64 through
   both facades on the card, held at 1e-8.
6. Main path, both facades at bench.py's size (48,000 tets, 500,000
   particles): CopyInitialPosition, one two-phase move, then continue
   moves; track-length conservation at rtol 1e-6; WriteTallyResults;
   every kernel's launch count > 0 in that run; moves/s; then one more
   continue move under torch.profiler: wall time, device-busy time and
   the kernels that take it.
7. One JSON line with each kernel's launches, times, bound and error,
   then the card's name and power limit, then the result line.

Kernel comparisons: element ids, done/exited/pending masks and ``iters``
must be equal; positions and ray coordinates are expected bitwise equal
(both sides build with no fused multiply-add) and are held at 1e-6
absolute in float32; flux sums in another order (float atomics) and is
held at rtol 1e-4.

It imports nothing of JAX; it needs one CUDA device and exits non-zero
without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np

MESH_DIV = 20  # 20^3 cells -> 48,000 tets (bench.py MESH_DIV)
N = 500_000  # particles per batch (bench.py N)
MEAN_STEP = 0.25  # mean segment length (bench.py MEAN_STEP)
CONTINUE_MOVES = 4
VMEM_BOUND = 1024  # bench.py run_vmem_blocked default bound
CAPACITY_FACTOR = 2.0
CONSERVATION_RTOL = 1e-6
ORACLE_TOL = 1e-8
POS_ATOL = 1e-6
FLUX_RTOL = 1e-4
# H100 SXM datasheet peaks: HBM bytes/s, f32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Operations per crossing in csrc/walk_step.cuh: per face two 3-term dot
# products (10), b (2), the crossing test (2), one division, the clamp
# and the running minimum (2); then the tally's subtract and multiply.
FLOPS_PER_CROSSING = 4 * 17 + 2


def make_trajectory(rng, n: int, moves: int) -> list:
    """bench.py's generator: a source and ``moves`` destination arrays,
    all strictly inside the unit cube."""
    pts = [rng.uniform(0.05, 0.95, (n, 3))]
    for _ in range(moves):
        step = rng.normal(scale=MEAN_STEP / np.sqrt(3.0), size=(n, 3))
        pts.append(np.clip(pts[-1] + step, 0.02, 0.98))
    return pts


def flat(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.reshape(-1))


def sync():
    import torch

    torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs after one
    warm-up, with CUDA events."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def wall_ms(fn) -> float:
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_equal(what: str, got, want) -> None:
    import torch

    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{what}: {bad} entries differ from the plain "
                             "version")


def check_flux(what: str, got, want) -> float:
    err = max_abs(got, want)
    scale = float(want.double().abs().max())
    if err > FLUX_RTOL * max(scale, 1e-30):
        raise AssertionError(f"{what}: flux differs by {err} (max {scale})")
    return err


def count_crossings(table, x, lelem, dest, active, base, tol) -> int:
    """Crossings this input needs: a lock-step replay of the walk that
    sums, per step, the particles still walking (block-local when
    ``base`` offsets a stacked table; a block exit ends the walk)."""
    import torch

    from pumiumtally_tpu_torch.ops.walk import advance_cols

    d0 = dest - x
    s = torch.zeros_like(d0[:, 0])
    e = lelem.long()
    tol_t = torch.tensor(tol, dtype=x.dtype, device=x.device)
    total = 0
    while bool(active.any()):
        total += int(active.sum())
        s_new, nxt, reached = advance_cols(table[base + e], s, d0, dest,
                                           tol_t)
        stop = reached | (nxt < 0)
        e = torch.where(active & ~stop, nxt.long(), e)
        s = torch.where(active, s_new, s)
        active = active & ~stop
    return total


def bound_entry(nbytes: float, crossings: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = crossings * FLOPS_PER_CROSSING / F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_device() -> tuple:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"# device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {smi}")
    return name, smi


def phase_build() -> None:
    from pumiumtally_tpu_torch import kernels

    seconds = kernels.build()
    print(f"# build: {seconds:.2f} s for {sorted(kernels.SOURCES)}")
    for name in kernels.SOURCES:
        for line in kernels.build_log(name).splitlines():
            if "entry function" in line or "registers" in line:
                print(f"#   {name}: {line.strip()}")


def phase_w0(mesh, pts) -> dict:
    """W0 vs walk_plain at the main path's shapes."""
    import torch

    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.ops.walk import walk, walk_plain

    t = PumiTally(mesh, N, TallyConfig(check_found_all=False))
    t.CopyInitialPosition(flat(pts[0]))
    dev = t.device
    x, elem = t.x, t.elem
    dest = torch.as_tensor(pts[1], dtype=torch.float32, device=dev)
    fly = torch.ones((N,), dtype=torch.int8, device=dev)
    w = torch.ones((N,), dtype=torch.float32, device=dev)
    kw = dict(tally=True, tol=t._tol, max_iters=t._max_iters)

    def run(fn):
        flux = torch.zeros((mesh.nelems,), dtype=torch.float32, device=dev)
        return fn(t.mesh, x, elem, dest, fly, w, flux, **kw)

    rk, rp = run(walk), run(walk_plain)
    sync()
    for f in ("elem", "done", "exited", "iters"):
        check_equal(f"W0 {f}", getattr(rk, f), getattr(rp, f))
    err_x, err_s = max_abs(rk.x, rp.x), max_abs(rk.s, rp.s)
    if max(err_x, err_s) > POS_ATOL:
        raise AssertionError(f"W0 positions differ by {err_x}, s by {err_s}")
    err_f = check_flux("W0", rk.flux, rp.flux)
    ms = cuda_ms(lambda: run(walk))
    plain_ms = wall_ms(lambda: run(walk_plain))
    crossings = count_crossings(t.mesh.walk_table, x, elem, dest,
                                torch.ones_like(fly, dtype=torch.bool), 0,
                                t._tol)
    per_particle = 12 + 12 + 4 + 1 + 4 + 12 + 4 + 1 + 1 + 4
    nbytes = N * per_particle + mesh.nelems * (80 + 2 * 4)
    print(f"# W0: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain; "
          f"{crossings} crossings; x bitwise={err_x == 0.0}, "
          f"s bitwise={err_s == 0.0}, flux max abs diff {err_f:.3e}")
    return {"name": "W0 walk", "route": "cuda",
            "source": "pumiumtally_tpu_torch/csrc/walk.cu",
            "replaces": "pumiumtally_tpu/ops/walk.py:449",
            "max_abs_err": max(err_x, err_s, err_f), "ms": ms,
            "plain_ms": plain_ms, **bound_entry(nbytes, crossings),
            "library_ms": None}


def phase_w1(mesh, pts) -> dict:
    """W1 vs vmem_walk_local_plain on one round of the sub-split."""
    import torch

    from pumiumtally_tpu_torch import PartitionedPumiTally, TallyConfig
    from pumiumtally_tpu_torch.ops.vmem_walk import (
        vmem_walk_local,
        vmem_walk_local_plain,
    )

    t = PartitionedPumiTally(
        mesh, N, TallyConfig(capacity_factor=CAPACITY_FACTOR,
                             walk_vmem_max_elems=VMEM_BOUND,
                             check_found_all=False),
    )
    t.CopyInitialPosition(flat(pts[0]))
    eng = t.engine
    st = eng.state
    dev = t.device
    dest = eng._by_pid(torch.as_tensor(pts[1], dtype=torch.float32,
                                       device=dev), 0.0)
    fly = st["alive"].to(torch.int8)
    w = fly.to(torch.float32)
    done = ~st["alive"]
    exited = torch.zeros_like(done)
    table = eng.part.table
    kw = dict(tally=True, tol=eng.tol, max_iters=eng.max_iters,
              blocks=eng.nparts)

    def run(fn):
        flux = torch.zeros_like(eng.flux_padded)
        return fn(table, st["x"], st["lelem"], dest, fly, w, done, exited,
                  flux, **kw)

    rk, rp = run(vmem_walk_local), run(vmem_walk_local_plain)
    sync()
    for i, f in ((1, "lelem"), (2, "done"), (3, "exited"), (4, "pending"),
                 (6, "iters")):
        check_equal(f"W1 {f}", rk[i], rp[i])
    n_paused = int((rk[4] >= 0).sum())
    if n_paused == 0:
        raise AssertionError("W1: no particle paused at a block face")
    err_x = max_abs(rk[0], rp[0])
    if err_x > POS_ATOL:
        raise AssertionError(f"W1 positions differ by {err_x}")
    err_f = check_flux("W1", rk[5], rp[5])
    ms = cuda_ms(lambda: run(vmem_walk_local))
    plain_ms = wall_ms(lambda: run(vmem_walk_local_plain))
    S = st["x"].shape[0]
    base = (torch.arange(S, device=dev) // eng.cap_per_block) * eng.part.L
    crossings = count_crossings(table, st["x"], st["lelem"], dest, ~done,
                                base, eng.tol)
    per_slot = (12 + 4 + 12 + 1 + 4 + 1 + 1) + (12 + 4 + 1 + 1 + 4)
    nbytes = S * per_slot + table.shape[0] * (80 + 2 * 4)
    print(f"# W1: {eng.nparts} blocks of <= {eng.part.L} elements, "
          f"{eng.cap_per_block} slots each; {ms:.3f} ms kernel, "
          f"{plain_ms:.3f} ms plain; {crossings} crossings, {n_paused} "
          f"paused; x bitwise={err_x == 0.0}, flux max abs diff {err_f:.3e}")
    return {"name": "W1 block_walk", "route": "cuda",
            "source": "pumiumtally_tpu_torch/csrc/block_walk.cu",
            "replaces": "pumiumtally_tpu/ops/vmem_walk.py:250",
            "max_abs_err": max(err_x, err_f), "ms": ms,
            "plain_ms": plain_ms, **bound_entry(nbytes, crossings),
            "library_ms": None}


def phase_oracle() -> None:
    """The reference's 6-tet cube oracle (tests/test_walk_oracle.py) in
    float64 through both facades on the card."""
    import torch

    from pumiumtally_tpu_torch import (
        PartitionedPumiTally,
        PumiTally,
        TallyConfig,
        build_box,
    )

    num = 5
    init = np.tile([0.1, 0.4, 0.5], (num, 1))
    dests = np.tile([1.2, 0.4, 0.5], (num, 1))
    origins2 = np.tile([1.0, 0.4, 0.5], (num, 1))
    next_pos = origins2.copy()
    flying2 = np.zeros(num, dtype=np.int8)
    weights2 = np.ones(num)
    next_pos[0], flying2[0], weights2[0] = [0.15, 0.05, 0.20], 1, 2.0
    next_pos[2], flying2[2], weights2[2] = [0.85, 0.05, 0.10], 1, 0.5
    expected1 = np.array([0.0, 0.0, 0.3 * num, 0.1 * num, 0.5 * num, 0.0])
    expected2 = expected1.copy()
    expected2[3] += 0.08790490988459178 * 2.0
    expected2[4] += 0.879049070406094 * 2.0 + 0.552268050859363 * 0.5

    mesh = build_box(1, 1, 1, 1, 1, 1, dtype=torch.float64)
    for t in (PumiTally(mesh, num),
              PartitionedPumiTally(mesh, num,
                                   TallyConfig(walk_vmem_max_elems=2))):
        kind = type(t).__name__
        t.CopyInitialPosition(flat(init), 3 * num)
        np.testing.assert_array_equal(t.elem_ids, np.full(num, 2), kind)
        fly = np.ones(num, dtype=np.int8)
        t.MoveToNextLocation(flat(init), flat(dests), fly, np.ones(num))
        np.testing.assert_array_equal(fly, 0, kind)
        np.testing.assert_array_equal(t.elem_ids, np.full(num, 4), kind)
        np.testing.assert_allclose(t.positions, origins2, atol=ORACLE_TOL)
        np.testing.assert_allclose(t.flux.cpu().numpy(), expected1,
                                   atol=ORACLE_TOL, err_msg=kind)
        t.MoveToNextLocation(flat(origins2), flat(next_pos), flying2.copy(),
                             weights2)
        np.testing.assert_allclose(t.positions, next_pos, atol=ORACLE_TOL)
        np.testing.assert_array_equal(t.elem_ids, [3, 4, 4, 4, 4], kind)
        np.testing.assert_allclose(t.flux.cpu().numpy(), expected2,
                                   atol=ORACLE_TOL, err_msg=kind)
    print("# oracle: 6-tet cube, float64, both facades on the card: ok at "
          f"{ORACLE_TOL}")


def phase_main_path(facade, mesh, pts, config, card: str) -> dict:
    """CopyInitialPosition, one two-phase move, then continue moves at
    bench.py's size; conservation, output file, launch counts, rate."""
    from pumiumtally_tpu_torch import kernels

    kernels.reset_launch_counts()
    t = facade(mesh, N, config)
    t.CopyInitialPosition(flat(pts[0]))
    t.MoveToNextLocation(flat(pts[0]), flat(pts[1]),
                         np.ones(N, np.int8), np.ones(N))
    move_ms = []
    for m in range(2, CONTINUE_MOVES + 2):
        move_ms.append(wall_ms(
            lambda m=m: t.MoveToNextLocation(None, flat(pts[m]))
        ))
    dt = sum(move_ms) / 1e3
    counts = dict(kernels.launch_counts)
    total = float(t.flux.double().sum())
    expect = sum(float(np.linalg.norm(pts[m] - pts[m - 1], axis=1).sum())
                 for m in range(1, CONTINUE_MOVES + 2))
    rel = abs(total - expect) / expect
    if rel > CONSERVATION_RTOL:
        raise AssertionError(f"{facade.__name__}: conservation off by "
                             f"{rel:.3e} (got {total}, want {expect})")
    with tempfile.TemporaryDirectory() as d:
        t.WriteTallyResults(f"{d}/fluxresult.vtk")
    rate = N * CONTINUE_MOVES / dt
    print(f"# main path {facade.__name__}: {rate:.1f} moves/s on {card} "
          f"over "
          f"{CONTINUE_MOVES} continue moves of {N} particles on "
          f"{mesh.nelems} tets (per move ms: "
          f"{', '.join(f'{v:.3f}' for v in move_ms)}); conservation rel "
          f"err {rel:.3e}; launches {counts}")
    profile_move(t, pts[CONTINUE_MOVES + 2])
    return counts


def profile_move(t, dests: np.ndarray) -> None:
    """Where one continue move's time goes: wall time on the host clock,
    device-busy time as the union of the device activity intervals that
    torch.profiler records (kernels and copies; the CPU ops that launch
    them are not counted again), and the device activities that take
    most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t.MoveToNextLocation(None, flat(dests))
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    name = type(t).__name__
    if busy_us == 0:
        print(f"# profile {name}: wall {wall_ms:.3f} ms; device time not "
              "measured (the profiler saw none)")
        return
    print(f"# profile {name}: one continue move, wall {wall_ms:.3f} ms "
          f"(under the profiler), device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / 1e3 / wall_ms:.3f}")
    totals = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = totals.get(e.name, (0, 0.0))
            totals[e.name] = (n + 1, us + e.time_range.elapsed_us())
    for key, (n, us) in sorted(totals.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"#   {us / 1e3:9.3f} ms  x{n:<5d} {key[:90]}")


def main() -> int:
    import torch

    name, smi = phase_device()
    phase_build()

    from pumiumtally_tpu_torch import (
        PartitionedPumiTally,
        PumiTally,
        TallyConfig,
        build_box,
    )

    torch.manual_seed(0)
    mesh = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                     dtype=torch.float32)
    pts = make_trajectory(np.random.default_rng(0), N, CONTINUE_MOVES + 2)
    w0 = phase_w0(mesh, pts)
    w1 = phase_w1(mesh, pts)
    phase_oracle()
    mono = phase_main_path(PumiTally, mesh, pts,
                           TallyConfig(check_found_all=True), smi)
    part = phase_main_path(
        PartitionedPumiTally, mesh, pts,
        TallyConfig(capacity_factor=CAPACITY_FACTOR,
                    walk_vmem_max_elems=VMEM_BOUND), smi,
    )
    if mono["walk"] == 0 or part["block_walk"] == 0:
        raise AssertionError(
            f"a kernel of the main path never launched: {mono}, {part}"
        )
    w0["launches"] = mono["walk"] + part["walk"]
    w1["launches"] = mono["block_walk"] + part["block_walk"]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in (w0, w1)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
