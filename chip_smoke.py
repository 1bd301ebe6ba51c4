#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --w0-times      # W0's times alone, no checks
    python3 chip_smoke.py --w3-g1-times   # W3's and G1's, no checks

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name, and its name and power limit as nvidia-smi
   reports them.
2. Build: every kernel of the port, compiled from csrc/ with nvcc for
   sm_90a (build seconds and the ptxas register/shared-memory report;
   W0's registers and spills on a line of their own).
3. W0 (csrc/walk.cu) against its plain PyTorch version ``walk_plain`` on
   the card: a 48,000-tet box, 500,000 particles on bench.py's random
   trajectory, float32, tallying. The kernel counts the particles it
   walked, which must be all of them, and its time, tallying and not,
   stands beside the crossings per second and the SM cycles per
   crossing.
4. W1 (csrc/block_walk.cu) against ``vmem_walk_local_plain``: the same
   mesh sub-split into blocks of at most 1024 elements, every tallied
   round of the first move (round 1; round 2 is round 1's output after
   the engine's own ``_migrate``; and so on while particles pause at
   block faces), rounds 1 and 2 timed (device time from torch.profiler,
   CUDA events beside it) against each round's bytes bound. The kernel
   counts how many of its CUDA blocks found no active slot, walked with
   rows from global memory, or staged the table in shared memory by
   TMA, and the slots it walked and wrote out idle: each round must
   walk every active slot and write out every idle one, W1 must have
   staged and found empty shares, and never read rows from global
   memory.
5. W0's two-tier variant (csrc/walk.cu, bf16 select + f32 refinement
   tables) against the two-tier ``walk_plain``, as phase 3; then W0 in
   float64 on the box (100,000 particles) against ``walk_plain``.
6. W2 (csrc/twotier_block_walk.cu) against ``pallas_walk_local_plain``
   as phase 4, in both regimes: 24 blocks of <= 2,000 elements (the bf16
   tier doubles the 1024 bound; rows may be staged in shared memory),
   and one block of all 48,000 (rows read from global memory, one
   round); the first must stage and find empty shares, the second read
   global rows, so the three per-CUDA-block regimes all run.
7. W3 (csrc/resident_walk.cu) through its experiment entry point
   (``experiments/r3_vmem.py`` bench: the L sweep of
   tools/exp_r3_vmem.py with W3 and W0, launches counted over it), its
   SASS summarised (``cuobjdump -sass``: global and shared loads,
   atomics; one instance per regime, the shared-adjacency one with one
   global load fewer), then at each L = 750, 1,296, 2,058, 3,072
   (neighbour ids in shared memory) and 3,360 (ids read from global
   memory; each cell's L and regime asserted, both regimes run),
   500,000 particles on the tool's trajectory, against
   ``walk_vmem_plain``: the kernel's count of walked particles must be
   all of them, and its time stands beside the entry point's time a
   call, W0's on the same input, the SM cycles per crossing and the
   lanes' busy share (crossings / (32 x warp steps)).
8. G1 (csrc/row_gather.cu) through its experiment entry point
   (``experiments/pallas_gather.py``, both probes, launches counted over
   them), then both fill modes against ``gather_plain`` at the probes'
   shape (8,192 rows of [48000,32] f32) and at 500,000 rows, on in-range
   indices and on wrapped and out-of-range ones, with its bound,
   ``torch.index_select`` as the yardstick (nothing in the port calls
   it), an empty kernel, a fill of the output and a contiguous device
   copy of as many rows. The bound counts each distinct table row the
   indices name once.
9. Oracle: the reference's 6-tet unit-cube oracle in float64 through
   both facades on the card, held at 1e-8.
10. Main paths at bench.py's size (48,000 tets, 500,000 particles):
   ``PumiTally`` and ``PartitionedPumiTally`` on the float32 table, then
   both on the two-tier tables (``walk_table_dtype="bfloat16"``; the
   partitioned one with ``walk_kernel="pallas"``). Each:
   CopyInitialPosition, one two-phase move, then continue moves;
   track-length conservation at rtol 1e-6; WriteTallyResults; its
   kernels' launch counts > 0 in that run; moves/s; then one more
   continue move under torch.profiler: wall time, device-busy time, the
   kernels that take it and, on the partitioned facade, the block
   walk's kernel time in each round, its launches per move and their
   sum. A two-tier run's flux stays within the
   JAX package's tie-class band of the float32 run's (L1 < 1e-2 of the
   total track length, tests/test_walk_twotier.py).
11. The 3x3 pincell assembly (FLAGSHIP_PINCELL cells, 60 layers:
   984,960 tets), written with the port's ``write_osh`` into a
   temporary directory: W0 on both tiers against its plain version on
   that mesh (first move, beside the box's), then ``PumiTally`` built
   from the ``.osh`` path on both tiers through the main path of phase
   10 on bench.py's trajectory over the assembly's box. The two-tier
   flux is held to conservation and its L1 against the float32 flux
   reported (on this geometry the select tier moves more track length
   than the box's tie band, in the JAX package too).
12. One JSON line with each kernel's launches, times, bound and error,
   then the card's name and power limit, then the result line.

Kernel comparisons: element ids, done/exited/pending masks and ``iters``
must be equal; positions and ray coordinates are expected bitwise equal
(both sides build with no fused multiply-add): W1 holds them at 1e-6
absolute in float32, W0 (both tiers, both dtypes), W2 and W3 bitwise; flux
sums in another order (float atomics) and is held at rtol 1e-4. G1 moves
values without arithmetic and is held bitwise, NaN fills by position.

``--w0-times`` runs phases 1-2, then prints W0's times (tallying and
not, crossings, SM cycles per crossing) on the box and the lattice, on
both tiers, one JSON line a cell. It calls only what every checkout of
the port has (``PumiTally``, the ``walk`` wrapper, the plain steps), so
a copy of this file in another checkout times that checkout: an A/B of
two trees runs each tree's copy in turn.

``--w3-g1-times`` runs phases 1-2, prints the SASS summaries of W3 and
G1, then one JSON line a cell: W3 at each L of phase 7 (kernel ms over
four profiled passes, the entry point's ms a call, W0's ms, crossings,
SM cycles per crossing, the lanes' busy share where the checkout's
``walk_vmem`` takes ``counts``, the bound), G1 at both row counts in
both fill modes (microseconds over four passes, the bound,
``index_select``, the empty kernel, the output fill and the copy). It calls only ``r3_vmem.setup``, ``r3_vmem.walk_vmem``, ``walk``
and ``pallas_gather.gather``, so a copy times another checkout as
``--w0-times`` does.

It imports nothing of JAX; it needs one CUDA device and exits non-zero
without one.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

MESH_DIV = 20  # 20^3 cells -> 48,000 tets (bench.py MESH_DIV)
N = 500_000  # particles per batch (bench.py N)
CONTINUE_MOVES = 4
VMEM_BOUND = 1024  # bench.py run_vmem_blocked default bound
# Slots per CUDA block of the per-chunk grid the block walks' schedule
# replaced: each staged the table once its chunk held an active slot.
CHUNK_GRID_SLOTS = 256
CAPACITY_FACTOR = 2.0
CONSERVATION_RTOL = 1e-6
ORACLE_TOL = 1e-8
POS_ATOL = 1e-6
FLUX_RTOL = 1e-4
TIE_BAND = 1e-2  # two-tier vs float32 flux, L1 over total track length
BF16 = dict(walk_table_dtype="bfloat16")
K3_N = 500_000  # tools/exp_r3_vmem.py bench's default N
# W3's boxes (cells a side): the tool's sweep, L = 750, 1,296, 2,058 and
# 3,072 (neighbour ids in shared memory), and L = 3,360 (ids read from
# global memory).
W3_CELLS = ((5, 5, 5), (6, 6, 6), (7, 7, 7), (8, 8, 8), (8, 7, 10))
W3_REGIMES = {(8, 7, 10): "global adjacency"}  # else "shared adjacency"
# G1's gathered rows: the probes' T, and the main path's particle count.
G1_ROWS = (8192, 500_000)
# The 3x3 pincell assembly (BASELINE.json configs[0-1] geometry at
# assembly scale): FLAGSHIP_PINCELL cells, 60 layers -> 984,960 tets.
LATTICE, LATTICE_NZ = (3, 3), 60
# H100 SXM datasheet peaks: HBM bytes/s, f32 and f64 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
W0_F64_N = 100_000  # particles of the float64 W0 check on the box
# Operations per crossing in csrc/walk_step.cuh: per face two 3-term dot
# products (10), b (2), the crossing test (2), one division, the clamp
# and the running minimum (2); then the tally's subtract and multiply.
FLOPS_PER_CROSSING = 4 * 17 + 2
# The two-tier crossing (csrc/twotier_step.cuh): the select as above,
# then the winning face's refinement (16: the two dot products, b, the
# test, one division and the clamp); the lift is bit shifts.
FLOPS_PER_CROSSING_TWO_TIER = 4 * 17 + 16 + 2


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


def count_crossings(step, x, lelem, dest, active, base, tol) -> int:
    """Crossings this input needs: a lock-step replay of the walk that
    sums, per step, the particles still walking (block-local when
    ``base`` offsets stacked tables; a block exit ends the walk).
    ``step(rows, s, d0, dest, tol)`` is one crossing of every row: the
    plain versions' ``advance_cols`` on a packed table or
    ``advance_twotier`` on the two tiers."""
    import torch

    d0 = dest - x
    s = torch.zeros_like(d0[:, 0])
    e = lelem.long()
    tol_t = torch.tensor(tol, dtype=x.dtype, device=x.device)
    total = 0
    while bool(active.any()):
        total += int(active.sum())
        s_new, nxt, reached = step(base + e, s, d0, dest, tol_t)
        stop = reached | (nxt < 0)
        e = torch.where(active & ~stop, nxt.long(), e)
        s = torch.where(active, s_new, s)
        active = active & ~stop
    return total


def packed_step(table):
    from pumiumtally_tpu_torch.ops.walk import advance_cols

    return lambda rows, s, d0, dest, tol: advance_cols(table[rows], s, d0,
                                                       dest, tol)


def twotier_step(lo, hi):
    from functools import partial

    from pumiumtally_tpu_torch.ops.walk import advance_twotier

    return partial(advance_twotier, lo, hi)


def bound_entry(nbytes: float, crossings: int,
                flops_per_crossing: int = FLOPS_PER_CROSSING,
                flops: float = F32_FLOPS) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = crossings * flops_per_crossing / flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def sass_counts(name: str) -> dict:
    """For each kernel of the named library, from ``cuobjdump -sass``:
    its global loads (``LDG``), shared loads (``LDS``), and atomic and
    bulk-copy instructions by opcode. Empty where the toolkit has no
    cuobjdump."""
    from pumiumtally_tpu_torch import kernels

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(kernels._library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts = {}
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)",
                               sass, re.S):
        ops = re.findall(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                         body)
        c = {"LDG": sum(op.startswith("LDG") for op in ops),
             "LDS": sum(op.startswith("LDS") for op in ops)}
        for op in ops:
            if op.startswith(("ATOM", "RED", "UBLKCP", "SYNCS")):
                c[op] = c.get(op, 0) + 1
        counts[fn] = c
    return counts


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def sm_clock() -> tuple:
    """The card's SM count and maximum SM clock in Hz (SM cycles per
    crossing are counted at that clock)."""
    import torch

    hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    return torch.cuda.get_device_properties(0).multi_processor_count, hz


def phase_device() -> tuple:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    print(f"# device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {smi}")
    return name, smi


def phase_build() -> None:
    from pumiumtally_tpu_torch import kernels

    seconds = kernels.build()
    print(f"# build: {seconds:.2f} s for {sorted(kernels.SOURCES)}")
    for name in kernels.SOURCES:
        for line in kernels.build_log(name).splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"#   {name}: {line.strip()}")
    # W0's instances (float / double, packed table / two tiers):
    # registers and spills, from ptxas's report.
    kernel, spills = None, "spills not reported"
    for line in kernels.build_log("walk").splitlines():
        m = re.search(r"properties for _Z\d+walk_kernelI(\w)Lb(\d)E", line)
        if m:
            dtype = {"f": "float", "d": "double"}[m[1]]
            tier = ("packed", "two-tier")[int(m[2])]
            kernel = f"walk_kernel<{dtype}> ({tier})"
        elif kernel and "spill" in line:
            spills = line.strip()
        elif kernel and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)[1]
            print(f"# W0 {kernel}: {regs} registers; {spills}")
            kernel = None


def w0_inputs(mesh, pts, two_tier: bool = False, n: int = N) -> tuple:
    """The first move's walk inputs, localised by ``PumiTally``: the
    ``walk`` wrapper's positional arguments (``flux`` left out) and its
    keywords."""
    import torch

    from pumiumtally_tpu_torch import PumiTally, TallyConfig

    t = PumiTally(mesh, n, TallyConfig(check_found_all=False,
                                       **(BF16 if two_tier else {})))
    t.CopyInitialPosition(flat(pts[0][:n]))
    dev, dt = t.device, t.dtype
    assert t.mesh.two_tier == two_tier
    args = (t.mesh, t.x, t.elem,
            torch.as_tensor(pts[1][:n], dtype=dt, device=dev),
            torch.ones((n,), dtype=torch.int8, device=dev),
            torch.ones((n,), dtype=dt, device=dev))
    return args, dict(tally=True, tol=t._tol, max_iters=t._max_iters)


def w0_times(args, kw) -> dict:
    """W0's kernel time on these inputs, tallying (``ms``) and not
    (``untallied_ms``: no flux atomics; the main path's localisation and
    phase A), with CUDA events; the crossings the input needs and the SM
    cycles each costs at the card's maximum clock. It calls only the
    ``walk`` wrapper and the plain steps, as every checkout of the port
    has them."""
    import torch

    from pumiumtally_tpu_torch.ops.walk import walk

    m, x, elem, dest, fly, w = args
    zeros = lambda: torch.zeros((m.nelems,), dtype=x.dtype,  # noqa: E731
                                device=x.device)
    ms = cuda_ms(lambda: walk(*args, zeros(), **kw))
    untallied_ms = cuda_ms(lambda: walk(*args, None, **dict(kw, tally=False)))
    step = (twotier_step(m.walk_table_lo, m.walk_table_hi) if m.two_tier
            else packed_step(m.walk_table))
    crossings = count_crossings(step, x, elem, dest,
                                torch.ones_like(fly, dtype=torch.bool), 0,
                                kw["tol"])
    sms, hz = sm_clock()
    return {"ms": ms, "untallied_ms": untallied_ms, "crossings": crossings,
            "sm_cycles_per_crossing": ms * 1e-3 * sms * hz / crossings}


def phase_w0(mesh, pts, label: str = "", two_tier: bool = False,
             n: int = N) -> dict:
    """W0 (with ``two_tier``, its two-tier variant) vs walk_plain at the
    main path's shapes, in the mesh's dtype: ids, masks, iters, positions
    and s equal, flux at rtol 1e-4, and the kernel's count of walked
    particles equal to n. Prints crossings per second and SM cycles per
    crossing beside the kernel time, tallying and not."""
    import torch

    from pumiumtally_tpu_torch.ops.walk import walk, walk_plain

    name = "W0 two-tier" if two_tier else "W0"
    args, kw = w0_inputs(mesh, pts, two_tier, n)
    m, x = args[:2]

    def run(fn, **extra):
        flux = torch.zeros((m.nelems,), dtype=x.dtype, device=x.device)
        return fn(*args, flux, **kw, **extra)

    counts = torch.zeros((1,), dtype=torch.int32, device=x.device)
    rk, rp = run(walk, counts=counts), run(walk_plain)
    sync()
    for f in ("elem", "done", "exited", "iters", "x", "s"):
        check_equal(f"{name}{label} {f}", getattr(rk, f), getattr(rp, f))
    err_f = check_flux(f"{name}{label}", rk.flux, rp.flux)
    walked = int(counts[0])
    if walked != n:
        raise AssertionError(f"{name}{label}: the kernel walked {walked} "
                             f"particles, not {n}")
    times = w0_times(args, kw)
    ms, crossings = times["ms"], times["crossings"]
    plain_ms = wall_ms(lambda: run(walk_plain))
    k = x.element_size()
    # x, dest, elem, fly, w in; x, elem, done, exited, s out; each tet's
    # rows (the packed row, or the select row and four refinement rows)
    # and its flux read and written.
    row_bytes = 32 + 4 * 5 * k if two_tier else 20 * k
    nbytes = n * (11 * k + 11) + m.nelems * (row_bytes + 2 * k)
    bound = bound_entry(nbytes, crossings,
                        FLOPS_PER_CROSSING_TWO_TIER if two_tier
                        else FLOPS_PER_CROSSING,
                        F32_FLOPS if k == 4 else F64_FLOPS)
    sms, hz = sm_clock()
    print(f"# {name}{label}: {ms:.3f} ms kernel ({times['untallied_ms']:.3f}"
          f" ms untallied), {plain_ms:.3f} ms plain; {crossings} crossings, "
          f"{crossings / ms / 1e6:.3f} G crossings/s, "
          f"{times['sm_cycles_per_crossing']:.2f} SM cycles per crossing "
          f"({sms} SMs at {hz / 1e9:.3f} GHz max); walked {walked} of {n}; "
          f"x, s bitwise; flux max abs diff {err_f:.3e}; bound {bound}")
    return {"name": "W0 walk (two-tier)" if two_tier else "W0 walk",
            "route": "cuda",
            "source": "pumiumtally_tpu_torch/csrc/walk.cu",
            "replaces": ("pumiumtally_tpu/ops/walk.py:425" if two_tier
                         else "pumiumtally_tpu/ops/walk.py:449"),
            "max_abs_err": err_f, "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": None}


def phase_block_walk(kind: str, mesh, pts, bound, shared: bool = True):
    """W1 (``kind`` "W1", float32 tables) or W2 ("W2", two-tier tables)
    against its plain version on every tallied round of the first move's
    phase, each round's input migrated from the kernel's previous output
    by the engine's own ``_migrate``: ids, masks, pending and iters
    equal, positions at 1e-6 (W1) or bitwise (W2), flux at rtol 1e-4;
    the kernel's slot counts equal to the round's active and idle slots.
    ``bound`` 1024 sub-splits the box (W1: 47 blocks, W2: 24 blocks whose
    bf16 rows may be staged in shared memory); W2 with None walks one
    block of the whole mesh from global memory (one round). Rounds 1 and
    2 are timed. Returns the kernel entry (round 1) and the CUDA blocks
    per regime summed over the rounds."""
    import torch

    from pumiumtally_tpu_torch import PartitionedPumiTally, TallyConfig
    from pumiumtally_tpu_torch.experiments.block_rounds import round_bytes
    from pumiumtally_tpu_torch.ops.pallas_walk import (
        pallas_walk_local,
        pallas_walk_local_plain,
        w2_uses_shared,
    )
    from pumiumtally_tpu_torch.ops.vmem_walk import (
        SCHED_COUNTS,
        vmem_walk_local,
        vmem_walk_local_plain,
    )

    w2 = kind == "W2"
    cfg = dict(walk_kernel="pallas", **BF16) if w2 else {}
    t = PartitionedPumiTally(
        mesh, N, TallyConfig(capacity_factor=CAPACITY_FACTOR,
                             walk_vmem_max_elems=bound,
                             check_found_all=False, **cfg),
    )
    t.CopyInitialPosition(flat(pts[0]))
    eng = t.engine
    L, dev = eng.part.L, t.device
    if w2 and w2_uses_shared(L, torch.float32) != shared:
        raise AssertionError(f"W2: blocks of {L} elements are not in the "
                             f"{'shared' if shared else 'global'} regime")
    if w2:
        tables = (eng.part.table, eng.part.table_hi)
        kernel, plain = pallas_walk_local, pallas_walk_local_plain
        step = twotier_step(*tables)
        flops = FLOPS_PER_CROSSING_TWO_TIER
        row_bytes = 32 + 4 * 20  # select row, four refinement rows
    else:
        tables = (eng.part.table,)
        kernel, plain = vmem_walk_local, vmem_walk_local_plain
        step = packed_step(eng.part.table)
        flops = FLOPS_PER_CROSSING
        row_bytes = 80
    staged_row = tables[0].shape[1] * tables[0].element_size()
    kw = dict(tally=True, tol=eng.tol, max_iters=eng.max_iters,
              blocks=eng.nparts)
    # The first move's tallied round 1 as the engine builds it.
    st = dict(eng.state)
    st["fly"] = st["alive"].to(torch.int8)
    st["w"] = st["fly"].to(torch.float32)
    st["done"] = ~st["alive"]
    st["exited"] = torch.zeros_like(st["done"])
    st["dest"] = eng._by_pid(torch.as_tensor(pts[1], dtype=torch.float32,
                                             device=dev), 0.0)

    def run(fn, st, **extra):
        flux = torch.zeros_like(eng.flux_padded)
        return fn(*tables, st["x"], st["lelem"], st["dest"], st["fly"],
                  st["w"], st["done"], st["exited"], flux, **kw, **extra)

    regimes = np.zeros(3, dtype=np.int64)
    staged, chunk_grid_staged, timed, err = [], [], [], 0.0
    S = st["x"].shape[0]
    base = (torch.arange(S, device=dev) // eng.cap_per_block) * L
    label = kind if not w2 else f"W2 ({'shared' if shared else 'global'})"
    for r in range(1, eng.max_rounds + 1):
        counts = torch.zeros(len(SCHED_COUNTS), dtype=torch.int32,
                             device=dev)
        rk = run(kernel, st, sched_counts=counts)
        rp = run(plain, st)
        sync()
        for i, f in ((1, "lelem"), (2, "done"), (3, "exited"),
                     (4, "pending"), (6, "iters")):
            check_equal(f"{label} round {r} {f}", rk[i], rp[i])
        if w2:
            check_equal(f"{label} round {r} x", rk[0], rp[0])
        elif max_abs(rk[0], rp[0]) > POS_ATOL:
            raise AssertionError(f"{label} round {r}: positions differ by "
                                 f"{max_abs(rk[0], rp[0])}")
        err = max(err, max_abs(rk[0], rp[0]),
                  check_flux(f"{label} round {r}", rk[5], rp[5]))
        c = counts.cpu().numpy()
        n_active = int((~st["done"]).sum())
        if (c[3], c[4]) != (n_active, S - n_active):
            raise AssertionError(
                f"{label} round {r}: the kernel walked {c[3]} slots and "
                f"wrote out {c[4]} idle ones; the round has {n_active} "
                f"active of {S}")
        regimes += c[:3]
        staged.append(int(c[2]) * L * staged_row)
        # What the per-chunk grid would stage on this round's masks.
        live = torch.nn.functional.pad(
            (~st["done"]).view(eng.nparts, eng.cap_per_block),
            (0, -eng.cap_per_block % CHUNK_GRID_SLOTS))
        chunks = live.view(eng.nparts, -1, CHUNK_GRID_SLOTS).any(dim=2)
        chunk_grid_staged.append(int(chunks.sum()) * L * staged_row)
        n_paused = int((rk[4] >= 0).sum())
        if r <= 2:
            x0 = st["x"]
            dest_c = x0 + (st["dest"] - x0) if w2 else st["dest"]
            crossings = count_crossings(step, x0, st["lelem"], dest_c,
                                        ~st["done"], base, eng.tol)
            nbytes = round_bytes(st["done"], st["exited"], eng.nparts, L,
                                 row_bytes, 4)
            bound_r = bound_entry(nbytes, crossings, flops)
            ev_ms = cuda_ms(lambda: run(kernel, st))
            dev_ms = device_us(lambda: run(kernel, st), 5,
                               "block_walk_kernel") / 1e3
            plain_ms = wall_ms(lambda: run(plain, st))
            # The profiler's device time: a later round's kernel takes less
            # time on the card than its wrapper on the host, so events
            # around back-to-back calls (printed beside) time the host.
            timed.append(dict(ms=dev_ms, plain_ms=plain_ms, **bound_r))
            print(f"# {label} round {r}: {eng.nparts} blocks of <= {L} "
                  f"elements, {eng.cap_per_block} slots each, {n_active} "
                  f"active; {ev_ms:.4f} ms kernel (events), {dev_ms:.4f} "
                  f"ms (profiler), {plain_ms:.3f} ms plain; {crossings} "
                  f"crossings, {n_paused} paused; counts "
                  f"{dict(zip(SCHED_COUNTS, c.tolist()))}, {staged[-1]} B "
                  f"staged (a per-chunk grid: {chunk_grid_staged[-1]} B); "
                  f"{nbytes} B to move, bound {bound_r}")
        if n_paused == 0:
            break
        st = eng._migrate(dict(st, x=rk[0], lelem=rk[1], done=rk[2],
                               exited=rk[3], pending=rk[4]))
    if (r > 1) != (eng.nparts > 1):
        raise AssertionError(f"{label}: {r} rounds over {eng.nparts} blocks")
    print(f"# {label}: {r} rounds, each equal to the plain version and "
          f"walking every active slot once; CUDA blocks per regime over "
          f"them {dict(zip(SCHED_COUNTS, regimes.tolist()))}; staged bytes "
          f"per round {staged} (a per-chunk grid: {chunk_grid_staged})")
    name, src, line = (
        ("W2 twotier_block_walk", "twotier_block_walk.cu",
         "pumiumtally_tpu/ops/pallas_walk.py:175") if w2 else
        ("W1 block_walk", "block_walk.cu",
         "pumiumtally_tpu/ops/vmem_walk.py:250"))
    return {"name": name, "route": "cuda",
            "source": f"pumiumtally_tpu_torch/csrc/{src}", "replaces": line,
            "max_abs_err": err, **timed[0], "library_ms": None}, regimes


def w3_setup(dims: tuple):
    """The tool's W3 inputs (``r3_vmem.setup``: K3_N particles localized
    in a float32 unit box, destinations one normal step away) on a box
    of nx x ny x nz cells. ``setup`` builds cubes; a box of other sides
    goes through the same recipe with its ``build_box`` call widened."""
    from unittest import mock

    from pumiumtally_tpu_torch.experiments import r3_vmem

    if len(set(dims)) == 1:
        inputs = r3_vmem.setup(dims[0], K3_N, seed=0)
    else:
        box = r3_vmem.build_box
        with mock.patch.object(r3_vmem, "build_box",
                               lambda *a, **kw: box(1, 1, 1, *dims, **kw)):
            inputs = r3_vmem.setup(dims[0], K3_N, seed=0)
    L = inputs[0].nelems
    if L != 6 * math.prod(dims):
        raise AssertionError(f"W3 inputs: a box of {dims} cells gave {L} "
                             f"tets, not {6 * math.prod(dims)}")
    return inputs


def w3_regime(L: int) -> str:
    """W3's regime at L in this checkout: where its neighbour ids live
    (a checkout without the shared-adjacency regime reads them from
    global memory at every L)."""
    from pumiumtally_tpu_torch.experiments import r3_vmem

    shared = getattr(r3_vmem, "w3_shared_adj", lambda L: False)(L)
    return "shared adjacency" if shared else "global adjacency"


def w3_times(inputs, passes: int) -> dict:
    """W3's kernel time on one cell over ``passes`` profiled passes of 5
    calls, W0's on the same input, the crossings the input needs and the
    SM cycles each costs at the card's maximum clock, the bytes bound,
    and, where this checkout's ``walk_vmem`` takes ``counts``, the
    particles walked, the warp steps and the lanes' busy share
    (crossings / (32 x warp steps)). ``entry_ms`` is the entry point's
    own time per call (CUDA events around 10 back-to-back calls of
    ``walk_vmem``, as ``r3_vmem.bench`` times it): the kernel plus what
    the wrapper does around it. It calls only ``walk_vmem`` and ``walk``,
    as every checkout of the port has them."""
    import inspect

    import torch

    from pumiumtally_tpu_torch.experiments import r3_vmem
    from pumiumtally_tpu_torch.ops.walk import walk

    mesh, x, elem, dest = inputs
    L, n, dev = mesh.nelems, x.shape[0], x.device
    fly = torch.ones((n,), dtype=torch.int8, device=dev)
    w = torch.ones((n,), dtype=torch.float32, device=dev)
    kw = dict(tol=r3_vmem.TOL, max_iters=r3_vmem.MAX_ITERS)

    def run(fn, **extra):
        flux = torch.zeros((L,), dtype=torch.float32, device=dev)
        return fn(mesh, x, elem, dest, fly, w, flux, **kw, **extra)

    ms = [device_us(lambda: run(r3_vmem.walk_vmem), 5, "resident_walk") / 1e3
          for _ in range(passes)]
    entry_ms = cuda_ms(lambda: run(r3_vmem.walk_vmem), 10)
    w0_ms = device_us(lambda: run(lambda *a, **k: walk(*a, tally=True, **k)),
                      5, "walk_kernel<") / 1e3
    crossings = count_crossings(packed_step(mesh.walk_table), x, elem, dest,
                                torch.ones_like(fly, dtype=torch.bool), 0,
                                r3_vmem.TOL)
    sms, hz = sm_clock()
    # Per particle as W0 (x, dest, elem, fly, w in; x, elem, done,
    # exited, s out); per element the plane row, the ids, flux in and out.
    nbytes = n * (12 + 12 + 4 + 1 + 4 + 12 + 4 + 1 + 1 + 4) + L * (64 + 16
                                                                    + 8)
    out = {"L": L, "regime": w3_regime(L), "n": n, "ms": ms,
           "entry_ms": entry_ms, "w0_ms": w0_ms,
           "crossings": crossings,
           "sm_cycles_per_crossing": [t * 1e-3 * sms * hz / crossings
                                      for t in ms],
           "walked": None, "warp_steps": None, "busy_share": None,
           **bound_entry(nbytes, crossings)}
    if "counts" in inspect.signature(r3_vmem.walk_vmem).parameters:
        counts = torch.zeros((2,), dtype=torch.int32, device=dev)
        run(r3_vmem.walk_vmem, counts=counts)
        walked, steps = (int(c) for c in counts.tolist())
        out.update(walked=walked, warp_steps=steps,
                   busy_share=crossings / (32 * steps) if steps else None)
    return out


def phase_w3() -> dict:
    """W3 (csrc/resident_walk.cu) through its experiment entry point
    ``r3_vmem.bench`` (the tool's L sweep with W3 and W0), launches
    counted over that run; then, at each W3_CELLS box, W3 against
    ``walk_vmem_plain`` on the tool's inputs (ids, masks, x and s equal,
    flux at rtol 1e-4, walked == n), its time, busy share and SM cycles
    per crossing, and W0's time on the same input."""
    import torch

    from pumiumtally_tpu_torch import kernels
    from pumiumtally_tpu_torch.experiments import r3_vmem

    kernels.reset_launch_counts()
    r3_vmem.bench(K3_N)
    launches = kernels.launch_counts["resident_walk"]
    if launches == 0:
        raise AssertionError("W3: r3_vmem.bench never launched it")
    sass = sass_counts("resident_walk")
    print(f"# W3 SASS: {sass}")
    if not sass:
        raise AssertionError("W3: no cuobjdump in the CUDA toolkit; the "
                             "global loads of its instances go unchecked")
    # The two regimes' instances (template kSharedAdj true: ILb1E, false:
    # ILb0E) differ by the global read of a neighbour id: the
    # shared-adjacency one reads no mesh data from global memory (its
    # loads are the staging copy's and a refilled particle's inputs).
    ldg = {fn: c["LDG"] for fn, c in sass.items()}
    shared = [n for fn, n in ldg.items() if "ILb1E" in fn]
    glob = [n for fn, n in ldg.items() if "ILb0E" in fn]
    if len(shared) != 1 or len(glob) != 1:
        raise AssertionError(f"W3: global loads per instance {ldg}; "
                             "expected one instance of each regime")
    if glob[0] - shared[0] != 1:
        raise AssertionError(f"W3: global loads per instance {ldg}; the "
                             "shared-adjacency one should read one fewer")
    entry, regimes = None, set()
    for dims in W3_CELLS:
        mesh, x, elem, dest = inputs = w3_setup(dims)
        L, dev = mesh.nelems, x.device
        regime = W3_REGIMES.get(dims, "shared adjacency")
        if w3_regime(L) != regime:
            raise AssertionError(f"W3 (L={L}): regime {w3_regime(L)!r}, "
                                 f"expected {regime!r}")
        regimes.add(regime)
        fly = torch.ones((K3_N,), dtype=torch.int8, device=dev)
        w = torch.ones((K3_N,), dtype=torch.float32, device=dev)
        kw = dict(tol=r3_vmem.TOL, max_iters=r3_vmem.MAX_ITERS)

        def run(fn):
            flux = torch.zeros((L,), dtype=torch.float32, device=dev)
            return fn(mesh, x, elem, dest, fly, w, flux, **kw)

        rk, rp = run(r3_vmem.walk_vmem), run(r3_vmem.walk_vmem_plain)
        sync()
        for f in ("elem", "done", "exited", "x", "s"):
            check_equal(f"W3 (L={L}) {f}", getattr(rk, f), getattr(rp, f))
        err_f = check_flux(f"W3 (L={L})", rk.flux, rp.flux)
        t = w3_times(inputs, passes=1)
        if t["walked"] != K3_N:
            raise AssertionError(f"W3 (L={L}): the kernel walked "
                                 f"{t['walked']} particles, not {K3_N}")
        ms = t["ms"][0]
        plain_ms = wall_ms(lambda: run(r3_vmem.walk_vmem_plain))
        bound = {k: t[k] for k in ("bound_ms", "bound_by")}
        print(f"# W3 (L={L}, {t['regime']}, N={K3_N}): {ms:.4f} ms kernel "
              f"(profiler), {t['entry_ms']:.4f} ms a walk_vmem call (events), "
              f"{plain_ms:.3f} ms plain, W0 {t['w0_ms']:.4f} ms "
              f"(profiler) on the same input; {t['crossings']} crossings, "
              f"{t['sm_cycles_per_crossing'][0]:.2f} SM cycles per "
              f"crossing, lanes busy {t['busy_share']:.3f} "
              f"({t['warp_steps']} warp steps); walked {t['walked']} of "
              f"{K3_N}; x, s bitwise; flux max abs diff {err_f:.3e}; bound "
              f"{bound}")
        if L == 6 * max(r3_vmem.BENCH_DIVS) ** 3:  # the tool's largest mesh
            entry = {"name": f"W3 resident_walk (L={L})", "route": "cuda",
                     "source": "pumiumtally_tpu_torch/csrc/resident_walk.cu",
                     "replaces": "tools/exp_r3_vmem.py:172",
                     "launches": launches, "max_abs_err": err_f, "ms": ms,
                     "plain_ms": plain_ms, **bound, "library_ms": None}
    if regimes != set(W3_REGIMES.values()) | {"shared adjacency"}:
        raise AssertionError(f"W3: the cells ran the regimes {regimes}")
    return entry


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls, with CUDA
    events around calls queued behind a sleep kernel: the card runs them
    back to back, so host launch gaps are not timed, but every device
    operation of a call is (a wrapper's zero fills too)."""
    import torch

    fn()
    sync()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(20_000_000)  # ~10 ms: time to queue the calls
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def device_us(fn, reps: int = 100, name: str = "") -> float:
    """Device time per call of ``fn`` in microseconds: the summed
    duration of the device activities whose name contains ``name`` that
    torch.profiler records over ``reps`` calls. Unlike CUDA events
    around back-to-back calls it holds no host gaps, which matter for a
    kernel that takes less time on the card than its wrapper takes to
    launch it. The profiler now and then misses some or all of a
    window's device activity: a window whose count of such activities is
    not a positive multiple of ``reps`` is profiled again, twice at most;
    after three such windows ``queued_ms`` times the calls instead. Each
    retry prints a line."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and name in e.name]
        if spans and len(spans) % reps == 0:
            return sum(spans) / reps
        print(f"# profiler retry: {len(spans)} device activities named "
              f"{name!r} over {reps} calls; profiling again")
    us = queued_ms(fn, reps) * 1e3
    print(f"# profiler retry: it missed {name!r} in three windows; timed "
          f"with events behind a sleep kernel instead: {us:.3f} us a call")
    return us


def same_bits(what: str, got, want) -> None:
    """NaN at the same places and every other value bit for bit."""
    import torch

    nan = want.isnan()
    check_equal(f"{what} NaN mask", got.isnan(), nan)
    check_equal(what, got[~nan].view(torch.int32),
                want[~nan].view(torch.int32))


def g1_inputs(rows: int):
    """The probes' [E,W] table and ``rows`` in-range indices: the probes'
    own input at their T, else indices from seed 2."""
    import torch

    from pumiumtally_tpu_torch.experiments import pallas_gather as pg

    tab, idx = pg.probe_inputs("cuda")
    if rows != pg.T:
        idx = torch.as_tensor(np.random.default_rng(2).integers(
            0, pg.E, rows).astype(np.int32), device=tab.device)
    return tab, idx


def g1_times(tab, idx, fill: float, passes: int) -> dict:
    """G1's kernel time (microseconds, ``passes`` profiled passes) at
    this input beside its bytes bound, ``torch.index_select``'s time
    (the yardstick; nothing in the port calls it) and three yardsticks:
    an empty kernel (``torch.cuda._sleep(0)``, one thread reading the
    clock once), a fill of the [T, W] output (the gather's writes alone)
    and a contiguous device copy of T rows (the gather's bytes at the
    probes' shape; at T above the table's E rows it reads T rows where
    the gather reads at most E from memory, so it is no floor there).
    The bound counts each index read once, each distinct table row the
    indices name read once, and each output row written once. It calls
    only ``pallas_gather.gather``, as every checkout of the port has it."""
    import torch

    from pumiumtally_tpu_torch.experiments import pallas_gather as pg

    rows, width = idx.shape[0], tab.shape[1]
    reps = 100 if rows <= pg.T else 10
    us = [device_us(lambda: pg.gather(tab, idx, fill), reps, "row_gather")
          for _ in range(passes)]
    lib_us = device_us(lambda: torch.index_select(tab, 0, idx), reps)
    empty_us = device_us(lambda: torch.cuda._sleep(0), reps, "spin")
    # The copy's source: the table's first rows, or (more rows than the
    # table has) a contiguous [rows, W] tensor.
    src = (tab[:rows] if rows <= tab.shape[0]
           else torch.randn((rows, width), device=tab.device))
    dst = torch.empty_like(src)
    copy_us = device_us(lambda: dst.copy_(src), reps, "Memcpy")
    out = torch.empty((rows, width), dtype=tab.dtype, device=tab.device)
    fill_us = device_us(lambda: out.fill_(1.0), reps, "Fill")
    E = tab.shape[0]
    distinct = int(torch.unique(torch.where(idx < 0, idx + E, idx)).numel())
    nbytes = rows * 4 + (distinct + rows) * width * 4
    return {"E": E, "W": width, "T": rows, "distinct_rows": distinct,
            "us": us, "bound_us": bound_entry(nbytes, 0)["bound_ms"] * 1e3,
            "index_select_us": lib_us, "empty_kernel_us": empty_us,
            "fill_us": fill_us, "copy_us": copy_us}


def phase_g1() -> list:
    """G1 (csrc/row_gather.cu) through its experiment entry point, the
    probe ``pallas_gather.main`` in both fill modes (launches counted
    over those runs); then, at each of G1_ROWS, each mode against
    ``gather_plain`` bitwise on in-range indices and on wrapped and
    out-of-range ones, and its time (``g1_times``) beside its bound,
    ``torch.index_select`` and the two floors."""
    import torch

    from pumiumtally_tpu_torch import kernels
    from pumiumtally_tpu_torch.experiments import pallas_gather as pg

    kernels.reset_launch_counts()
    for variant in pg.VARIANTS:
        if not pg.main(variant)["ok"]:
            raise AssertionError(f"G1 {variant}: the probe's check failed")
    counts = dict(kernels.launch_counts)
    entries = []
    for rows in G1_ROWS:
        tab, idx = g1_inputs(rows)
        rng = np.random.default_rng(1)
        wild = rng.integers(-2 * pg.E, 2 * pg.E, rows)
        wild[:6] = [0, pg.E - 1, -1, -pg.E, pg.E, -pg.E - 1]
        wild = torch.as_tensor(wild.astype(np.int32), device=tab.device)
        for variant, (tool, line) in (("take", ("exp_pallas_gather.py", 14)),
                                      ("take_along_axis",
                                       ("exp_pallas_gather2.py", 15))):
            fill = pg.VARIANTS[variant][1]
            for ix in (idx, wild):
                same_bits(f"G1 {variant} (T={rows})",
                          pg.gather(tab, ix, fill),
                          pg.gather_plain(tab, ix, fill))
            t = g1_times(tab, idx, fill, passes=1)
            plain_ms = wall_ms(lambda: pg.gather_plain(tab, idx, fill))
            entry_name = f"row_gather_{variant}"
            print(f"# G1 {variant} ([{pg.E},{pg.W}] f32, {rows} rows): "
                  f"{t['us'][0]:.3f} us kernel, bound {t['bound_us']:.3f} us "
                  f"(bytes), torch.index_select {t['index_select_us']:.3f} "
                  f"us, empty kernel {t['empty_kernel_us']:.3f} us, "
                  f"output fill {t['fill_us']:.3f} us, contiguous copy of "
                  f"T rows {t['copy_us']:.3f} us (profiler); "
                  f"{plain_ms:.3f} ms plain; bitwise incl. wrapped and "
                  f"out-of-range indices")
            if rows != pg.T:
                continue
            if counts[entry_name] == 0:
                raise AssertionError(f"G1: the probe never launched "
                                     f"{entry_name}")
            entries.append({
                "name": f"G1 {entry_name}", "route": "cuda",
                "source": "pumiumtally_tpu_torch/csrc/row_gather.cu",
                "replaces": f"tools/{tool}:{line}",
                "launches": counts[entry_name], "max_abs_err": 0.0,
                "ms": t["us"][0] / 1e3, "plain_ms": plain_ms,
                "bound_ms": t["bound_us"] / 1e3, "bound_by": "bytes",
                "library_ms": t["index_select_us"] / 1e3})
    return entries


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


def phase_main_path(facade, mesh, pts, config, card: str) -> tuple:
    """CopyInitialPosition, one two-phase move, then continue moves of N
    particles; conservation, output file, launch counts, rate. ``mesh``
    is a TetMesh or a mesh file's path. Returns the launch counts and
    the flux after the continue moves."""
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
    flux = t.flux.double().clone()
    with tempfile.TemporaryDirectory() as d:
        t.WriteTallyResults(f"{d}/fluxresult.vtk")
    rate = N * CONTINUE_MOVES / dt
    tier = config.resolved_table_dtype()
    print(f"# main path {facade.__name__} ({tier} tables): {rate:.1f} "
          f"moves/s on {card} "
          f"over "
          f"{CONTINUE_MOVES} continue moves of {N} particles on "
          f"{t.mesh.nelems} tets (per move ms: "
          f"{', '.join(f'{v:.3f}' for v in move_ms)}); conservation rel "
          f"err {rel:.3e}; launches {counts}")
    profile_move(t, pts[CONTINUE_MOVES + 2])
    return counts, flux


def profile_move(t, dests: np.ndarray) -> None:
    """Where one continue move's time goes: wall time on the host clock,
    device-busy time as the union of the device activity intervals that
    torch.profiler records (kernels and copies; the CPU ops that launch
    them are not counted again), and the device activities that take
    most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pumiumtally_tpu_torch import kernels

    before = dict(kernels.launch_counts)
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
    walks = sorted((e.time_range.start, e.time_range.elapsed_us() / 1e3)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "block_walk_kernel" in e.name)
    if walks:
        # The profiler now and then misses kernels: the wrappers' own
        # count of this move's launches stands beside its list.
        launched = sum(kernels.launch_counts[k] - before[k]
                       for k in ("block_walk", "twotier_block_walk"))
        print(f"#   block walk per round (ms): "
              f"{', '.join(f'{ms:.4f}' for _, ms in walks)}; "
              f"{len(walks)} launches profiled of {launched} made, "
              f"{sum(ms for _, ms in walks):.4f} ms per move")


def write_lattice(directory: str) -> tuple:
    """The 3x3 lattice written with the port's ``write_osh``: its path,
    and bench.py's trajectory over its box (``run_pincell``'s seed)."""
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )
    from pumiumtally_tpu_torch.io.osh import write_osh
    from pumiumtally_tpu_torch.mesh.pincell import (
        FLAGSHIP_PINCELL,
        lattice_arrays,
    )

    params = dict(FLAGSHIP_PINCELL, nz=LATTICE_NZ)
    t0 = time.perf_counter()
    coords, tets, _, _ = lattice_arrays(*LATTICE, **params)
    path = f"{directory}/lattice.osh"
    write_osh(path, coords, tets)
    box = [LATTICE[0] * params["pitch"], LATTICE[1] * params["pitch"],
           params["height"]]
    print(f"# lattice: {LATTICE[0]}x{LATTICE[1]} FLAGSHIP_PINCELL cells, "
          f"nz={LATTICE_NZ}: {tets.shape[0]} tets, {coords.shape[0]} "
          f"vertices, box {box}; generated and written as .osh in "
          f"{time.perf_counter() - t0:.1f} s")
    pts = make_trajectory(np.random.default_rng(1), N, CONTINUE_MOVES + 2,
                          box=box)
    return path, pts


def check_tie_band(what: str, flux_bf16, flux_f32, band=TIE_BAND) -> None:
    """Two-tier vs float32 flux: on the box, face ties below bf16
    precision move track length between neighbouring tets, within the
    tie-class band. ``band=None`` reports the L1 only."""
    l1 = float((flux_bf16 - flux_f32).abs().sum()) / float(flux_f32.sum())
    print(f"# two-tier vs float32 flux ({what}): L1 {l1:.3e} of the total "
          f"track length")
    if band is not None and l1 > band:
        raise AssertionError(f"{what}: two-tier flux L1 {l1} outside the "
                             f"tie-class band {TIE_BAND}")


def main() -> int:
    import torch

    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()

    from pumiumtally_tpu_torch import (
        PartitionedPumiTally,
        PumiTally,
        TallyConfig,
        build_box,
    )
    from pumiumtally_tpu_torch.io.load import load_mesh

    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )

    torch.manual_seed(0)
    mesh = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                     dtype=torch.float32)
    pts = make_trajectory(np.random.default_rng(0), N, CONTINUE_MOVES + 2)
    w0 = phase_w0(mesh, pts)
    w1, regimes_w1 = phase_block_walk("W1", mesh, pts, VMEM_BOUND)
    w0t = phase_w0(mesh, pts, two_tier=True)
    phase_w0(build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                       dtype=torch.float64), pts, " (float64)", n=W0_F64_N)
    w2, regimes_w2 = phase_block_walk("W2", mesh, pts, VMEM_BOUND)
    _, regimes_w2g = phase_block_walk("W2", mesh, pts, None, shared=False)
    # Which regimes each run can take: a staging launch stages every
    # non-empty share, so only W2's global run reads global rows.
    for label, regimes, ran in (("W1", regimes_w1, (1, 0, 1)),
                                ("W2 (shared)", regimes_w2, (1, 0, 1)),
                                ("W2 (global)", regimes_w2g, (0, 1, 0))):
        if tuple(int(c > 0) for c in regimes) != ran:
            raise AssertionError(f"{label}: CUDA blocks per regime "
                                 f"{regimes.tolist()}, expected the "
                                 f"regimes {ran} to run")
    w3 = phase_w3()
    g1 = phase_g1()
    phase_oracle()
    part_cfg = dict(capacity_factor=CAPACITY_FACTOR,
                    walk_vmem_max_elems=VMEM_BOUND)
    runs = {
        "mono": (PumiTally, TallyConfig(check_found_all=True)),
        "part": (PartitionedPumiTally, TallyConfig(**part_cfg)),
        "mono_bf16": (PumiTally, TallyConfig(**BF16)),
        "part_bf16": (PartitionedPumiTally,
                      TallyConfig(walk_kernel="pallas", **BF16, **part_cfg)),
    }
    counts, fluxes = {}, {}
    for key, (facade, config) in runs.items():
        counts[key], fluxes[key] = phase_main_path(facade, mesh, pts, config,
                                                   smi)
    # The lattice, loaded from its .osh path as users load a mesh: W0
    # on both tiers against the plain versions, then PumiTally's main
    # path on both tiers.
    with tempfile.TemporaryDirectory() as d:
        path, lat_pts = write_lattice(d)
        lat_mesh = load_mesh(path, dtype=torch.float32)
        lw0 = phase_w0(lat_mesh, lat_pts, " (lattice)")
        lw0t = phase_w0(lat_mesh, lat_pts, " (lattice)", two_tier=True)
        print(f"# W0 first move: lattice {lw0['ms']:.3f} ms vs box "
              f"{w0['ms']:.3f} ms; two-tier lattice {lw0t['ms']:.3f} ms vs "
              f"box {w0t['ms']:.3f} ms")
        del lat_mesh
        for key, config in (("lat", TallyConfig(check_found_all=True)),
                            ("lat_bf16", TallyConfig(**BF16))):
            counts[key], fluxes[key] = phase_main_path(PumiTally, path,
                                                       lat_pts, config, smi)
    needs = {"mono": "walk", "part": "block_walk", "mono_bf16": "walk_twotier",
             "part_bf16": "twotier_block_walk", "lat": "walk",
             "lat_bf16": "walk_twotier"}
    for key, entry in needs.items():
        if counts[key][entry] == 0:
            raise AssertionError(f"{key}: kernel {entry} never launched on "
                                 f"its main path: {counts[key]}")
    for arm in ("mono", "part"):
        check_tie_band(arm, fluxes[f"{arm}_bf16"], fluxes[arm])
    # On the lattice the bf16 plane offsets (coordinates up to 3.78, an
    # ulp of 2^-6 above 2) are coarse against its 1/60-thick layers, so
    # the select tier misattributes a share of the track length that is
    # not a tie class; the JAX package does the same
    # (tests/test_torch_pincell.py holds the port's two-tier flux to
    # it). Here the two-tier run is held to conservation and W0's
    # two-tier variant to its plain version on this mesh; the L1 is
    # reported.
    check_tie_band("lat", fluxes["lat_bf16"], fluxes["lat"], band=None)
    for e, entry in ((w0, "walk"), (w1, "block_walk"), (w0t, "walk_twotier"),
                     (w2, "twotier_block_walk")):
        e["launches"] = sum(c[entry] for c in counts.values())
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in (w0, w1, w0t, w2, w3, *g1)]}))
    print(f"# total: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def main_w0_times() -> int:
    import torch

    from pumiumtally_tpu_torch import build_box
    from pumiumtally_tpu_torch.experiments.block_rounds import (
        make_trajectory,
    )
    from pumiumtally_tpu_torch.io.load import load_mesh

    phase_device()
    phase_build()
    sms, hz = sm_clock()
    print(f"# {sms} SMs at up to {hz / 1e9:.3f} GHz; package "
          f"{sys.modules['pumiumtally_tpu_torch'].__file__}")
    box = build_box(1, 1, 1, MESH_DIV, MESH_DIV, MESH_DIV,
                    dtype=torch.float32)
    pts = make_trajectory(np.random.default_rng(0), N, CONTINUE_MOVES + 2)
    with tempfile.TemporaryDirectory() as d:
        path, lat_pts = write_lattice(d)
        lattice = load_mesh(path, dtype=torch.float32)
        for label, mesh, p in (("box", box, pts),
                               ("lattice", lattice, lat_pts)):
            for two_tier in (False, True):
                times = w0_times(*w0_inputs(mesh, p, two_tier))
                print(json.dumps({"mesh": label, "two_tier": two_tier,
                                  "tets": mesh.nelems, "n": N, **times}))
    return 0


def main_w3_g1_times() -> int:
    from pumiumtally_tpu_torch.experiments import pallas_gather as pg

    phase_device()
    phase_build()
    sms, hz = sm_clock()
    print(f"# {sms} SMs at up to {hz / 1e9:.3f} GHz; package "
          f"{sys.modules['pumiumtally_tpu_torch'].__file__}")
    for name in ("resident_walk", "row_gather"):
        print(f"# {name} SASS: {sass_counts(name) or 'cuobjdump not found'}")
    for dims in W3_CELLS:
        print(json.dumps({"kernel": "W3", "cells": dims,
                          **w3_times(w3_setup(dims), passes=4)}))
    for rows in G1_ROWS:
        tab, idx = g1_inputs(rows)
        for variant, (_, fill) in pg.VARIANTS.items():
            print(json.dumps({"kernel": "G1", "entry": variant,
                              **g1_times(tab, idx, fill, passes=4)}))
    return 0


if __name__ == "__main__":
    modes = {"--w0-times": main_w0_times, "--w3-g1-times": main_w3_g1_times}
    sys.exit(next((fn for flag, fn in modes.items()
                   if flag in sys.argv[1:]), main)())
