"""Kernel time of every round of the partitioned engine's block walks (W1
on the float32 tables, W2 on the two-tier tables) over one move of
chip_smoke.py's main path, beside each round's bytes bound.

    python -m pumiumtally_tpu_torch.experiments.block_rounds
    python -m pumiumtally_tpu_torch.experiments.block_rounds \\
        --device cpu --div 4 --n 2000          # a rehearsal, no times

The configuration is chip_smoke.py's: bench.py's box (``--div 20``,
48,000 tets), 500,000 particles on its trajectory (seed 0),
``capacity_factor=2.0``, ``walk_vmem_max_elems=1024``. Recorded from the
engine's own run: the tallied rounds of the first two-phase move (its
rounds 1 and 2 are the inputs chip_smoke.py checks the kernels on) and
every round of the continue move after it. Each recorded input is then
replayed through its kernel ``REPS`` times under torch.profiler, and a
round's time is the kernel's mean device duration (the wrappers take
longer on the host than the later rounds' kernels on the card, so CUDA
events around calls would time the host).

It calls only the engine's round entry point and the kernels' wrappers
as every checkout of the port has them, so it times any checkout: run
this file by its path with ``PYTHONPATH`` naming the checkout.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from pumiumtally_tpu_torch import PartitionedPumiTally, TallyConfig, build_box
from pumiumtally_tpu_torch.ops import pallas_walk, vmem_walk

MESH_DIV = 20
BOUND = 1024  # chip_smoke.py's walk_vmem_max_elems
N = 500_000
MEAN_STEP = 0.25  # bench.py's mean segment length
REPS = 3
KERNEL_NAME = "block_walk_kernel"  # W1's and W2's kernels both
HBM_BYTES_PER_S = 3.35e12  # H100 SXM datasheet
CONFIGS = {
    "W1": dict(capacity_factor=2.0),
    "W2": dict(capacity_factor=2.0, walk_table_dtype="bfloat16",
               walk_kernel="pallas"),
}


def make_trajectory(rng, n: int, moves: int, box=None) -> list:
    """bench.py's generator: a source and ``moves`` destination arrays,
    all strictly inside the box (the unit cube by default)."""
    box = np.ones(3) if box is None else np.asarray(box, np.float64)
    pts = [rng.uniform(0.05, 0.95, (n, 3)) * box]
    for _ in range(moves):
        step = rng.normal(scale=MEAN_STEP / np.sqrt(3.0), size=(n, 3))
        pts.append(np.clip(pts[-1] + step, 0.02 * box, 0.98 * box))
    return pts


def round_bytes(done, exited, nparts: int, L: int, row_bytes: int,
                itemsize: int) -> int:
    """Bytes a block-walk round must move on this input: an active slot
    reads x, lelem, dest, fly, w and its masks and writes x, lelem, its
    masks and pending (57 B in f32); an idle one reads only dest, lelem
    and its masks (x too if it left the mesh) and writes the same
    outputs (40 B, 52 B); the blocks with an active slot read their
    tables (``row_bytes`` per element) once and read and write their
    flux."""
    active = ~done
    n_active = int(active.sum())
    n_idle = done.numel() - n_active
    n_exited_idle = int((done & exited).sum())
    walking = int(active.view(nparts, -1).any(dim=1).sum())
    return (n_active * (10 * itemsize + 17) + n_idle * (6 * itemsize + 16)
            + n_exited_idle * 3 * itemsize
            + walking * L * (row_bytes + 2 * itemsize))


def _flat(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.reshape(-1))


def record_move(t, origins, dests) -> list:
    """Run one move of the one-device partitioned facade ``t``
    (``origins`` None: a continue move) and return the engine state each
    tallied round walked from."""
    eng = t.engine
    rounds = []
    walk_round = eng._round

    def spy(sts, tally, *rest, **kw):
        if tally:
            rounds.append(dict(sts[0]))
        return walk_round(sts, tally, *rest, **kw)

    eng._round = spy
    try:
        if origins is None:
            t.MoveToNextLocation(None, _flat(dests))
        else:
            n = origins.shape[0]
            t.MoveToNextLocation(_flat(origins), _flat(dests),
                                 np.ones(n, np.int8), np.ones(n))
    finally:
        del eng._round
    return rounds


def launch(eng, st):
    """One block-walk call on a recorded round input, tallying into a
    scratch flux."""
    flux = torch.zeros_like(eng.flux_padded)
    args = (st["x"], st["lelem"], st["dest"], st["fly"], st["w"],
            st["done"], st["exited"], flux)
    kw = dict(tally=True, tol=eng.tol, max_iters=eng.max_iters,
              blocks=eng.nparts)
    if eng.use_pallas_walk:
        return pallas_walk.pallas_walk_local(eng.part.table,
                                             eng.part.table_hi, *args, **kw)
    return vmem_walk.vmem_walk_local(eng.part.table, *args, **kw)


def table_row_bytes(eng) -> int:
    """Table bytes per element: the packed row, or the two-tier bf16
    select row and its four refinement rows."""
    t = eng.part.table
    row = t.shape[1] * t.element_size()
    if eng.use_pallas_walk:
        hi = eng.part.table_hi
        row += 4 * hi.shape[1] * hi.element_size()
    return row


def time_rounds(eng, rounds: list, reps: int = REPS) -> list:
    """Mean device milliseconds of the block-walk kernel on each recorded
    round input, from torch.profiler over ``reps`` replays. A window in
    which the profiler missed some of the kernels is profiled again,
    twice at most, and says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for st in rounds:
        launch(eng, st)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for st in rounds:
                    launch(eng, st)
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.elapsed_us())
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and KERNEL_NAME in e.name)
        if len(spans) == reps * len(rounds):
            us = np.array([d for _, d in spans]).reshape(reps, len(rounds))
            return [float(v) for v in us.mean(axis=0) / 1e3]
        print(f"# profiler retry: it saw {len(spans)} block-walk kernels, "
              f"not {reps * len(rounds)}; profiling again")
    raise AssertionError("the profiler missed block-walk kernels in three "
                         "windows")


def record(kind: str, n: int, div: int, device: str):
    """The facade, the first move's tallied rounds and the continue
    move's rounds."""
    dtype = torch.float32 if device == "cuda" else torch.float64
    mesh = build_box(1, 1, 1, div, div, div, dtype=dtype, device=device)
    config = TallyConfig(walk_vmem_max_elems=BOUND, **CONFIGS[kind])
    t = PartitionedPumiTally(mesh, n, config, device=device)
    pts = make_trajectory(np.random.default_rng(0), n, 2)
    t.CopyInitialPosition(_flat(pts[0]))
    first = record_move(t, pts[0], pts[1])
    cont = record_move(t, None, pts[2])
    return t, first, cont


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def rounds_main(n: int, div: int, device: str) -> dict:
    import pumiumtally_tpu_torch

    result = {}
    for kind in CONFIGS:
        t, first, cont = record(kind, n, div, device)
        eng = t.engine
        rounds = first[:2] + cont
        itemsize = eng.part.table_hi.element_size() if eng.use_pallas_walk \
            else eng.part.table.element_size()
        bound_ms = [round_bytes(st["done"], st["exited"], eng.nparts,
                                eng.part.L, table_row_bytes(eng), itemsize)
                    / HBM_BYTES_PER_S * 1e3 for st in rounds]
        line = {"kernel": kind, "package": pumiumtally_tpu_torch.__file__,
                "blocks": eng.nparts, "L": eng.part.L,
                "slots_per_block": eng.cap_per_block,
                "first_move_rounds": len(first),
                "launches_per_move": len(cont),
                "active": [int((~st["done"]).sum()) for st in rounds],
                "bound_ms": bound_ms}
        if device == "cuda":
            ms = time_rounds(eng, rounds)
            line.update(round1_ms=ms[0], round2_ms=ms[1],
                        continue_rounds_ms=ms[2:], per_move_ms=sum(ms[2:]),
                        per_move_bound_ms=sum(bound_ms[2:]))
            print(f"# {kind} ({eng.nparts} blocks of <= {eng.part.L}): "
                  f"first move round 1 {ms[0]:.4f} ms (bound "
                  f"{bound_ms[0]:.4f}), round 2 {ms[1]:.4f} ms (bound "
                  f"{bound_ms[1]:.4f}); continue move {len(cont)} rounds, "
                  f"{sum(ms[2:]):.4f} ms in all (bound "
                  f"{sum(bound_ms[2:]):.4f}); its last round {ms[-1]:.4f} "
                  f"ms, bound {bound_ms[-1]:.4f}")
        else:
            print(f"# {kind} on the CPU: {len(first)} tallied rounds in the "
                  f"first move, {len(cont)} in the continue move; times "
                  "not measured (the card's only)")
        print(json.dumps(line))
        result[kind] = line
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--div", type=int, default=MESH_DIV)
    a = p.parse_args(argv)
    if a.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("block_rounds: no CUDA device is available")
        print(f"# card: {card_line()}")
    rounds_main(a.n, a.div, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
