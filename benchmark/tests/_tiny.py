"""A real cell cut to a size the CPU runs in about a second: the same
configuration and traffic files, limits included, over a 2 x 1 lattice
of coarse pincells and 2,000 particles."""

from pathlib import Path

from benchmark.cell import BENCH_DIR, load_benchmark, read_json, resolve
from benchmark.harness import run_cell

TINY_MESH = dict(nx=2, ny=1, n_theta=8, n_rings_fuel=1, n_rings_pad=1,
                 nz=3)
TINY_N = 2000


# Every traffic mix, also one that no cell of BENCHMARK.json sends yet.
MIXES = sorted(p.stem for p in (BENCH_DIR / "traffic").glob("*.json"))


def tiny_cell(workload: str, mix: str = None):
    """The cell cut to the tiny size; ``mix`` sends that traffic file in
    place of the cell's own."""
    cell = resolve(load_benchmark(), workload, False)
    cell.config["mesh"].update(TINY_MESH)
    cell.config["particles"] = TINY_N
    if mix is not None:
        cell.traffic = read_json(BENCH_DIR / "traffic" / f"{mix}.json")
    return cell


def run_tiny(workload: str, cache: Path, seed: int = 2**33 + 7,
             seconds: float = 0.3, mix: str = None, **kw):
    return run_cell(tiny_cell(workload, mix), seed, seconds, False,
                    device="cpu", cache=cache, **kw)
