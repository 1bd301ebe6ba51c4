"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--control]

From the root of a checkout, on a machine with the CUDA devices the cell
asks for. The last line of standard output is one JSON object:
``correct``, ``attempted`` (move calls in the window), ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``: each number the check compared beside its limit (also the
last lines of standard error). ``--control`` runs the program's own
lower-precision path in place of the configuration's (the check's
control, which has to come out not correct).

Exit codes: 0 with a result; 2 without the devices the cell needs; 3
when JAX or the JAX package is loaded once the window has closed; any
other failure raises.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = Path(__file__).resolve().parent / ".cache"
# Modules that must not be loaded in the process that prints a result,
# by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "pumiumtally_tpu")


def fixed_environment() -> None:
    """The program as it ships: no PUMIUMTALLY_* switch from the caller's
    environment; every compiler cache in a fixed directory of the
    checkout."""
    for k in [k for k in os.environ if k.startswith("PUMIUMTALLY_")]:
        del os.environ[k]
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    fixed_environment()
    sys.path.insert(0, str(ROOT))
    from benchmark.cell import load_benchmark, resolve

    cell = resolve(load_benchmark(ROOT), args.workload, bool(args.trace))
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from benchmark.harness import run_cell

    result, nums = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            control=args.control, t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measured process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    if args.control:
        result["control"] = True
        result["check"] = result.pop("check")
    others = {k: v for k, v in nums.items() if k not in result["check"]}
    if others:
        print("# not compared: " + json.dumps(others), file=sys.stderr)
    for k, c in result["check"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
