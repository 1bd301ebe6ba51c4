"""The row-gather probes (the port of tools/exp_pallas_gather.py and
tools/exp_pallas_gather2.py), as kernel G1 (csrc/row_gather.cu) with
its plain PyTorch version beside it.

Both probes gather ``T`` rows of a resident ``[E,W]`` float32 table by
an int32 index. They differ in the fill an out-of-range index gives:

- ``take`` (tools/exp_pallas_gather.py): ``jnp.take(tab, idx, axis=0,
  fill_value=0)`` -> ``gather(tab, idx, 0.0)``, G1's entry
  ``row_gather_take``;
- ``take_along_axis`` (tools/exp_pallas_gather2.py): its default fill is
  NaN -> ``gather(tab, idx, nan)``, G1's entry
  ``row_gather_take_along_axis``.

An index in [-E, 0) wraps to ``idx + E``; one outside [-E, E) gives a
row of the fill value.

Usage:
  python -m pumiumtally_tpu_torch.experiments.pallas_gather take
  python -m pumiumtally_tpu_torch.experiments.pallas_gather take_along_axis

Each prints the probe's lines ("works", microseconds, Mrows/s) at the
probes' shape (E, W, T = 48000, 32, 8192), on the card unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from pumiumtally_tpu_torch import kernels
from pumiumtally_tpu_torch.experiments import time_ms

E, W, T = 48000, 32, 8192  # table rows, row width, gathered rows
VARIANTS = {"take": ("take-based", 0.0),
            "take_along_axis": ("take_along_axis", float("nan"))}


def gather_plain(tab: torch.Tensor, idx: torch.Tensor,
                 fill: float) -> torch.Tensor:
    """G1's plain PyTorch version: ``out[i] = tab[idx[i]]`` with the
    probes' wrap and fill rules."""
    n_rows = tab.shape[0]
    j = torch.where(idx < 0, idx.long() + n_rows, idx.long())
    ok = (j >= 0) & (j < n_rows)
    rows = tab[torch.where(ok, j, torch.zeros_like(j))]
    return torch.where(ok[:, None], rows,
                       torch.full((), fill, dtype=tab.dtype,
                                  device=tab.device))


def _gather_cuda(tab, idx, fill) -> torch.Tensor:
    dev = tab.device
    n_rows, width = tab.shape
    n = idx.shape[0]
    kernels.check_cuda_args("gather", dev, [
        ("tab", tab, torch.float32, (n_rows, width)),
        ("idx", idx, torch.int32, (n,)),
    ])
    if width % 4 or tab.data_ptr() % 16:
        raise ValueError("gather: rows are moved as 16-byte words; the "
                         "table needs a width that is a multiple of 4 and "
                         "a 16-byte aligned start")
    out = torch.empty((n, width), dtype=torch.float32, device=dev)
    entry = ("row_gather_take_along_axis" if math.isnan(fill)
             else "row_gather_take")
    kernels.launch(entry, torch.float32, dev, tab.data_ptr(),
                   idx.data_ptr(), out.data_ptr(), n_rows, n, width,
                   float(fill))
    return out


def gather(tab: torch.Tensor, idx: torch.Tensor,
           fill: float = 0.0) -> torch.Tensor:
    """Gather ``tab[idx]`` rows; an index in [-E, 0) wraps, one outside
    [-E, E) gives ``fill``. CUDA tensors launch G1 (its take_along_axis
    entry when ``fill`` is NaN, else its take entry); CPU tensors run
    ``gather_plain``."""
    if tab.is_cuda:
        return _gather_cuda(tab, idx, fill)
    if tab.device.type != "cpu":
        raise ValueError(f"gather runs on CUDA or CPU tensors, not "
                         f"{tab.device}")
    return gather_plain(tab, idx, fill)


def probe_inputs(device, seed: int = 0):
    """The probes' inputs: a normal [E,W] table and T in-range
    indices, from ``seed``."""
    rng = np.random.default_rng(seed)
    tab = torch.as_tensor(rng.normal(size=(E, W)).astype(np.float32),
                          device=device)
    idx = torch.as_tensor(rng.integers(0, E, T).astype(np.int32),
                          device=device)
    return tab, idx


def main(variant: str = "take", device="cuda", reps: int = 50) -> dict:
    """One probe: gather, check against the table's rows, then time
    ``reps`` gathers (``experiments.time_ms``). Returns {"ok", "us",
    "mrows_per_s"}."""
    label, fill = VARIANTS[variant]
    tab, idx = probe_inputs(device)
    out = gather(tab, idx, fill)
    ok = bool(torch.equal(out.cpu(), tab.cpu()[idx.cpu().long()]))
    print(f"{label} gather works: {ok}")
    dt = time_ms(lambda: gather(tab, idx, fill), reps, device) / 1e3
    print(f"gather {T} rows x {W} f32: {dt * 1e6:.1f} us -> "
          f"{T / dt / 1e6:.1f} Mrows/s")
    return {"ok": ok, "us": dt * 1e6, "mrows_per_s": T / dt / 1e6}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variant", nargs="?", default="take",
                    choices=tuple(VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return 0 if main(args.variant, device=args.device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(cli())
