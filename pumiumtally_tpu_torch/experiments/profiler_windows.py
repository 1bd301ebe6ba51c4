"""Whether ``utils.profiling.trace`` windows keep their device events as a
process ages, and where the device timestamps lie against the host's.

    python -m pumiumtally_tpu_torch.experiments.profiler_windows
    python -m pumiumtally_tpu_torch.experiments.profiler_windows \\
        --seconds 240 --every 20 --between idle

A long chip_smoke.py run can write a trace whose window holds no device
event at all, late in the process, while a fresh process's first window
holds them; shorter windows lose a few of their first or last kernels
throughout. This probe repeats, every ``--every`` seconds for
``--seconds``, two windows under ``trace``:

- plain: ``--host-ms`` of host time (a move's host work before its
  first launch), then ``--kernels`` spin kernels (``torch.cuda._sleep``),
  then a synchronise: how many of the kernels the trace kept;
- padded: the same with ``--pad-ms`` of host time at each end inside the
  window, so that a shift of the device clock smaller than that keeps
  every kernel: each kernel's start less its ``cudaLaunchKernel``'s
  (the same correlation id), in microseconds. The first kernel after an
  idle queue starts a few microseconds after its launch; a growing
  difference is the device clock drifting from the host's.

``--rapid`` windows of 100 short kernels each, at the start and at the
end, count the kernels lost and whether they were the first or the last
of their window. Between windows the card multiplies matrices
(``--between busy``) or waits. Prints a line a window, then one JSON
object with every reading and the least-squares slope of the padded
offset against the process's age. ``--env NAME=VALUE`` sets a profiler
variable inside the process before its first window, ``--last-env``
before one last plain window after the rest.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from pumiumtally_tpu_torch.utils.profiling import trace

SPIN_CYCLES = 100_000  # ~50 us a spin kernel at the H100's clock
RAPID_KERNELS = 100
RAPID_CYCLES = 2_000


def _events(log_dir: str) -> list:
    """The trace events of the one Chrome trace ``trace`` wrote."""
    names = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    if len(names) != 1:
        raise RuntimeError(f"trace({log_dir}) wrote {names}")
    with open(os.path.join(log_dir, names[0])) as f:
        return json.load(f)["traceEvents"]


def window(kernels: int, cycles: int, host_ms: float, pad_ms: float) -> dict:
    """One traced window: ``pad_ms`` of host time, ``host_ms`` more, the
    spin kernels, a synchronise, ``pad_ms`` again. Returns the kernels
    kept, the places (0-based, in launch order) of the lost ones, and
    each kept kernel's start less its launch's (us)."""
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            time.sleep(pad_ms / 1e3)
            time.sleep(host_ms / 1e3)
            for _ in range(kernels):
                torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
            time.sleep(pad_ms / 1e3)
        events = _events(d)
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and "LaunchKernel" in e.get("name", "")),
                      key=lambda e: e["ts"])
    kernel = {e["args"].get("correlation"): e for e in events
              if e.get("cat") == "kernel"}
    order = [e["args"].get("correlation") for e in launches]
    lost = [i for i, c in enumerate(order) if c not in kernel]
    offsets = [kernel[c]["ts"] - e["ts"] for c, e in
               zip(order, launches) if c in kernel]
    return {"launches": len(launches), "kept": len(kernel), "lost": lost,
            "offset_us": offsets}


def rapid(windows: int) -> dict:
    """``windows`` unpadded windows of RAPID_KERNELS short kernels: the
    kernels lost in all, and how many were their window's first or last
    launched."""
    lost = first = last = 0
    for _ in range(windows):
        w = window(RAPID_KERNELS, RAPID_CYCLES, 0.0, 0.0)
        lost += RAPID_KERNELS - w["kept"]
        first += 0 in w["lost"]
        last += (w["launches"] - 1) in w["lost"]
    return {"windows": windows, "kernels": windows * RAPID_KERNELS,
            "lost": lost, "windows_losing_first": first,
            "windows_losing_last": last}


def busy(seconds: float) -> None:
    """Matrix products on the card for about ``seconds``."""
    a = torch.randn(4096, 4096, device="cuda")
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        for _ in range(8):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()


def probe(seconds: float, every: float, host_ms: float, pad_ms: float,
          kernels: int, rapid_windows: int, between: str) -> dict:
    t0 = time.perf_counter()
    out = {"rapid_start": rapid(rapid_windows), "windows": []}
    print(f"# rapid windows at the start: {json.dumps(out['rapid_start'])}")
    while True:
        age = time.perf_counter() - t0
        plain = window(kernels, SPIN_CYCLES, host_ms, 0.0)
        padded = window(kernels, SPIN_CYCLES, host_ms, pad_ms)
        off = padded["offset_us"]
        row = {"age_s": age, "plain_kept": plain["kept"],
               "plain_lost": plain["lost"], "padded_kept": padded["kept"],
               "offset_us": off}
        out["windows"].append(row)
        print(f"# age {age:.1f} s: plain window kept {plain['kept']} of "
              f"{plain['launches']} kernels (lost {plain['lost']}); padded "
              f"kept {padded['kept']} of {padded['launches']}, kernel start "
              f"- launch {', '.join(f'{o:.1f}' for o in off)} us")
        if age + every > seconds:
            break
        if between == "busy":
            busy(every)
        else:
            time.sleep(every)
    out["rapid_end"] = rapid(rapid_windows)
    print(f"# rapid windows at the end: {json.dumps(out['rapid_end'])}")
    pts = [(w["age_s"], w["offset_us"][0]) for w in out["windows"]
           if w["offset_us"]]
    if len(pts) >= 2:
        ages, offs = np.array(pts).T
        out["offset_slope_us_per_s"] = float(np.polyfit(ages, offs, 1)[0])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seconds", type=float, default=240.0)
    p.add_argument("--every", type=float, default=20.0)
    p.add_argument("--host-ms", type=float, default=4.0)
    p.add_argument("--pad-ms", type=float, default=200.0)
    p.add_argument("--kernels", type=int, default=5)
    p.add_argument("--rapid", type=int, default=20)
    p.add_argument("--between", default="busy", choices=("busy", "idle"))
    p.add_argument("--env", action="append", default=[],
                   metavar="NAME=VALUE",
                   help="set in this process before its first window (a "
                        "profiler setting read at run time)")
    p.add_argument("--last-env", action="append", default=[],
                   metavar="NAME=VALUE",
                   help="set before one last plain window, after the rest")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_windows: no CUDA device is available")
    for item in a.env:
        name, _, value = item.partition("=")
        os.environ[name] = value
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; profiler variables set: "
          f"{ {k: v for k, v in os.environ.items() if 'CUPTI' in k} }")
    out = probe(a.seconds, a.every, a.host_ms, a.pad_ms, a.kernels, a.rapid,
                a.between)
    if a.last_env:
        for item in a.last_env:
            name, _, value = item.partition("=")
            os.environ[name] = value
        last = window(a.kernels, SPIN_CYCLES, a.host_ms, 0.0)
        out["last"] = last
        print(f"# last window ({' '.join(a.last_env)}): kept {last['kept']} "
              f"of {last['launches']} kernels")
    print(json.dumps(out))
    print("# probe done; the process exits now", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
