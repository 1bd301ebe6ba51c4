"""The port's counterparts of the JAX package's experiment tools that
hold TPU kernels (tools/exp_r3_vmem.py, tools/exp_pallas_gather*.py),
and block_rounds.py, which times the block walks round by round."""

from __future__ import annotations

import time

import torch


def time_ms(fn, reps: int, device) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls after one warm-up:
    CUDA events on the card, the host clock on the CPU (the tools time
    calls with the host clock after a device sync)."""
    fn()
    if torch.device(device).type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3
