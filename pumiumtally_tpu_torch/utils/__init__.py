"""Aux subsystems: logging, profiling (fenced phase timers, torch.profiler
traces, the kernel build tripwire), checkpoint/resume of tally state, the
walk autotuner, and the accelerator window interlock (``chiplock``)."""

from pumiumtally_tpu_torch.utils.autotune import autotune_walk
from pumiumtally_tpu_torch.utils.logging import get_logger, set_verbosity
from pumiumtally_tpu_torch.utils.profiling import phase_timer, trace
from pumiumtally_tpu_torch.utils.checkpoint import (
    CorruptCheckpointError,
    load_tally_state,
    save_tally_state,
)

__all__ = [
    "autotune_walk",
    "get_logger",
    "set_verbosity",
    "phase_timer",
    "trace",
    "save_tally_state",
    "load_tally_state",
    "CorruptCheckpointError",
]
