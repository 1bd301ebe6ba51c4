"""The program's ``ptt.sync`` spans inside the traced window's
``MoveToNextLocation`` calls, a call: how often a move waits on the
device."""

from benchmark.spans import count_per_call


def read(ctx):
    return count_per_call(ctx, "ptt.sync")
