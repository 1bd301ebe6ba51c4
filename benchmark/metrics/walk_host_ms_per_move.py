"""Host ms in the program's ``ptt.walk`` spans inside the traced
window's ``MoveToNextLocation`` calls, a call: the walk wrapper's host
work through the kernel launch's return."""

from benchmark.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx, "ptt.walk")
