"""Host ms in the program's ``ptt.sync`` spans inside the traced
window's ``MoveToNextLocation`` calls, a call: the host waiting on the
device (staging slots' events, the found-all read, the fence)."""

from benchmark.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx, "ptt.sync")
