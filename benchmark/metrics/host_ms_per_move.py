"""The mean, over the traced window's ``MoveToNextLocation`` calls, of a
call's wall time less the device-busy time inside it (ms): the host's
own work a move, facade and staging."""

from benchmark.readers import host_ms_per_move


def read(ctx):
    return host_ms_per_move(ctx)
