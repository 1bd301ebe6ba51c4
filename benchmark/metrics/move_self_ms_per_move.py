"""Host ms of the program's ``ptt.move`` spans less the union of the
program's spans inside them, over the traced window's
``MoveToNextLocation`` calls: the facade's own host work a move (input
checks, the flying and weights tests, the caller's flying buffer
zeroed, the walk's operands, the hooks, Python)."""

from benchmark.spans import self_ms_per_call


def read(ctx):
    return self_ms_per_call(ctx, "ptt.move", "bench.move")
