"""Host ms of the streaming facade's ``ptt.stream.check`` spans less
their ``ptt.echo`` spans, inside the traced window's
``MoveToNextLocation`` calls, a call: the whole batch's checks before
any chunk dispatches (the float64 finite checks and the working-dtype
pass), without the echo compare that nests in them (its own metric,
``echo_ms_per_move``). None where the program opens no such span."""

from benchmark.spans import self_ms_per_call

SPAN = "ptt.stream.check"


def read(ctx):
    if ctx.trace is None or not ctx.trace.spans(SPAN):
        return None
    return self_ms_per_call(ctx, SPAN, "bench.move", children="ptt.echo")
