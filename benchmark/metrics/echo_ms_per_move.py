"""Host ms in the program's ``ptt.echo`` spans inside the traced
window's ``MoveToNextLocation`` calls, a call: the origin-echo compare
of the caller's origins with the previous move's destinations. None
where the program opens no such span (origins never passed)."""

from benchmark.spans import ms_per_call

SPAN = "ptt.echo"


def read(ctx):
    if ctx.trace is None or not ctx.trace.spans(SPAN):
        return None
    return ms_per_call(ctx, SPAN)
