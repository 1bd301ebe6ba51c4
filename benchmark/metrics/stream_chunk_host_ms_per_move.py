"""Host ms of the streaming facade's ``ptt.stream.chunk`` spans less
their ``ptt.sync`` spans, inside the traced window's
``MoveToNextLocation`` calls, a call: the chunk pipeline's host work
(each chunk's fill, the wait issued on the device, the dispatch, the
next chunk's upload) without its waits on the device. None where the
program opens no such span."""

from benchmark.spans import self_ms_per_call

SPAN = "ptt.stream.chunk"


def read(ctx):
    if ctx.trace is None or not ctx.trace.spans(SPAN):
        return None
    return self_ms_per_call(ctx, SPAN, "bench.move", children="ptt.sync")
