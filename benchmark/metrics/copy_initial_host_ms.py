"""Host ms of the program's ``ptt.copy_initial`` spans less their
``ptt.sync`` spans, a ``CopyInitialPosition`` call of the traced
window: the call's host work without its waits on the device."""

from benchmark.spans import self_ms_per_call


def read(ctx):
    return self_ms_per_call(ctx, "ptt.copy_initial", "bench.copy_initial",
                            children="ptt.sync")
