"""1 less the union of device activity over the traced window, in %."""

from benchmark.trace import device_busy


def read(ctx):
    if ctx.trace is None:
        return None
    busy, window = device_busy(ctx.trace)
    return 100.0 * (1.0 - busy / window)
