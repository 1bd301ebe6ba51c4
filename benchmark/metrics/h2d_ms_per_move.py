"""Device time of host-to-device copies in the traced window, per
``MoveToNextLocation`` call there (ms)."""


def read(ctx):
    if ctx.trace is None or not ctx.traced.moves:
        return None
    w = ctx.trace.window()
    us = sum(e.dur for e in ctx.trace.device
             if e.cat == "gpu_memcpy" and "HtoD" in e.name
             and e.start >= w.start and e.end <= w.end)
    return us * 1e-3 / ctx.traced.moves
