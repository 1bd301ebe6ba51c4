"""The share (%) of the host-to-device copies' device time, over the
copies that start inside the traced window's ``MoveToNextLocation``
calls, during which a W0 kernel runs: how much of the upload the copy
stream hides behind the walks. None without a trace, the program's
spans or such copies."""

from benchmark.readers import w0_scored
from benchmark.spans import calls, program_spans
from benchmark.trace import busy_in


def read(ctx):
    if ctx.trace is None or program_spans(ctx) is None:
        return None
    moves = calls(ctx, "bench.move")
    copies = [e for e in ctx.trace.device
              if e.cat == "gpu_memcpy" and "HtoD" in e.name
              and any(m.start <= e.start < m.end for m in moves)]
    total = sum(e.dur for e in copies)
    if total <= 0:
        return None
    w0 = [e for e in ctx.trace.kernels() if w0_scored(e.name) is not None]
    under = sum(busy_in(w0, e.start, e.end) for e in copies)
    return 100.0 * under / total
