"""W0's roofline bound over W0's device time in the traced window (%),
all of its launches: the localization walks, the phase-A relocations
(the echo's skipped launches walk nothing and are bound by 0) and the
tallied walks. The bound is counted from the reference's walk of the
same inputs (``roofline.py``)."""

from benchmark.readers import w0_share


def read(ctx):
    return w0_share(ctx, scored=False)
