"""Host ms in the program's ``ptt.stage.fill`` spans inside the traced
window's ``MoveToNextLocation`` calls, a call: the working-dtype casts
into the pinned buffers and their finite checks (staging)."""

from benchmark.spans import ms_per_call


def read(ctx):
    return ms_per_call(ctx, "ptt.stage.fill")
