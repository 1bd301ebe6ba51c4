"""Particle moves completed in the window over its wall seconds: the
particles handed to every ``MoveToNextLocation`` call, over the whole
window, each batch's ``CopyInitialPosition`` and ``close_batch``
included."""


def read(ctx):
    return ctx.window.particles / ctx.window.seconds
