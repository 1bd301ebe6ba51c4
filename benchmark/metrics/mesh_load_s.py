"""Seconds the facade's constructor takes on the cached mesh file: the
file read and the host and device tables (host clock)."""


def read(ctx):
    return ctx.mesh_load_s
