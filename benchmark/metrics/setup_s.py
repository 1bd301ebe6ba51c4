"""Process start to the window's first call: CUDA's start, the kernel
libraries, the mesh file read into the facade's tables, the traffic and
the warm-up (in a checkout's first run also the kernel build and the
mesh file's generation)."""


def read(ctx):
    return ctx.setup_s
