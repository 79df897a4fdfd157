"""Seconds from the process's start to the first timed request: imports,
the CUDA context, the kernel library (built on a checkout's first run),
the inputs, the scene and the warm-up."""


def read(ctx):
    return ctx.window.setup_s
