"""Kernels, memcpys and memsets a build, counted in the profiler's trace."""


def read(ctx):
    n = ctx.trace.count()
    return n / ctx.steps if n else None
