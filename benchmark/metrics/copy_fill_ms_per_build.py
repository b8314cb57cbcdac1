"""Device milliseconds a build of memcpys and memsets (the profiler's
`gpu_memcpy` and `gpu_memset` events)."""

CATS = ("gpu_memcpy", "gpu_memset")


def read(ctx):
    t = ctx.trace.seconds(cats=CATS)
    return 1e3 * t / ctx.steps if t > 0 else None
