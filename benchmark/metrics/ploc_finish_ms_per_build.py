"""Device milliseconds a build of the PLOC finisher (B7, benchmark/kernels/
ploc_finish.json)."""


def read(ctx):
    t = ctx.kernel_seconds_per_step("ploc_finish")
    return None if t is None else 1e3 * t
