"""Device milliseconds a build of the PLOC rounds (B6, benchmark/kernels/
ploc_round.json)."""


def read(ctx):
    t = ctx.kernel_seconds_per_step("ploc_round")
    return None if t is None else 1e3 * t
