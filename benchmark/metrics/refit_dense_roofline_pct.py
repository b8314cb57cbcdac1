"""B2's share of its roofline: the least time its bytes (benchmark/kernels/
refit_dense.json) take at the card's peak rate over its device time a build,
in per cent."""


def read(ctx):
    return ctx.roofline_pct("refit_dense")
