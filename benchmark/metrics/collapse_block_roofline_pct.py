"""B3's share of its roofline: the least time its bytes (benchmark/kernels/
collapse_block.json, a floor that leaves out its data-dependent reads) take
at the card's peak rate over its device time a build, in per cent."""


def read(ctx):
    return ctx.roofline_pct("collapse_block")
