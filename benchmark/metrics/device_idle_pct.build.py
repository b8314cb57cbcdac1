"""Share of the traced builds' window in which no kernel, memcpy or memset
ran on the card, in per cent."""


def read(ctx):
    return ctx.idle_pct()
