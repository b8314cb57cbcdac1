"""Idle device milliseconds a build while the host is in the front half (the
program's span `bvh.front_half`), split from the steps' idle time by
`benchmark/spans.py`."""
from benchmark import spans


def read(ctx):
    s = spans.Spans(ctx.trace)
    if not ctx.trace.gpu or not s.has("bvh.front_half"):
        return None
    return 1e3 * s.idle_by_top()["bvh.front_half"] / ctx.steps
