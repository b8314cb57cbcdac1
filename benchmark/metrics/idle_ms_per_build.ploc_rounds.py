"""Idle device milliseconds a build while the host is in PLOC's round loop:
the program's spans `bvh.ploc_round`, one a round (a B6 launch and the read
of its merge count), split from the steps' idle time by
`benchmark/spans.py`."""
from benchmark import spans


def read(ctx):
    s = spans.Spans(ctx.trace)
    if not ctx.trace.gpu or not s.has("bvh.ploc_round"):
        return None
    return 1e3 * s.idle_by_top()["bvh.ploc_round"] / ctx.steps
