"""Idle device milliseconds a build while the host is in the BVH4 collapse
(the program's span `bvh.collapse`), split from the steps' idle time by
`benchmark/spans.py`."""
from benchmark import spans


def read(ctx):
    s = spans.Spans(ctx.trace)
    if not ctx.trace.gpu or not s.has("bvh.collapse"):
        return None
    return 1e3 * s.idle_by_top()["bvh.collapse"] / ctx.steps
