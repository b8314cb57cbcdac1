"""Idle device milliseconds a build while the host is in the LBVH's tail: the
topology and its refit (the program's span `bvh.topology`, `bvh.refit`
inside it) and the output assembly (`bvh.finalize`), split from the steps'
idle time by `benchmark/spans.py`."""
from benchmark import spans

TAIL = ("bvh.topology", "bvh.finalize")


def read(ctx):
    s = spans.Spans(ctx.trace)
    if not ctx.trace.gpu or not s.has("bvh.topology"):
        return None
    idle = s.idle_by_top()
    return 1e3 * sum(idle[name] for name in TAIL) / ctx.steps
