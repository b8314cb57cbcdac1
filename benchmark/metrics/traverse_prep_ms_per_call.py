"""Host milliseconds a traversal call spends before its launch: the program's
span `bvh.traverse_prep` (the ray and transform arguments, their checks, the
root and the outputs' allocation), one a call, on the trace's clock."""
from benchmark import spans


def read(ctx):
    d = spans.Spans(ctx.trace).durations("bvh.traverse_prep")
    return 1e3 * sum(d) / ctx.steps if d else None
