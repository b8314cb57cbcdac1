"""Device milliseconds a build of the front half: the kernels, memcpys and
memsets launched under the program's span `bvh.front_half` (boxes, extents,
Morton codes, the sort key, and `bvh.sort`: the sort and its gathers),
attributed by `benchmark/spans.py`."""
from benchmark import spans


def read(ctx):
    s = spans.Spans(ctx.trace)
    if not ctx.trace.gpu or not s.has("bvh.front_half"):
        return None
    return 1e3 * s.device_seconds_under("bvh.front_half") / ctx.steps
