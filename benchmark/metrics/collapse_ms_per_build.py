"""Device milliseconds a build of the BVH4 collapse: the kernels, memcpys and
memsets launched under the program's span `bvh.collapse` (the prep and the
coarse stage, and B3 as `bvh.collapse_block`), attributed by
`benchmark/spans.py`."""
from benchmark import spans


def read(ctx):
    s = spans.Spans(ctx.trace)
    if not ctx.trace.gpu or not s.has("bvh.collapse"):
        return None
    return 1e3 * s.device_seconds_under("bvh.collapse") / ctx.steps
