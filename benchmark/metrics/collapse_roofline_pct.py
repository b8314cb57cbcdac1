"""The whole BVH4 collapse's share of its roofline: the least bytes any
collapse moves, at the card's peak rate, over the device time under the
program's span `bvh.collapse` a build, in per cent.

The least bytes, frozen here: the Bvh2 read once, 32 B a node (its box of
6 floats, left and right; the parent is left out, so the bound is a floor),
and the Bvh4 written once, 120 B a wide slot row (4 slot ids, 24 box
floats, the parent and the count) and 8 B a leaf (primitive and wide
parent). With n leaves: 32 (2 n - 1) + 120 (n - 1) + 8 n."""
from benchmark import spans


def least_bytes(n: int) -> int:
    return 32 * (2 * n - 1) + 120 * (n - 1) + 8 * n


def read(ctx):
    s = spans.Spans(ctx.trace)
    if not ctx.trace.gpu or not s.has("bvh.collapse") or not ctx.peaks:
        return None
    t = s.device_seconds_under("bvh.collapse") / ctx.steps
    if not t > 0:
        return None
    return 100.0 * least_bytes(int(ctx.sizes["n"])) / ctx.peaks["bytes_per_s"] / t
