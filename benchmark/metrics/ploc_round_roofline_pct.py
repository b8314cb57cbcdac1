"""B6's share of its roofline over a build's rounds: the sum over the rounds
of each round's least time (its bytes at the card's peak rate or its f32
operations at the f32 peak, the larger) over B6's device time a build, in
per cent. Each round's live clusters and merges come from the program's own
counters (`tpu_bvh_torch.ops.ploc.last_build["clusters"]`, `["merged"]`),
read after each traced build.

The counts are `utils/work.py:ploc_round` at commit abd2c2d, frozen here: a
round of nc live clusters and `merged` merges keeps nc - merged; it reads
the state once (7 rows at shift 32, 8 below, and at shift 32 the code row
of each survivor) and writes 8 rows a survivor and 8 a merged node, 4 bytes
each; it computes RADIUS pair areas of 18 operations a cluster. PLOC++ runs
one segment, so every round is at shift 32; RADIUS is the port's fixed
`types.PLOC_RADIUS`, the configuration's `radius`."""
import importlib

RADIUS = 8
FLOPS_PER_PAIR = 18
SHIFT = 32


def round_bytes(nc: int, merged: int, shift: int = SHIFT) -> int:
    kept = nc - merged
    rows = 7 if shift >= 32 else 8
    return 4 * (rows * nc + (kept if shift >= 32 else 0) + 8 * kept + 8 * merged)


def round_flops(nc: int, radius: int = RADIUS) -> int:
    return nc * radius * FLOPS_PER_PAIR


def collect(store, out):
    last = importlib.import_module("tpu_bvh_torch.ops.ploc").last_build
    if "clusters" in last:
        store.append((list(last["clusters"]), list(last["merged"])))


def read(ctx):
    builds = ctx.store.get("ploc_round_roofline_pct", [])
    if not builds or not ctx.peaks:
        return None
    t = ctx.kernel_seconds_per_step("ploc_round")
    if t is None or not t > 0:
        return None
    bps, fps = ctx.peaks["bytes_per_s"], ctx.peaks["f32_flops_per_s"]
    least = sum(max(round_bytes(nc, m) / bps, round_flops(nc) / fps)
                for clusters, merged in builds for nc, m in zip(clusters, merged))
    return 100.0 * least / len(builds) / t
