"""The traversal's SIMD efficiency over the traced calls: lane steps (node and
leaf steps) over 32 x warp steps, from the kernel's own counters
(`tpu_bvh_torch.ops.traverse.last_stats`, `last_warp_steps`), in per cent."""
import importlib


def collect(store, out):
    tr = importlib.import_module("tpu_bvh_torch.ops.traverse")
    if tr.last_stats is not None:  # set by the kernel, not by the plain engine
        store.append((tr.last_stats, tr.last_warp_steps))


def read(ctx):
    got = ctx.store.get("traverse_simd_eff_pct", [])
    lanes = sum(int(s[0]) + int(s[1]) for s, _ in got)
    warps = sum(int(w) for _, w in got)
    return 100.0 * lanes / (32 * warps) if warps else None
