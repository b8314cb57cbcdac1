"""Node and leaf steps a ray over the traced calls, from the kernel's own
counters (`tpu_bvh_torch.ops.traverse.last_stats`)."""
import importlib


def collect(store, out):
    tr = importlib.import_module("tpu_bvh_torch.ops.traverse")
    if tr.last_stats is not None:  # set by the kernel, not by the plain engine
        store.append((tr.last_stats, int(out[0].shape[0])))


def read(ctx):
    got = ctx.store.get("traverse_steps_per_ray", [])
    rays = sum(n for _, n in got)
    return sum(int(s[0]) + int(s[1]) for s, _ in got) / rays if rays else None
