"""Hand-written launches of the LBVH tail a build: the program's own counter
(`tpu_bvh_torch.ops.radix_tree.last_build["launches"]`: B1's links form,
B2's tree mode and the long-node launch of the last single-pass tail, 3 on
the card), read after each traced build. A program whose radix tree keeps
no such counter reports nothing."""
import importlib


def collect(store, out):
    try:
        mod = importlib.import_module("tpu_bvh_torch.ops.radix_tree")
    except ModuleNotFoundError:
        return
    last = getattr(mod, "last_build", None)
    if last is not None:
        store.append(last["launches"])


def read(ctx):
    vals = ctx.store.get("lbvh_tail_kernels_per_build", [])
    return sum(vals) / len(vals) if vals else None
