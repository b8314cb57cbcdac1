"""Hand-written collapse launches a build: the program's own counter
(`tpu_bvh_torch.ops.collapse_fast.last_build["launches"]`: the prep, coarse
and block kernels of the last collapse, 3 on the card), read after each
traced build. A program whose collapse keeps no such counter reports
nothing."""
import importlib


def collect(store, out):
    try:
        mod = importlib.import_module("tpu_bvh_torch.ops.collapse_fast")
    except ModuleNotFoundError:
        return
    last = getattr(mod, "last_build", None)
    if last is not None:
        store.append(last["launches"])


def read(ctx):
    vals = ctx.store.get("collapse_kernels_per_build", [])
    return sum(vals) / len(vals) if vals else None
