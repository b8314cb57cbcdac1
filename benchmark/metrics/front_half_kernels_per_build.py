"""Hand-written front-half launches a build: the program's own counter
(`tpu_bvh_torch.ops.front_half.last_build["launches"]`: the box, key and
gather kernels of the last front half, 3 on the card), read after each
traced build. A program without the module reports nothing."""
import importlib


def collect(store, out):
    try:
        mod = importlib.import_module("tpu_bvh_torch.ops.front_half")
    except ModuleNotFoundError:
        return
    store.append(mod.last_build["launches"])


def read(ctx):
    vals = ctx.store.get("front_half_kernels_per_build", [])
    return sum(vals) / len(vals) if vals else None
