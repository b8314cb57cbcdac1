"""Host syncs a PLOC build: the program's own counter
(`tpu_bvh_torch.ops.ploc.last_build["host_syncs"]`, one a round and one for the
finisher), read after each traced build."""
import importlib


def collect(store, out):
    store.append(importlib.import_module("tpu_bvh_torch.ops.ploc").last_build["host_syncs"])


def read(ctx):
    vals = [v for v in ctx.store.get("ploc_host_syncs_per_build", []) if v is not None]
    return sum(vals) / len(vals) if vals else None
