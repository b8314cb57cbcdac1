"""Host syncs an LBVH build: the program's own counter
(`tpu_bvh_torch.models.lbvh.last_build["host_syncs"]`, each device-to-host
read counted at its site: the extent copy, the refit's long-node count and
its `nonzero`), read after each traced build."""
import importlib


def collect(store, out):
    last = getattr(importlib.import_module("tpu_bvh_torch.models.lbvh"), "last_build", None)
    if last is not None:
        store.append(last["host_syncs"])


def read(ctx):
    vals = ctx.store.get("lbvh_host_syncs_per_build", [])
    return sum(vals) / len(vals) if vals else None
