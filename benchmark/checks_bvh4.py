"""The check that decides `correct` for builders that collapse to a 4-wide BVH:
each sampled Bvh4 against the configuration's reference (`"reference"`,
`benchmark/reference/collapse.py`) of the same frame, exactly.

A mix names it as `"check": {"entry": "benchmark.checks_bvh4:trees4", ...}`;
it is called as `checks.trees` is and returns one dict of readings an output:

* `order_differs`: wide leaf slots whose primitive (`leaf_prim`) differs;
* `links_differ`: wide nodes, used on either side, whose slot ids, child
  count or wide parent differ, plus leaves whose wide parent (`leaf_parent`)
  differs, plus one when the root differs;
* `boxes_differ`: box floats of the reference's used slots (slot k < child
  count of a used wide node) whose bits differ.
"""
from __future__ import annotations

import torch

from benchmark import entry

I32 = torch.int32
FIELDS = ("slot_packed_t", "child_t", "parent", "child_count", "leaf_prim", "leaf_parent")


def compare4(got, want) -> dict:
    """The readings of one Bvh4 (any object with the Bvh4 fields) against
    the reference's."""
    dev = want.child_t.device
    g = {f: getattr(got, f).to(dev) for f in FIELDS}
    w = {f: getattr(want, f) for f in FIELDS}
    m, n = w["child_t"].shape[-1], w["leaf_prim"].shape[0]
    if any(g[f].shape != w[f].shape for f in FIELDS):
        return {"order_differs": n, "links_differ": m + n + 1, "boxes_differ": 24 * m}
    order = int((g["leaf_prim"] != w["leaf_prim"]).sum())
    used = (g["child_count"] > 0) | (w["child_count"] > 0)
    node = ((g["child_t"] != w["child_t"]).any(dim=0) | (g["child_count"] != w["child_count"])
            | (g["parent"] != w["parent"]))
    links = int((node & used).sum()) + int((g["leaf_parent"] != w["leaf_parent"]).sum())
    links += int(int(got.root) != int(want.root))
    slot = torch.arange(4, device=dev)[:, None] < w["child_count"][None]  # [4, m]
    bits = (g["slot_packed_t"].contiguous().view(I32)
            != w["slot_packed_t"].contiguous().view(I32))  # [4, 6, m]
    boxes = int((bits & slot[:, None, :]).sum())
    return {"order_differs": order, "links_differ": links, "boxes_differ": boxes}


def trees4(sample, scene, inputs, config, traffic, seed) -> list:
    """Each sampled build against the reference's Bvh4 of the same frame."""
    reference = entry(config["reference"])
    refs, per = {}, []
    for _, f, out in sample:
        if f not in refs:
            refs[f] = reference(scene.frames[f], config)
        per.append(compare4(out, refs[f]))
    return per
