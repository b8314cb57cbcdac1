"""The numbers compared between what the timed path produced and the reference.

Trees (a Bvh2 tuple or any object with packed_t, left, right, root), exact:

* `order_differs`: leaves whose primitive differs (the front half: scene box,
  Morton codes and the (code, primitive) sort decide the leaf order);
* `links_differ`: internal nodes whose left or right child differs, plus one
  when the root differs;
* `boxes_differ`: node box floats (internal and leaf) whose bits differ.

Hits of sampled rays:

* `prims_differ`: rays whose hit primitive differs (a miss is -1);
* `t_gap`: the largest |t - t_ref| / t_ref over rays both sides hit;
* `uv_gap`: the largest |u - u_ref| or |v - v_ref| over rays that hit the
  same primitive on both sides.
"""
from __future__ import annotations

import torch

I32 = torch.int32


def _parts(tree):
    if isinstance(tree, tuple) and not hasattr(tree, "packed_t"):
        return tree
    return tree.packed_t, tree.left, tree.right, tree.root


def trees(got, want) -> dict:
    gp, gl, gr, groot = _parts(got)
    wp, wl, wr, wroot = _parts(want)
    n_nodes = wl.shape[0]
    m = (n_nodes - 1) // 2
    if tuple(gp.shape) != tuple(wp.shape) or gl.shape != wl.shape or gr.shape != wr.shape:
        return {"order_differs": m + 1, "links_differ": m + 1, "boxes_differ": 6 * n_nodes}
    gl, gr, wl, wr = gl.to(wl.device), gr.to(wl.device), wl, wr
    order = int((gl[m:] != wl[m:]).sum())
    links = int(((gl[:m] != wl[:m]) | (gr[:m] != wr[:m])).sum())
    links += int(int(groot) != int(wroot))
    boxes = int((gp.to(wp.device).contiguous().view(I32) != wp.contiguous().view(I32)).sum())
    return {"order_differs": order, "links_differ": links, "boxes_differ": boxes}


def hits(got, want) -> dict:
    gp, gt, gu, gv = (x.to(want[0].device) for x in got)
    wp, wt, wu, wv = want
    both = (gp >= 0) & (wp >= 0)
    same = both & (gp == wp)
    t_gap = ((gt - wt).abs() / wt.abs().clamp(min=1e-30))[both]
    uv_gap = torch.maximum((gu - wu).abs(), (gv - wv).abs())[same]
    return {"prims_differ": int((gp != wp).sum()),
            "t_gap": float(t_gap.max()) if t_gap.numel() else 0.0,
            "uv_gap": float(uv_gap.max()) if uv_gap.numel() else 0.0}


def worst(readings: list) -> dict:
    """The largest reading of each number over several comparisons."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out
