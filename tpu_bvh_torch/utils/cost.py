"""SAH cost of a BVH2 (ci = ct = 1, areas normalized by the root area,
root counted once at ct)."""
from __future__ import annotations

import torch

from ..ops.aabb import area


def sah_cost_bvh2(bvh) -> torch.Tensor:
    """ct for the root + ct per internal-node child + ci per leaf, all
    area-weighted. Returns a 0-dim f32 tensor."""
    m = bvh.n_internal
    areas = area(bvh.node_min, bvh.node_max)
    inv_root = 1.0 / areas[bvh.root.to(torch.int64)]
    left = bvh.left[:m].to(torch.int64)
    right = bvh.right[:m].to(torch.int64)
    cost = 1.0 + (areas[left] * inv_root).sum() + (areas[right] * inv_root).sum()
    return cost + (areas[m:] * inv_root).sum()
