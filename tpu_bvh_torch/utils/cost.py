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


def sah_cost_bvh4(bvh4, prim_aabb_min, prim_aabb_max) -> torch.Tensor:
    """ct per wide internal child + ci per wide leaf (leaf areas from the
    primitives' own AABBs), over the root's area. Reads the lane-major
    slot store; used wide nodes are those with child_count > 0, which
    holds for both numberings. Returns a 0-dim f32 tensor."""
    cap = bvh4.n_internal_cap
    child_t = bvh4.child_t
    sp = bvh4.slot_packed_t  # [4, 6, K]
    ext = torch.clamp(-sp[:, 3:6, :] - sp[:, 0:3, :], min=0.0)  # [4, 3, K]
    child_areas = 2.0 * (ext[:, 0] * ext[:, 1] + ext[:, 0] * ext[:, 2]
                         + ext[:, 1] * ext[:, 2])  # [4, K]
    root = bvh4.root.to(torch.int64)
    root_valid = child_t[:, root] >= 0  # [4]
    root_pk = torch.where(root_valid[:, None], sp[:, :, root], torch.inf).amin(dim=0)
    root_ext = torch.clamp(-root_pk[3:6] - root_pk[0:3], min=0.0)
    inv_root = 1.0 / (2.0 * (root_ext[0] * root_ext[1] + root_ext[0] * root_ext[2]
                             + root_ext[1] * root_ext[2]))
    is_used = (bvh4.child_count > 0)[None, :]
    is_internal_child = (child_t >= 0) & (child_t < cap) & is_used
    cost = 1.0 + torch.where(is_internal_child, child_areas, 0.0).sum() * inv_root
    lp = bvh4.leaf_prim.to(torch.int64)
    leaf_areas = area(prim_aabb_min[lp], prim_aabb_max[lp])
    return cost + leaf_areas.sum() * inv_root
