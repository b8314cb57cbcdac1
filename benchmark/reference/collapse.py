"""Plain reference of the greedy BVH2 -> BVH4 collapse, and the single-pass
LBVH collapsed by it.

Semantics (the reference renderer's `CollapseToWide4Bvh`, as its host
version in `Utility.cpp` states them): from the root, top down and one BFS
level of wide nodes at a time, each wide node starts from its bvh2 node's
two children and expands twice the internal slot of largest area: the slot
takes that child's left child and its right child is appended. The first
maximum wins ties; a child expands only if its area is strictly greater
than 0; an area is 2 * ((ex * ey + ex * ez) + ey * ez), each product and
sum rounded on its own, with ex = max(max x - min x, 0), and areas are
compared by their f32 bits. A leaf never expands. Every internal slot
becomes a wide node of the next level.

Numbering: a departure from the reference GPU kernel, which hands out wide
ids in the order its atomics run. Here, as in the port, a wide node keeps
its bvh2 id (ids that no wide node takes have child count 0, slots -1,
parent -1 and zero boxes), the root is the bvh2 root, and a slot holding
leaf j (bvh2 node m + j) reads m + j. Empty slots hold -1 and a zero box.

Bvh2 here is the tuple (packed_t f32[6, 2n - 1], left i32[2n - 1],
right i32[2n - 1], root), internal nodes first; it uses nothing else of
the tree (no leaf ranges, no parents).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import build

I32, I64, F32 = torch.int32, torch.int64, torch.float32


class Bvh4(NamedTuple):
    """The collapsed tree, with the field names of the port's Bvh4."""

    slot_packed_t: torch.Tensor  # f32[4, 6, m]: slot k of wide node x at [k, :, x]
    child_t: torch.Tensor  # i32[4, m]: slot ids, -1 empty
    parent: torch.Tensor  # i32[m]: the wide node whose slot holds x, -1 for the root
    child_count: torch.Tensor  # i32[m]
    n_nodes: torch.Tensor  # i32[]: wide nodes in use
    leaf_prim: torch.Tensor  # i32[n]
    leaf_parent: torch.Tensor  # i32[n]: the wide node whose slot holds leaf j
    root: torch.Tensor  # i32[]


def area_bits(packed_t, dtype=F32):
    """The i32 bits of each node's f32 surface area (>= 0, so their integer
    order is the float order), the arithmetic done in `dtype`."""
    p = packed_t.to(dtype)
    ext = torch.clamp(-p[3:6] - p[0:3], min=0.0)
    ex, ey, ez = ext[0], ext[1], ext[2]
    area = 2.0 * ((ex * ey + ex * ez) + ey * ez)
    return area.to(F32).contiguous().view(I32)


def collapse(tree, dtype=F32) -> Bvh4:
    """The greedy BVH4 of a Bvh2 tuple, level by level."""
    packed_t, left, right, root = tree
    n_nodes = left.shape[0]
    n = (n_nodes + 1) // 2
    m = n - 1
    if m < 1:
        raise ValueError("the collapse needs at least 2 leaves")
    dev = left.device
    left, right = left.to(I64), right.to(I64)
    code = torch.cat([area_bits(packed_t[:, :m], dtype),
                      torch.full((n,), -1, dtype=I32, device=dev)])  # leaves: -1
    child = torch.full((4, m), -1, dtype=I64, device=dev)
    count = torch.zeros(m, dtype=I64, device=dev)
    parent = torch.full((m,), -1, dtype=I64, device=dev)
    leaf_parent = torch.full((n,), -1, dtype=I64, device=dev)
    slot = torch.arange(4, dtype=I64, device=dev)
    frontier = torch.as_tensor(root, device=dev).to(I64).reshape(1)
    while frontier.numel():
        k = frontier.numel()
        ids = torch.full((k, 4), -1, dtype=I64, device=dev)
        ids[:, 0], ids[:, 1] = left[frontier], right[frontier]
        cnt = torch.full((k,), 2, dtype=I64, device=dev)
        for _ in range(2):
            codes = torch.where(ids >= 0, code[ids.clamp(min=0)], -1)
            best = codes.max(dim=1).values
            pos = torch.where(codes == best[:, None], slot, 4).min(dim=1).values  # the first
            grow = torch.nonzero(best > 0).flatten()
            c = ids[grow, pos[grow]]
            ids[grow, pos[grow]] = left[c]
            ids[grow, cnt[grow]] = right[c]
            cnt[grow] += 1
        child[:, frontier] = ids.T
        count[frontier] = cnt
        used = ids >= 0
        owner = frontier[:, None].expand(k, 4)
        inner = used & (ids < m)
        parent[ids[inner]] = owner[inner]
        outer = used & (ids >= m)
        leaf_parent[ids[outer] - m] = owner[outer]
        frontier = ids[inner]
    boxes = packed_t[:, child.clamp(min=0)].permute(1, 0, 2)  # [4, 6, m]
    boxes = torch.where((child >= 0)[:, None, :], boxes, torch.zeros((), dtype=F32, device=dev))
    return Bvh4(slot_packed_t=boxes.contiguous(), child_t=child.to(I32),
                parent=parent.to(I32), child_count=count.to(I32),
                n_nodes=(count > 0).sum().to(I32), leaf_prim=left[m:].to(I32),
                leaf_parent=leaf_parent.to(I32),
                root=torch.as_tensor(root, device=dev).to(I32).reshape(()))


def build_lbvh_bvh4(tris, config: dict, dtype=F32) -> Bvh4:
    """The reference single-pass LBVH of a triangle soup collapsed to its
    greedy BVH4 (a configuration's
    `"reference": "benchmark.reference.collapse:build_lbvh_bvh4"`)."""
    return collapse(build.build_lbvh(tris, config, dtype), dtype)
