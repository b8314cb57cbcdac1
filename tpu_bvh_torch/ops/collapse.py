"""Queue-ordered BVH2 -> BVH4 collapse: the port of `tpu_bvh.ops.collapse`.

The general-tree path (any Bvh2, e.g. PLOC trees): a BFS over a task
queue, processed in slabs of 4096 tasks in queue order. Each task expands
its largest-area internal child twice (up to 4 children), its internal
children get the next free wide ids by an exclusive cumsum and join the
queue, in order. The numbering is therefore that of the sequential oracle
(`utils/cpu_reference.collapse_cpu`), byte for byte: wide nodes in BFS
order from root 0. No Pallas kernel backs it in the JAX package, so this
is plain PyTorch on either device (one host sync per slab).
"""
from __future__ import annotations

import torch

from ..types import Bvh2, Bvh4

I32 = torch.int32
SLAB = 4096


def collapse_bvh2_to_bvh4(bvh: Bvh2) -> Bvh4:
    n_leaves = bvh.n_leaves
    n2_int = bvh.n_internal
    mm = bvh.n_nodes
    cap = max(n2_int, 1)
    slab = min(SLAB, max(cap, 8))
    dev = bvh.packed_t.device

    pk = bvh.packed_t
    ext = torch.clamp(-pk[3:6] - pk[0:3], min=0.0)
    areas = 2.0 * ((ext[0] * ext[1] + ext[0] * ext[2]) + ext[1] * ext[2])
    # per-node i32 row [left, right, area bits, min bits xyz, max bits xyz];
    # areas are >= 0, so their bit patterns order like the floats
    prow = torch.cat([
        bvh.left.to(I32)[None], bvh.right.to(I32)[None], areas.view(I32)[None],
        pk[0:3].contiguous().view(I32), (-pk[3:6]).contiguous().view(I32),
    ]).T.contiguous()  # [mm, 9]

    def fetch(ids):
        return prow[torch.clamp(ids, 0, mm - 1).to(torch.int64)]

    tq_id = torch.full((cap + slab,), -1, dtype=I32, device=dev)
    tq_id[0] = bvh.root.to(I32)
    tq_parent = torch.full((cap + slab,), -1, dtype=I32, device=dev)
    child = torch.full((cap, 4), -1, dtype=I32, device=dev)
    cmin = torch.zeros((cap, 4, 3), dtype=I32, device=dev)
    cmax = torch.zeros((cap, 4, 3), dtype=I32, device=dev)
    parent = torch.full((cap,), -1, dtype=I32, device=dev)
    child_count = torch.zeros((cap,), dtype=I32, device=dev)
    leaf_prim = torch.full((n_leaves,), -1, dtype=I32, device=dev)
    leaf_parent = torch.full((n_leaves,), -1, dtype=I32, device=dev)

    slot_ids = torch.arange(4, dtype=I32, device=dev)[None, :]
    start, alloc = 0, 1
    while start < alloc:
        k = min(slab, alloc - start)  # tasks allocated before this round
        gidx = torch.arange(start, start + k, dtype=I32, device=dev)
        trow = fetch(tq_id[start:start + k])
        neg = torch.full((k,), -1, dtype=I32, device=dev)
        ids = torch.stack([trow[:, 0], trow[:, 1], neg, neg], dim=1)  # [k, 4]
        zero = torch.zeros((k, 9), dtype=I32, device=dev)
        rowdata = torch.stack([fetch(trow[:, 0]), fetch(trow[:, 1]), zero, zero], dim=1)
        count = torch.full((k,), 2, dtype=I32, device=dev)
        for _ in range(2):
            is_int = (slot_ids < count[:, None]) & (ids >= 0) & (ids < n2_int)
            slot_area = torch.where(is_int, rowdata[:, :, 2], -1)
            best = slot_area.amax(dim=1)
            pos = slot_area.argmax(dim=1)  # the first max wins
            do = (best > 0)[:, None]  # strict > 0, like the oracle's maxArea = 0
            chosen = rowdata[torch.arange(k, device=dev), pos]
            cl, cr = chosen[:, 0], chosen[:, 1]
            at_pos = do & (slot_ids == pos[:, None])
            at_end = do & (slot_ids == count[:, None])
            ids = torch.where(at_pos, cl[:, None], torch.where(at_end, cr[:, None], ids))
            rowdata = torch.where(at_pos[:, :, None], fetch(cl)[:, None],
                                  torch.where(at_end[:, :, None], fetch(cr)[:, None], rowdata))
            count = count + do[:, 0].to(I32)

        in_slot = slot_ids < count[:, None]
        is_int_child = in_slot & (ids >= 0) & (ids < n2_int)
        is_leaf_child = in_slot & (ids >= n2_int)
        flat_int = is_int_child.reshape(-1).to(I32)
        new_ids = (alloc + torch.cumsum(flat_int, 0, dtype=I32) - flat_int).reshape(k, 4)
        n_new = int(flat_int.sum())  # one host sync per slab

        rows = slice(start, start + k)
        child[rows] = torch.where(is_int_child, new_ids,
                                  torch.where(is_leaf_child, cap + (ids - n2_int), -1))
        cmin[rows] = rowdata[:, :, 3:6]
        cmax[rows] = rowdata[:, :, 6:9]
        parent[rows] = tq_parent[rows]
        child_count[rows] = count

        # enqueue internal children contiguously at [alloc, alloc + n_new)
        tq_id[new_ids[is_int_child].to(torch.int64)] = ids[is_int_child]
        tq_parent[new_ids[is_int_child].to(torch.int64)] = gidx[:, None].expand(k, 4)[is_int_child]
        # wide leaves: a leaf's `left` is its primitive
        leaf_slot = (ids - n2_int)[is_leaf_child].to(torch.int64)
        leaf_prim[leaf_slot] = rowdata[:, :, 0][is_leaf_child]
        leaf_parent[leaf_slot] = gidx[:, None].expand(k, 4)[is_leaf_child]

        start += k
        alloc += n_new
    return Bvh4.from_rowmajor(
        child_min=cmin.view(torch.float32),
        child_max=cmax.view(torch.float32),
        child=child,
        parent=parent,
        child_count=child_count,
        n_nodes=torch.tensor(alloc, dtype=I32, device=dev),
        leaf_prim=leaf_prim,
        leaf_parent=leaf_parent,
        root=torch.zeros((), dtype=I32, device=dev),
    )
