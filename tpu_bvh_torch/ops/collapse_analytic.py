"""BVH2 -> BVH4 collapse derived analytically, with no task queue: the
port of `tpu_bvh.ops.collapse_analytic`, JAX's executable specification
of the collapse (not a production path; no kernel backs it in either
package).

A task's expansion is a local function of its children's and
grandchildren's areas, so the whole wide tree has a closed form:

1. expansion tables: for every internal node at once, the two expansion
   steps of the sequential oracle (the largest-area internal child, the
   first on ties, while its area is > 0): final child ids, count, and the
   two consumed nodes e1, e2;
2. states: each internal node is WIDE, E1 or E2 (consumed as a wide
   ancestor's first or second expansion), a 3-state transition table per
   node composed along parent chains by pointer doubling;
3. BFS numbering: a wide node's level and slot path from the root by a
   second pointer doubling, then one sort on (level, path words) gives
   the oracle's BFS order;
4. emit: one masked scatter per output array.

The doubling loops test convergence on the host once a trip.
"""
from __future__ import annotations

import torch

from ..types import Bvh2, Bvh4

I32 = torch.int32
I64 = torch.int64
INVALID = -1

_WIDE, _E1, _E2 = 0, 1, 2


def _apply(table, s):
    """Apply a base-4-encoded 3-state transition table to state(s) s."""
    return (table >> (2 * s)) & 3


def _double(ptr, values, combine):
    """Pointer doubling until `ptr` stops moving: each trip combines every
    value with its pointer's value, then jumps the pointers."""
    while True:
        values = combine(ptr, values)
        nptr = ptr[ptr]
        if torch.equal(nptr, ptr):
            return nptr, values
        ptr = nptr


def collapse_bvh2_to_bvh4_analytic(bvh: Bvh2) -> Bvh4:
    n_int = bvh.n_internal
    mm = bvh.n_nodes
    cap = max(n_int, 1)
    dev = bvh.packed_t.device
    root = bvh.root.to(I64)

    pk = bvh.packed_t
    left = bvh.left.to(I64)
    right = bvh.right.to(I64)
    ext = torch.clamp(-pk[3:6] - pk[0:3], min=0.0)
    area = 2.0 * (ext[0] * ext[1] + ext[0] * ext[2] + ext[1] * ext[2])

    def clip(x, hi):
        return torch.clamp(x, 0, hi)

    # 1. the expansion of every internal node at once
    slot_ids = torch.arange(4, dtype=I64, device=dev)[None, :]
    none = torch.full((cap,), INVALID, dtype=I64, device=dev)
    ids = torch.stack([left[:cap], right[:cap], none, none], dim=1)
    count = torch.full((cap,), 2, dtype=I64, device=dev)
    e_steps = []
    for _ in range(2):
        is_int = (ids >= 0) & (ids < n_int)
        a = torch.where(is_int, area[clip(ids, mm - 1)], -1.0)
        best, pos = a.max(dim=1)  # the first max, as the oracle
        do = best > 0
        chosen = torch.gather(ids, 1, pos[:, None])[:, 0]
        csafe = clip(chosen, mm - 1)
        ids = torch.where(do[:, None] & (slot_ids == pos[:, None]), left[csafe][:, None], ids)
        ids = torch.where(do[:, None] & (slot_ids == count[:, None]), right[csafe][:, None], ids)
        e_steps.append(torch.where(do, chosen, INVALID))
        count = count + do.to(I64)
    e1, e2 = e_steps

    # 2. states by transition-table pointer doubling
    src = torch.arange(cap, dtype=I64, device=dev)
    parent2 = torch.full((mm,), INVALID, dtype=I64, device=dev)
    if n_int > 0:  # a single-leaf scene has no internal node
        parent2[clip(left[:cap], mm - 1)] = src
        parent2[clip(right[:cap], mm - 1)] = src

    y = src
    p = parent2[:cap]
    ps = clip(p, cap - 1)
    g = parent2[ps]
    gs = clip(g, cap - 1)
    t_wide = torch.where(y == e1[ps], _E1, torch.where(y == e2[ps], _E2, _WIDE))
    t_e1 = torch.where(y == e2[gs], _E2, _WIDE)
    parentless = p < 0  # the root, and orphan slots (which converge on themselves)
    fenc = torch.where(parentless, 0, t_wide | (t_e1 << 2))
    ptr = torch.where(parentless, y, p)

    def compose(ptr, f):
        fp = f[ptr]
        return (_apply(f, _apply(fp, 0)) | (_apply(f, _apply(fp, 1)) << 2)
                | (_apply(f, _apply(fp, 2)) << 4))

    if n_int > 1:
        ptr, fenc = _double(ptr, fenc, compose)
    state = fenc & 3
    reach = ptr == root
    is_root = y == root
    is_wide = (state == _WIDE) & reach

    # the wide node whose slots hold each node (leaves too), and the slot
    p_all = parent2
    ps_all = clip(p_all, cap - 1)
    g_all = parent2[ps_all]
    gs_all = clip(g_all, cap - 1)
    s_p = state[ps_all]
    s_g = state[gs_all]
    a_of = torch.where(s_p == _WIDE, p_all,
                       torch.where(s_p == _E1, g_all,
                                   torch.where(s_g == _WIDE, g_all, parent2[gs_all])))
    a_of = torch.where(p_all < 0, INVALID, a_of)
    a_safe = clip(a_of[:cap], cap - 1)
    slot_in_a = (ids[a_safe] == y[:, None]).to(I32).argmax(dim=1).to(I64)

    # 3. level and path words by pointer doubling over the wide-parent chain
    chain_live = is_wide & ~is_root
    a = torch.where(chain_live, a_safe, root)
    lvl = chain_live.to(I64)
    if n_int > 1:
        _, lvl = _double(a, lvl, lambda ptr, d: d + d[ptr])
    li = torch.clamp(lvl - 1, min=0)
    word = li // 16
    shift = 30 - 2 * (li % 16)
    bits = torch.where(chain_live, slot_in_a << shift, 0)
    words = torch.stack([torch.where(word == k, bits, 0) for k in range(4)])
    if n_int > 1:
        _, words = _double(a, words, lambda ptr, w: w | w[:, ptr])

    # the BFS rank: the position under the stable ascending sort on
    # (level, path words), wide nodes first
    lvl_key = torch.where(is_wide, lvl, 0x7FFFFFFF)
    perm = y
    for key in (words[3], words[2], words[1], words[0], lvl_key):  # least significant first
        perm = perm[torch.sort(key[perm], stable=True).indices]
    bfs_rank = torch.empty((cap,), dtype=I64, device=dev)
    bfs_rank[perm] = torch.arange(cap, dtype=I64, device=dev)
    n_wide = is_wide.sum().to(I32)

    # 4. emit
    valid_slot = slot_ids < count[:, None]
    ids_safe = clip(ids, mm - 1)
    child_vals = torch.where(~valid_slot, INVALID,
                             torch.where(ids >= n_int, cap + ids - n_int,
                                         bfs_rank[clip(ids, cap - 1)]))
    cmin_vals = torch.where(valid_slot[None], pk[0:3][:, ids_safe], 0.0).permute(1, 2, 0)
    cmax_vals = torch.where(valid_slot[None], -pk[3:6][:, ids_safe], 0.0).permute(1, 2, 0)
    parent_vals = torch.where(is_root, INVALID, bfs_rank[a_safe])

    tgt = bfs_rank[is_wide]
    out_child = torch.full((cap, 4), INVALID, dtype=I32, device=dev)
    out_child[tgt] = child_vals[is_wide].to(I32)
    out_cmin = torch.zeros((cap, 4, 3), dtype=torch.float32, device=dev)
    out_cmin[tgt] = cmin_vals[is_wide]
    out_cmax = torch.zeros((cap, 4, 3), dtype=torch.float32, device=dev)
    out_cmax[tgt] = cmax_vals[is_wide]
    out_parent = torch.full((cap,), INVALID, dtype=I32, device=dev)
    out_parent[tgt] = parent_vals[is_wide].to(I32)
    out_count = torch.zeros((cap,), dtype=I32, device=dev)
    out_count[tgt] = count[is_wide].to(I32)

    return Bvh4.from_rowmajor(
        child_min=out_cmin, child_max=out_cmax, child=out_child, parent=out_parent,
        child_count=out_count, n_nodes=n_wide, leaf_prim=bvh.left[n_int:].to(I32),
        leaf_parent=bfs_rank[clip(a_of[n_int:], cap - 1)].to(I32),
        root=torch.zeros((), dtype=I32, device=dev))
