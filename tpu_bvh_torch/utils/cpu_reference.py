"""Sequential BVH2 -> BVH4 collapse: the numpy oracle of both collapses.

A copy of `tpu_bvh.utils.cpu_reference.collapse_cpu` (the reference's
`collapseBvh2toBvh4` behaviour), kept in the port so that it runs where
JAX is not installed. It accepts the port's tensors or numpy arrays.
"""
from __future__ import annotations

import numpy as np

from .validate import _as_np


def collapse_cpu(bvh):
    """Sequential BVH2 -> BVH4 collapse with BFS task order and in-order
    child-slot allocation: repeatedly expand the largest-area internal
    child (2 expansions -> up to 4 children).

    Returns a dict with child[K,4], child_min/max[K,4,3], parent[K],
    child_count[K], n_nodes, leaf_prim[N], leaf_parent[N] and b2_node[K]
    (the bvh2 node that became wide node i). Child ids >= cap
    (= n2_internal) denote wide-leaf slots (id - cap indexes leaf_prim).
    """
    packed = _as_np(bvh.packed_t)
    node_min = packed[0:3].T
    node_max = -packed[3:6].T
    left = _as_np(bvh.left)
    right = _as_np(bvh.right)
    n_leaves = bvh.n_leaves
    n_internal = bvh.n_internal
    root = int(_as_np(bvh.root))
    cap = n_internal

    def area(i):
        e = node_max[i] - node_min[i]
        return 2.0 * (e[0] * e[1] + e[0] * e[2] + e[1] * e[2])

    child = np.full((max(cap, 1), 4), -1, np.int64)
    cmin = np.zeros((max(cap, 1), 4, 3), np.float32)
    cmax = np.zeros((max(cap, 1), 4, 3), np.float32)
    parent = np.full(max(cap, 1), -1, np.int64)
    child_count = np.zeros(max(cap, 1), np.int64)
    leaf_prim = np.full(n_leaves, -1, np.int64)
    leaf_parent = np.full(n_leaves, -1, np.int64)

    # tasks[i] = (bvh2 node, wide parent) for wide node i
    tasks = {0: (root, -1)}
    next_free = 1
    frontier = [0]
    while frontier:
        new_frontier = []
        for widx in frontier:
            b2, par = tasks[widx]
            ids = [left[b2], right[b2]]
            for _ in range(2):
                best_area, best_pos = 0.0, -1
                for k, c in enumerate(ids):
                    if c < n_internal and area(c) > best_area:
                        best_area, best_pos = area(c), k
                if best_pos < 0:
                    break
                c = ids[best_pos]
                ids[best_pos] = left[c]
                ids.append(right[c])
            parent[widx] = par
            child_count[widx] = len(ids)
            k_alloc = 0
            for slot, c in enumerate(ids):
                cmin[widx, slot] = node_min[c]
                cmax[widx, slot] = node_max[c]
                if c < n_internal:
                    w = next_free + k_alloc
                    k_alloc += 1
                    child[widx, slot] = w
                    tasks[w] = (c, widx)
                    new_frontier.append(w)
                else:
                    leaf_slot = c - n_internal
                    child[widx, slot] = cap + leaf_slot
                    leaf_prim[leaf_slot] = left[c]
                    leaf_parent[leaf_slot] = widx
            next_free += k_alloc
        frontier = new_frontier

    b2_node = np.full(max(cap, 1), -1, np.int64)
    for widx, (b2, _par) in tasks.items():
        b2_node[widx] = b2
    return {
        "child": child,
        "child_min": cmin,
        "child_max": cmax,
        "parent": parent,
        "child_count": child_count,
        "n_nodes": next_free,
        "leaf_prim": leaf_prim,
        "leaf_parent": leaf_parent,
        "b2_node": b2_node,
    }
