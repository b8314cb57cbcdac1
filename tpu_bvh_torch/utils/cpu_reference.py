"""Sequential numpy oracles: the traversal and the BVH2 -> BVH4 collapse.

Copies of `tpu_bvh.utils.cpu_reference.traverse_cpu` (the reference's
`TraversalLbvhCPU` behaviour) and `collapse_cpu` (its `collapseBvh2toBvh4`),
kept in the port so that they run where JAX is not installed. They accept
the port's tensors or numpy arrays.
"""
from __future__ import annotations

import numpy as np

from .validate import _as_np

FLT_MAX = np.float32(3.402823466e38)


def _qt_rotate(q, p):
    qv = q[:3]
    qw = q[3]
    t = 2.0 * np.cross(qv, p)
    return p + qw * t + np.cross(qv, t)


def _transform(p, scale, quat, translation):
    return _qt_rotate(quat, scale * p) + translation


def _inv_transform(p, scale, quat, translation):
    qinv = np.concatenate([-quat[:3], quat[3:]])
    return _qt_rotate(qinv, p - translation) / scale


def _intersect_triangle(v0, v1, v2, org, d):
    pos0, pos1, pos2 = v0 - org, v1 - org, v2 - org
    e0, e1, e2 = v2 - v0, v0 - v1, v1 - v2
    normal = np.cross(e1, e0)
    u = np.dot(np.cross(pos0 + pos2, e0), d)
    v = np.dot(np.cross(pos1 + pos0, e1), d)
    w = np.dot(np.cross(pos2 + pos1, e2), d)
    t = np.dot(pos0, normal) * 2.0
    denom = np.dot(normal, d) * 2.0
    return np.array([u, v, w, t]) / denom


def _slab(amin, amax, org, inv, maxt):
    dfar = (amax - org) * inv
    dnear = (amin - org) * inv
    tfar = min(np.maximum(dfar, dnear).min(), maxt)
    tnear = max(np.minimum(dfar, dnear).max(), 0.0)
    return tnear, tfar


def traverse_cpu(bvh, tris, origins, dirs, tr_scale, tr_quat, tr_translation):
    """Closest-hit traversal of each ray (sequential stack walk). Returns
    (prim i64[R], t f64[R], u f64[R], v f64[R]); a miss has prim -1 and t
    FLT_MAX."""
    packed = _as_np(bvh.packed_t)
    node_min = packed[0:3].T
    node_max = -packed[3:6].T
    left = _as_np(bvh.left)
    right = _as_np(bvh.right)
    n_internal = bvh.n_internal
    root = int(_as_np(bvh.root))
    tris = _as_np(tris)
    origins, dirs = _as_np(origins), _as_np(dirs)
    tr_scale, tr_quat, tr_translation = (_as_np(x) for x in (tr_scale, tr_quat, tr_translation))

    n_rays = origins.shape[0]
    out_prim = np.full(n_rays, -1, np.int64)
    out_t = np.full(n_rays, FLT_MAX, np.float64)
    out_u = np.zeros(n_rays)
    out_v = np.zeros(n_rays)

    for ri in range(n_rays):
        org = origins[ri]
        d = dirs[ri]
        t_org = _inv_transform(org, tr_scale, tr_quat, tr_translation)
        t_dir = _inv_transform(d, tr_scale, tr_quat, np.zeros(3))
        inv = 1.0 / t_dir
        best_t = FLT_MAX
        best = (-1, 0.0, 0.0)
        stack = [-1]
        node = root
        while node != -1:
            if node >= n_internal:
                prim = left[node]
                tv = [
                    _transform(tris[prim, k], tr_scale, tr_quat, tr_translation)
                    for k in range(3)
                ]
                u, v, w, t = _intersect_triangle(tv[0], tv[1], tv[2], org, d)
                if u > 0 and v > 0 and w > 0 and 0 < t < best_t:
                    best_t = t
                    best = (prim, u, v)
                node = stack.pop()
            else:
                l, r = left[node], right[node]
                t0n, t0f = _slab(node_min[l], node_max[l], t_org, inv, best_t)
                t1n, t1f = _slab(node_min[r], node_max[r], t_org, inv, best_t)
                hit_l = t0n <= t0f
                hit_r = t1n <= t1f
                if hit_l or hit_r:
                    if hit_l and hit_r:
                        node, pushed = (l, r) if t0n < t1n else (r, l)
                        stack.append(pushed)
                    else:
                        node = l if hit_l else r
                    continue
                node = stack.pop()
        out_prim[ri] = best[0]
        out_t[ri] = best_t
        out_u[ri] = best[1]
        out_v[ri] = best[2]
    return out_prim, out_t, out_u, out_v


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
