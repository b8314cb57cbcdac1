"""Binned SAH builder, the CPU-quality reference builder: the port of
`tpu_bvh.models.binned_sah`.

A host (numpy) builder, as in the JAX package and the reference
(`BinnedSahBvh.cpp:13-210`): top down, 32 centroid bins on the node's
longest axis, split cost `0.125 + (nL*A(L) + nR*A(R)) / A(node)`, with a
centroid-midpoint and then a median fallback when the bins do not
separate the prims. Nodes are (firstChild, firstChild + 1) pairs, with
prim_count marking leaves. The loop is Python per node, so its time
grows with the scene (the app's `--builder binned_sah`); `to_bvh2` hands
the tree to the engine's traversal, collapse and cost paths on a device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..types import Bvh2

N_BUCKETS = 32
FLT_MAX = np.float32(3.402823466e38)


class SahBvh(NamedTuple):
    node_min: np.ndarray  # f32[K, 3]
    node_max: np.ndarray  # f32[K, 3]
    first_child: np.ndarray  # i64[K]; leaf: primitive index
    prim_count: np.ndarray  # i64[K]; 0 = internal, 1 = leaf
    n_nodes: int

    @property
    def root(self) -> int:
        return 0


def _area(mn, mx):
    e = mx - mn
    return 2.0 * (e[..., 0] * e[..., 1] + e[..., 0] * e[..., 2] + e[..., 1] * e[..., 2])


def build_binned_sah(tris: np.ndarray) -> SahBvh:
    """Top-down binned SAH build of a triangle soup f32[N, 3, 3]."""
    tris = np.asarray(tris, np.float32)
    n = tris.shape[0]
    prim_min = tris.min(axis=1)
    prim_max = tris.max(axis=1)
    centers = (prim_min + prim_max) * 0.5

    order = np.arange(n)  # the prim permutation, partitioned in place
    cap = 2 * n
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    first_child = np.zeros(cap, np.int64)
    prim_count = np.zeros(cap, np.int64)

    next_node = 1
    stack = [(0, 0, n)]  # (node, start, end) over `order`
    while stack:
        node, start, end = stack.pop()
        ids = order[start:end]
        mn = prim_min[ids].min(axis=0)
        mx = prim_max[ids].max(axis=0)
        node_min[node] = mn
        node_max[node] = mx

        if end - start == 1:
            first_child[node] = ids[0]
            prim_count[node] = 1
            continue

        ext = mx - mn
        dim = 0 if (ext[0] > ext[1] and ext[0] > ext[2]) else (1 if ext[1] > ext[2] else 2)
        c = centers[ids, dim]

        if end - start <= 2:
            split = (start + end) // 2
            order[start:end] = ids[np.argsort(c, kind="stable")]
        else:
            span = mx[dim] - mn[dim]
            t = (c - mn[dim]) / span if span > 0 else np.zeros_like(c)
            b = np.minimum((N_BUCKETS * t).astype(np.int64), N_BUCKETS - 1)

            counts = np.bincount(b, minlength=N_BUCKETS)
            bmin = np.full((N_BUCKETS, 3), FLT_MAX, np.float32)
            bmax = np.full((N_BUCKETS, 3), -FLT_MAX, np.float32)
            np.minimum.at(bmin, b, prim_min[ids])
            np.maximum.at(bmax, b, prim_max[ids])

            lmin = np.minimum.accumulate(bmin, axis=0)
            lmax = np.maximum.accumulate(bmax, axis=0)
            rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
            lcount = np.cumsum(counts)
            rcount = np.cumsum(counts[::-1])[::-1]

            cost = np.full(N_BUCKETS, FLT_MAX, np.float64)
            node_area = _area(mn, mx)
            for k in range(N_BUCKETS - 1):
                nl, nr = lcount[k], rcount[k + 1]
                la = _area(lmin[k], lmax[k]) if nl else 0.0
                ra = _area(rmin[k + 1], rmax[k + 1]) if nr else 0.0
                total = (nl * la + nr * ra) / node_area if node_area > 0 else 0.0
                if total > 0:
                    cost[k] = 0.125 + total
            split_bucket = int(np.argmin(cost[: N_BUCKETS - 1]))

            go_left = b <= split_bucket
            split = start + int(go_left.sum())
            if split <= start or split >= end:  # fallback 1: the centroid midpoint
                go_left = c < (mn[dim] + mx[dim]) * 0.5
                split = start + int(go_left.sum())
            if split <= start or split >= end:  # fallback 2: the median
                order[start:end] = ids[np.argsort(c, kind="stable")]
                split = (start + end) // 2
            else:
                order[start:end] = ids[np.argsort(~go_left, kind="stable")]  # left first

        left = next_node
        next_node += 2
        first_child[node] = left
        prim_count[node] = 0
        stack.append((left, start, split))
        stack.append((left + 1, split, end))

    return SahBvh(node_min=node_min[:next_node], node_max=node_max[:next_node],
                  first_child=first_child[:next_node], prim_count=prim_count[:next_node],
                  n_nodes=next_node)


def sah_cost(bvh: SahBvh) -> float:
    """`calculateBinnedSahBvhCost` (`Utility.cpp:398-422`): ci = ct = 1."""
    areas = _area(bvh.node_min, bvh.node_max)
    inv_root = 1.0 / areas[0]
    cost = 1.0
    for i in np.nonzero(bvh.prim_count == 0)[0]:
        first = bvh.first_child[i]
        for child in (first, first + 1):
            cost += 1.0 * areas[child] * inv_root
    return float(cost)


def check_correctness(bvh: SahBvh, n_prims: int) -> bool:
    """`checkSahCorrectness` (`Utility.cpp:132-159`): every prim under the
    root exactly once."""
    prims = []
    stack = [0]
    while stack:
        i = stack.pop()
        if bvh.prim_count[i] != 0:
            prims.append(bvh.first_child[i])
        else:
            stack.append(int(bvh.first_child[i]))
            stack.append(int(bvh.first_child[i]) + 1)
    prims = np.array(prims)
    return len(prims) == n_prims and len(np.unique(prims)) == n_prims


def to_bvh2(bvh: SahBvh, device="cuda") -> Bvh2:
    """The tree in the engine's Bvh2 layout (internal nodes first, then
    leaves), on `device` (the GPU unless the caller names another)."""
    k = bvh.n_nodes
    internal_mask = bvh.prim_count == 0
    n_internal = int(internal_mask.sum())
    new_idx = np.zeros(k, np.int64)
    new_idx[internal_mask] = np.arange(n_internal)
    new_idx[~internal_mask] = n_internal + np.arange(k - n_internal)

    if 2 * (k - n_internal) - 1 != k:
        raise ValueError("a SAH tree must be a full binary tree")
    left = np.full(k, -1, np.int64)
    right = np.full(k, -1, np.int64)
    nmn = np.zeros((k, 3), np.float32)
    nmx = np.zeros((k, 3), np.float32)
    for i in range(k):
        j = new_idx[i]
        nmn[j] = bvh.node_min[i]
        nmx[j] = bvh.node_max[i]
        if internal_mask[i]:
            left[j] = new_idx[bvh.first_child[i]]
            right[j] = new_idx[bvh.first_child[i] + 1]
        else:
            left[j] = bvh.first_child[i]  # prim index
    t = lambda a: torch.from_numpy(a).to(device)
    return Bvh2.from_rows(t(nmn), t(nmx), t(left.astype(np.int32)), t(right.astype(np.int32)),
                          t(np.asarray(new_idx[0], np.int32)))
