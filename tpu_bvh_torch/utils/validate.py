"""Structural invariant checkers on a built tree (numpy oracles)."""
from __future__ import annotations

import numpy as np
import torch


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_root_aabb(bvh) -> bool:
    """Root AABB equals the reduction of all leaf AABBs."""
    packed = _as_np(bvh.packed_t)
    n_internal = bvh.n_internal
    root = int(_as_np(bvh.root))
    leaves = packed[:, n_internal:]
    return bool(np.array_equal(leaves.min(axis=1), packed[:, root]))


def collect_leaf_prims(bvh) -> np.ndarray:
    """DFS from the root collecting leaf primitive ids."""
    left = _as_np(bvh.left)
    right = _as_np(bvh.right)
    n_internal = bvh.n_internal
    prims = []
    stack = [int(_as_np(bvh.root))]
    while stack:
        idx = stack.pop()
        if idx >= n_internal:
            prims.append(left[idx])
        else:
            stack.append(int(left[idx]))
            stack.append(int(right[idx]))
    return np.array(prims)


def check_bvh2_correctness(bvh, n_prims: int | None = None) -> bool:
    """Every primitive appears exactly once under the root."""
    prims = collect_leaf_prims(bvh)
    n = bvh.n_leaves
    uniq = np.unique(prims)
    ok = len(prims) == n and len(uniq) == n
    if n_prims is not None:
        # with one leaf per triangle the leaf prims are a permutation of [0, n)
        ok = ok and uniq.min() == 0 and uniq.max() == n_prims - 1
    return bool(ok)


def check_parent_child_consistency(bvh) -> bool:
    """Each internal node's AABB is exactly the union of its children's."""
    packed = _as_np(bvh.packed_t)
    m = bvh.n_internal
    left = _as_np(bvh.left)[:m]
    right = _as_np(bvh.right)[:m]
    want = np.minimum(packed[:, left], packed[:, right])
    return bool(np.array_equal(want, packed[:, :m]))
