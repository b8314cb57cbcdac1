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


def check_bvh4_isomorphic(fast, oracle) -> bool:
    """The fast collapse's sparse numbering (wide node x at its bvh2 id)
    equals the BFS numbering of `cpu_reference.collapse_cpu` (`oracle`)
    under the oracle's `b2_node` map: counts, children, parents, the used
    slots' AABBs bit for bit, and the wide leaves."""
    b2 = oracle["b2_node"]
    k = oracle["n_nodes"]
    used = b2[:k]
    remap = lambda ids: np.where(ids >= 0, b2[np.clip(ids, 0, len(b2) - 1)], -1)
    o_child = oracle["child"][:k]
    want_child = np.where(o_child < fast.n_internal_cap, remap(o_child), o_child)
    slot_used = np.arange(4)[None, :] < oracle["child_count"][:k][:, None]
    count = _as_np(fast.child_count)
    return bool(
        int(_as_np(fast.n_nodes)) == k and int((count > 0).sum()) == k
        and int(_as_np(fast.root)) == b2[0]
        and np.array_equal(count[used], oracle["child_count"][:k])
        and np.array_equal(_as_np(fast.child)[used], want_child)
        and np.array_equal(_as_np(fast.parent)[used], remap(oracle["parent"][:k]))
        and all(_as_np(getattr(fast, f))[used][slot_used].tobytes()
                == oracle[f][:k][slot_used].tobytes() for f in ("child_min", "child_max"))
        and np.array_equal(_as_np(fast.leaf_prim), oracle["leaf_prim"])
        and np.array_equal(_as_np(fast.leaf_parent), remap(oracle["leaf_parent"]))
    )


def check_bvh4_correctness(bvh4, n_prims: int) -> bool:
    """The 4-wide tree visits every primitive exactly once."""
    child = _as_np(bvh4.child)
    leaf_prim = _as_np(bvh4.leaf_prim)
    cap = bvh4.n_internal_cap
    prims = []
    stack = [int(_as_np(bvh4.root))]
    while stack:
        idx = stack.pop()
        if idx >= cap:
            prims.append(leaf_prim[idx - cap])
        else:
            for c in child[idx]:
                if c >= 0:
                    stack.append(int(c))
    prims = np.array(prims)
    uniq = np.unique(prims)
    return bool(len(prims) == n_prims and len(uniq) == n_prims)


def reference_radix_tree_ranges(codes) -> list[tuple[int, int]]:
    """Golden model: the sorted leaf ranges of the radix tree over the
    sorted (code, index) keys, built by direct recursion (the split of a
    range is its first least common prefix). Both LBVH topologies must
    give exactly this set."""
    codes = _as_np(codes)
    n = len(codes)
    keys = [((int(codes[i]) & 0xFFFFFFFF) << 32) | i for i in range(n)]

    def delta(a, b):
        return 64 - (keys[a] ^ keys[b]).bit_length()

    ranges = []

    def rec(lo, hi):
        if lo == hi:
            return
        best, arg = None, lo
        for j in range(lo, hi):
            d = delta(j, j + 1)
            if best is None or d < best:
                best, arg = d, j
        ranges.append((lo, hi))
        rec(lo, arg)
        rec(arg + 1, hi)

    rec(0, n - 1)
    return sorted(ranges)
