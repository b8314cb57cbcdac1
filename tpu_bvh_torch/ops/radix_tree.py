"""LBVH radix-tree topology in the single-pass (Apetrei) layout, and its
relabelling into the two-pass (Karras) layout.

Internal node i sits at Morton boundary i (between sorted leaves i and
i+1) and covers leaves [psv(i) + 1, nsv(i)] of the adjacent-delta array;
its children are the delta argmins of its two half-ranges. The builders'
scans come from `scan32.scan_core` (B1, a CUDA kernel on CUDA tensors).

`apetrei_tree` is the single-pass build's tail, from the sorted codes and
leaf columns to the finished tree's arrays. On CUDA tensors it is three
launches and no host read: B1's links form (`scan32.topology_links`: the
codes in, first, last, parent, left, right and the root out), then
`refit.refit_tree` (B2 writing the tree's boxes in place, L the long
nodes); `last_build["launches"]` counts them. On the CPU it is
`apetrei_build_packed_full` (the scans, JAX's refit) and the join of the
internal and leaf columns.

The gather-free topologies `apetrei_topology_fast` and
`karras_topology_fast` take the same tree from the threshold scans of
`threshold_core` (B12/B13 and B14 on the card) and emit child links by
inverting a permutation; `apetrei_topology` and `karras_topology` are the
search-based oracles (sparse-table descent; Karras's doubling and binary
searches), plain PyTorch on any device.

Key tie-break: delta(i, j) = 32 + clz32(i ^ j) when codes are equal, else
clz32(code_i ^ code_j); -1 where j is out of range.
"""
from __future__ import annotations

import math

import torch

from ..utils import timer
from ..utils.platform import on_cuda
from . import refit as _refit
from . import threshold_core
from .scan32 import remap_deltas, scan_core, topology_links

I32 = torch.int32
last_build = {"launches": 0}  # the last `apetrei_tree`'s hand-written launches


def _clz32(x):
    """Count of leading zeros of u32 values held in an int64 tensor; exact
    through the float64 exponent (frexp(0) gives exponent 0, so clz 32)."""
    return (32 - torch.frexp(x.to(torch.float64)).exponent).to(I32)


def adjacent_deltas(codes):
    """delta(j, j+1) for j in [0, n-2] along the last axis. codes: int64
    [..., n] of sorted u32 values."""
    n = codes.shape[-1]
    x = codes[..., :-1] ^ codes[..., 1:]
    j = torch.arange(n - 1, dtype=torch.int64, device=codes.device)
    tie = 32 + _clz32(j ^ (j + 1))
    return torch.where(x == 0, tie, _clz32(x))


def _boundary_parents(dlt):
    """Leaf j's side and parent boundary: right child of boundary j - 1
    where dlt[j-1] > dlt[j] (out of range = -1), else left child of j."""
    n = dlt.shape[0] + 1
    none = torch.full((1,), -1, dtype=dlt.dtype, device=dlt.device)
    leaf_is_right = torch.cat([none, dlt]) > torch.cat([dlt, none])
    jdx = torch.arange(n, dtype=I32, device=dlt.device)
    return leaf_is_right, torch.where(leaf_is_right, jdx - 1, jdx)


def _topology_scans(codes):
    """(dlt, first, last, psv_val, nsv_val, psv, lc, rc) for sorted codes;
    dlt on the [0, 52] scale."""
    n = codes.shape[0]
    if n > (1 << 22):
        raise ValueError("pos packing requires n <= 2^22")
    dlt_raw = adjacent_deltas(codes)
    dlt = remap_deltas(dlt_raw)
    psv, psv_val, lc, nsv, nsv_val, rc = scan_core(dlt_raw)
    return dlt, psv + 1, nsv, psv_val, nsv_val, psv, lc, rc


def karras_build_packed(codes, leaf_packed_t):
    """Two-pass (Karras-layout) build: the same scans and refit, then one
    relabel sort. Boundary node i splits its range at boundary i, and
    Karras numbers children by split position, so its left child is Karras
    node i (lc >= 0) or leaf i, its right child Karras node i + 1 (rc >= 0)
    or leaf i + 1. Node i moves to Karras slot pi = (right child ? first :
    last), the root to 0; pi is unique, so any sort on it gives the same
    order. Returns (left, right, int_packed_t f32[6, m]); root is node 0."""
    with timer.span("bvh.topology"):
        return _karras_build_packed(codes, leaf_packed_t)


def _karras_build_packed(codes, leaf_packed_t):
    n = codes.shape[0]
    m = n - 1
    dev = codes.device
    _dlt, first, last, psv_val, nsv_val, _psv, lc, rc = _topology_scans(codes)
    idx = torch.arange(m, dtype=I32, device=dev)
    is_root = (first == 0) & (last == n - 1)
    pi = torch.where(is_root, 0, torch.where(psv_val > nsv_val, first, last))
    left_k = torch.where(lc >= 0, idx, m + idx)
    right_k = torch.where(rc >= 0, idx + 1, m + idx + 1)
    int_b = _refit.refit_anchored_packed(leaf_packed_t, first, last)
    order = torch.sort(pi).indices
    leaf_none = torch.full((n,), -1, dtype=I32, device=dev)
    left = torch.cat([left_k[order].to(I32), leaf_none])
    right = torch.cat([right_k[order].to(I32), leaf_none])
    return left, right, int_b[:, order]


def karras_build(codes, leaf_min, leaf_max):
    """Row-major wrapper around `karras_build_packed`.
    Returns (left, right, int_min, int_max); root is node 0."""
    leaf_packed_t = torch.cat([leaf_min, -leaf_max], dim=1).T
    left, right, int_packed_t = karras_build_packed(codes, leaf_packed_t)
    out = int_packed_t.T
    return left, right, out[:, :3], -out[:, 3:]


def apetrei_build_packed(codes, leaf_packed_t):
    """Single-pass build: topology scans + anchored refit.
    leaf_packed_t: f32[6, n] (rows = leaf min xyz, -max xyz), sorted order.
    Returns (left, right, parent, int_packed_t f32[6, m], root)."""
    return apetrei_build_packed_full(codes, leaf_packed_t)[:5]


def apetrei_build(codes, leaf_min, leaf_max):
    """Row form of `apetrei_build_packed`: leaf_min/max f32[n, 3] sorted.
    Returns (left, right, parent, int_min f32[n-1, 3], int_max, root)."""
    leaf_packed_t = torch.cat([leaf_min, -leaf_max], dim=1).T.contiguous()
    left, right, parent, int_packed_t, root = apetrei_build_packed(codes, leaf_packed_t)
    out = int_packed_t.T
    return left, right, parent, out[:, :3], -out[:, 3:], root


def apetrei_build_packed_full(codes, leaf_packed_t):
    """`apetrei_build_packed` plus the per-node leaf ranges (first, last)."""
    with timer.span("bvh.topology"):
        left, right, parent, root, first, last = _apetrei_links(codes)
        int_packed_t = _refit.refit_anchored_packed(leaf_packed_t, first, last)
        return left, right, parent, int_packed_t, root, first, last


def _apetrei_links(codes):
    """(left, right, parent, root, first, last) of the single-pass tree from
    `scan_core`'s rows; a leaf's left and right are -1."""
    n = codes.shape[0]
    m = n - 1
    dev = codes.device
    dlt, first, last, psv_val, nsv_val, psv, lc, rc = _topology_scans(codes)
    nsv = last
    idx = torch.arange(m, dtype=I32, device=dev)
    is_root = (first == 0) & (last == n - 1)
    internal_is_right = psv_val > nsv_val
    parent_internal = torch.where(
        is_root, -1, torch.where(internal_is_right, psv, nsv)
    ).to(I32)

    _, parent_leaf = _boundary_parents(dlt)

    left_internal = torch.where(lc >= 0, lc, m + idx)
    right_internal = torch.where(rc >= 0, rc, m + idx + 1)

    leaf_none = torch.full((n,), -1, dtype=I32, device=dev)
    left = torch.cat([left_internal.to(I32), leaf_none])
    right = torch.cat([right_internal.to(I32), leaf_none])
    parent = torch.cat([parent_internal, parent_leaf])
    root_idx = torch.argmax(is_root.to(I32)).to(I32)
    return left, right, parent, root_idx, first, last


def apetrei_links_reference(codes, leaf_prim):
    """Plain version of B1's links form (`scan32.topology_links`): (first,
    last, parent, left, right, root) with a leaf's left its primitive."""
    left, right, parent, root, first, last = _apetrei_links(codes)
    left[codes.shape[0] - 1:] = leaf_prim
    return first, last, parent, left, right, root


def apetrei_tree(codes, leaf_packed_t, leaf_prim):
    """The single-pass tree from sorted codes (int64 [n] of u32 values),
    leaf columns f32[6, n] and the leaves' primitives i32[n]: (packed_t
    f32[6, 2n-1], internal columns then leaf columns; left i32[2n-1], a
    leaf's its primitive; right, a leaf's -1; parent; root; first and last
    i32[n-1]). Spans `bvh.topology` (with `bvh.refit` inside) and, on the
    CPU, `bvh.finalize` for the join."""
    with timer.tally(last_build):
        if on_cuda(codes):
            with timer.span("bvh.topology"):
                first, last, parent, left, right, root = topology_links(codes, leaf_prim)
                with timer.span("bvh.refit"):
                    packed_t = _refit.refit_tree(leaf_packed_t, first, last)
            return packed_t, left, right, parent, root, first, last
        left, right, parent, int_packed_t, root, first, last = apetrei_build_packed_full(
            codes, leaf_packed_t)
        with timer.span("bvh.finalize"):
            packed_t = torch.cat([int_packed_t, leaf_packed_t], dim=1)
            left[codes.shape[0] - 1:] = leaf_prim
        return packed_t, left, right, parent, root, first, last


# ---------------------------------------------------------------- oracles

def delta_at(codes, i, j):
    """Common-prefix length between sorted keys i and j with index
    augmentation on code ties; -1 where j is out of range. i, j: i32."""
    n = codes.shape[0]
    valid = (j >= 0) & (j < n)
    jc = torch.clamp(j, 0, n - 1).to(torch.int64)
    i64 = i.to(torch.int64)
    x = codes[i64] ^ codes[jc]
    d = torch.where(x == 0, 32 + _clz32(i64 ^ jc), _clz32(x))
    return torch.where(valid, d, -1)


def _search_iters(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2)))) + 2


def karras_topology(codes):
    """Vectorised Karras build (the oracle of `karras_topology_fast`).
    codes: int64 [n] of sorted u32 values. Returns (left i32[2n-1], right
    i32[2n-1], parent i32[2n-1], first i32[n-1], last i32[n-1]); internal
    node i's children are node / leaf `split` and `split + 1`, leaves are
    biased by n - 1, the root is node 0."""
    n = codes.shape[0]
    m = n - 1
    dev = codes.device
    iters = _search_iters(n)
    idx = torch.arange(m, dtype=I32, device=dev)

    l_delta = delta_at(codes, idx, idx - 1)
    r_delta = delta_at(codes, idx, idx + 1)
    d = torch.where(r_delta > l_delta, 1, -1).to(I32)
    delta_min = torch.minimum(l_delta, r_delta)

    lmax = torch.full_like(idx, 2)  # doubling upper bound of the range length
    growing = torch.ones_like(idx, dtype=torch.bool)
    for _ in range(iters):
        growing = growing & (delta_at(codes, idx, idx + d * lmax) > delta_min)
        lmax = torch.where(growing, lmax << 1, lmax)

    l = torch.zeros_like(idx)  # binary search for the far end
    for k in range(1, iters + 1):
        t = lmax >> k
        probe = delta_at(codes, idx, idx + (l + t) * d)
        l = torch.where((t > 0) & (probe > delta_min), l + t, l)

    jdx = idx + l * d
    first = torch.minimum(idx, jdx)
    last = torch.maximum(idx, jdx)

    # findSplit: a do-while binary search (the body runs once more after
    # the stride reaches 1)
    delta_node = delta_at(codes, first, last)
    split = first
    stride = last - first
    active = torch.ones_like(idx, dtype=torch.bool)
    for _ in range(iters):
        stride = (stride + 1) >> 1
        middle = split + stride
        take = active & (middle < last) & (delta_at(codes, first, middle) > delta_node)
        split = torch.where(take, middle, split)
        active = active & (stride > 1)

    left = torch.where(split == first, split + m, split)
    right = torch.where(split + 1 == last, split + 1 + m, split + 1)
    none = torch.full((n,), -1, dtype=I32, device=dev)
    parent = torch.full((2 * n - 1,), -1, dtype=I32, device=dev)
    parent[left.to(torch.int64)] = idx
    parent[right.to(torch.int64)] = idx
    return torch.cat([left, none]), torch.cat([right, none]), parent, first, last


def _sparse_min_tables(vals, levels: int):
    """T_k[i] = min(vals[i : i + 2^k]) with clamped windows."""
    n = vals.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=vals.device)
    tabs = [vals]
    cur = vals
    for k in range(1, levels + 1):
        cur = torch.minimum(cur, cur[torch.clamp(pos + (1 << (k - 1)), max=n - 1)])
        tabs.append(cur)
    return tabs


def _next_smaller(tabs, vals):
    """Least j > i with vals[j] < vals[i] by sparse-table descent; n where
    none exists."""
    n = vals.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=vals.device) + 1
    for k in range(len(tabs) - 1, -1, -1):
        width = 1 << k
        win_min = tabs[k][torch.clamp(pos, max=n - 1)]
        skip = (pos + width <= n) & (win_min >= vals)  # [pos, pos + width) all >= vals[i]
        pos = torch.where(skip, pos + width, pos)
    return pos.to(I32)


def nsv_psv(vals):
    """Previous / next strictly-smaller-value indices of each position:
    (psv i32[n] in [-1, n-1], nsv i32[n] in [1, n])."""
    n = vals.shape[0]
    levels = max(1, math.ceil(math.log2(max(n, 2))))
    nsv = _next_smaller(_sparse_min_tables(vals, levels), vals)
    rev = torch.flip(vals, [0])
    nsv_r = _next_smaller(_sparse_min_tables(rev, levels), rev)
    return (n - 1) - torch.flip(nsv_r, [0]), nsv


def apetrei_topology(codes):
    """Single-pass layout with every parent computed directly (the oracle
    of `apetrei_topology_fast`): node i covers leaves [psv(i) + 1, nsv(i)]
    of the adjacent-delta array, its parent is the external boundary with
    the larger delta. Returns (left, right, parent, first, last, root_idx)."""
    n = codes.shape[0]
    m = n - 1
    dev = codes.device
    dlt = adjacent_deltas(codes)
    psv, nsv = nsv_psv(dlt)
    first = psv + 1
    last = nsv
    idx = torch.arange(m, dtype=I32, device=dev)
    left_b = first - 1
    right_b = last
    dl = torch.where(left_b >= 0, dlt[torch.clamp(left_b, min=0).to(torch.int64)], -1)
    dr = torch.where(right_b <= m - 1, dlt[torch.clamp(right_b, max=m - 1).to(torch.int64)], -1)
    is_right = dl > dr  # attached at its left external boundary
    is_root = (first == 0) & (last == n - 1)
    parent_internal = torch.where(is_root, -1, torch.where(is_right, left_b, right_b)).to(I32)
    leaf_is_right, parent_leaf = _boundary_parents(dlt)
    parent = torch.cat([parent_internal, parent_leaf])

    # each parent has one left and one right child: plain scatters, the
    # root routed nowhere
    left = torch.full((2 * n - 1,), -1, dtype=I32, device=dev)
    right = torch.full((2 * n - 1,), -1, dtype=I32, device=dev)
    jdx = torch.arange(n, dtype=I32, device=dev)
    for tgt, side, src, live in ((parent_internal, is_right, idx, ~is_root),
                                 (parent_leaf, leaf_is_right, m + jdx, None)):
        on_left = ~side if live is None else ~side & live
        on_right = side if live is None else side & live
        left[tgt[on_left].to(torch.int64)] = src[on_left]
        right[tgt[on_right].to(torch.int64)] = src[on_right]
    root_idx = torch.argmax(is_root.to(I32)).to(I32)
    return left, right, parent, first.to(I32), last.to(I32), root_idx


# ---------------------------------------------------------------- fast

def _threshold_core(codes):
    """Per boundary (dlt, first, last, psv_val, nsv_val, psv) from the
    packed PSV/NSV threshold scan (B12/B13); dlt on the [0, 52] scale."""
    n = codes.shape[0]
    m = n - 1
    if n > (1 << 22):
        raise ValueError("pos packing requires n <= 2^22")
    dlt = remap_deltas(adjacent_deltas(codes))
    psv_packed, nsv_packed = threshold_core.psv_nsv_packed_auto(dlt)
    has_nsv = nsv_packed != threshold_core.BIG
    has_psv = psv_packed >= 0
    nsv = torch.where(has_nsv, nsv_packed >> 6, m)
    nsv_val = torch.where(has_nsv, nsv_packed & 63, -1)
    psv = torch.where(has_psv, psv_packed >> 6, -1)
    psv_val = torch.where(has_psv, psv_packed & 63, -1)
    return dlt, psv + 1, nsv, psv_val, nsv_val, psv


def _invert(keys, vals):
    """vals ordered by keys, where keys are a permutation of [0, len):
    what a sort by key gives, as one scatter."""
    out = torch.empty_like(vals)
    out[keys.to(torch.int64)] = vals
    return out


def apetrei_topology_fast(codes):
    """Gather-free single-pass topology from the threshold scans. Child
    links come from sorting every non-root node by (side, parent): each
    parent has exactly one left and one right child, so the keys
    side * m + parent, with 2m for the root, are a permutation of
    [0, 2m], and the sort is its inverse. Same contract as
    `apetrei_topology`."""
    n = codes.shape[0]
    m = n - 1
    dev = codes.device
    dlt, first, last, psv_val, nsv_val, psv = _threshold_core(codes)
    idx = torch.arange(m, dtype=I32, device=dev)
    is_root = (first == 0) & (last == n - 1)
    internal_is_right = psv_val > nsv_val
    parent_internal = torch.where(is_root, -1, torch.where(internal_is_right, psv, last)).to(I32)
    leaf_is_right, parent_leaf = _boundary_parents(dlt)

    key_internal = torch.where(is_root, 2 * m, internal_is_right.to(I32) * m + parent_internal)
    key_leaf = leaf_is_right.to(I32) * m + parent_leaf
    jdx = torch.arange(n, dtype=I32, device=dev)
    ordered = _invert(torch.cat([key_internal, key_leaf]), torch.cat([idx, m + jdx]))
    none = torch.full((n,), -1, dtype=I32, device=dev)
    left = torch.cat([ordered[:m], none])
    right = torch.cat([ordered[m:2 * m], none])
    parent = torch.cat([parent_internal, parent_leaf])
    root_idx = torch.argmax(is_root.to(I32)).to(I32)
    return left, right, parent, first.to(I32), last.to(I32), root_idx


def _karras_parent_kp(codes, dlt, first, last, psv, nsv, psv_val, nsv_val, is_root):
    """Karras index of every node's parent without a 2m-row gather: pi
    (the single-pass -> Karras relabel, pi = right child ? first : last,
    root 0) evaluated at each node's psv / nsv rides the payload scan
    (B14). Returns (kp_internal i32[m], kp_leaf i32[n], internal_is_right,
    leaf_is_right, pi)."""
    internal_is_right = psv_val > nsv_val
    pi = torch.where(is_root, 0, torch.where(internal_is_right, first, last)).to(I32)
    _, pi_at_psv, _, pi_at_nsv = threshold_core.psv_nsv_payload_auto(dlt, pi)
    kp_internal = torch.where(internal_is_right, pi_at_psv, pi_at_nsv)
    leaf_is_right, _ = _boundary_parents(dlt)
    # leaf j's parent is boundary j - 1 (right child) or j (left child):
    # both dense shifts of pi
    pi_at_j = torch.cat([pi, pi[-1:]])  # pi[min(j, m - 1)]
    pi_at_jm1 = torch.cat([pi[:1], pi])  # pi[max(j - 1, 0)]
    kp_leaf = torch.where(leaf_is_right, pi_at_jm1, pi_at_j)
    return kp_internal, kp_leaf, internal_is_right, leaf_is_right, pi


def karras_topology_fast(codes):
    """Karras node layout from the threshold scans: node [l, r] sits at its
    own `last` when it is a left child and at its `first` when it is a
    right child, the root at 0 (pi, a bijection of [0, m)); child links
    by the (side, parent) permutation as in `apetrei_topology_fast`, with
    parents in Karras numbering. Same contract as `karras_topology`."""
    n = codes.shape[0]
    m = n - 1
    dev = codes.device
    dlt, first, last, psv_val, nsv_val, psv = _threshold_core(codes)
    is_root = (first == 0) & (last == n - 1)
    kp_internal, kp_leaf, internal_is_right, leaf_is_right, pi = _karras_parent_kp(
        codes, dlt, first, last, psv, last, psv_val, nsv_val, is_root)

    key_internal = torch.where(is_root, 2 * m, internal_is_right.to(I32) * m + kp_internal)
    key_leaf = leaf_is_right.to(I32) * m + kp_leaf
    jdx = torch.arange(n, dtype=I32, device=dev)
    ordered = _invert(torch.cat([key_internal, key_leaf]), torch.cat([pi, m + jdx]))
    # (first, last, parent) into Karras order: pi is a permutation of [0, m)
    parent_k = _invert(pi, torch.where(is_root, -1, kp_internal).to(I32))
    none = torch.full((n,), -1, dtype=I32, device=dev)
    left = torch.cat([ordered[:m], none])
    right = torch.cat([ordered[m:2 * m], none])
    parent = torch.cat([parent_k, kp_leaf])
    return left, right, parent, _invert(pi, first.to(I32)), _invert(pi, last.to(I32))
