"""LBVH radix-tree topology in the single-pass (Apetrei) layout, and its
relabelling into the two-pass (Karras) layout.

Internal node i sits at Morton boundary i (between sorted leaves i and
i+1) and covers leaves [psv(i) + 1, nsv(i)] of the adjacent-delta array;
its children are the delta argmins of its two half-ranges. The scans come
from `scan32.scan_core` (a CUDA kernel on CUDA tensors).

Key tie-break: delta(i, j) = 32 + clz32(i ^ j) when codes are equal, else
clz32(code_i ^ code_j).
"""
from __future__ import annotations

import torch

from . import refit as _refit
from .scan32 import remap_deltas, scan_core

I32 = torch.int32


def _clz32(x):
    """Count of leading zeros of u32 values held in an int64 tensor; exact
    through the float64 exponent (frexp(0) gives exponent 0, so clz 32)."""
    return (32 - torch.frexp(x.to(torch.float64)).exponent).to(I32)


def adjacent_deltas(codes):
    """delta(j, j+1) for j in [0, n-2]. codes: int64 [n] of sorted u32 values."""
    n = codes.shape[0]
    x = codes[:-1] ^ codes[1:]
    j = torch.arange(n - 1, dtype=torch.int64, device=codes.device)
    tie = 32 + _clz32(j ^ (j + 1))
    return torch.where(x == 0, tie, _clz32(x))


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


def apetrei_build_packed_full(codes, leaf_packed_t):
    """`apetrei_build_packed` plus the per-node leaf ranges (first, last)."""
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

    int_packed_t = _refit.refit_anchored_packed(leaf_packed_t, first, last)

    jdx = torch.arange(n, dtype=I32, device=dev)
    none = torch.full((1,), -1, dtype=dlt.dtype, device=dev)
    ldl = torch.cat([none, dlt])  # dlt[j-1]
    ldr = torch.cat([dlt, none])  # dlt[j]
    parent_leaf = torch.where(ldl > ldr, jdx - 1, jdx)

    left_internal = torch.where(lc >= 0, lc, m + idx)
    right_internal = torch.where(rc >= 0, rc, m + idx + 1)

    leaf_none = torch.full((n,), -1, dtype=I32, device=dev)
    left = torch.cat([left_internal.to(I32), leaf_none])
    right = torch.cat([right_internal.to(I32), leaf_none])
    parent = torch.cat([parent_internal, parent_leaf.to(I32)])
    root_idx = torch.argmax(is_root.to(I32)).to(I32)
    return left, right, parent, int_packed_t, root_idx, first, last
