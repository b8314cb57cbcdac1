"""AABB refit for boundary-ordered LBVH nodes (node i covers leaves
[first_i, last_i] with first_i <= i < last_i).

Every node covers a contiguous range of Morton-sorted leaves, so its AABB
is a range min over the packed leaf columns (min xyz, -max xyz). Short
ranges (within +-radius of their own boundary) come from the dense
stencil (`refit_dense`, a CUDA kernel on CUDA tensors); the few long
ranges from a two-level min table, built over `aabb.min_key`s (i32 keys
whose order is `fmin`'s, so each level is one integer min). Every path
is exact, so the result is the same at any radius.
"""
from __future__ import annotations

import math

import torch

from ..utils import timer
from .aabb import from_min_key, min_key
from .refit_dense import BIG, refit_dense_cols

I32 = torch.int32
RADIUS = 24
BIG_KEY = int(min_key(torch.tensor([BIG], dtype=torch.float32)))


def _floor_log2(x):
    """floor(log2(x)) for integer tensors x >= 1, exact via the float64 exponent."""
    return (torch.frexp(x.to(torch.float64)).exponent - 1).to(I32)


def _shift_min(cur, s):
    """min(cur[:, i], cur[:, min(i + s, n - 1)]) of i32 keys — one
    clamped-window level."""
    n = cur.shape[1]
    if s >= n:
        return cur
    return torch.minimum(cur, torch.cat([cur[:, s:], cur[:, -1:].expand(-1, s)], dim=1))


def _packed(leaf_min, leaf_max):
    return torch.cat([leaf_min, -leaf_max], dim=1).T.contiguous()


def _rows(out_t):
    out = out_t.T
    return out[:, :3], -out[:, 3:]


def refit_ranges(leaf_min, leaf_max, first, last):
    """AABBs of nodes covering sorted-leaf ranges [first, last] (any
    number of nodes, last > first) from one full min table.
    leaf_min/max: f32[n, 3] in Morton-sorted leaf order; first/last: i32[m].
    Returns (node_min f32[m, 3], node_max f32[m, 3])."""
    return _rows(_refit_full_table(_packed(leaf_min, leaf_max), first, last))


def refit_anchored(leaf_min, leaf_max, first, last, radius: int = 16):
    """Row form of `refit_anchored_packed` (radius below 15 takes
    `refit_ranges`, as JAX's does). Returns (node_min, node_max) f32[n-1, 3]."""
    if radius < 15:
        return refit_ranges(leaf_min, leaf_max, first, last)
    return _rows(refit_anchored_packed(_packed(leaf_min, leaf_max), first, last, radius))


def refit_anchored_packed(packed_t, first, last, radius: int = RADIUS):
    """packed_t: f32[6, n] sorted leaf columns; first/last: i32[n-1].
    Returns packed f32[6, n-1] (min xyz, -max xyz) of every internal node."""
    with timer.span("bvh.refit"):
        return _refit_anchored_packed(packed_t, first, last, radius)


def _refit_anchored_packed(packed_t, first, last, radius: int):
    n = packed_t.shape[1]
    m = first.shape[0]
    if m != n - 1:
        raise ValueError("boundary-ordered refit requires one node per boundary")
    if m >= (1 << 22):
        raise ValueError("long-path key packs positions in 22 bits")
    # long-node budget: about 2n/L nodes have range length > L in Morton order
    cap = min(m, max(64, (4 * m) // (3 * radius)))
    if cap >= m:
        return _refit_anchored_fast(packed_t, first, last, radius)
    i = torch.arange(m, dtype=I32, device=first.device)
    short0 = (i - first < radius) & (last - i <= radius)
    # the reference's lax.cond becomes a Python branch: one host sync
    n_long = m - int(short0.sum())
    timer.count_host_sync()
    if n_long <= cap:
        return _refit_anchored_fast(packed_t, first, last, radius)
    return _refit_full_table(packed_t, first, last)


def _refit_anchored_fast(packed_t, first, last, radius: int):
    """Dense stencil for short nodes + two-level table for long ones."""
    n = packed_t.shape[1]
    m = first.shape[0]
    dev = packed_t.device
    acc, short, t4 = refit_dense_cols(packed_t.contiguous(), first.contiguous(),
                                      last.contiguous(), n, radius)

    # long nodes: a fine level-4 row (T4[i] = min over [i, i + 16)) covers
    # both range ends, a lifting table over block-16 mins the middle
    nb = (n + 15) // 16
    padn = nb * 16
    ptp = packed_t if padn == n else torch.cat(
        [packed_t, torch.full((6, padn - n), BIG, dtype=torch.float32, device=dev)], dim=1
    )
    c0 = min_key(ptp).reshape(6, nb, 16).amin(dim=2)
    levels_c = max(1, math.ceil(math.log2(max(nb, 2))))
    ctabs = [min_key(t4), c0]
    ccur = c0
    for k in range(1, levels_c + 1):
        ccur = _shift_min(ccur, 1 << (k - 1))
        ctabs.append(ccur)
    table_t = torch.cat(ctabs, dim=1)  # [6, n + (levels_c + 1) * nb]

    out = acc[:, :m].clone()
    # the long nodes' positions: one nonzero (a host sync) replaces the
    # reference's payload sort and place-back sort
    long_idx = torch.nonzero(~short[:m]).squeeze(1)
    timer.count_host_sync()
    if long_idx.numel():
        cf = first[long_idx]
        cl = last[long_idx]
        u = torch.minimum(table_t[:, cf], table_t[:, torch.clamp(cl - 15, min=0)])
        bf = (cf + 15) >> 4
        bl = ((cl + 1) >> 4) - 1
        has_mid = bl >= bf  # guaranteed when cl - cf + 1 >= 32
        bfs = torch.clamp(bf, max=nb - 1)
        cnt = torch.clamp(bl - bfs + 1, min=1)
        kc = _floor_log2(cnt)
        b2 = torch.clamp(bl - (1 << kc) + 1, min=0)
        uc = torch.minimum(table_t[:, n + kc * nb + bfs], table_t[:, n + kc * nb + b2])
        out[:, long_idx] = from_min_key(torch.minimum(u, torch.where(has_mid[None], uc, BIG_KEY)))
    return out


def _refit_full_table(packed_t, first, last):
    """Exact full-table path for degenerate scenes whose long-node count
    overflows the budget (caterpillar Morton runs)."""
    n = packed_t.shape[1]
    levels = max(1, math.ceil(math.log2(max(n, 2))))
    cur = min_key(packed_t)
    tabs = [cur]
    for k in range(1, levels + 1):
        cur = _shift_min(cur, 1 << (k - 1))
        tabs.append(cur)
    table_t = torch.cat(tabs, dim=1)  # [6, (levels + 1) * n]
    k = _floor_log2(last - first + 1)
    b = torch.clamp(last - (1 << k) + 1, min=0)
    return from_min_key(torch.minimum(table_t[:, k * n + first], table_t[:, k * n + b]))
