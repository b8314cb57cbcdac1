"""AABB refit for boundary-ordered LBVH nodes (node i covers leaves
[first_i, last_i] with first_i <= i < last_i).

Every node covers a contiguous range of Morton-sorted leaves, so its AABB
is a range min over the packed leaf columns (min xyz, -max xyz). Short
ranges (within +-radius of their own boundary) come from the dense
stencil (`refit_dense`, a CUDA kernel on CUDA tensors); the few long
ranges from a two-level min table, built over `aabb.min_key`s (i32 keys
whose order is `fmin`'s, so each level is one integer min). Every path
is exact, so the result is the same at any radius.

On CUDA tensors the refit takes no host read: `refit_tree` is B2 in its
tree mode (`refit_dense.refit_dense_nodes`, which also copies the leaf
columns into the tree's boxes) and one launch of `csrc/refit_long.cu`
(L), which answers every node whose short flag is clear, however many
there are, and counts them on the card to take the CPU branch's answers
where they differ (past the budget, for coordinates at +3e38 or NaN). A
CPU tensor keeps JAX's branch: the long-node count and its `nonzero` are
host reads there.
"""
from __future__ import annotations

import math

import torch

from ..utils import kernels, timer, work
from ..utils.platform import on_cuda
from .aabb import from_min_key, min_key
from .refit_dense import BIG, refit_dense_cols, refit_dense_nodes

I32 = torch.int32
RADIUS = 24
BIG_KEY = int(min_key(torch.tensor([BIG], dtype=torch.float32)))
MAX_KEY = torch.iinfo(torch.int32).max
# L's scratch, mirrors of csrc/refit_long.cu: leaves a block minimum covers
# (kBlock), levels of a superblock's table (kLocal), superblocks at n <=
# 2^22 (kMaxSuper), CTAs of the largest grid (kMaxBlocks)
BLOCK = 16
LOCAL_LEVELS = 10
MAX_SUPER = 256
MAX_BLOCKS = 1024


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


def _check_ranges(n: int, m: int) -> None:
    if m != n - 1:
        raise ValueError("boundary-ordered refit requires one node per boundary")
    if m >= (1 << 22):
        raise ValueError("long-path key packs positions in 22 bits")


def _cap(m: int, radius: int) -> int:
    """The long-node budget: about 2n/L nodes have range length > L in
    Morton order."""
    return min(m, max(64, (4 * m) // (3 * radius)))


def _refit_anchored_packed(packed_t, first, last, radius: int):
    n = packed_t.shape[1]
    m = first.shape[0]
    _check_ranges(n, m)
    if on_cuda(packed_t):
        return refit_tree(packed_t, first, last, radius)[:, :m]
    cap = _cap(m, radius)
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


def refit_tree(packed_t, first, last, radius: int = RADIUS):
    """The tree's boxes f32[6, 2n - 1]: every internal node's union (as
    `refit_anchored_packed` gives it, bit for bit), then the n leaf columns
    of packed_t. On CUDA tensors two launches (B2 in its tree mode, then L)
    and no host read; on the CPU the plain versions of both."""
    n = packed_t.shape[1]
    _check_ranges(n, first.shape[0])
    nodes, short, t4 = refit_dense_nodes(packed_t.contiguous(), first.contiguous(),
                                         last.contiguous(), radius)
    return refit_long(nodes, short, t4, first, last, radius)


def refit_long(nodes, short, t4, first, last, radius: int):
    """L: B2's tree-mode outputs in (t4 f32[n, 6]), `nodes` overwritten in
    place at every internal node whose short flag is clear (and, past the
    budget, at the short ones B2 left at +3e38 or NaN) and returned;
    dispatch by device."""
    if not on_cuda(nodes):
        return refit_long_reference(nodes, short, t4, first, last, radius)
    n = t4.shape[0]
    kernels.require(nodes, "nodes", torch.float32, (6, 2 * n - 1))
    kernels.require(short, "short", torch.bool, (n,))
    kernels.require(t4, "t4", torch.float32, (n, 6))
    kernels.require(first, "first", torch.int32, (n - 1,))
    kernels.require(last, "last", torch.int32, (n - 1,))
    nb = -(-n // BLOCK)
    scratch = torch.empty(6 * (LOCAL_LEVELS * nb + MAX_SUPER) + MAX_BLOCKS + n - 1,
                          dtype=torch.int32, device=nodes.device)
    kernels.launch("refit_long", "tbvh_refit_long", t4, short, first, last, n, radius, scratch,
                   nodes, like=nodes, count=lambda: work.refit_long(short, nb),
                   symbols="refit_long_kernel")
    return nodes


def long_unions(t4, f, l, fill):
    """The two-level query of long ranges [f, l] (each more than 15
    leaves): the min_key-min of the end windows t4[:, f] and
    t4[:, max(l - 15, 0)] and of the whole 16-leaf blocks between them, from
    a doubling table over the block minima t4[:, ::16]; `fill` (a key, or
    None for none) stands in for the blocks where the range holds none.
    Returns f32[6, len(f)]."""
    keys = min_key(t4)
    u = torch.minimum(keys[:, f], keys[:, torch.clamp(l - (BLOCK - 1), min=0)])
    bf = (f + BLOCK - 1) // BLOCK
    bl = (l + 1) // BLOCK - 1
    has = bl >= bf
    k = _floor_log2(torch.clamp(bl - bf + 1, min=1))
    mid = torch.full_like(u, MAX_KEY if fill is None else fill)
    level = keys[:, ::BLOCK]  # level k at b: the min of blocks [b, b + 2^k)
    for lv in range(int(k[has].max()) + 1 if bool(has.any()) else 0):
        if lv:
            h = 1 << (lv - 1)
            level = torch.minimum(level[:, :-h], level[:, h:])
        at = torch.nonzero(has & (k == lv)).squeeze(1)
        mid[:, at] = torch.minimum(level[:, bf[at]], level[:, bl[at] - (1 << lv) + 1])
    return from_min_key(torch.minimum(u, mid))


def refit_long_reference(nodes, short, t4, first, last, radius: int):
    """Plain version of L (any device; host reads; t4 f32[n, 6]): the long
    nodes' two-level query with no budget, and past the budget (where the
    CPU branch takes `_refit_full_table`) no fill, and the short nodes that
    the stencil's +3e38 start value or a NaN touched redone from the leaf
    columns nodes[:, m:]."""
    m = first.shape[0]
    long = ~short[:m]
    exact = _cap(m, radius) < m and int(long.sum()) > _cap(m, radius)
    at = torch.nonzero(long).squeeze(1)
    nodes[:, at] = long_unions(t4.T, first[at], last[at], None if exact else BIG_KEY)
    if exact:
        cur = nodes[:, :m]
        at = torch.nonzero(~long & ((cur != cur) | (cur == BIG)).any(dim=0)).squeeze(1)
        nodes[:, at] = _refit_full_table(nodes[:, m:], first[at], last[at])
    return nodes
