"""Sharded single-scene LBVH build over `torch.distributed` ranks: the port
of `tpu_bvh.parallel.sharded_build`.

One scene's triangles are sharded over the ranks and the whole build runs
SPMD with collectives: the scene extents are an all-reduce, the global
sort a deterministic PSRS sample sort (one exchange, then a +-1 neighbour
balance), the threshold scans combine per-shard carries, and the refit is
a halo'd dense stencil plus long-node queries answered by every shard and
reduced with a `pmin`.

The tree is bit-identical to the single-device `models.lbvh.
build_single_pass` tree:

* the distributed sort orders by the total key (code, original index),
  which is what the single-device sort produces;
* the threshold scans use associative combines (max, segmented min) whose
  cross-shard carry is the same operator, so integer outputs match;
* AABB refit is min/max over `aabb.min_key`s, exact in any grouping and
  signed zeros included (the cross-rank reduction too: the backends give
  no order for a float MIN on +0.0 against -0.0).

JAX's scans are XLA ops (its docstring calls them the "XLA formulation of
ops/pallas/scan32"). Its psv and nsv are `lax.cummax` / `lax.cummin` over
[L, 64] threshold planes, which is B11's function: they run
`ops.plane_scan` (on the card one launch of `csrc/plane_scan.cu` a scan,
on every rank). The segmented lc / rc scans and the rest are torch ops.

Per-shard layout (p shards, L = n/p): rank s owns sorted leaves and
boundaries [sL, (s+1)L); the last shard's final boundary slot is a pad
(global boundary n-1 does not exist; its delta is set below every real
value so reverse scans resolve "no next smaller" to the n-1 sentinel).
Codes are u32 values held in int64, as elsewhere in the port.

Degenerate scenes can exceed the long-node routing capacity; the build
then reports `overflow=True` and the affected AABBs are undefined: rebuild
unsharded.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import aabb as A
from ..ops import morton as M
from ..ops import plane_scan
from ..ops.radix_tree import _clz32
from ..ops.scan32 import remap_deltas
from ..types import Bvh2
from .comm import Mesh

I32 = torch.int32
I64 = torch.int64
V = 64  # threshold lanes (delta alphabet remapped to [0, 52])
_BIG = 2**31 - 1
_FBIG = 3.0e38
_POSB = 22  # bits of a position in the lc/rc packing: n <= 2^22
_FILL_KEY = ((0xFFFFFFFF - (1 << 31)) << 32) + _BIG  # (code 0xFFFFFFFF, gidx 2^31-1): sorts last


def _sort_key(codes, gidx):
    """(code, gidx) as one int64 whose order is the pair's lexicographic
    order (the code biased by -2^31 keeps its unsigned order)."""
    return (codes - (1 << 31)) * (1 << 32) + gidx.to(I64)


def _key_code(key):
    return (key >> 32) + (1 << 31)


def _dslice(x, start, size: int):
    """`lax.dynamic_slice` along the last axis: `size` items from `start`
    (a 0-d tensor), the start clamped so the slice fits."""
    start = torch.clamp(start, 0, x.shape[-1] - size)
    return x[..., start + torch.arange(size, device=x.device)]


def _floor_log2(x):
    """floor(log2(max(x, 1))) of int tensors, exact (float64 exponent)."""
    return (torch.frexp(torch.clamp(x, min=1).to(torch.float64)).exponent - 1).to(I64)


# ---------------------------------------------------------------------------
# distributed sort: deterministic PSRS sample sort (O(1) collective rounds)
# ---------------------------------------------------------------------------
#
# Local sort -> regular-sample splitters -> ONE exchange by splitter bucket
# -> local sort of the bucket -> one +-1 neighbour balance that restores the
# exact [sL, (s+1)L) global rank ownership. Regular sampling bounds the
# splitter-rank drift to |R_b - b*L| <= L, so every bucket fits 2L+2 slots
# and the balance touches only direct neighbours; the bound is checked
# (overflow=True on violation). The items travel as one int64 key (code,
# gidx) and their [6, L] box columns.


def _sample_sort(key, cols, p: int, mesh: Mesh, L: int):
    """key: int64[L] (`_sort_key`), cols: f32[6, L], locally sorted by key.
    Returns (key, cols) with shard s owning global ranks [sL, (s+1)L),
    and the overflow flag (bool[])."""
    dev = key.device
    if p == 1:
        return key, cols, torch.zeros((), dtype=torch.bool, device=dev)
    s_idx = mesh.axis_index()
    C = 2 * L + 8  # bucket capacity (PSRS bound 2L+2, padded up)
    ar_p = torch.arange(p, device=dev)

    # ---- splitters from regular samples ----
    samp_pos = (ar_p + 1) * L // p - 1
    all_sk = torch.sort(mesh.all_gather(key[samp_pos]).reshape(p * p)).values
    spl = all_sk[torch.arange(1, p, device=dev) * p - 1]  # [p-1]

    # ---- destination bucket per item (non-decreasing: the keys are sorted) ----
    dst = (spl[None, :] <= key[:, None]).sum(dim=1)  # [L] in [0, p)
    counts = (dst[:, None] == ar_p[None, :]).sum(dim=0)  # [p]
    in_off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    cmat = mesh.all_gather(counts)  # [p_src, p_dst]

    # ---- exchange: masked all-gather + one local merge sort ----
    # item (src, i) is mine iff in_off_src[me] <= i < in_off_src[me] +
    # cmat[src, me]; the fill keys sort last, and the bucket is the first C
    io_all = mesh.all_gather(in_off)  # [p_src, p_dst]
    lo_run = io_all[:, s_idx][:, None]  # [p, 1]
    hi_run = lo_run + cmat[:, s_idx][:, None]
    ii = torch.arange(L, device=dev)[None, :]
    mine = (ii >= lo_run) & (ii < hi_run)  # [p, L]
    k_all = torch.where(mine, mesh.all_gather(key), _FILL_KEY).reshape(p * L)
    c_all = torch.where(mine[:, None], mesh.all_gather(cols), _FBIG)  # [p, 6, L]
    c_all = c_all.permute(1, 0, 2).reshape(6, p * L)
    k_sorted, order = torch.sort(k_all)  # valid keys are distinct; fills all alike
    buf_k, buf_c = k_sorted[:C], c_all[:, order[:C]]

    # ---- global bucket offsets + drift-bound check ----
    sizes = cmat.sum(dim=0)  # [p] destination bucket sizes
    r_all = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])  # [p+1]
    drift = (r_all[:p] - ar_p * L).abs().max()
    overflow = (drift > L) | (sizes.max() > C)

    # ---- +-1 neighbour balance: exchange tails/heads, rank-slice ----
    # My item of global rank g comes from the left bucket (g < r_mine), my
    # own, or the right bucket (g >= r_mine + mysize); the drift bound
    # makes those the only possibilities (starts as in tpu_bvh :160-164).
    mysize = sizes[s_idx]
    r_mine = r_all[s_idx]
    r_next = r_all[min(s_idx + 1, p)]
    right_to_left = [(t, t - 1) for t in range(1, p)]
    left_to_right = [(t, t + 1) for t in range(p - 1)]
    lo_want = s_idx * L
    gr = lo_want + torch.arange(L, device=dev)
    use_l = gr < r_mine
    use_r = gr >= r_mine + mysize
    outs = []
    for b, f in ((buf_k, _FILL_KEY), (buf_c, _FBIG)):
        def pad(m, b=b, f=f):
            return torch.full((*b.shape[:-1], m), f, dtype=b.dtype, device=dev)
        bp = torch.cat([pad(L), b], dim=-1)
        from_left = mesh.ppermute(_dslice(bp, mysize, L), left_to_right)
        from_right = mesh.ppermute(b[..., :L].contiguous(), right_to_left)
        cl = _dslice(torch.cat([from_left, pad(2 * L)], dim=-1), lo_want - r_mine + L, L)
        cm = _dslice(bp, lo_want - r_mine + L, L)
        cr = _dslice(torch.cat([pad(2 * L), from_right], dim=-1), lo_want - r_next + 2 * L, L)
        outs.append(torch.where(use_l, cl, torch.where(use_r, cr, cm)))
    return outs[0], outs[1], overflow


# ---------------------------------------------------------------------------
# carry-combined threshold scans (tpu_bvh's XLA formulation of scan32)
# ---------------------------------------------------------------------------


def _seg_comb(a, b):
    """Segmented-min combine over (min, reset_seen) pairs: a reset in `b`
    discards `a`."""
    mm = torch.where(b[1], b[0], torch.minimum(a[0], b[0]))
    return (mm, a[1] | b[1])


def _scan(items, comb, neutral):
    """Inclusive scan of the planes `items` along axis 0 by log-step
    doubling (`lax.associative_scan`), exact because the combine here is
    the segmented min. No TPU kernel computes a segmented plane scan."""
    d = 1
    while d < items[0].shape[0]:
        prev = tuple(torch.cat([torch.full_like(x[:d], v), x[:-d]])
                     for x, v in zip(items, neutral))
        items = comb(prev, items)
        d *= 2
    return items


def _max(a, b):
    return (torch.maximum(a[0], b[0]),)


def _min(a, b):
    return (torch.minimum(a[0], b[0]),)


def _carry_fold(items, neutral, comb, reverse: bool = False):
    """Exclusive fold of per-shard totals (a small static loop): slot s
    combines the shards before s, or after s when `reverse`."""
    p = items[0].shape[0]
    res = [None] * p
    acc = neutral
    for s in range(p - 1, -1, -1) if reverse else range(p):
        res[s] = acc
        acc = comb(acc, tuple(x[s] for x in items))
    return [torch.stack([o[k] for o in res]) for k in range(len(neutral))]


def _pick(rows, dlt):
    """rows[i, dlt[i]] (0 where dlt < 0): JAX's one-hot select (a sum; for
    lc and rc a max over rows that hold no negative value)."""
    got = rows.gather(1, dlt.clamp(min=0)[:, None])[:, 0]
    return torch.where(dlt >= 0, got, 0)


def _sharded_scans(dlt, gb, mesh: Mesh, p: int, n_sentinel: int):
    """Global psv/nsv/lc/rc for this shard's boundaries.

    dlt: int64[L] remapped deltas [0, 52] (pad slots hold -1: below every
    real value). gb: int64[L] global boundary indices.
    Returns (psv, psv_val, nsv, nsv_val, lc, rc) with global positions.
    The [L, V] planes are int32, as JAX's: the packings stay below 2^28.
    """
    idx = mesh.axis_index()
    vr = torch.arange(V, device=dlt.device)
    maskv = dlt[:, None] < vr[None, :]
    big = torch.tensor(_BIG, dtype=I32, device=dlt.device)
    full = lambda v: torch.full((V,), v, dtype=I32, device=dlt.device)  # noqa: E731

    # ---- psv: running max of packed pos*64+val where val < lane ----
    # the pad boundary (global n-1) carries dlt = -1, so it is a universal
    # candidate packing val 0; its decoded position n-1 is the "no next
    # smaller" sentinel
    packed = (gb * 64 + torch.clamp(dlt, min=0)).to(I32)
    pk = torch.where(maskv, packed[:, None], -1)
    pre = plane_scan.plane_scan(pk, is_min=False, reverse=False)  # lax.cummax
    tots = mesh.all_gather(pre[-1])  # [p, V]
    carry_in = _carry_fold((tots,), (full(-1),), _max)[0][idx]
    pre_g = torch.maximum(pre, carry_in[None, :])
    psv_rows = torch.cat([carry_in[None, :], pre_g[:-1]])
    ppk = _pick(psv_rows, dlt)
    has = ppk >= 0
    psv = torch.where(has, ppk // 64, -1)
    psv_val = torch.where(has, ppk % 64, -1)

    # ---- nsv: suffix min of packed pos*64+val where val < lane ----
    pk2 = torch.where(maskv, packed[:, None], big)
    suf = plane_scan.plane_scan(pk2, is_min=True, reverse=True)  # lax.cummin, reverse
    tots_r = mesh.all_gather(suf[0])
    carry_in_r = _carry_fold((tots_r,), (full(_BIG),), _min, reverse=True)[0][idx]
    suf_g = torch.minimum(suf, carry_in_r[None, :])
    nsv_rows = torch.cat([suf_g[1:], carry_in_r[None, :]])
    npk = _pick(nsv_rows, dlt)
    hasn = npk != _BIG
    nsv = torch.where(hasn, npk // 64, -1)  # the caller maps -1 to the n-1 sentinel
    # the pad boundary decodes to the n-1 sentinel with a placeholder val 0:
    # report -1 ("no real next-smaller") there, as psv_val > nsv_val needs
    nsv_val = torch.where(hasn & (nsv < n_sentinel), npk % 64, -1)

    # ---- lc: exclusive segmented min (reset where dlt <= lane) ----
    cpacked = ((dlt << _POSB) | gb).to(I32)
    cand = torch.where(dlt[:, None] > vr[None, :], cpacked[:, None], big)
    reset = dlt[:, None] <= vr[None, :]
    m_f, r_f = _scan((cand, reset), _seg_comb, (_BIG, False))
    cm, _cr = _carry_fold((mesh.all_gather(m_f[-1]), mesh.all_gather(r_f[-1])),
                          (full(_BIG), torch.zeros(V, dtype=torch.bool, device=dlt.device)),
                          _seg_comb)
    cm_in = cm[idx]
    m_g = torch.where(r_f, m_f, torch.minimum(cm_in[None, :], m_f))
    m_excl = torch.cat([cm_in[None, :], m_g[:-1]])
    lpk = _pick(m_excl, dlt)
    lc = torch.where(lpk == _BIG, -1, lpk & ((1 << _POSB) - 1))

    # ---- rc: reverse segmented min, exclusive after the position ----
    m_r, r_r = _scan((cand.flip(0), reset.flip(0)), _seg_comb, (_BIG, False))
    m_r, r_r = m_r.flip(0), r_r.flip(0)
    cmr, _crr = _carry_fold((mesh.all_gather(m_r[0]), mesh.all_gather(r_r[0])),
                            (full(_BIG), torch.zeros(V, dtype=torch.bool, device=dlt.device)),
                            _seg_comb, reverse=True)
    cmr_in = cmr[idx]
    m_rg = torch.where(r_r, m_r, torch.minimum(cmr_in[None, :], m_r))
    m_excl_r = torch.cat([m_rg[1:], cmr_in[None, :]])
    rpk = _pick(m_excl_r, dlt)
    rc = torch.where(rpk == _BIG, -1, rpk & ((1 << _POSB) - 1))

    return psv, psv_val, nsv, nsv_val, lc, rc


# ---------------------------------------------------------------------------
# sharded refit: halo dense phase + routed long-node queries, on min_keys
# ---------------------------------------------------------------------------


def _halo_cols(cols, radius: int, mesh: Mesh, p: int, edge):
    """[6, L] -> [6, L + 2*radius] with the neighbours' halos (`edge` at the
    ends of the mesh)."""
    idx = mesh.axis_index()
    # partial permutations: a rank no pair reaches receives zeros, which
    # the mesh-edge masks below override
    right_of = [(s, s + 1) for s in range(p - 1)]
    left_of = [(s, s - 1) for s in range(1, p)]
    from_left = mesh.ppermute(cols[:, -radius:].contiguous(), right_of)
    from_right = mesh.ppermute(cols[:, :radius].contiguous(), left_of)
    if idx == 0:
        from_left = torch.full_like(from_left, edge)
    if idx == p - 1:
        from_right = torch.full_like(from_right, edge)
    return torch.cat([from_left, cols, from_right], dim=1)


def _local_range_table(cols, levels: int):
    """T_k[i] = min(cols[i : i + 2^k]) clamped, stacked rows [(Lv+1)*L, 6]."""
    L = cols.shape[1]
    tabs = [cols]
    cur = cols
    for k in range(1, levels + 1):
        s = 1 << (k - 1)
        if s < L:
            shifted = torch.cat([cur[:, s:], cur[:, -1:].expand(6, s)], dim=1)
            cur = torch.minimum(cur, shifted)
        tabs.append(cur)
    return torch.cat(tabs, dim=1).T  # [(levels+1)*L, 6]


def _answer_clamped(table, L: int, lo: int, cf, cl, edge):
    """min over leaves [cf, cl] ∩ [lo, lo+L) from this shard's table."""
    a = torch.clamp(cf - lo, 0, L - 1)
    b = torch.clamp(cl - lo, 0, L - 1)
    nonempty = (cf <= lo + L - 1) & (cl >= lo) & (b >= a)
    length = torch.clamp(b - a + 1, min=1)
    k = _floor_log2(length)
    s = torch.clamp(b - (torch.ones_like(k) << k) + 1, min=0)
    u = torch.minimum(table[k * L + a], table[k * L + s])
    return torch.where(nonempty[:, None], u, edge)


class ShardedBvh2(NamedTuple):
    """This rank's shard of the build ([L] rows: its sorted leaves and
    boundaries), plus the replicated root and routing-overflow flag.
    `to_bvh2` gathers the shards into the standard Bvh2."""

    int_packed: torch.Tensor  # f32[L, 6] internal (min,-max); the last shard's last row is a pad
    leaf_packed: torch.Tensor  # f32[L, 6] sorted leaves (min,-max)
    left: torch.Tensor  # i32[L]
    right: torch.Tensor  # i32[L]
    parent_internal: torch.Tensor  # i32[L]
    parent_leaf: torch.Tensor  # i32[L]
    leaf_prim: torch.Tensor  # i32[L]
    root: torch.Tensor  # i32[] replicated
    overflow: torch.Tensor  # bool[] replicated


def _check(n: int, p: int, radius: int, route_cap):
    """The build's shape rules, as errors before any collective; returns
    (L, routing capacity)."""
    if n % p:
        raise ValueError(f"triangle count {n} must divide over {p} ranks")
    if n > (1 << _POSB):
        raise ValueError(f"n = {n} > 2^{_POSB}: the child scans pack a position in {_POSB} bits")
    L = n // p
    if L < max(2 * radius, 64):
        raise ValueError(f"shards of {L} triangles are too small (need >= {max(2 * radius, 64)})")
    cap = route_cap or min(L, max(128, ((L // 4 + 127) // 128) * 128))
    if cap > L:
        raise ValueError(f"route_cap {cap} > shard size {L}")
    return L, cap


def build_single_pass_sharded(mesh: Mesh, tris, radius: int = 16, use_extended: bool = True,
                              route_cap: int | None = None) -> ShardedBvh2:
    """Sharded single-pass LBVH build (see the module docstring), called
    on every rank with the whole f32[n, 3, 3] soup; each rank takes rows
    [sL, (s+1)L). n must divide over the ranks, n/p >= max(2*radius, 64)
    and n <= 2^22 (each raises ValueError before any work). Returns this
    rank's ShardedBvh2; `to_bvh2` assembles the standard Bvh2.
    `route_cap` overrides the per-shard long-node routing capacity."""
    p = mesh.size
    n = int(tris.shape[0])
    L, cap = _check(n, p, radius, route_cap)
    m = n - 1
    levels_loc = max(1, math.ceil(math.log2(max(L, 2))))
    s = mesh.axis_index()
    lo = s * L  # global offset of this shard's leaves and boundaries
    dev = tris.device
    local = tris[lo:lo + L]
    leaf = A.packed_bounds(local.permute(1, 2, 0), 0, 1)  # [6, L]: min xyz, -max xyz

    # ---- global scene extents: a deterministic all-reduce of min_keys ----
    ext_keys = mesh.pmin(A.min_key(leaf).amin(dim=1))
    smin, smax = A.from_min_key(ext_keys[:3]), -A.from_min_key(ext_keys[3:])
    mn, mx = leaf[0:3], -leaf[3:6]
    ext = smax - smin
    safe = torch.where(ext > 0, ext, 1.0)
    nx, ny, nz = ((mn + mx) * 0.5 - smin[:, None]) / safe[:, None]
    if use_extended:
        codes = M.extended_morton30_cols(nx, ny, nz, ext)
    else:
        codes = M.morton30_cols(nx, ny, nz)

    # ---- distributed sort by the total key (code, original index) ----
    gb = lo + torch.arange(L, dtype=I64, device=dev)  # global indices: triangles, then boundaries
    key, order = torch.sort(_sort_key(codes, gb))
    key, leaf_cols, sort_ovf = _sample_sort(key, leaf[:, order], p, mesh, L)
    codes = _key_code(key)
    leaf_prim = (key & 0xFFFFFFFF).to(I32)

    # ---- boundary deltas (halo: the next shard's first code) ----
    nxt = mesh.ppermute(codes[:1], [(t, t - 1) for t in range(1, p)] + [(0, p - 1)])
    cj = torch.cat([codes[1:], nxt])
    x = codes ^ cj
    tie = 32 + _clz32(gb ^ (gb + 1))
    dlt = remap_deltas(torch.where(x == 0, tie, _clz32(x))).to(I64)
    dlt = torch.where(gb < m, dlt, -1)  # pad boundary: below everything

    psv, psv_val, nsv_p, nsv_val, lc, rc = _sharded_scans(dlt, gb, mesh, p, m)
    first = psv + 1
    last = torch.where(nsv_p >= 0, nsv_p, n - 1)

    # ---- refit: dense halo stencil, on min_keys ----
    leaf_keys = A.min_key(leaf_cols)
    edge = int(A.min_key(torch.tensor(_FBIG, dtype=torch.float32)))
    halo = _halo_cols(leaf_keys, radius, mesh, p, edge)
    acc = torch.full((6, L), edge, dtype=I32, device=dev)
    la = last - gb
    ab = gb - first
    for d in range(-radius + 1, radius + 1):
        w = halo[:, radius + d:radius + d + L]
        # ranges contain their own boundary: one-sided checks suffice
        ok = (d <= la) if d > 0 else (-d <= ab)
        acc = torch.where(ok[None, :], torch.minimum(acc, w), acc)
    short = (ab < radius) & (la <= radius) & (gb < m)

    # ---- long nodes: compact, broadcast, answer, pmin, route back ----
    table = _local_range_table(leaf_keys, levels_loc)
    is_long = (~short) & (gb < m)
    n_long = is_long.sum()
    cpos = torch.sort((~is_long).to(I32), stable=True).indices  # long nodes first, in order
    cf, cl = first[cpos], last[cpos]
    allq = mesh.all_gather(torch.stack([cf[:cap], cl[:cap]]))  # [p, 2, cap]
    qf = allq[:, 0].reshape(p * cap)
    ql = allq[:, 1].reshape(p * cap)
    ans = mesh.pmin(_answer_clamped(table, L, lo, qf, ql, edge))  # [p*cap, 6]
    mine = ans[s * cap:(s + 1) * cap].T  # [6, cap]
    in_long = torch.arange(L, device=dev) < torch.clamp(n_long, max=cap)
    back = torch.where(in_long, torch.cat([mine, mine.new_full((6, L - cap), edge)], dim=1), edge)
    long_cols = torch.empty_like(back)
    long_cols[:, cpos] = back  # each long node's answer back at its own position
    int_packed = A.from_min_key(torch.where(short, acc, long_cols))
    overflow = mesh.pmax(torch.stack([n_long > cap, sort_ovf]).to(I32)).any()

    # ---- links (apetrei layout, global ids) ----
    is_root = (first == 0) & (last == n - 1) & (gb < m)
    internal_is_right = psv_val > nsv_val
    parent_internal = torch.where(is_root, -1, torch.where(internal_is_right, psv, last))
    # leaf j's parents need dlt[j-1]: a one-left halo
    prv_d = mesh.ppermute(dlt[-1:], [(t, t + 1) for t in range(p - 1)] + [(p - 1, 0)])
    if s == 0:
        prv_d = torch.full_like(prv_d, -1)
    ldl = torch.cat([prv_d, dlt[:-1]])
    ldr = torch.where(gb < m, dlt, -1)
    parent_leaf = torch.where(ldl > ldr, gb - 1, gb)
    left = torch.where(lc >= 0, lc, m + gb)
    right = torch.where(rc >= 0, rc, m + gb + 1)
    left = torch.where(gb < m, left, -1)
    right = torch.where(gb < m, right, -1)
    root = mesh.pmin(torch.where(is_root, gb, _BIG).min())

    return ShardedBvh2(
        int_packed=int_packed.T.contiguous(), leaf_packed=leaf_cols.T.contiguous(),
        left=left.to(I32), right=right.to(I32), parent_internal=parent_internal.to(I32),
        parent_leaf=parent_leaf.to(I32), leaf_prim=leaf_prim, root=root.to(I32),
        overflow=overflow)


def gather(mesh: Mesh, sb: ShardedBvh2) -> ShardedBvh2:
    """Every rank's shard concatenated in rank order ([p*L] rows, the
    global arrays JAX's sharded outputs hold); root and overflow as they
    are."""
    rows = [mesh.all_gather(f).reshape(-1, *f.shape[1:]) for f in sb[:7]]
    return ShardedBvh2(*rows, sb.root, sb.overflow)


def to_bvh2(sb: ShardedBvh2, n: int, mesh: Mesh) -> Bvh2:
    """Gather the shards and assemble the standard replicated Bvh2 (node
    slots [0, 2n-2], leaves at [n-1, 2n-2], a leaf's left = its prim id),
    on every rank."""
    g = gather(mesh, sb)
    m = n - 1
    packed_t = torch.cat([g.int_packed[:m], g.leaf_packed], dim=0).T.contiguous()
    left = torch.cat([g.left[:m], g.leaf_prim])
    right = torch.cat([g.right[:m], torch.full((n,), -1, dtype=I32, device=g.right.device)])
    return Bvh2(packed_t=packed_t, left=left, right=right, root=g.root)
