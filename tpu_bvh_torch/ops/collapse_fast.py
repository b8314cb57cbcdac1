"""Fast BVH2 -> BVH4 collapse for boundary-layout (single-pass LBVH) trees:
the port of `tpu_bvh.ops.collapse_fast`.

The greedy collapse of the reference: from the root, each wide node
expands its largest-area internal child twice (up to 4 children);
expanded nodes disappear, the rest become wide children. The tree equals
the sequential oracle's (`utils/cpu_reference.collapse_cpu`) but is
numbered sparsely: wide node x keeps its bvh2 index (unused ids have
child_count 0) and `Bvh4.root` is the bvh2 root.

Three stages, as in the JAX package:
  1. prep: areas, short flags, the kernel's dense input rows;
  2. coarse stage: the nodes whose leaf range exceeds S_LEN (an
     ancestor-closed crown of a few percent) are compacted; the expansion
     simulation, the state pointer doubling and the ownership values run
     there, and everything they produce (seeds, slots, counts, slot AABBs,
     claims) goes into the kernel's rows by one lane scatter;
  3. `collapse_block` (B3): the short nodes, plus the coarse rows passed
     through; its dense outputs are the Bvh4.

The coarse capacity 2n/(S_LEN+1) + 2 covers bushy trees; chain-shaped
crowns can exceed it, so a Python branch on the measured long count (one
host sync) runs the same stage at capacity m.

On the card stages 1 and 2 are two hand-written launches
(`csrc/collapse_prep.cu`): P1 (`collapse_prep`) writes every row and
compacts the long nodes by a single-pass scan, which also gives the long
count; P2 (`collapse_coarse`, one cooperative launch) runs the coarse stage
and its scatter. A CPU tensor takes the plain ops (`_prepare`), which the
JAX package is held to; both give the same rows bit for bit.

Under a running profiler the collapse is the span `bvh.collapse`, with
`bvh.collapse_prep` (stages 1 and 2) and `bvh.collapse_block` (B3's launch
and its error flag's read) inside it; on the card B3's flag is read in a
second `bvh.collapse_block` span, after the Bvh4's slices are queued. Its device-to-host reads are counted
at their sites (`utils/timer.count_host_sync`): the long count and, on the
card, B3's error flag. `last_build` holds the last collapse's
hand-written launches (P1, P2 and B3: 3 on the card, 0 on the CPU;
`kernels.launches` has each kernel's) and its long count (an i32[] on the
tree's device).
"""
from __future__ import annotations

import torch

from ..types import Bvh2, Bvh4
from ..utils import kernels, timer, work
from ..utils.platform import on_cuda
from . import collapse_block as b3
from .collapse_block import _E1, _E2, _UNK, _WIDE, S_LEN, _apply, collapse_block, expand2

I32 = torch.int32
F32 = torch.float32
_BIGKEY = 2**30
_PREP_TILE = 1024  # lanes a block of P1 (kTile in csrc/collapse_prep.cu)
_COARSE_ROWS = 11  # P2's scratch rows (csrc/collapse_prep.cu)
last_build = {"launches": 0, "long": None}
_prep_work = {}  # (device, stream) -> P1's look-back status words and ticket


def _bits(x):
    return x.contiguous().view(I32)


def collapse_lbvh_to_bvh4(bvh: Bvh2, parent, first, last) -> Bvh4:
    """bvh: boundary-layout Bvh2 from `lbvh.build_single_pass_aux` (node i
    at boundary i with first_i <= i < last_i). parent: i32[2n-1] (leaf
    parents included). first/last: i32[n-1] inclusive leaf ranges."""
    with timer.span("bvh.collapse"), timer.tally(last_build):
        m = bvh.n_internal
        rows, n_long = _inputs(bvh, parent, first, last)
        if on_cuda(bvh.packed_t):
            # the Bvh4's slices are queued behind B3 before its flag is read
            with timer.span("bvh.collapse_block"):
                outm, outa, err = b3.launch(*rows, m)
            del rows  # B3's input, freed before the slices allocate
            out = _bvh4(bvh, outm, outa)
            with timer.span("bvh.collapse_block"):
                b3.check_flag(err)
        else:
            out = _bvh4(bvh, *collapse_block(*rows, m))
        last_build["long"] = n_long
        return out


def kernel_inputs(bvh: Bvh2, parent, first, last):
    """Stages 1 and 2: the arguments (meta, node8, leaf8, carr) of
    `collapse_block` for this tree; P1 and P2 on the card."""
    return _inputs(bvh, parent, first, last)[0]


def _inputs(bvh: Bvh2, parent, first, last):
    """(the kernel rows, the long count i32[]), under the span
    `bvh.collapse_prep`."""
    m = bvh.n_internal
    if m < 1:
        raise ValueError("collapse needs at least 2 leaves")
    # the doubling packs ptr * 64 + table in i32 and the coarse sort's
    # sentinel is 2^30, so node ids must fit 22 bits
    if m >= (1 << 22):
        raise ValueError("collapse packing requires < 2^22 internal nodes")
    parent = parent.to(I32)
    with timer.span("bvh.collapse_prep"):
        if on_cuda(bvh.packed_t):
            return _prepare_cuda(bvh, parent, first, last)
        is_long = (last - first + 1) > S_LEN
        n_long = is_long.sum(dtype=I32)
        return _prepare(bvh, parent, is_long, _capacity(bvh, n_long)), n_long


def _capacity(bvh: Bvh2, n_long) -> int:
    """The coarse capacity that holds the long nodes, given their count
    (an i32[], read only where the bushy capacity is below m)."""
    m = bvh.n_internal
    ccap = min(2 * bvh.n_leaves // (S_LEN + 1) + 2, m)
    if ccap < m:
        count = int(n_long)  # one host sync
        timer.count_host_sync()
        if count > ccap:
            ccap = m  # a chain-shaped crown: the same stage at full capacity
    return ccap


def _bvh4(bvh: Bvh2, outm, outa) -> Bvh4:
    """The Bvh4 in B3's dense outputs."""
    m = bvh.n_internal
    n = bvh.n_leaves
    count = outm[4, :m]
    sp = torch.stack([a[0:6, :m] for a in outa]).contiguous().view(F32)  # [4, 6, m]
    return Bvh4(
        slot_packed_t=sp,
        child_t=outm[0:4, :m].contiguous(),
        parent=outm[6, :m].contiguous(),
        child_count=count.contiguous(),
        n_nodes=(count > 0).sum(dtype=I32),
        leaf_prim=bvh.left[m:].to(I32).contiguous(),
        leaf_parent=outm[7, :n].contiguous(),
        root=bvh.root.to(I32),
    )


def _prepare_cuda(bvh: Bvh2, parent, first, last):
    """`_prepare`'s rows by P1 and P2, and the long count i32[] (P1's)."""
    n, m, mm = bvh.n_leaves, bvh.n_internal, bvh.n_nodes
    pk, left, right = bvh.packed_t, bvh.left.to(I32), bvh.right.to(I32)
    first, last = first.to(I32), last.to(I32)
    kernels.require(pk, "packed_t", F32, (6, mm))
    for name, x, size in (("left", left, mm), ("right", right, mm), ("parent", parent, mm),
                          ("first", first, m), ("last", last, m)):
        kernels.require(x, name, I32, (size,))
    dev = pk.device
    stream = kernels.stream_of(pk)
    rows = torch.empty((56, n), dtype=I32, device=dev)  # meta, node8, leaf8, carr
    longs = torch.empty(2 * m + 1, dtype=I32, device=dev)  # rank, ids, the long count
    rank, ids, n_long = longs[:m], longs[m:2 * m], longs[2 * m]
    status, ticket, epoch = kernels.look_back_work(_prep_work, dev, stream, -(-n // _PREP_TILE))
    kernels.launch("collapse_prep", "tbvh_collapse_prep", pk, left, right, parent, first, last, n,
                   rows, rank, ids, n_long, status, ticket, epoch, like=pk,
                   count=lambda: work.collapse_prep(n, int(n_long)),
                   symbols="collapse_prep_kernel")
    meta, node8, leaf8, carr = rows[0:8], rows[8:16], rows[16:24], rows[24:56]
    cap = _capacity(bvh, n_long)
    scratch = torch.empty((_COARSE_ROWS, cap), dtype=I32, device=dev)
    kernels.launch("collapse_coarse", "tbvh_collapse_coarse", pk, left, right, parent, n, rank,
                   ids, n_long, cap, scratch, meta, carr, like=pk,
                   count=lambda: work.collapse_prep(n, int(n_long), meta, carr),
                   symbols="collapse_coarse_kernel")
    return (meta, node8, leaf8, carr), n_long


def _prepare(bvh: Bvh2, parent, is_long, ccap: int):
    """The kernel inputs at coarse capacity `ccap` (>= the long-node count)."""
    n = bvh.n_leaves
    m = bvh.n_internal
    mm = bvh.n_nodes
    dev = bvh.packed_t.device
    full = lambda shape, v: torch.full(shape, v, dtype=I32, device=dev)

    pk = bvh.packed_t  # f32[6, mm] (min xyz, -max xyz)
    left = bvh.left.to(I32)
    right = bvh.right.to(I32)
    ext = torch.clamp(-pk[3:6] - pk[0:3], min=0.0)
    # separately rounded products and sums: the area bits decide which
    # child expands, so they must not depend on FMA contraction
    area = 2.0 * ((ext[0] * ext[1] + ext[0] * ext[2]) + ext[1] * ext[2])
    area_bits = _bits(area)  # >= 0: i32 order == f32 order

    # ---- coarse stage on the compacted long set ----
    idx_m = torch.arange(m, dtype=I32, device=dev)
    skey = torch.sort(torch.where(is_long, idx_m, _BIGKEY)).values[:ccap]
    cidx = torch.clamp(skey, max=m - 1)  # coarse ids, sorted
    cvalid = skey < 2**29
    prow_t = torch.cat([area_bits[None], left[None], right[None], parent[None], _bits(pk)])

    def fetch(ids):
        return prow_t[:, torch.clamp(ids, 0, mm - 1).to(torch.int64)]  # [10, k]

    trow = fetch(cidx)
    c_left, c_right, c_parent = trow[1], trow[2], trow[3]

    def fetch_exp(ids):  # (area code, left, right, packed AABB bits)
        rows = fetch(ids)
        return torch.where((ids >= 0) & (ids < m), rows[0], -1), rows[1], rows[2], rows[4:10]

    s_id, s_ab, count2, e1_c, e2_c = expand2(c_left, c_right, fetch_exp)

    # coarse states: pointer doubling in compacted space (parents coarse)
    long_i = is_long.to(I32)
    rank = torch.cumsum(long_i, 0, dtype=I32) - long_i
    p_rank = torch.where(c_parent >= 0, rank[torch.clamp(c_parent, 0, m - 1).to(torch.int64)], -1)
    lanes_c = torch.arange(ccap, dtype=I32, device=dev)
    ps = torch.clamp(p_rank, 0, ccap - 1).to(torch.int64)
    e1_at_p, e2_at_p = e1_c[ps], e2_c[ps]
    e2_at_g = e2_c[torch.clamp(p_rank[ps], 0, ccap - 1).to(torch.int64)]
    t_wide = torch.where(cidx == e1_at_p, _E1, torch.where(cidx == e2_at_p, _E2, _WIDE)).to(I32)
    t_e1 = torch.where(cidx == e2_at_g, _E2, _WIDE).to(I32)
    rootless = (p_rank < 0) | ~cvalid
    fenc = torch.where(rootless, 0, t_wide | (t_e1 << 2))
    packed = torch.where(rootless, lanes_c, ps.to(I32)) * 64 + fenc
    for _ in range(6):
        pulled = packed[torch.clamp(packed >> 6, 0, ccap - 1).to(torch.int64)]
        fp, f = pulled & 63, packed & 63
        nf = (_apply(f, _apply(fp, 0)) | (_apply(f, _apply(fp, 1)) << 2)
              | (_apply(f, _apply(fp, 2)) << 4))
        packed = (pulled & ~63) | nf
    state_c = packed & 3

    def child_state(cid):
        """States of the coarse nodes' children (seeds for the kernel)."""
        return torch.where(
            state_c == _WIDE,
            torch.where(cid == e1_c, _E1, torch.where(cid == e2_c, _E2, _WIDE)),
            torch.where(state_c == _E1, torch.where(cid == e2_at_p, _E2, _WIDE), _WIDE),
        ).to(I32)

    state_l, state_r = child_state(c_left), child_state(c_right)

    # nearest wide ancestor, inclusive (`own_inc`): WIDE -> self; E1 ->
    # parent; E2 -> parent if the parent is wide, else grandparent
    state_p = state_c[ps]
    gp_id = c_parent[ps]
    own_inc = torch.where(state_c == _WIDE, cidx,
                          torch.where(state_c == _E1, c_parent,
                                      torch.where(state_p == _E1, gp_id, c_parent)))
    # own_parent(x) := own_inc(parent(x)), the claim terminal at seed lanes
    own_pc = torch.where(p_rank >= 0, own_inc[ps], -1)

    # ---- dense seed / own / coarse-output rows: one lane scatter ----
    # A coarse node that is also a coarse node's child is reached both as
    # a tgt_c row and as a tl/tr row; both carry equal values.
    oob = mm + 5
    tgt_c = torch.where(cvalid, cidx, oob)
    tl = torch.where(cvalid & (c_left >= 0) & (c_left < m), c_left, oob)
    tr = torch.where(cvalid & (c_right >= 0) & (c_right < m), c_right, oob)

    def long_child(cid):
        cr = rank[torch.clamp(cid, 0, m - 1).to(torch.int64)]
        ok = ((cid >= 0) & (cid < m) & is_long[torch.clamp(cid, 0, m - 1).to(torch.int64)]
              & (cr < ccap))
        return ok, torch.clamp(cr, 0, ccap - 1).to(torch.int64)

    def child_e2(cid):
        ok, cr = long_child(cid)
        return torch.where(ok, e2_c[cr], -1)

    enc_se = lambda st, e2v: st * (1 << 23) + (e2v + 1)
    is_wide_c = cvalid & (state_c == _WIDE)
    slotmask = (torch.arange(4, device=dev)[:, None] < count2[None]) & is_wide_c[None]
    slots_rows = torch.where(slotmask, torch.stack(s_id), -1)  # [4, ccap]
    cnt_row = torch.where(is_wide_c, count2, 0)[None]
    cw_row = is_wide_c.to(I32)[None]
    ab_rows = torch.cat([torch.where(is_wide_c[None], s_ab[k], 0) for k in range(4)])
    cvals = torch.cat([slots_rows, cnt_row, cw_row, ab_rows])  # [30, ccap]
    cbg_col = torch.cat([full((4, 1), -1), full((26, 1), 0)])  # background column

    def child_cvals(cid):
        """The child's own coarse-output column when it is coarse, else
        the background."""
        ok, cr = long_child(cid)
        return torch.where(ok[None], cvals[:, cr], cbg_col)

    pre_t = torch.cat([tgt_c, tl, tr]).to(torch.int64)
    seed_row = torch.cat([enc_se(state_c, e2_c), enc_se(state_l, child_e2(c_left)),
                          enc_se(state_r, child_e2(c_right))])[None]
    own_row = torch.cat([own_pc + 1, own_inc + 1, own_inc + 1])[None]
    cout = torch.cat([cvals, child_cvals(c_left), child_cvals(c_right)], dim=1)
    pre_v = torch.cat([seed_row, own_row, cout, full((2, 3 * ccap), 0)])  # [34, 3 ccap]
    # JAX's mode="drop": targets outside [0, m) land in a spare column m
    pre = torch.cat([full((1, m + 1), _UNK << 23), full((1, m + 1), 0),
                     cbg_col.expand(30, m + 1), full((2, m + 1), 0)], dim=0)
    pre[:, torch.where(pre_t < m, pre_t, m)] = pre_v
    pre = pre[:, :m]
    seed_e2, own_dense, carr = pre[0], pre[1], pre[2:34]

    # ---- kernel inputs (lane-major; W = n columns so leaf n-1 exists) ----
    W = n
    pad = lambda v, fill: torch.cat([v, full((W - m,), fill)])
    meta = torch.stack([
        pad(area_bits[:m], 0), pad(left[:m], -1), pad(right[:m], -1), pad(parent[:m], -1),
        pad(seed_e2, _UNK << 23), pad((~is_long).to(I32), 0), pad(own_dense, 0),
        parent[m:],  # leaf parents (for claims)
    ])
    node8 = torch.cat([_bits(pk[:, :m]), full((2, m), 0)])
    node8 = torch.cat([node8, full((8, W - m), 0)], dim=1)
    leaf8 = torch.cat([_bits(pk[:, m:]), full((2, n), 0)])
    carr = torch.cat([carr, torch.cat([cbg_col, full((2, 1), 0)]).expand(32, W - m)], dim=1)
    return meta.contiguous(), node8.contiguous(), leaf8.contiguous(), carr.contiguous()
