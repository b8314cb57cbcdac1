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
     ancestor-closed crown of a few percent) are compacted by one sort;
     the expansion simulation, the state pointer doubling and the
     ownership values run there, and everything they produce (seeds,
     slots, counts, slot AABBs, claims) goes into the kernel's rows by
     one lane scatter;
  3. `collapse_block`: the short nodes, plus the coarse rows passed
     through; its dense outputs are the Bvh4.

The coarse capacity 2n/(S_LEN+1) + 2 covers bushy trees; chain-shaped
crowns can exceed it, so a Python branch on the measured long count (one
host sync) reruns the same stage at capacity m.

On the card the three stages run as one CUDA graph a size: a size's first
call runs them op by op and captures them, and later calls copy the tree
into the graph's inputs, replay it and copy its outputs out, so the host
makes one launch for the collapse's ~600 kernels. Cost analysis
(`utils/introspect`) and the CPU run the ops one by one.

Under a running profiler the collapse is the span `bvh.collapse`, with
`bvh.collapse_block` inside it (B3's launch and its error flag's read; in a
replay the flag's read). Its device-to-host reads are counted at their
sites (`utils/timer.count_host_sync`): the long count and, on the card,
B3's error flag.
"""
from __future__ import annotations

import threading

import torch

from ..types import Bvh2, Bvh4
from ..utils import introspect, kernels, timer
from ..utils.platform import on_cuda
from . import collapse_block as b3
from .collapse_block import _E1, _E2, _UNK, _WIDE, S_LEN, _apply, collapse_block, expand2

I32 = torch.int32
F32 = torch.float32
_BIGKEY = 2**30


def _bits(x):
    return x.contiguous().view(I32)


def collapse_lbvh_to_bvh4(bvh: Bvh2, parent, first, last) -> Bvh4:
    """bvh: boundary-layout Bvh2 from `lbvh.build_single_pass_aux` (node i
    at boundary i with first_i <= i < last_i). parent: i32[2n-1] (leaf
    parents included). first/last: i32[n-1] inclusive leaf ranges."""
    with timer.span("bvh.collapse"):
        is_long, ccap = _long_nodes(bvh, first, last)
        parent = parent.to(I32)
        if not on_cuda(bvh.packed_t) or introspect.recording():
            return _collapse(bvh, parent, is_long, ccap, collapse_block)
        return _replay(bvh, parent, is_long, ccap)


def kernel_inputs(bvh: Bvh2, parent, first, last):
    """Stages 1 and 2: the arguments (meta, node8, leaf8, carr) of
    `collapse_block` for this tree."""
    return _prepare(bvh, parent.to(I32), *_long_nodes(bvh, first, last))


def _long_nodes(bvh: Bvh2, first, last):
    """The long-node flags and the coarse capacity that holds them."""
    n = bvh.n_leaves
    m = bvh.n_internal
    if m < 1:
        raise ValueError("collapse needs at least 2 leaves")
    # the doubling packs ptr * 64 + table in i32 and the coarse sort's
    # sentinel is 2^30, so node ids must fit 22 bits
    if m >= (1 << 22):
        raise ValueError("collapse packing requires < 2^22 internal nodes")
    is_long = (last - first + 1) > S_LEN
    ccap = min(2 * n // (S_LEN + 1) + 2, m)
    if ccap < m:
        n_long = int(is_long.sum())  # one host sync
        timer.count_host_sync()
        if n_long > ccap:
            ccap = m  # a chain-shaped crown: the same stage at full capacity
    return is_long, ccap


def _collapse(bvh: Bvh2, parent, is_long, ccap: int, block) -> Bvh4:
    """Stages 1-3 at coarse capacity `ccap`; `block(meta, node8, leaf8,
    carr, m)` runs B3."""
    m = bvh.n_internal
    n = bvh.n_leaves
    outm, outa = block(*_prepare(bvh, parent, is_long, ccap), m)
    # the kernel's dense outputs are the Bvh4
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


class _Graph:
    """Stages 1-3 captured as one CUDA graph for trees of n leaves at coarse
    capacity `ccap`, on the stream current at capture: static inputs (the
    tree's boxes and links, the parents, the long-node flags) that each call
    copies in, and static outputs that each call copies out."""

    def __init__(self, bvh: Bvh2, parent, is_long, ccap: int):
        dev = bvh.packed_t.device
        self.inputs = [x.clone() for x in (bvh.packed_t, bvh.left, bvh.right, parent, is_long)]
        self.err = torch.zeros((1,), dtype=I32, device=dev)
        tree = Bvh2(*self.inputs[:3], bvh.root)
        block = lambda *rows: b3.launch(*rows, self.err)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = _collapse(tree, self.inputs[3], self.inputs[4], ccap, block)

    def __call__(self, bvh: Bvh2, parent, is_long) -> Bvh4:
        for dst, src in zip(self.inputs, (bvh.packed_t, bvh.left, bvh.right, parent, is_long)):
            dst.copy_(src)
        self.graph.replay()
        b3.launches += 1
        out = Bvh4(*(x.clone() for x in self.outputs))._replace(root=bvh.root.to(I32))
        with timer.span("bvh.collapse_block"):
            b3.check_flag(self.err)
        return out


# each thread's graphs by (device, stream, n, ccap), the newest last; each
# holds the collapse's working memory at its size, so a thread keeps two
_graphs = threading.local()
_MAX_GRAPHS = 2


def _replay(bvh: Bvh2, parent, is_long, ccap: int) -> Bvh4:
    """The collapse on the card. A size's first call runs the ops one by one
    and then captures them as a graph (`_Graph`); later calls replay it, so
    the host launches the collapse's ~600 kernels as one."""
    dev = bvh.packed_t.device
    key = (dev, kernels.stream_of(bvh.packed_t), bvh.n_leaves, ccap)
    graphs = vars(_graphs).setdefault("graphs", {})
    g = graphs.get(key)
    if g is not None:
        return g(bvh, parent, is_long)
    out = _collapse(bvh, parent, is_long, ccap, collapse_block)
    if len(graphs) >= _MAX_GRAPHS:  # every call ends in a sync: no replay is in flight
        del graphs[next(iter(graphs))]
    with torch.cuda.device(dev):
        graphs[key] = _Graph(bvh, parent, is_long, ccap)
    return out


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
