"""The short-node phases of the fast BVH2 -> BVH4 collapse (LBVH trees).

The contract of `tpu_bvh.ops.pallas.collapse_block.collapse_block_pallas`.
A node is short when its leaf range has at most S_LEN leaves; the XLA-side
prep (`collapse_fast.py`) has already resolved the long ("coarse") nodes
and seeded their states. For every lane i (boundary i, which also carries
leaf i), all i32 rows:

  meta [8, W]: 0 area bits (f32 >= 0, so i32 order is f32 order), 1 left,
               2 right, 3 parent, 4 seed state << 23 | coarse e2 + 1
               (state 3 = unseeded), 5 short flag, 6 own_parent + 1 at
               seed lanes (0 = none), 7 leaf lane i's bvh2 parent
  node8 [8, W]: rows 0-5 node packed (min xyz, -max xyz) as f32 bits
  leaf8 [8, W]: rows 0-5 leaf packed, leaf j at column j
  carr [32, W]: the coarse stage's own rows: 0-3 slots, 4 count,
               5 coarse-wide flag, 6-29 slot AABB bits (slot k at 6+6k)

Outputs (i32): outm [8, W] with rows 0-3 the final slot ids (internal id
< m, leaf slot m + j, -1 empty), 4 count, 5 state (WIDE 0 / E1 1 / E2 2,
3 off the internal lanes), 6 wide-parent claim, 7 leaf lane i's claim;
and four outa [8, W], rows 0-5 the packed bits of slot k. Short wide
lanes take their own values, coarse wide lanes (carr row 5 == 1) pass
the coarse rows through, every other lane holds -1 slots and zeros.

Phases: (A) the two largest-area-child expansions of every short node
(first max wins, area > 0 strictly, areas compared as i32 bits); (B) each
node's state, the composition of 3-state transition tables along its
parent chain to a seeded terminal; (C) the ownership claims: the first
WIDE or terminal among parent, grandparent and great-grandparent; (D) the
slot AABBs at the final slot ids. All of it is integer work, so the CUDA
kernel (`csrc/collapse_block.cu`) equals `collapse_block_reference` bit
for bit. A CUDA tensor launches the kernel (one launch over tiles of TILE
lanes that stage HALO lanes on either side); a CPU tensor takes the plain
version. The output does not depend on the tile size; where it would
depend on a lane beyond the halo, the kernel raises.
"""
from __future__ import annotations

import threading

import torch

from ..utils import kernels, timer, work
from ..utils.platform import on_cuda

I32 = torch.int32
S_LEN = 33  # short node: leaf range of at most S_LEN leaves
_WIDE, _E1, _E2, _UNK = 0, 1, 2, 3
_CONST_TBL = 0b010101  # state s -> the constant table (s, s, s)
# doubling trips: 2^6 hops cover the longest short chain (<= S_LEN + 2)
N_TRIPS = max(3, (S_LEN + 2).bit_length())
TILE = 1024  # lanes one block owns (kTile in csrc/collapse_block.cu)
HALO = 128  # lanes staged on either side of a tile (kHalo)


def collapse_block(meta, node8, leaf8, carr, m: int):
    """Returns (outm i32[8, W], [outa0..outa3] i32[8, W]); dispatch by device.
    Under a running profiler the call is the span `bvh.collapse_block`."""
    with timer.span("bvh.collapse_block"):
        if on_cuda(meta):
            return _collapse_block_cuda(meta, node8, leaf8, carr, m)
        return collapse_block_reference(meta, node8, leaf8, carr, m)


def _pull(vals, t, m: int):
    """vals[t] at internal targets 0 <= t < m, else -1."""
    ok = (t >= 0) & (t < m)
    return torch.where(ok, vals[torch.where(ok, t, 0).to(torch.int64)], -1)


def _apply(table, s):
    return (table >> (2 * s)) & 3


def expand2(left, right, fetch, active=True):
    """The two largest-area-child expansions of the nodes with children
    (left, right), as the reference collapse makes them: the first max
    wins ties, area > 0 strictly, areas compared as i32 bits; only
    `active` nodes expand. `fetch(ids)` returns (area code (-1 off the
    internal nodes), left, right, payload rows [P, k]) at node ids.
    Returns (4 slot ids, their 4 payloads, count, e1, e2), e1/e2 -1 where
    that step did not expand."""
    fl, fr = fetch(left), fetch(right)
    neg = torch.full_like(left, -1)
    zero = torch.zeros_like(fl[3])
    s_id = [left, right, neg, neg]
    s_ac = [fl[0], fr[0], neg, neg]
    s_lc = [fl[1], fr[1], neg, neg]
    s_rc = [fl[2], fr[2], neg, neg]
    s_pl = [fl[3], fr[3], zero, zero]

    best1 = torch.maximum(s_ac[0], s_ac[1])
    pos1 = (s_ac[1] > s_ac[0]).to(I32)  # the first max wins ties
    do1 = (best1 > 0) & active
    e1 = torch.where(pos1 == 1, s_id[1], s_id[0])
    c1l = torch.where(pos1 == 1, s_lc[1], s_lc[0])
    c1r = torch.where(pos1 == 1, s_rc[1], s_rc[0])
    new_l, new_r = (c1l, *fetch(c1l)), (c1r, *fetch(c1r))
    for k, mk in ((0, do1 & (pos1 == 0)), (1, do1 & (pos1 == 1)), (2, do1)):
        nv = new_r if k == 2 else new_l
        s_id[k], s_ac[k], s_lc[k], s_rc[k] = (
            torch.where(mk, n, c) for c, n in zip((s_id[k], s_ac[k], s_lc[k], s_rc[k]), nv))
        s_pl[k] = torch.where(mk[None], nv[4], s_pl[k])
    count1 = 2 + do1.to(I32)

    best2 = torch.maximum(torch.maximum(s_ac[0], s_ac[1]), s_ac[2])
    pos2 = torch.where(s_ac[0] == best2, 0, torch.where(s_ac[1] == best2, 1, 2)).to(I32)
    do2 = (best2 > 0) & active
    pick = lambda vs: torch.where(pos2 == 0, vs[0], torch.where(pos2 == 1, vs[1], vs[2]))
    e2, c2l, c2r = pick(s_id), pick(s_lc), pick(s_rc)
    pl2l, pl2r = fetch(c2l)[3], fetch(c2r)[3]
    for k in range(3):
        mk = do2 & (pos2 == k)
        s_id[k] = torch.where(mk, c2l, s_id[k])
        s_pl[k] = torch.where(mk[None], pl2l, s_pl[k])
    for k in range(2, 4):
        mk = do2 & (count1 == k)
        s_id[k] = torch.where(mk, c2r, s_id[k])
        s_pl[k] = torch.where(mk[None], pl2r, s_pl[k])
    return s_id, s_pl, count1 + do2.to(I32), torch.where(do1, e1, -1), torch.where(do2, e2, -1)


def collapse_block_reference(meta, node8, leaf8, carr, m: int):
    """Plain PyTorch version (any device): per-lane gathers at the target
    ids, the expansion simulation of `collapse_fast`'s coarse stage
    (`expand2`), and pointer doubling of the states."""
    W = meta.shape[1]
    dev = meta.device
    lane = torch.arange(W, dtype=I32, device=dev)
    area, left, right, parent = meta[0], meta[1], meta[2], meta[3]
    seed = meta[4] >> 23
    e2in = (meta[4] & ((1 << 23) - 1)) - 1
    own_in = meta[6] - 1
    has_own = meta[6] > 0
    is_int = lane < m
    shortv = (meta[5] == 1) & is_int
    neg1 = torch.full((W,), -1, dtype=I32, device=dev)
    pull = lambda v, t: _pull(v, t, m)

    # ---- (A) expansion tables (no payload: (D) loads at the final ids) ----
    def fetch(t):
        ac = torch.where((t >= 0) & (t < m), pull(area, t), -1)
        return ac, pull(left, t), pull(right, t), meta[:0]

    s_id, _, count2, e1_out, e2_out = expand2(left, right, fetch, shortv)

    # ---- (B) states: transition tables composed by pointer doubling ----
    e2_full = torch.where(shortv, e2_out, e2in)
    e1p, e2p = pull(e1_out, parent), pull(e2_out, parent)
    e2g = pull(pull(e2_full, parent), parent)  # e2 at the grandparent
    t_wide = torch.where(lane == e1p, _E1, torch.where(lane == e2p, _E2, _WIDE)).to(I32)
    t_e1 = torch.where(lane == e2g, _E2, _WIDE).to(I32)
    fenc = t_wide | (t_e1 << 2)  # f(WIDE), f(E1); f(E2) = WIDE
    seeded = (seed <= 2) | (parent < 0)
    seed_eff = torch.where(seed <= 2, seed, _WIDE)
    fenc = torch.where(seeded, seed_eff * _CONST_TBL, fenc)
    safe_lane = torch.clamp(lane, 0, max(m - 1, 0))
    ptr = torch.where(seeded | ~is_int, safe_lane, parent)
    packed = ptr * 64 + fenc
    for _ in range(N_TRIPS):
        pulled = packed[(packed >> 6).to(torch.int64)]
        fp, f = pulled & 63, packed & 63
        nf = (_apply(f, _apply(fp, 0)) | (_apply(f, _apply(fp, 1)) << 2)
              | (_apply(f, _apply(fp, 2)) << 4))
        packed = (pulled & ~63) | nf
    top = (packed >> 6).to(torch.int64)
    if not torch.equal(packed[top] >> 6, packed >> 6):
        raise RuntimeError("collapse_block: a parent chain is longer than the doubling covers")
    state = packed & 3
    is_wide = (state == _WIDE) & shortv

    # ---- (C) ownership claims along the wide-ancestor chain ----
    term_claim = torch.where(state == _WIDE, lane, own_in)
    pk_row = torch.where(is_int & has_own, (term_claim + 1) * 4 + 3,
                         torch.where(is_int, (parent + 1) * 4 + torch.clamp(state, max=2), -1))
    dec = lambda pk: torch.where(pk >= 0, (pk >> 2) - 1, -1)
    leafp = meta[7]
    prev = torch.cat([neg1[:1], pk_row[:-1]])  # pk_row at lane - 1
    pk_q = torch.where(leafp == lane, pk_row, torch.where(leafp == lane - 1, prev, -1))
    pq = dec(pk_q)
    pk_p, pk_pq = pull(pk_row, parent), pull(pk_row, pq)
    gp, gpq = dec(pk_p), dec(pk_pq)
    pk_gp, pk_gpq = pull(pk_row, gp), pull(pk_row, gpq)
    ggp = dec(pk_gp)
    pk_ggp = pull(pk_row, ggp)

    def first_wide(cands):
        c = neg1
        for t, pk in reversed(cands):
            hit_w = (pk >= 0) & ((pk & 3) == _WIDE)
            hit_t = (pk >= 0) & ((pk & 3) == 3)  # seed terminal
            c = torch.where(hit_w, t, torch.where(hit_t, (pk >> 2) - 1, c))
        return c

    claim_int = torch.where(
        is_wide & (parent >= 0),
        torch.where(has_own, own_in, first_wide([(parent, pk_p), (gp, pk_gp), (ggp, pk_ggp)])),
        -1)
    claim_leaf = torch.where(
        (lane < m + 1) & (leafp >= 0),
        first_wide([(leafp, pk_q), (pq, pk_pq), (gpq, pk_gpq)]), -1)

    # ---- (D) slot AABBs at the final slot ids, and the outputs ----
    cw = carr[5] == 1
    outm = torch.stack(
        [torch.where(cw, carr[k], torch.where(is_wide, s_id[k], -1)) for k in range(4)]
        + [torch.where(cw, carr[4], torch.where(is_wide, count2, 0)),
           torch.where(is_int, state, _UNK),
           torch.where(cw, own_in, claim_int),
           claim_leaf])
    zeros2 = torch.zeros((2, W), dtype=I32, device=dev)
    outa = []
    for k, sid in enumerate(s_id):
        is_node = (sid >= 0) & (sid < m)
        col = torch.where(is_node, sid, torch.where(sid >= m, sid - m, 0)).to(torch.int64)
        ab = torch.where(is_node, node8[:, col], torch.where(sid >= m, leaf8[:, col], 0))
        c_ab = torch.cat([carr[6 + 6 * k:12 + 6 * k], zeros2])
        outa.append(torch.where(cw, c_ab, torch.where(is_wide, ab, 0)))
    return outm, outa


ERR_CHAIN, ERR_WINDOW = 1, 2  # the kernel's error flag bits (kErrChain, kErrWindow)
# the kernel's error words, zero between calls: one for each thread and, in
# it, each (device, stream), so that calls in flight on other streams or
# from other threads never set, read or clear each other's word
_err = threading.local()


def _collapse_block_cuda(meta, node8, leaf8, carr, m: int):
    outm, outa, err = launch(meta, node8, leaf8, carr, m)
    check_flag(err)
    return outm, outa


def launch(meta, node8, leaf8, carr, m: int):
    """Launch B3 on the current stream; returns (outm, outa, its error word
    i32[1]) without reading the word, so that a caller can queue the work
    that follows before it reads the word with `check_flag`."""
    W = meta.shape[1]
    for name, x, rows in (("meta", meta, 8), ("node8", node8, 8), ("leaf8", leaf8, 8),
                          ("carr", carr, 32)):
        kernels.require(x, name, I32, (rows, W))
    if not 1 <= m < W:
        raise ValueError(f"collapse_block needs 1 <= m < W, got m={m}, W={W}")
    dev = meta.device
    stream = kernels.stream_of(meta)
    words = vars(_err).setdefault("words", {})
    err = words.get((dev, stream))
    if err is None:
        err = words[(dev, stream)] = torch.zeros((1,), dtype=I32, device=dev)
    outm = torch.empty((8, W), dtype=I32, device=dev)
    outa = torch.empty((4, 8, W), dtype=I32, device=dev)
    kernels.launch("collapse_block", "tbvh_collapse_block", meta, node8, leaf8, carr, W, m, err,
                   outm, outa, like=meta,
                   count=lambda: work.collapse_block(meta, carr, outm, outa, m),
                   symbols="collapse_block_kernel")
    return outm, list(outa.unbind(0)), err


def check_flag(err) -> None:
    """Read B3's error word (one host sync); raise, after zeroing it, where
    the kernel set it."""
    flag = int(err)  # one host sync
    timer.count_host_sync()
    if flag:
        err.zero_()
        if flag & ERR_CHAIN:
            raise RuntimeError("collapse_block: a short node's parent chain exceeds "
                               f"S_LEN + 2 = {S_LEN + 2} hops (the input is not a short-node tree)")
        raise RuntimeError(f"collapse_block: an output depends on a lane more than HALO = {HALO} "
                           "lanes outside its block's tile")
