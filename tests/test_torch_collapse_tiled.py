"""The one-launch schedule of B3, the collapse kernel
(`csrc/collapse_block.cu`), held on the CPU by a plain-torch emulation.

A block owns the T lanes [t0, t0 + T) and stages the meta rows of the lanes
within H of them. Phase A (the expansions) runs for every staged lane;
phase B walks every staged internal lane's parent chain, which needs phase
A's rows at short lanes: a walk that needs one outside the window stops
unresolved. Phases C and D run for the block's own lanes: the claims walk
the packed claim rows only up to the first WIDE or seed terminal. An input
row is read from global memory where a lane is not staged, and a seeded
lane's claim row is computed in place from its own meta; an output that
needs an unresolved state or a claim row outside the window sets the
error flag. The emulation runs all tiles at once ([tiles, window lanes])
with T = 64 and 256, so a scene spans many tiles, and must equal
`collapse_block_reference`; it also measures the reach (the largest
distance from a tile of a computed row its outputs need), which must be at
most the kernel's HALO, and shows that a halo one lane short of the reach
sets the error flag instead of giving a wrong answer.
"""
import numpy as np
import pytest
import torch

from tests.conftest import random_tris
from tpu_bvh_torch.models import lbvh
from tpu_bvh_torch.ops import collapse_block as cb
from tpu_bvh_torch.ops import collapse_fast
from tpu_bvh_torch.utils import scenes

I64 = torch.int64
OUTSIDE, BAD_CHAIN = -2, -3  # the kernel's kOutside, kBadChain


def tiled(meta, node8, leaf8, carr, m, tile, halo):
    """(outm, outa, error flag, reach) of the kernel's schedule."""
    M = meta.long()
    W = M.shape[1]
    idx = torch.arange(W)
    nt = -(-W // tile)
    t0 = (torch.arange(nt) * tile)[:, None]
    w0 = t0 - halo
    lane = w0 + torch.arange(tile + 2 * halo)[None]  # [tiles, window]
    staged = (lane >= 0) & (lane < W)

    def dist(t):
        return torch.clamp(torch.maximum(t0 - t, t - (t0 + tile - 1)), min=0)

    g = lambda r, t: M[r][t.clamp(0, W - 1)]  # an input row: staged or global, same words
    short = (M[5] == 1) & (idx < m)
    # phase A: a pure function of meta (the plain version's expansion)
    fetch = lambda t: (torch.where((t >= 0) & (t < m), cb._pull(M[0], t, m), -1),
                       cb._pull(M[1], t, m), cb._pull(M[2], t, m), M[:0])
    s_id, _, count, e1, e2 = cb.expand2(M[1], M[2], fetch, short)
    e2f = torch.where(short, e2, (M[4] & ((1 << 23) - 1)) - 1)
    seeded = ((M[4] >> 23) <= 2) | (M[3] < 0)
    seed_eff = torch.where((M[4] >> 23) <= 2, M[4] >> 23, cb._WIDE)
    err = 0

    def claim_row(t, state):
        ownp1 = g(6, t)
        claim = torch.where(state == cb._WIDE, t, ownp1 - 1)
        return torch.where(ownp1 > 0, (claim + 1) * 4 + 3, (g(3, t) + 1) * 4 + state.clamp(max=2))

    # phase B: every staged internal lane walks its chain, hop by hop
    internal = staged & (lane < m)
    x = lane.clamp(0, W - 1)
    tbl = torch.full_like(lane, 0 | (1 << 2) | (2 << 4))
    res = torch.full_like(lane, cb._UNK)
    areach = torch.zeros_like(lane)  # the farthest phase-A row a walk read
    run = internal.clone()
    for hops in range(cb.S_LEN + 3):
        seed, par = g(4, x) >> 23, g(3, x)
        term = run & ((seed <= 2) | (par < 0))
        res = torch.where(term, cb._apply(tbl, torch.where(seed <= 2, seed, cb._WIDE)), res)
        run &= ~term
        bad = run & ((hops == cb.S_LEN + 2) | (par >= m))
        res = torch.where(bad, BAD_CHAIN, res)
        err |= cb.ERR_CHAIN if bool(bad.any()) else 0
        run &= ~bad
        pc = par.clamp(0, W - 1)
        gp = g(3, pc)
        gc = gp.clamp(0, W - 1)
        need_p = run & short[pc]
        need_g = run & (gp >= 0) & (gp < m) & short[gc]
        areach = torch.where(need_p, torch.maximum(areach, dist(par)), areach)
        areach = torch.where(need_g, torch.maximum(areach, dist(gp)), areach)
        out = (need_p & (dist(par) > halo)) | (need_g & (dist(gp) > halo))
        res = torch.where(out, OUTSIDE, res)
        run &= ~out
        e2g = torch.where((gp >= 0) & (gp < m), e2f[gc], -1)
        t_wide = torch.where(x == e1[pc], cb._E1, torch.where(x == e2[pc], cb._E2, cb._WIDE))
        f = t_wide | (torch.where(x == e2g, cb._E2, cb._WIDE) << 2)
        composed = (cb._apply(tbl, cb._apply(f, 0)) | (cb._apply(tbl, cb._apply(f, 1)) << 2)
                    | (cb._apply(tbl, cb._apply(f, 2)) << 4))
        tbl = torch.where(run, composed, tbl)
        x = torch.where(run, pc, x)
    assert not bool(run.any())
    rows_b = claim_row(lane.clamp(0, W - 1), res.clamp(min=0))
    pk_w = torch.where(lane >= m, -1, torch.where(res >= 0, rows_b, OUTSIDE))

    # phases C and D: the block's own lanes
    i = lane[:, halo:halo + tile]
    own = i < W
    reach = int(areach[:, halo:halo + tile][own & (i < m)].max()) if m else 0
    state = res[:, halo:halo + tile]
    if bool((own & (i < m) & (state == OUTSIDE)).any()):
        err |= cb.ERR_WINDOW

    def pk_at(t, need):
        nonlocal err, reach
        tc = t.clamp(0, W - 1)
        inside = need & (t >= 0) & (t < m)
        in_place = claim_row(tc, seed_eff[tc])
        k = (t - w0).clamp(0, lane.shape[1] - 1)
        from_window = pk_w.gather(1, k)
        far = inside & ~seeded[tc]
        if bool(far.any()):
            reach = max(reach, int(torch.maximum(dist(t), areach.gather(1, k))[far].max()))
        lost = far & ((dist(t) > halo) | (from_window == OUTSIDE))
        err |= cb.ERR_WINDOW if bool(lost.any()) else 0
        v = torch.where(seeded[tc], in_place, torch.where(from_window >= 0, from_window, -1))
        return torch.where(inside, v, -1)

    def first_wide(t, pk, live):
        c = torch.full_like(t, -1)
        for k in range(3):
            hit_w = live & (pk >= 0) & ((pk & 3) == cb._WIDE)
            hit_t = live & (pk >= 0) & ((pk & 3) == 3)
            c = torch.where(hit_w, t, torch.where(hit_t, (pk >> 2) - 1, c))
            live = live & ~(hit_w | hit_t)
            if k < 2:
                t = torch.where(pk >= 0, (pk >> 2) - 1, -1)
                pk = pk_at(t, live)
        return c

    ic = i.clamp(0, W - 1)
    is_wide = own & (i < m) & (state == cb._WIDE) & short[ic]
    parent, ownp1, leafp = g(3, ic), g(6, ic), g(7, ic)
    walk = is_wide & (parent >= 0) & (ownp1 <= 0)
    claim_int = torch.where(is_wide & (parent >= 0), torch.where(
        ownp1 > 0, ownp1 - 1, first_wide(parent, pk_at(parent, walk), walk)), -1)
    lq = own & (i < m + 1) & (leafp >= 0)
    pk_q = torch.where(leafp == i, pk_at(i, lq & (leafp == i)),
                       torch.where(leafp == i - 1, pk_at(i - 1, lq & (leafp == i - 1)), -1))
    claim_leaf = torch.where(lq, first_wide(leafp, pk_q, lq), -1)

    # the outputs, lane-major again
    flat = lambda v: v[own]
    lanes = flat(i)
    assert torch.equal(lanes, idx)
    is_wide, state = flat(is_wide), torch.where(lanes < m, flat(state), cb._UNK)
    C = carr.long()
    cw = C[5] == 1
    outm = torch.stack(
        [torch.where(cw, C[k], torch.where(is_wide, s_id[k], -1)) for k in range(4)]
        + [torch.where(cw, C[4], torch.where(is_wide, count, 0)), state,
           torch.where(cw, M[6] - 1, flat(claim_int)), flat(claim_leaf)])
    outa = []
    for k, sid in enumerate(s_id):
        col = torch.where((sid >= 0) & (sid < m), sid, torch.where(sid >= m, sid - m, 0))
        ab = torch.where((sid >= 0) & (sid < m), node8.long()[:, col],
                         torch.where(sid >= m, leaf8.long()[:, col], 0))
        c_ab = torch.cat([C[6 + 6 * k:12 + 6 * k], torch.zeros((2, W), dtype=I64)])
        outa.append(torch.where(cw, c_ab, torch.where(is_wide, ab, 0)).to(torch.int32))
    return outm.to(torch.int32), outa, err, reach


def _scene(name):
    if name == "sponza_like":
        return scenes.sponza_like(4096)
    if name == "dup":
        return np.repeat(random_tris(np.random.default_rng(1234), 64), 16, axis=0)
    return scenes.caterpillar()


@pytest.fixture(scope="module", params=["sponza_like", "dup", "caterpillar"])
def rows(request):
    bvh, parent, first, last = lbvh.build_single_pass_aux(torch.from_numpy(_scene(request.param)))
    m = bvh.n_internal
    rows = collapse_fast.kernel_inputs(bvh, parent, first, last)
    return rows, m, cb.collapse_block_reference(*rows, m)


def assert_same(got_m, got_a, want):
    want_m, want_a = want
    assert got_m.numpy().tobytes() == want_m.numpy().tobytes()
    for g, w in zip(got_a, want_a):
        assert g.numpy().tobytes() == w.numpy().tobytes()


@pytest.mark.parametrize("tile", [64, 256])
def test_tile_schedule_equals_plain(rows, tile):
    (meta, node8, leaf8, carr), m, want = rows
    got_m, got_a, err, reach = tiled(meta, node8, leaf8, carr, m, tile, cb.HALO)
    assert err == 0 and reach <= cb.HALO
    assert_same(got_m, got_a, want)


def test_reach_fits_the_halo_and_a_shorter_halo_raises(rows):
    """With every lane staged the emulation measures the reach; a halo of
    the reach gives the plain answer, one lane less sets the flag."""
    (meta, node8, leaf8, carr), m, want = rows
    W = meta.shape[1]
    _, _, err, reach = tiled(meta, node8, leaf8, carr, m, 64, W)
    assert err == 0 and 0 < reach <= cb.HALO
    got_m, got_a, err, _ = tiled(meta, node8, leaf8, carr, m, 64, reach)
    assert err == 0
    assert_same(got_m, got_a, want)
    assert tiled(meta, node8, leaf8, carr, m, 64, reach - 1)[2] & cb.ERR_WINDOW
