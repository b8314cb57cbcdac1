"""The one-launch psv/nsv scan of `csrc/psv_scan.cuh` (B12/B13, B14, and B1
through its child epilogue in `csrc/scan32.cu`), held on the CPU by a
plain-torch emulation of the kernel's schedule.

The emulation follows the kernel step by step: the six bit planes of a
warp's deltas (its ballots), each lane's comparator masks (rows of the
warp below a threshold) for thresholds lane and lane + 32 and for its own
row, the warps' last and first hitting rows, their exclusive scan over a
tile's warps as the last earlier (first later) warp with a hit, the tile
totals and each row's answer within its tile, the blocks' totals and hit
masks over contiguous runs of tiles, each block's carry-in from the last
earlier (first later) block that hits, its tiles' exclusive carries, and
the carry a row without an answer in
its tile takes; for B1 the epilogue that splits the packed keys and
scatters each child into its parent's slot, counting the writes to every
slot. It runs at the kernel's tile (`threshold_core.TILE`, the mirror of
`kTile`) and at a tile of 64 rows, so that a few hundred rows span many
tiles, on grids of one block, a few blocks and one block a tile. Every
output must equal the plain versions and the Pallas kernels (interpret
mode) exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bvh.ops.pallas import scan32 as jscan32
from tpu_bvh.ops.pallas import threshold_core as jtc
from tpu_bvh_torch.models import lbvh
from tpu_bvh_torch.ops import radix_tree, scan32, threshold_core
from tpu_bvh_torch.utils import scenes

V = threshold_core.V
BIG = threshold_core.BIG
WARP = 32
PAD = 63  # the delta of a row past the end (kPad)
FULL = 0xFFFFFFFF
SIZES = [1, 2, 31, 32, 33, 1023, 1024, 1025]
SMALL_TILE = 64


def _last_bit(x):
    """Index of the highest set bit of each x (i64 in [0, 2^32)), -1 for 0."""
    e = torch.frexp(x.to(torch.float64)).exponent.to(torch.int64) - 1
    return torch.where(x == 0, -1, e)


def _first_bit(x):
    return _last_bit(x & -x)


def _compare(planes, q):
    """Per warp row and query q [W, K]: the masks of the warp's rows with
    d < q and with d == q, by the comparator over the bit planes [W, 6],
    high bit first."""
    lt = torch.zeros_like(q)
    eq = torch.full_like(q, FULL)
    for b in range(5, -1, -1):
        pb = planes[:, b:b + 1]
        qb = torch.where((q >> b) & 1 == 1, FULL, 0)
        lt = lt | (eq & ~pb & qb)
        eq = eq & ~(pb ^ qb) & FULL
    return lt, eq


def _less_mask(planes, q):
    return _compare(planes, q)[0]


def _runs(nt, blocks):
    """Each block's contiguous run of tiles [t0, t1), as the kernel deals them."""
    g = min(blocks, nt)
    return [(nt * b // g, nt * (b + 1) // g) for b in range(g)]


def schedule(d, tile, blocks, le=False):
    """(psv, nsv) i64[m] of the kernel's schedule on deltas d in [0, 63];
    with `le` also (pl, nl), the same with d[j] <= q (an Op with kLe: the
    threshold q + 1 of the same scans, the neighbours at q = 63)."""
    m = d.shape[0]
    nt = -(-m // tile)
    wpt = tile // WARP
    dw = torch.full((nt * tile,), PAD, dtype=torch.int64)
    dw[:m] = d
    dw = dw.view(nt * wpt, WARP)
    lane = torch.arange(WARP)
    planes = torch.stack([(((dw >> b) & 1) << lane).sum(1) for b in range(6)], 1)
    base = torch.arange(nt * wpt)[:, None] * WARP

    # the warps' last and first hitting rows at every threshold
    mk = _less_mask(planes, torch.arange(V).expand(nt * wpt, V))
    last, first = _last_bit(mk), _first_bit(mk)
    w_p = torch.where(last >= 0, 64 * (base + last) + dw.gather(1, last.clamp(min=0)), -1)
    w_n = torch.where(first >= 0, 64 * (base + first) + dw.gather(1, first.clamp(min=0)), BIG)
    w_p, w_n = w_p.view(nt, wpt, V), w_n.view(nt, wpt, V)

    # phase 1: exclusive scans over each tile's warps (the last earlier /
    # first later warp with a hit, by a ballot over the warps), the tile
    # totals, and each row's answer within its tile: the nearest hit of its
    # own mask in its warp, else the scan at its q
    hit = ((w_p >= 0).long() << torch.arange(wpt)[None, :, None]).sum(1, keepdim=True)
    w = torch.arange(wpt)[None, :, None]
    wb, wa = _last_bit(hit & ((1 << w) - 1)), _first_bit(hit & ~((2 << w) - 1))
    ex_p = torch.where(wb >= 0, w_p.gather(1, wb.clamp(min=0)), -1).reshape(-1, V)
    ex_n = torch.where(wa >= 0, w_n.gather(1, wa.clamp(min=0)), BIG).reshape(-1, V)
    t_p = w_p.gather(1, _last_bit(hit).clamp(min=0))[:, 0]
    t_n = w_n.gather(1, _first_bit(hit).clamp(min=0))[:, 0]
    t_p = torch.where(hit[:, 0] > 0, t_p, -1)
    t_n = torch.where(hit[:, 0] > 0, t_n, BIG)
    mk, eq = _compare(planes, dw)

    def in_tile(mk, q):
        before = mk & ((1 << lane) - 1)
        after = mk & ~((2 << lane) - 1) & FULL
        jb, ja = _last_bit(before), _first_bit(after)
        return (torch.where(jb >= 0, 64 * (base + jb) + dw.gather(1, jb.clamp(min=0)),
                            ex_p.gather(1, q)),
                torch.where(ja >= 0, 64 * (base + ja) + dw.gather(1, ja.clamp(min=0)),
                            ex_n.gather(1, q)))

    p, n = in_tile(mk, dw)
    q1 = (dw + 1).clamp(max=V - 1)
    pl, nl = in_tile(mk | eq, q1)

    # the blocks' totals and hit masks; phase 2: each block's carry-in (the
    # total of the last earlier / first later block whose mask has v),
    # then its tiles' exclusive carries
    runs = _runs(nt, blocks)
    b_p = torch.stack([t_p[a:z].amax(0) for a, z in runs])
    b_n = torch.stack([t_n[a:z].amin(0) for a, z in runs])
    b_hit = b_p >= 0
    c_p, c_n = torch.empty_like(t_p), torch.empty_like(t_n)
    for b, (a, z) in enumerate(runs):
        cp, cn = torch.full((V,), -1), torch.full((V,), BIG)
        for v in range(V):
            earlier = torch.nonzero(b_hit[:b, v])
            later = torch.nonzero(b_hit[b + 1:, v])
            if earlier.numel():
                cp[v] = b_p[earlier[-1, 0], v]
            if later.numel():
                cn[v] = b_n[b + 1 + later[0, 0], v]
        for t in range(a, z):
            c_p[t], cp = cp, torch.maximum(cp, t_p[t])
        for t in range(z - 1, a - 1, -1):
            c_n[t], cn = cn, torch.minimum(cn, t_n[t])

    # phase 3: a row without an answer in its tile takes its tile's carry
    tile = (torch.arange(nt * wpt) // wpt)[:, None].expand(-1, WARP)
    p = torch.where(p >= 0, p, c_p[tile, dw])
    n = torch.where(n != BIG, n, c_n[tile, dw])
    if not le:
        return p.reshape(-1)[:m], n.reshape(-1)[:m]
    pl = torch.where(pl >= 0, pl, c_p[tile, q1]).reshape(-1)[:m]
    nl = torch.where(nl != BIG, nl, c_n[tile, q1]).reshape(-1)[:m]
    i = torch.arange(m)
    key = 64 * i + d.to(torch.int64)
    top = d == V - 1  # every row has d <= 63: the neighbouring rows
    pl = torch.where(top, torch.cat([torch.tensor([-1]), key[:-1]]), pl)
    nl = torch.where(top, torch.cat([key[1:], torch.tensor([BIG])]), nl)
    return p.reshape(-1)[:m], n.reshape(-1)[:m], pl, nl


def payload(p, n, pay):
    """The payload epilogue (B14): pay at each answer, -1 where none."""
    pay = pay.to(torch.int64)
    pp = torch.where(p >= 0, pay[(p >> 6).clamp(min=0)], -1)
    np_ = torch.where(n != BIG, pay[(n >> 6).clamp(max=pay.numel() - 1)], -1)
    return pp, np_


def child_positions(d, tile, blocks):
    """B15 by the kernel's one pass: ns (strict), pl and nl (<=) from the
    schedule with `le`, left and right -1, then each row j writes itself
    into left[ns(j)] where pl(ns(j)) = pl(j) and into right[pl(j)] where
    nl(pl(j)) = ns(j). Returns (left, right) and the writes to each slot."""
    m = d.shape[0]
    _, ns, pl, nl = schedule(d, tile, blocks, le=True)
    j = torch.arange(m)
    left = torch.full((m,), -1, dtype=torch.int64)
    right = left.clone()
    writes_l = torch.zeros(m, dtype=torch.int64)
    writes_r = writes_l.clone()
    to_l = (ns != BIG) & (pl[(ns >> 6).clamp(max=m - 1)] == pl)
    to_r = (pl >= 0) & (nl[(pl >> 6).clamp(min=0)] == ns)
    for out, writes, at, who in ((left, writes_l, ns[to_l] >> 6, j[to_l]),
                                 (right, writes_r, pl[to_r] >> 6, j[to_r])):
        out[at] = who
        writes.index_add_(0, at, torch.ones_like(at))
    return (left.to(torch.int32), right.to(torch.int32)), writes_l, writes_r


def topology(dlt_raw, tile, blocks):
    """B1's six outputs by the kernel's schedule and child epilogue, and the
    number of writes each lc / rc slot took."""
    raw = dlt_raw.to(torch.int64)
    d = torch.where(raw <= 31, raw - 2, raw - 11)
    m = d.shape[0]
    p, n = schedule(d, tile, blocks)
    hp, hn = p >= 0, n != BIG
    dp, dn = torch.where(hp, p & 63, -1), torch.where(hn, n & 63, -1)
    i = torch.arange(m)
    lc = torch.full((m,), -2, dtype=torch.int64)
    rc = lc.clone()
    writes_l = torch.zeros(m, dtype=torch.int64)
    writes_r = writes_l.clone()

    def put(out, writes, at, val):
        out[at] = val
        writes.index_add_(0, at, torch.ones_like(at))

    to_r = (hp | hn) & (dp > dn)  # boundary i is rc of psv i, else lc of nsv i
    to_l = (hp | hn) & ~(dp > dn)
    put(rc, writes_r, p[to_r] >> 6, i[to_r])
    put(lc, writes_l, n[to_l] >> 6, i[to_l])
    dprev = torch.cat([torch.tensor([-1]), d[:-1]])
    leaf_r = dprev > d  # leaf i is rc of i - 1, else lc of i
    put(rc, writes_r, i[leaf_r] - 1, torch.full_like(i[leaf_r], -1))
    put(lc, writes_l, i[~leaf_r], torch.full_like(i[~leaf_r], -1))
    put(rc, writes_r, torch.tensor([m - 1]), torch.tensor([-1]))  # leaf m
    outs = (torch.where(hp, p >> 6, -1), dp, lc, torch.where(hn, n >> 6, m), dn, rc)
    return tuple(x.to(torch.int32) for x in outs), writes_l, writes_r


def _grids(m):
    """(tile, blocks) schedules: the kernel's tile and a small one, each on
    one block, a few and one block a tile."""
    out = []
    for tile in (threshold_core.TILE, SMALL_TILE):
        nt = -(-m // tile)
        out += [(tile, g) for g in sorted({1, 2, 3, nt})]
    return out


_SPONZA = {}


def _sponza_codes(dup):
    if dup not in _SPONZA:
        tris = scenes.sponza_like(2048)
        if dup:
            rng = np.random.default_rng(0)
            tris = np.repeat(tris[rng.choice(len(tris), 64, replace=False)], 32, axis=0)
        _SPONZA[dup] = lbvh._sorted_leaves_from_tris(torch.from_numpy(tris), True)[0]
    return _SPONZA[dup]


def _raw_deltas(kind, m):
    """Raw adjacent deltas of m + 1 sorted codes."""
    if kind in ("sponza", "dup"):
        codes = _sponza_codes(kind == "dup")[:m + 1]
    elif kind == "all_equal":
        codes = torch.full((m + 1,), 12345, dtype=torch.int64)
    else:  # random 30-bit codes
        codes = torch.from_numpy(np.sort(np.random.default_rng(m).integers(0, 1 << 30, m + 1)))
    return radix_tree.adjacent_deltas(codes)


def _deltas(kind, m):
    """Deltas in [0, 63]: the remapped deltas of sorted codes, or draws."""
    if kind == "draws":
        return torch.from_numpy(np.random.default_rng(m + 7).integers(0, 64, m).astype(np.int32))
    return scan32.remap_deltas(_raw_deltas(kind, m))


@pytest.mark.parametrize("kind", ["sponza", "dup", "all_equal", "draws"])
@pytest.mark.parametrize("m", SIZES)
def test_schedule_matches_plain_psv_nsv_and_payload(kind, m):
    """B12/B13 and B14 on every schedule against their plain versions."""
    d = _deltas(kind, m)
    pay = torch.from_numpy(np.random.default_rng(m).integers(0, 1 << 22, m).astype(np.int32))
    want = threshold_core.psv_nsv_payload_reference(d, pay)
    assert torch.equal(torch.stack(threshold_core.psv_nsv_packed_reference(d)),
                       torch.stack([want[0], want[2]]))
    for tile, blocks in _grids(m):
        p, n = schedule(d, tile, blocks)
        pp, np_ = payload(p, n, pay)
        for g, w in zip((p, pp, n, np_), want):
            assert torch.equal(g.to(torch.int32), w), (tile, blocks)


@pytest.mark.parametrize("m", SIZES)
def test_schedule_matches_pallas_lanes(m):
    """The kernel's schedule on draws in [0, 63] against the lane-layout
    Pallas kernel (B13) in interpret mode."""
    d = _deltas("draws", m)
    want = jtc.psv_nsv_packed_lanes(jnp.asarray(d.numpy()), interpret=True)
    for tile, blocks in ((threshold_core.TILE, 1), (SMALL_TILE, 3)):
        for g, w in zip(schedule(d, tile, blocks), want):
            np.testing.assert_array_equal(g.to(torch.int32).numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["sponza", "dup", "all_equal", "random"])
@pytest.mark.parametrize("m", SIZES)
def test_topology_epilogue_matches_plain(kind, m):
    """B1: the schedule with the child epilogue writes every lc / rc slot
    exactly once and equals `scan_core_reference` on every schedule."""
    dlt_raw = _raw_deltas(kind, m)
    want = scan32.scan_core_reference(dlt_raw)
    for tile, blocks in _grids(m):
        got, writes_l, writes_r = topology(dlt_raw, tile, blocks)
        assert bool((writes_l == 1).all()) and bool((writes_r == 1).all()), (tile, blocks)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (tile, blocks)


@pytest.mark.parametrize("kind", ["sponza", "dup"])
@pytest.mark.parametrize("m", SIZES)
def test_topology_epilogue_matches_pallas(kind, m):
    """B1's schedule against the Pallas topology scan in interpret mode."""
    dlt_raw = _raw_deltas(kind, m)
    want = jscan32.scan_core(jnp.asarray(dlt_raw.numpy()), interpret=True)
    got = topology(dlt_raw, SMALL_TILE, 3)[0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["sponza", "dup", "all_equal", "equal", "draws", "soup"])
@pytest.mark.parametrize("m", SIZES)
def test_child_one_pass_matches_jax(kind, m):
    """B15's one pass (ns, pl, nl from the less and equal masks, then the
    scatter) writes each slot at most once and equals JAX's
    `child_positions_reference` and the port's plain version, on every
    schedule: the deltas of sorted codes, every delta equal, draws in
    [0, 63], and a soup of a few repeated values."""
    if kind == "soup":
        d = torch.from_numpy(np.random.default_rng(m + 3).choice(
            np.array([0, 5, 5, 17, 62, 63], np.int32), m))
    elif kind == "equal":
        d = torch.full((m,), 7, dtype=torch.int32)
    else:
        d = _deltas(kind, m)
    want = jtc.child_positions_reference(jnp.asarray(d.numpy()))
    plain = threshold_core.child_positions_reference(d)
    for tile, blocks in _grids(m):
        got, writes_l, writes_r = child_positions(d, tile, blocks)
        assert int(writes_l.max()) <= 1 and int(writes_r.max()) <= 1, (tile, blocks)
        for g, w, pw in zip(got, want, plain):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{tile}, {blocks}")
            assert torch.equal(g, pw), (tile, blocks)
