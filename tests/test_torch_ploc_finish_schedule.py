"""The schedule of B7's thread-block-cluster finisher (`csrc/ploc_finish.cu`),
held on the CPU by a plain-torch emulation against `ploc_finish_reference`.

The kernel runs every remaining PLOC/HPLOC round in one launch, in three
regimes picked round by round by the live count nc:

* wide (nc > one_cta_at): C CTAs, CTA r holding the lanes [r*S, r*S + S),
  S = ceil(nc / C), in its own buffer. Each CTA reads the 2R lanes on each
  side of its slice from the CTAs that own them (its halo), computes the
  forward pair areas of lanes -2R..n+R-1 and best_rel of lanes -R..n+R-1
  from that view alone, flags and counts its own lanes, and takes its
  global ranks from the per-CTA totals. Survivors go to the CTA that owns
  their global rank under the next round's slicing;
* one CTA (32 < nc <= one_cta_at): the same round in CTA 0 alone;
* one warp (nc <= 32): 32 lanes, pair areas by shuffles (a lane past the
  warp reads its own value, which the guards never use), ranks by ballots,
  lanes past the live count keeping stale values.

The emulation runs exactly that data movement (each CTA sees only its
buffer and its halo, and lanes outside [0, nc) hold junk), at small widths
with C and the thresholds as parameters, on states whose segment borders
and mutual pairs straddle slice borders, with signed zeros and equal
areas, at shift steps 3 and 6. Every node column must equal the plain
finisher's bit for bit, and each regime must have run.
"""
import numpy as np
import pytest
import torch

from tests.conftest import random_tris
from tpu_bvh_torch.models import lbvh
from tpu_bvh_torch.ops import ploc as ploc_ops
from tpu_bvh_torch.ops import ploc_nn, ploc_round

I32, F32 = torch.int32, torch.float32
BIG = ploc_nn.BIG
R = 8
WARP = 32  # lanes of the one-warp regime (kWarpAt in the .cu)
JUNK = -7  # what lanes outside [0, nc) hold in a view


def _area(a, b):
    """The union area of packed boxes a, b (f32[6, m]), in ploc_common.cuh's order."""
    return ploc_nn.area6(ploc_nn.fmin(a, b))


def _view_round(view, lo, n, nc, shift, radius):
    """One CTA's NN stage on its view i32[8, n + 4R] (columns = lanes
    lo - 2R .. lo + n + 2R - 1). Returns best_rel and has_nn of lanes
    lo - R .. lo + n + R - 1 (i64[n + 2R], bool[n + 2R])."""
    lanes = lo - 2 * R + torch.arange(n + 4 * R)
    valid = (lanes >= 0) & (lanes < nc)
    cols = view[0:6].contiguous().view(F32)
    seg = ploc_nn.segments(view[6], shift)
    aw = n + 3 * R  # forward areas of lanes -2R .. n + R - 1
    e = torch.arange(aw)
    area = torch.full((R, aw), BIG)
    for d in range(1, radius + 1):
        ok = valid[e] & (lanes[e] + d < nc) & (seg[e] == seg[e + d])
        area[d - 1] = torch.where(ok, _area(cols[:, e], cols[:, e + d]), BIG)
    e = torch.arange(n + 2 * R)
    c = e + R  # area column of lane e - R
    best = torch.full((n + 2 * R,), BIG)
    rel = torch.zeros(n + 2 * R, dtype=torch.int64)
    for d in range(1, radius + 1):
        a = area[d - 1, c]
        better = a < best
        best, rel = torch.where(better, a, best), torch.where(better, d, rel)
    for d in range(1, radius + 1):
        a = area[d - 1, c - d]  # the pair (l - d, l) from its left lane
        better = (a < best) | ((a == best) & (-d < rel))
        best, rel = torch.where(better, a, best), torch.where(better, -d, rel)
    return rel, best < BIG


def _warp_rounds(state, nc, nc0, shift, step, base, radius, nodes, rounds, limit, count):
    """The one-warp regime on state i32[8, 32] (lane i = cluster i; lanes
    >= nc stale). Returns the live count."""
    lane = torch.arange(WARP)
    while nc > 1 and rounds[0] < limit:
        count["warp"] += 1
        cols = state[0:6].contiguous().view(F32)
        seg = ploc_nn.segments(state[6], shift)
        valid = lane < nc
        src = lambda off: torch.where((lane + off >= 0) & (lane + off < WARP), lane + off, lane)
        fa, best = [], torch.full((WARP,), BIG)
        rel = torch.zeros(WARP, dtype=torch.int64)
        for d in range(1, R + 1):  # shfl_down: a lane past the warp reads its own
            s = src(d)
            ok = (d <= radius) & valid & (lane + d < nc) & (seg[s] == seg)
            a = torch.where(ok, _area(cols, cols[:, s]), BIG)
            fa.append(a)
            better = a < best
            best, rel = torch.where(better, a, best), torch.where(better, d, rel)
        for d in range(1, R + 1):  # shfl_up of the left lane's forward area
            a = torch.where((d <= radius) & (lane >= d), fa[d - 1][src(-d)], BIG)
            better = (a < best) | ((a == best) & (-d < rel))
            best, rel = torch.where(better, a, best), torch.where(better, -d, rel)
        j = lane + rel
        p = j & 31
        mutual = (best < BIG) & valid & (j >= 0) & (j < WARP) & (rel[p] == -rel)
        merge, keep = mutual & (rel > 0), valid & ~(mutual & (rel < 0))
        mrank = torch.cumsum(merge.to(torch.int64), 0) - merge.to(torch.int64)
        krank = torch.cumsum(keep.to(torch.int64), 0) - keep.to(torch.int64)
        ids = base + (nc0 - nc) + mrank
        union = ploc_nn.fmin(cols, cols[:, p]).view(I32)
        for i in torch.nonzero(merge).flatten().tolist():
            nodes[:, ids[i]] = torch.cat([state[7, i:i + 1], state[7, p[i]:p[i] + 1], union[:, i]])
        new = torch.cat([torch.where(merge, union, state[0:6]), state[6:7],
                         torch.where(merge, ids.to(I32), state[7])[None]])
        nk = int(keep.sum())
        state[:, krank[keep]] = new[:, keep]  # lanes >= nk keep stale values
        nc = nk
        shift = min(shift + step, 32)
        rounds[0] += 1
    return nc


def finish_schedule(mat, nodes, nc0, shift, base, radius, step, ctas, one_cta_at):
    """The kernel's schedule on the nc0 live clusters of mat. Returns
    (nodes, rounds per regime, border events)."""
    count = {"wide": 0, "one_cta": 0, "warp": 0, "halo_merges": 0, "halo_segments": 0}
    nc, rounds, limit = nc0, [0], nc0 + 16
    wide = ctas > 1 and nc0 > one_cta_at
    S = -(-nc // ctas) if wide else nc
    bufs = [mat[:, r * S:min(r * S + S, nc)].clone() for r in range(ctas if wide else 1)]
    while nc > 1 and rounds[0] < limit:
        if not wide and nc <= WARP:
            state = torch.full((8, WARP), JUNK, dtype=I32)
            state[:, :nc] = bufs[0][:, :nc]
            nc = _warp_rounds(state, nc, nc0, shift, step, base, radius, nodes, rounds, limit,
                              count)
            break
        count["wide" if wide else "one_cta"] += 1
        C = len(bufs)
        S = -(-nc // C) if wide else nc
        stage, totals = [], []
        for r, buf in enumerate(bufs):
            lo = r * S
            n = max(min(lo + S, nc) - lo, 0)
            view = torch.full((8, n + 4 * R), JUNK, dtype=I32)
            view[:, 2 * R:2 * R + n] = buf[:, :n]
            for col in [*range(-2 * R, 0), *range(n, n + 2 * R)]:  # the halo, from its owners
                j = lo + col
                if 0 <= j < nc:
                    o = j // S
                    view[:, 2 * R + col] = bufs[o][:, j - o * S]
            rel, has = _view_round(view, lo, n, nc, shift, radius)
            i = torch.arange(n)
            br = rel[i + R]
            mutual = has[i + R] & (rel[i + R + br] == -br)
            merge, keep = mutual & (br > 0), ~(mutual & (br < 0))
            count["halo_merges"] += int((merge & (i + br >= n)).sum())
            seg = ploc_nn.segments(view[6], shift)
            if 0 < n < nc and wide:
                count["halo_segments"] += int(seg[2 * R + n - 1] != seg[2 * R + n])
            stage.append((view, i, br, merge, keep))
            totals.append((int(merge.sum()), int(keep.sum())))
        pre = np.cumsum([[0, 0]] + totals, axis=0)
        all_m, all_k = (int(x) for x in pre[-1])
        next_wide = wide and all_k > one_cta_at
        S2 = -(-all_k // C) if next_wide else all_k
        new_bufs = [torch.full((8, S2), JUNK, dtype=I32) for _ in range(C if next_wide else 1)]
        for r, (view, i, br, merge, keep) in enumerate(stage):
            col = 2 * R + i
            pcol = col + br
            union = ploc_nn.fmin(view[0:6, col].view(F32), view[0:6, pcol].view(F32)).view(I32)
            mrank = int(pre[r][0]) + torch.cumsum(merge.to(torch.int64), 0) - merge.to(torch.int64)
            ids = base + (nc0 - nc) + mrank
            for q in torch.nonzero(merge).flatten().tolist():
                nodes[:, ids[q]] = torch.cat([view[7, col[q]:col[q] + 1],
                                              view[7, pcol[q]:pcol[q] + 1], union[:, q]])
            new = torch.cat([torch.where(merge, union, view[0:6, col]), view[6:7, col],
                             torch.where(merge, ids.to(I32), view[7, col])[None]])
            g = int(pre[r][1]) + torch.cumsum(keep.to(torch.int64), 0) - keep.to(torch.int64)
            for q in torch.nonzero(keep).flatten().tolist():
                o = int(g[q]) // S2 if next_wide else 0
                new_bufs[o][:, int(g[q]) - o * S2] = new[:, q]
        bufs = new_bufs
        nc -= all_m
        shift = min(shift + step, 32)
        rounds[0] += 1
        wide = next_wide
    assert nc <= 1
    return nodes, count


def _state(kind, n):
    """A first-round cluster state i32[8, n]."""
    if kind == "zeros":  # -0.0 / +0.0 faces, equal areas, codes in few segments
        rng = np.random.default_rng(n)
        mn = rng.choice(np.array([-1.0, -0.0, 0.0, 0.5], np.float32), (3, n))
        mx = mn + rng.choice(np.array([0.0, 0.5], np.float32), (3, n))
        cols = np.concatenate([mn, -mx]).astype(np.float32).view(np.int32)
        codes = np.sort(rng.integers(0, 1 << 12, n)) << 18
        node = np.arange(n) + n - 1
        return torch.from_numpy(np.concatenate([cols, codes[None], node[None]]).astype(np.int32))
    tris = torch.from_numpy(random_tris(np.random.default_rng(n), n))
    codes, packed_t, _ = lbvh._sorted_leaves_from_tris(tris, True)
    return ploc_ops.initial_state(packed_t, codes)


@pytest.mark.parametrize("step", [3, 6])
@pytest.mark.parametrize("kind,n,shift,ctas,one_cta_at", [
    ("soup", 1500, 3, 8, 200),
    ("soup", 1500, 32, 16, 64),
    ("soup", 700, 9, 3, 100),
    ("zeros", 640, 3, 8, 64),
    ("zeros", 640, 24, 5, 128),
])
def test_schedule_equals_plain_finisher(kind, n, shift, ctas, one_cta_at, step):
    mat = _state(kind, n)
    base = 5
    want = ploc_round.ploc_finish_reference(mat, torch.full((8, n + base), -3, dtype=I32), n,
                                            shift, base, R, step)
    got, count = finish_schedule(mat, torch.full((8, n + base), -3, dtype=I32), n, shift, base,
                                 R, step, ctas, one_cta_at)
    assert torch.equal(got, want)
    assert count["wide"] > 0 and count["one_cta"] > 0 and count["warp"] > 0
    assert count["halo_merges"] > 0  # mutual pairs across slice borders
    if shift < 32:
        assert count["halo_segments"] > 0  # segment borders at slice borders


@pytest.mark.parametrize("nc,ctas,one_cta_at", [(2, 8, 2048), (33, 8, 2048), (40, 8, 32),
                                                (300, 1, 2048)])
def test_schedule_small_and_single_cta(nc, ctas, one_cta_at):
    """Widths at the warp threshold, a cluster that starts in CTA 0, and
    one CTA throughout."""
    mat = _state("soup", 400)[:, :nc].contiguous()
    want = ploc_round.ploc_finish_reference(mat, torch.full((8, nc), -3, dtype=I32), nc, 9, 0,
                                            R, 6)
    got, count = finish_schedule(mat, torch.full((8, nc), -3, dtype=I32), nc, 9, 0, R, 6, ctas,
                                 one_cta_at)
    assert torch.equal(got, want)
    assert count["warp"] > 0 and (nc <= WARP) == (count["one_cta"] + count["wide"] == 0)
