"""The exactness argument of B5's split sweep (`csrc/ray_sweep.cu`), held
on the CPU by a plain-torch emulation of its schedule.

The kernel splits each subgroup's pair list into chunks of C pair slots
that blocks sweep in no fixed order: a block stops at a pair once the pair
is at or above the largest of the subgroup's rays' events found so far,
keeps each ray's least (t, pair, row) key, and a finish pass takes the
stop pair K as that largest event, the count from K, and the winner from
the key (re-sweeping serially if the least key lies at or above K). The
emulation below runs that schedule with the chunks in a seeded random
order, publishes a chunk's events and keys only when the chunk finishes
(the latest the kernel may see them), and forces C = 1 and 2, so that a
subgroup spans many chunks. Every output (t, prim, u, v, count) must equal
`ray_sweep_reference` bit for bit: on the cornellbox primary and shadow
rays, a random ray set with dead rays (tmax = -1), a doubled cornellbox
with one prim a treelet (L = 1, exact t ties between neighbouring pairs,
so across chunk borders), rays from inside the box into its closed half
(every subgroup fully occluded), and rays from inside sponza_like(4096),
where the serial rule skips pairs and the split sweeps past them; the last
also with every entry bound tripled (still sorted, no longer below every
hit), where the least key may lie past K and the finish pass re-sweeps.
"""
import functools

import numpy as np
import pytest
import torch

from tpu_bvh_torch.models import lbvh
from tpu_bvh_torch.ops import raster
from tpu_bvh_torch.ops import ray_sweep as rs
from tpu_bvh_torch.types import Rays
from tpu_bvh_torch.utils import camera, scenes

BIG = rs.BIG
NO_PAIR = (1 << 23) - 1  # the pair field of the kernel's "no key"
LIGHT = torch.tensor([0.0, 0.9, 0.2])


def _after(p_tlb, lo, hi, v):
    """Per ray: the first k in [lo, hi) with !(p_tlb[k] < v), else hi."""
    return lo + torch.searchsorted(p_tlb[lo:hi].contiguous(), v.contiguous())


def _test_pair(slab, fr):
    """The kernel's Plücker test of 256 rays fr [256, NF] against one slab
    [L, 32]: t [256, L] (BIG where no hit in range), un, vn, inv."""
    un, vn, wn, den, tn = rs._plane_terms(slab[None], fr[:, None, :])
    ok = (un * den > 0) & (vn * den > 0) & (wn * den > 0) & (tn * den > 0)
    inv = 1.0 / torch.where(den != 0, den, 1.0)
    tp = torch.where(ok, tn * inv, BIG)
    tp = torch.where((tp > fr[:, None, 10]) & (tp < fr[:, None, 9]), tp, BIG)
    return tp, un, vn, inv


def _pair_best(tp):
    """Least t of each ray over the pair's rows, and the smallest row with it."""
    bt = tp.amin(dim=-1)
    rows = torch.arange(tp.shape[1])
    bl = torch.where(tp == bt[:, None], rows, tp.shape[1]).amin(dim=-1)
    return bt, torch.clamp(bl, max=tp.shape[1] - 1)


def _less(t, k, l, kt, kk, kl):
    """(t, k, l) < (kt, kk, kl) lexicographically; -0.0 == +0.0."""
    return (t < kt) | ((t == kt) & ((k < kk) | ((k == kk) & (l < kl))))


def split_sweep(feats, slabs, p_tid, p_tlb, p_bits, t_start, t_end, occlusion, chunk, seed):
    """Returns ((t, prim, u, v, count), stats) of the split schedule."""
    n_ct, L = feats.shape[0], slabs.shape[1]
    f = feats.reshape(n_ct, rs.NF, rs.NSUB, rs.RPT).permute(0, 2, 3, 1)
    shape = (n_ct, rs.NSUB, rs.RPT)
    ev = torch.empty(shape, dtype=torch.int64)
    usub = torch.empty((n_ct, rs.NSUB), dtype=torch.int64)
    kt = torch.full(shape, float("inf"))
    kk = torch.full(shape, NO_PAIR, dtype=torch.int64)
    kl = torch.zeros(shape, dtype=torch.int64)
    ts, te = t_start.tolist(), t_end.tolist()
    bits = lambda k, s: bool((int(p_bits[k]) >> s) & 1)
    items = []
    for g in range(n_ct):
        for s in range(rs.NSUB):
            k0 = next((k for k in range(ts[g], te[g]) if bits(k, s)), te[g])
            e = _after(p_tlb, ts[g], te[g], f[g, s, :, 9])
            if k0 < te[g]:  # best starts at BIG once the first pair is swept
                e = torch.minimum(e, _after(p_tlb, k0 + 1, te[g], torch.full((rs.RPT,), BIG)))
            ev[g, s] = e
            usub[g, s] = e.max()
            items += [(g, s, c) for c in range(-(-(te[g] - ts[g]) // chunk))]
    order = np.random.default_rng(seed).permutation(len(items))
    stats = {"sweeps": 0, "ties": 0, "resweeps": 0, "chunks_swept": {}}
    for i in order:
        g, s, c = items[i]
        a = ts[g] + c * chunk
        bound = int(usub[g, s])
        if a >= bound:
            continue
        fr = f[g, s]
        my_ev = ev[g, s].clone()
        mt, mk, ml = kt[g, s].clone(), kk[g, s].clone(), kl[g, s].clone()
        active = torch.ones(rs.RPT, dtype=torch.bool) if not occlusion else kk[g, s] >= a
        swept = 0
        for k in range(a, min(a + chunk, te[g])):
            if not bits(k, s):
                continue
            if k >= bound:
                break
            tp, _, _, _ = _test_pair(slabs[int(p_tid[k])], fr)
            if occlusion:
                hit = (tp < BIG).any(dim=-1) & active
                bt, bl = torch.zeros(rs.RPT), torch.zeros(rs.RPT, dtype=torch.int64)
                active &= ~hit
            else:
                bt, bl = _pair_best(tp)
                hit = bt < BIG
                stats["ties"] += int((hit & (bt == mt) & (mk < k)).sum())
            kv = torch.full((rs.RPT,), k, dtype=torch.int64)
            take = hit & _less(bt, kv, bl, mt, mk, ml)
            mt, mk, ml = (torch.where(take, x, y) for x, y in ((bt, mt), (kv, mk), (bl, ml)))
            my_ev = torch.where(hit, torch.minimum(my_ev, _after(p_tlb, k + 1, te[g], bt)), my_ev)
            swept += 1
            bound = min(bound, int(my_ev.max()))
        # the chunk's events and keys become visible only now
        ev[g, s] = torch.minimum(ev[g, s], my_ev)
        take = _less(mt, mk, ml, kt[g, s], kk[g, s], kl[g, s])
        kt[g, s] = torch.where(take, mt, kt[g, s])
        kk[g, s] = torch.where(take, mk, kk[g, s])
        kl[g, s] = torch.where(take, ml, kl[g, s])
        usub[g, s] = min(int(usub[g, s]), bound)
        stats["sweeps"] += swept
        if swept:
            stats["chunks_swept"][(g, s)] = stats["chunks_swept"].get((g, s), 0) + 1

    out_t = torch.full(shape, BIG)
    out_p = torch.full(shape, -1, dtype=torch.int32)
    out_u, out_v = torch.zeros(shape), torch.zeros(shape)
    count = torch.zeros(shape, dtype=torch.int32)
    for g in range(n_ct):
        for s in range(rs.NSUB):
            K = int(ev[g, s].max())
            swept_pairs = [k for k in range(ts[g], K) if bits(k, s)]
            count[g, s] = L * len(swept_pairs)
            fr = f[g, s]
            hit = kk[g, s] < K
            if not occlusion and bool(((kk[g, s] != NO_PAIR) & ~hit).any()):
                stats["resweeps"] += 1  # a least key at or above K: sweep serially
                for k in swept_pairs:
                    tp, un, vn, inv = _test_pair(slabs[int(p_tid[k])], fr)
                    bt, bl = _pair_best(tp)
                    better = bt < out_t[g, s]
                    pick = lambda x: x.gather(1, bl[:, None])[:, 0]
                    pid = slabs[int(p_tid[k]), :, 25].contiguous().view(torch.int32)[bl]
                    out_t[g, s] = torch.where(better, bt, out_t[g, s])
                    out_u[g, s] = torch.where(better, pick(un * inv), out_u[g, s])
                    out_v[g, s] = torch.where(better, pick(vn * inv), out_v[g, s])
                    out_p[g, s] = torch.where(better, pid, out_p[g, s])
            elif occlusion:
                out_t[g, s] = torch.where(hit, 0.0, BIG)
                out_p[g, s] = torch.where(hit, 0, -1).to(torch.int32)
            else:  # the winner, recomputed by one Plücker test
                for k in torch.unique(kk[g, s][hit]).tolist():
                    tp, un, vn, inv = _test_pair(slabs[int(p_tid[k])], fr)
                    sel = hit & (kk[g, s] == k)
                    row = kl[g, s][:, None]
                    pick = lambda x: x.gather(1, row)[:, 0]
                    pid = slabs[int(p_tid[k]), :, 25].contiguous().view(torch.int32)[kl[g, s]]
                    out_t[g, s] = torch.where(sel, pick(tp), out_t[g, s])
                    out_u[g, s] = torch.where(sel, pick(un * inv), out_u[g, s])
                    out_v[g, s] = torch.where(sel, pick(vn * inv), out_v[g, s])
                    out_p[g, s] = torch.where(sel, pid, out_p[g, s])
    flat = lambda x: x.reshape(n_ct, rs.RPG)
    return tuple(flat(x) for x in (out_t, out_p, out_u, out_v, count)), stats


def _surface_points(tris, packed, tr, w, h):
    """Primary hits of the cornellbox view, misses parked at the eye."""
    _, cam = scenes.preset("cornellbox", "cpu")
    prim = camera.generate_rays(cam, w, h)
    hit, _, _ = rs.trace_rays(packed, prim, tr, 64, 1024, 4)
    live = hit.prim_idx >= 0
    pts = prim.origin + prim.direction * torch.where(live, hit.t, 0.0)[:, None]
    return pts, live


@functools.lru_cache(maxsize=None)
def _workload(name):
    """The sweep's arguments (feats, slabs, p_tid, p_tlb, p_bits, t_start,
    t_end) for one scene."""
    if name == "sponza_inflated":
        args = list(_workload("sponza_inside"))
        args[3] = torch.where(args[3] < BIG, args[3] * 3.0 + 0.5, args[3])
        return tuple(args)
    tr, cam = scenes.preset("cornellbox", "cpu")
    soup = scenes.cornellbox()
    leaf, caps = 4, (64, 1024, 4)
    if name == "random":
        rng = np.random.default_rng(11)
        soup = (rng.uniform(-1.5, 1.5, (150, 1, 3))
                + rng.uniform(-0.4, 0.4, (150, 3, 3))).astype(np.float32)
        leaf, caps = 16, (32, 2048, 4)
    elif name == "doubled_L1":
        soup = np.concatenate([soup, soup])
        leaf, caps = 1, (128, 1024, 4)
    elif name == "sponza_inside":
        soup = scenes.sponza_like(4096)
        tr, _ = scenes.preset("sponza", "cpu")
        leaf, caps = 16, (512, 4096, 32)
    tris = torch.from_numpy(soup)
    packed = raster.pack_raster(lbvh.build_two_pass(tris), tris, leaf_size=leaf)
    if name in ("primary", "doubled_L1"):
        rays = camera.generate_rays(cam, 64, 64)
    elif name == "shadow":
        pts, live = _surface_points(tris, packed, tr, 48, 48)
        rays = rs.shadow_rays(pts, live, LIGHT, 1e-3)
    elif name == "random":
        rng = np.random.default_rng(12)
        n = 500
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tmax = np.where(np.arange(n) % 3 == 0, -1.0, 3.4e38).astype(np.float32)  # dead rays
        rays = Rays(torch.from_numpy(rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)),
                    torch.from_numpy(d), torch.zeros(n), torch.from_numpy(tmax))
    elif name == "sponza_inside":  # all directions from a point inside the hall
        pts = soup.reshape(-1, 3)
        centre = torch.from_numpy((pts.min(0) + pts.max(0)) / 2) + torch.tensor([0.0, 0.5, 0.0])
        d = np.random.default_rng(13).normal(size=(4096, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays = Rays(centre.expand(4096, 3), torch.from_numpy(d), torch.zeros(4096),
                    torch.full((4096,), 1000.0))
    else:  # "inside": from the box's centre into its closed half (away from the camera)
        world = soup.reshape(-1, 3) + tr.translation.numpy()
        centre = torch.from_numpy((world.min(0) + world.max(0)) / 2)
        rng = np.random.default_rng(13)
        d = rng.normal(size=(4096, 3)).astype(np.float32)
        d[:, 2] = -np.abs(d[:, 2]) - 0.2
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays = Rays(centre.expand(4096, 3), torch.from_numpy(d), torch.zeros(4096),
                    torch.full((4096,), 100.0))
    args, _, _, ovf = rs.prepare_trace(packed, rays, tr, *caps)
    assert not bool(ovf)
    return args


@functools.lru_cache(maxsize=None)
def _reference(name, occlusion):
    return rs.ray_sweep_reference(*_workload(name), occlusion)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("name", ["primary", "shadow", "random", "doubled_L1", "inside",
                                  "sponza_inside", "sponza_inflated"])
def test_split_sweep_equals_serial(name, occlusion, chunk):
    args = _workload(name)
    got, stats = split_sweep(*args, occlusion, chunk, seed=chunk + 10 * occlusion)
    want = _reference(name, occlusion)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
    assert bool((got[1] >= 0).any())
    assert stats["sweeps"] >= int(got[4].sum()) // (rs.RPT * args[1].shape[1])
    assert max(stats["chunks_swept"].values()) > 1  # subgroups span several chunks
    if name == "doubled_L1" and not occlusion:
        assert args[1].shape[1] == 1 and stats["ties"] > 0  # exact ties between pairs
    if name == "random":
        assert bool((args[0][:, 9] < 0).any())  # dead rays
    if name == "sponza_inside":  # pairs with the bit that the serial rule skips, swept here
        n_bits = sum(bin(b).count("1") for b in args[4].tolist())
        serial = int(got[4].sum()) // (rs.RPT * args[1].shape[1])
        assert serial < n_bits and (stats["sweeps"] > serial or not occlusion)
    if name == "sponza_inflated" and not occlusion:
        assert stats["resweeps"] > 0
    if name == "inside" and occlusion:  # every ray of a subgroup occluded
        assert bool((got[1].reshape(-1, rs.RPT) == 0).all(dim=1).any())
