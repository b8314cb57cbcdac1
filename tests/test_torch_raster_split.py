"""The exactness argument of B4's split sweep (`csrc/raster.cu`), held on
the CPU by a plain-torch emulation of its schedule.

The kernel splits each subtile's pair list into chunks of C pair slots
that blocks sweep in no fixed order: a block stops at a pair once the pair
is at or above the largest of the subtile's rays' events found so far
(the first pair with p_tlb >= BIG; after a hit of value t at pair j, the
first pair after j with p_tlb >= t), keeps each ray's least (t, pair, row)
key, and a finish pass takes the stop pair K as that largest event, the
count from K, and the winner from the key (re-sweeping serially if the
least key lies at or above K). The emulation below runs that schedule with
the chunks in a seeded random order, publishes a chunk's events and keys
only when the chunk finishes (the latest the kernel may see them), and
forces C = 1 and 2, so that a subtile spans many chunks. Every output
(t, prim, u, v, count) must equal `raster_sweep_reference` bit for bit: on
the cornellbox at 256^2; on sponza_like(4096), where the serial rule skips
pairs and the split sweeps past them; on a soup of small triangles before a
slanted backdrop, every triangle twice and one prim a treelet (L = 1:
exact t ties between neighbouring pairs, so across chunk borders); and on
the same with every entry bound tripled (still sorted, no longer below
every hit: the backdrop's near edge comes first and its far hits stop the
serial walk before the closer triangles), where the least key may lie past
K and the finish pass re-sweeps.
"""
import functools

import numpy as np
import pytest
import torch

from tpu_bvh_torch.models import lbvh
from tpu_bvh_torch.ops import raster, raster_gpu as rg
from tpu_bvh_torch.utils import camera, scenes

BIG = rg.BIG
NO_PAIR = (1 << 22) - 1  # the pair field of the kernel's "no key"


def _after(p_tlb, lo, hi, v):
    """Per ray: the first k in [lo, hi) with !(p_tlb[k] < v), else hi."""
    return lo + torch.searchsorted(p_tlb[lo:hi].contiguous(), v.contiguous())


def _test_pair(slab, dd):
    """The kernel's Möller test of 256 rays dd [256, 3] against one slab
    [L, 16], in the plain version's order: t [256, L] (BIG where no hit),
    un, vn, inv."""
    c = slab[None]  # [1, L, 16]
    dx, dy, dz = dd[:, 0:1], dd[:, 1:2], dd[:, 2:3]

    def plane(j):
        return c[..., j] * dx + c[..., j + 1] * dy + c[..., j + 2] * dz

    un, vn, wn, den = plane(0), plane(3), plane(6), plane(9)
    tn = c[..., 12]
    ok = (un * den > 0) & (vn * den > 0) & (wn * den > 0) & (tn * den > 0)
    inv = 1.0 / torch.where(den != 0, den, 1.0)
    return torch.where(ok, tn * inv, BIG), un, vn, inv


def _pair_best(tp):
    """Least t of each ray over the pair's rows, and the smallest row with it."""
    bt = tp.amin(dim=-1)
    rows = torch.arange(tp.shape[1])
    bl = torch.where(tp == bt[:, None], rows, tp.shape[1]).amin(dim=-1)
    return bt, torch.clamp(bl, max=tp.shape[1] - 1)


def _less(t, k, l, kt, kk, kl):
    """(t, k, l) < (kt, kk, kl) lexicographically; -0.0 == +0.0."""
    return (t < kt) | ((t == kt) & ((k < kk) | ((k == kk) & (l < kl))))


def split_sweep(dirs_ct, slabs, p_tid, p_tlb, p_bits, t_start, t_end, chunk, seed):
    """Returns ((t, prim, u, v, count), stats) of the split schedule."""
    n_ct, L = dirs_ct.shape[0], slabs.shape[1]
    d = dirs_ct.reshape(n_ct, 3, rg.NSUB, rg.RPT).permute(0, 2, 3, 1)  # [CT, 16, 256, 3]
    shape = (n_ct, rg.NSUB, rg.RPT)
    ev = torch.empty(shape, dtype=torch.int64)
    usub = torch.empty((n_ct, rg.NSUB), dtype=torch.int64)
    kt = torch.full(shape, float("inf"))
    kk = torch.full(shape, NO_PAIR, dtype=torch.int64)
    kl = torch.zeros(shape, dtype=torch.int64)
    ts, te = t_start.tolist(), t_end.tolist()
    bits = lambda k, s: bool((int(p_bits[k]) >> s) & 1)
    items = []
    for g in range(n_ct):
        e0 = int(_after(p_tlb, ts[g], te[g], torch.tensor([BIG])))  # every ray's first event
        ev[g] = e0
        usub[g] = e0
        items += [(g, s, c) for s in range(rg.NSUB) for c in range(-(-(te[g] - ts[g]) // chunk))]
    order = np.random.default_rng(seed).permutation(len(items))
    stats = {"sweeps": 0, "ties": 0, "resweeps": 0, "chunks_swept": {}}
    for i in order:
        g, s, c = items[i]
        a = ts[g] + c * chunk
        bound = int(usub[g, s])
        if a >= bound:
            continue
        dd = d[g, s]
        my_ev = ev[g, s].clone()
        mt, mk, ml = kt[g, s].clone(), kk[g, s].clone(), kl[g, s].clone()
        swept = 0
        for k in range(a, min(a + chunk, te[g])):
            if not bits(k, s):
                continue
            if k >= bound:
                break
            bt, bl = _pair_best(_test_pair(slabs[int(p_tid[k])], dd)[0])
            hit = bt < BIG
            stats["ties"] += int((hit & (bt == mt) & (mk < k)).sum())
            kv = torch.full((rg.RPT,), k, dtype=torch.int64)
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
        for s in range(rg.NSUB):
            K = int(ev[g, s].max())
            swept_pairs = [k for k in range(ts[g], K) if bits(k, s)]
            count[g, s] = L * len(swept_pairs)
            dd = d[g, s]
            hit = kk[g, s] < K
            if bool(((kk[g, s] != NO_PAIR) & ~hit).any()):
                stats["resweeps"] += 1  # a least key at or above K: sweep serially
                for k in swept_pairs:
                    tp, un, vn, inv = _test_pair(slabs[int(p_tid[k])], dd)
                    bt, bl = _pair_best(tp)
                    better = bt < out_t[g, s]
                    pick = lambda x: x.gather(1, bl[:, None])[:, 0]
                    pid = slabs[int(p_tid[k]), :, 13].contiguous().view(torch.int32)[bl]
                    out_t[g, s] = torch.where(better, bt, out_t[g, s])
                    out_u[g, s] = torch.where(better, pick(un * inv), out_u[g, s])
                    out_v[g, s] = torch.where(better, pick(vn * inv), out_v[g, s])
                    out_p[g, s] = torch.where(better, pid, out_p[g, s])
            else:  # the winner, recomputed by one Möller test
                for k in torch.unique(kk[g, s][hit]).tolist():
                    tp, un, vn, inv = _test_pair(slabs[int(p_tid[k])], dd)
                    sel = hit & (kk[g, s] == k)
                    row = kl[g, s][:, None]
                    pick = lambda x: x.gather(1, row)[:, 0]
                    pid = slabs[int(p_tid[k]), :, 13].contiguous().view(torch.int32)[kl[g, s]]
                    out_t[g, s] = torch.where(sel, pick(tp), out_t[g, s])
                    out_u[g, s] = torch.where(sel, pick(un * inv), out_u[g, s])
                    out_v[g, s] = torch.where(sel, pick(vn * inv), out_v[g, s])
                    out_p[g, s] = torch.where(sel, pid, out_p[g, s])
    flat = lambda x: x.reshape(n_ct, rg.RPC)
    return tuple(flat(x) for x in (out_t, out_p, out_u, out_v, count)), stats


@functools.lru_cache(maxsize=None)
def _workload(name):
    """The sweep's arguments (dirs_ct, slabs, p_tid, p_tlb, p_bits, t_start,
    t_end) for one scene."""
    if name == "doubled_L1_inflated":
        args = list(_workload("doubled_L1"))
        args[3] = torch.where(args[3] < BIG, args[3] * 3.0 + 0.5, args[3])
        return tuple(args)
    preset, size, leaf, caps = "cornellbox", 256, 4, (64, 2048, 4)
    if name == "cornellbox":
        soup = scenes.cornellbox()
    elif name == "doubled_L1":  # small triangles before a slanted backdrop, each twice
        rng = np.random.default_rng(5)
        small = rng.uniform(-1.5, 1.5, (120, 1, 3)) + rng.uniform(-0.3, 0.3, (120, 3, 3))
        back = np.array([[[-30.0, -30.0, 4.0], [30.0, -30.0, 4.0], [0.0, 40.0, -40.0]]])
        soup = np.concatenate([small, back] * 2).astype(np.float32)
        size, leaf, caps = 128, 1, (256, 8192, 4)
    else:  # sponza_like
        soup = scenes.sponza_like(4096)
        preset, size, leaf, caps = "sponza", 128, 16, (512, 4096, 32)
    tr, cam = scenes.preset(preset, "cpu")
    tris = torch.from_numpy(soup)
    packed = raster.pack_raster(lbvh.build_single_pass(tris), tris, leaf_size=leaf)
    rays = camera.generate_rays(cam, size, size)
    args, _, ovf = rg.prepare_sweep(packed, rays, tr, size, size, *caps)
    assert not bool(ovf)
    return args


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("name", ["cornellbox", "sponza_like", "doubled_L1",
                                  "doubled_L1_inflated"])
def test_split_sweep_equals_serial(name, chunk):
    args = _workload(name)
    got, stats = split_sweep(*args, chunk, seed=chunk)
    want = rg.raster_sweep_reference(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
    assert bool((got[1] >= 0).any())
    L = args[1].shape[1]
    counted = int(got[4].sum()) // (rg.RPT * L)
    assert stats["sweeps"] >= counted
    assert max(stats["chunks_swept"].values()) > 1  # subtiles span several chunks
    if name == "doubled_L1":
        assert L == 1 and stats["ties"] > 0  # exact ties between pairs
    if name == "sponza_like":  # pairs with the bit that the serial rule skips, swept here
        n_bits = sum(bin(b).count("1") for b in args[4].tolist())
        assert counted < n_bits and stats["sweeps"] > counted
    if name == "doubled_L1_inflated":
        assert stats["resweeps"] > 0
