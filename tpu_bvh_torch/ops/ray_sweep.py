"""Arbitrary-ray sweep and shadow occlusion: the port of
`tpu_bvh.ops.ray_sweep`.

The raster engine bakes a fixed eye into its Möller coefficients; this one
takes any rays. Every numerator of the triangle test is a dot product of
per-triangle coefficients with the ray's features F = [d, m = o x d, o]
(pos_i = v_i - o expanded; the factor 2 dropped throughout):

    u_num = (v0 x v2) . d + (v2 - v0) . m
    v_num = (v1 x v0) . d + (v0 - v1) . m
    w_num = (v2 x v1) . d + (v1 - v2) . m
    den   = n . d,           n = (v0 - v1) x (v2 - v0)
    t_num = n . v0 - n . o

The schedule is the raster's: rays are sorted once by (origin Morton cell,
direction Morton cell) into groups of 4096 (16 subgroups of 256);
(group, treelet) pairs come from the shared `_compact_pairs` with a
per-(pair, subgroup) cull bitmask from `_obox_vs_aabb` (the cone test for
an origin box). The sweep (`ray_sweep_kernel`) runs `csrc/ray_sweep.cu` on
CUDA tensors and `ray_sweep_reference` on CPU tensors; both sum the dot
products in the same order with separately rounded f32 operations, so they
agree bit for bit. The plain version walks each subgroup's pairs in order;
the kernel splits them into chunks over the SMs and finds the same stop
pair and winners (the argument is in its source note). Occlusion mode
(`shadow_occlusion`) answers the boolean query only: any hit in range
writes t = 0 and prim = 0.
"""
from __future__ import annotations

import torch

from ..types import FLT_MAX, HitInfo, Rays
from ..utils import kernels, work
from ..utils.platform import on_cuda
from . import raster as R
from .aabb import _cross, transform_point
from .raster_gpu import _compact_pairs

I32 = torch.int32
F32 = torch.float32
BIG = R.BIG
RPT = 256  # rays per subgroup (one block of the kernel)
NSUB = 16  # subgroups per group
RPG = RPT * NSUB  # rays per group (4096)
NF = 11  # feature rows: d xyz, m = o x d xyz, o xyz, tmax, tmin
PRIM_WORDS = 32  # floats per prim in a slab
# the largest leaf size whose slab (L * 128 B) and the kernel's 48 B of
# static shared memory (as ptxas reports it) fit the 48 KB a launch gets
# without opting in
MAX_L = (48 * 1024 - 48) // (PRIM_WORDS * 4)
MAX_P = 1 << 23  # pair indices fill 23 bits of the kernel's 64-bit hit key
CHUNK = 8  # pair slots per work item of the split sweep (kChunk in the .cu)
STATS = 4 + 1024  # the kernel's counters (kStats + kSmSlots in the .cu)
# the last call's device counters, i64[STATS]: ray-prim tests run, pair
# sweeps, subgroups re-swept serially, 0, then pair sweeps per SM id
last_stats = None


def _plucker_slabs(wt, prim_ids, leaf_size: int):
    """Per-treelet prim slabs f32[T, L, 32]. Per prim, the coefficients of
    the five dot products against F: words 0-5 u_num (d then m), 6-11
    v_num, 12-17 w_num, 18-20 den (d), 21-23 t_num (o) and 24 its
    constant n . v0, 25 the prim id's int bits, 26-31 zero. Padding prims
    are all zero (den = 0 never hits)."""
    v0, v1, v2 = wt[:, 0], wt[:, 1], wt[:, 2]
    n = _cross(v0 - v1, v2 - v0)
    nv0 = (n[:, 0] * v0[:, 0] + n[:, 1] * v0[:, 1]) + n[:, 2] * v0[:, 2]
    rows = torch.cat([
        _cross(v0, v2), v2 - v0, _cross(v1, v0), v0 - v1, _cross(v2, v1), v1 - v2,
        n, -n, nv0[:, None],
    ], dim=1)  # [P, 25]
    rows = torch.where((prim_ids >= 0)[:, None], rows, 0.0)
    p = wt.shape[0]
    rows = torch.cat([
        rows, prim_ids.to(I32).contiguous().view(F32)[:, None],
        torch.zeros((p, PRIM_WORDS - 26), dtype=F32, device=wt.device),
    ], dim=1)
    return rows.reshape(p // leaf_size, leaf_size, PRIM_WORDS).contiguous()


def _morton15(x, y, z):
    """15-bit Morton interleave of 5-bit cell coordinates."""
    def spread(v):
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249
    return spread(x) | (spread(y) << 1) | (spread(z) << 2)


def _ray_sort_key(o, d, omin, oext):
    """Coherence key (int64 holding a u32): origin Morton cell (32^3 cells
    over the origins' box) over direction Morton cell (32^3 over [-1, 1]^3,
    sign planes on each axis's top bit). Common-origin sets sort into
    tight direction cones."""
    q = torch.clamp(((o - omin[None, :]) / oext[None, :]) * 32.0, 0.0, 31.0).to(torch.int64)
    qd = torch.clamp((d + 1.0) * 16.0, 0.0, 31.0).to(torch.int64)
    return ((_morton15(q[:, 0], q[:, 1], q[:, 2]) << 15)
            | _morton15(qd[:, 0], qd[:, 1], qd[:, 2]))


def _plane_terms(c, f):
    """The five dot products of slab words `c` [..., L, 32] with feature
    rows `f` [..., 1, NF], each summed left to right in separately rounded
    f32 operations (the kernel's order)."""
    def dot(base, cols):
        acc = c[..., base] * f[..., cols[0]]
        for j, col in enumerate(cols[1:], 1):
            acc = acc + c[..., base + j] * f[..., col]
        return acc

    dm = (0, 1, 2, 3, 4, 5)
    un, vn, wn = dot(0, dm), dot(6, dm), dot(12, dm)
    den = dot(18, (0, 1, 2))
    tn = dot(21, (6, 7, 8)) + c[..., 24]
    return un, vn, wn, den, tn


def ray_sweep_kernel(feats, slabs, p_tid, p_tlb, p_bits, t_start, t_end,
                     occlusion: bool = False):
    """Closest (or, with `occlusion`, any) hit of every ray over its
    group's pairs; dispatch by device. feats f32[CT, NF, 4096] in sorted
    ray order; slabs f32[T, L, 32]; per pair p_tid, p_tlb, p_bits [P]; per
    group t_start, t_end [CT]. Returns (t, prim, u, v, count), each
    [CT, 4096] (prim and count i32)."""
    if on_cuda(feats):
        return _ray_sweep_cuda(feats, slabs, p_tid, p_tlb, p_bits, t_start, t_end, occlusion)
    return ray_sweep_reference(feats, slabs, p_tid, p_tlb, p_bits, t_start, t_end, occlusion)


def ray_sweep_reference(feats, slabs, p_tid, p_tlb, p_bits, t_start, t_end,
                        occlusion: bool = False):
    """Plain PyTorch version (any device): loops over pair rank within a
    group, vectorised across groups and subgroups, with the kernel's skip
    rule and arithmetic order (so counts and bits agree too)."""
    n_ct = feats.shape[0]
    L = slabs.shape[1]
    dev = feats.device
    f = feats.reshape(n_ct, NF, NSUB, RPT).permute(0, 2, 3, 1)  # [CT, 16, 256, NF]
    best_t = torch.full((n_ct, NSUB, RPT), BIG, dtype=F32, device=dev)
    best_p = torch.full((n_ct, NSUB, RPT), -1, dtype=I32, device=dev)
    best_u = torch.zeros((n_ct, NSUB, RPT), dtype=F32, device=dev)
    best_v = torch.zeros((n_ct, NSUB, RPT), dtype=F32, device=dev)
    count = torch.zeros((n_ct, NSUB, RPT), dtype=I32, device=dev)
    tmax_ray = f[..., 9]
    tmax_s = tmax_ray.amax(dim=-1)  # the subgroup's farthest reach
    sbit = torch.ones(NSUB, dtype=I32, device=dev) << torch.arange(NSUB, dtype=I32, device=dev)
    n_pairs = (t_end - t_start).to(torch.int64)
    rows = torch.arange(L, device=dev)
    last = max(p_tid.shape[0] - 1, 0)
    for rank in range(int(n_pairs.max()) if n_ct else 0):
        k = torch.clamp(t_start.to(torch.int64) + rank, max=last)
        live = ((rank < n_pairs)[:, None] & ((p_bits[k][:, None] & sbit) != 0)
                & (p_tlb[k][:, None] < tmax_s))
        ci, si = torch.nonzero(live, as_tuple=True)
        if ci.numel() == 0:
            continue
        count[ci, si] += L
        c = slabs[p_tid[k[ci]].to(torch.int64)][:, None]  # [N, 1, L, 32]
        fr = f[ci, si][:, :, None, :]  # [N, 256, 1, NF]
        un, vn, wn, den, tn = _plane_terms(c, fr)  # [N, 256, L]
        ok = (un * den > 0) & (vn * den > 0) & (wn * den > 0) & (tn * den > 0)
        inv = 1.0 / torch.where(den != 0, den, 1.0)
        tp = torch.where(ok, tn * inv, BIG)
        tp = torch.where((tp > fr[..., 10]) & (tp < fr[..., 9]), tp, BIG)
        tmin = tp.amin(dim=-1)
        if occlusion:
            hit = tmin < BIG
            best_t[ci, si] = torch.where(hit, 0.0, best_t[ci, si])
            best_p[ci, si] = torch.where(hit, 0, best_p[ci, si])
        else:
            win = torch.where(tp == tmin[..., None], rows, L).amin(dim=-1, keepdim=True)
            win = torch.clamp(win, max=L - 1)
            u_best = (un * inv).gather(-1, win)[..., 0]
            v_best = (vn * inv).gather(-1, win)[..., 0]
            pid = c[:, 0, :, 25].contiguous().view(I32).gather(1, win[..., 0])
            better = tmin < best_t[ci, si]
            best_t[ci, si] = torch.where(better, tmin, best_t[ci, si])
            best_p[ci, si] = torch.where(better, pid, best_p[ci, si])
            best_u[ci, si] = torch.where(better, u_best, best_u[ci, si])
            best_v[ci, si] = torch.where(better, v_best, best_v[ci, si])
        tmax_s[ci, si] = torch.minimum(best_t[ci, si], tmax_ray[ci, si]).amax(dim=-1)
    flat = lambda x: x.reshape(n_ct, RPG)
    return flat(best_t), flat(best_p), flat(best_u), flat(best_v), flat(count)


def _ray_sweep_cuda(feats, slabs, p_tid, p_tlb, p_bits, t_start, t_end, occlusion):
    """The split sweep of `csrc/ray_sweep.cu`. Needs p_tlb non-decreasing
    within each group's [t_start, t_end), as `prepare_trace` makes it."""
    global last_stats
    n_ct = feats.shape[0]
    nt, L = slabs.shape[0], slabs.shape[1]
    P = p_tid.shape[0]
    kernels.require(feats, "feats", F32, (n_ct, NF, RPG))
    kernels.require(slabs, "slabs", F32, (nt, L, PRIM_WORDS))
    kernels.require(p_tid, "p_tid", I32, (P,))
    kernels.require(p_tlb, "p_tlb", F32, (P,))
    kernels.require(p_bits, "p_bits", I32, (P,))
    kernels.require(t_start, "t_start", I32, (n_ct,))
    kernels.require(t_end, "t_end", I32, (n_ct,))
    if n_ct == 0 or not 1 <= L <= MAX_L:
        raise ValueError(f"ray_sweep needs n_ct >= 1 and 1 <= L <= {MAX_L}, got {n_ct}, {L}")
    if P >= MAX_P:
        raise ValueError(f"ray_sweep needs P < 2^23 = {MAX_P} pairs (the hit key), got {P}")
    dev = feats.device
    out = [torch.empty((n_ct, RPG), dtype=dt, device=dev) for dt in (F32, I32, F32, F32, I32)]
    # scratch: a 64-bit hit key and an event index per ray, a stop bound per
    # subgroup, chunk counts and order per group, the ticket and the level table
    keys = torch.empty((n_ct * RPG,), dtype=torch.int64, device=dev)
    ints = torch.empty((n_ct * (RPG + NSUB + 2) + 4 + P // CHUNK + 2,), dtype=I32, device=dev)
    stats = torch.empty((STATS,), dtype=torch.int64, device=dev)
    ins = (feats, slabs, p_tid, p_tlb, p_bits, t_start, t_end)
    kernels.launch("ray_sweep", "tbvh_ray_sweep", *ins, n_ct, P, L, int(occlusion), *out, keys,
                   ints, stats, like=feats, count=lambda: work.sweep("ray_sweep", ins, out),
                   symbols=("rs_init", "rs_sweep", "rs_finish"))
    last_stats = stats
    return tuple(out)


def prepare_trace(scene: R.RasterScene, rays: Rays, tr, cand_cap: int, pair_cap: int,
                  group: int):
    """Everything before the sweep. Returns (the sweep's tensor arguments
    (feats, slabs, p_tid, p_tlb, p_bits, t_start, t_end), the sorted-to-input
    permutation i64[Rp], empty_ct bool[CT], overflow bool[])."""
    L = scene.leaf_size
    n_in = rays.origin.shape[0]
    n_pad = -(-n_in // RPG) * RPG
    n_ct = n_pad // RPG
    dev = scene.tris_sorted.device

    wt = transform_point(scene.tris_sorted, tr.scale, tr.quat, tr.translation)
    bmin, bmax = R._treelet_aabbs(wt, scene.prim_ids, L)
    # centre the scene and the origins: Plücker moments grow with |v|^2
    c0 = (bmin.amin(dim=0) + bmax.amax(dim=0)) * 0.5
    wt = wt - c0
    bmin = bmin - c0
    bmax = bmax - c0
    o = rays.origin - c0
    d = rays.direction
    tmin_r, tmax_r = rays.tmin, rays.tmax
    if n_pad != n_in:
        extra = n_pad - n_in
        zeros3 = torch.zeros((extra, 3), dtype=F32, device=dev)
        o, d = torch.cat([o, zeros3]), torch.cat([d, zeros3])
        tmin_r = torch.cat([tmin_r, torch.zeros((extra,), dtype=F32, device=dev)])
        # dead padding rays: tmax = -1 rejects every candidate t
        tmax_r = torch.cat([tmax_r, torch.full((extra,), -1.0, dtype=F32, device=dev)])

    # the coherence sort: one ray permutation
    omin = o.amin(dim=0)
    oext = torch.clamp(o.amax(dim=0) - omin, min=1e-30)
    order = torch.sort(_ray_sort_key(o, d, omin, oext), stable=True).indices
    o, d, tmn, tmx = o[order], d[order], tmin_r[order], tmax_r[order]

    def bounds(nsub):
        """Origin and direction boxes of groups (nsub 1) or subgroups."""
        lo = lambda v: v.reshape(n_ct * nsub, RPG // nsub, 3).amin(dim=1)
        hi = lambda v: v.reshape(n_ct * nsub, RPG // nsub, 3).amax(dim=1)
        return lo(o), hi(o), lo(d), hi(d)

    glo, ghi, gdlo, gdhi = bounds(1)  # [CT, 3]
    possible, t_lb = R._obox_vs_aabb(glo[:, None], ghi[:, None], gdlo[:, None], gdhi[:, None],
                                     bmin[None], bmax[None])  # [CT, T]
    # cap the entry bound by the farthest live tmax in the group
    possible = possible & (t_lb <= tmx.reshape(n_ct, RPG).amax(dim=1)[:, None])
    p_tid, p_tlb, p_ct, t_start, t_end, empty_ct, overflow = _compact_pairs(
        possible, t_lb, n_ct, cand_cap, pair_cap, group)

    # per-(pair, subgroup) cull -> one bitmask per pair
    nt = bmin.shape[0]
    sub = [b.reshape(n_ct, NSUB, 3) for b in bounds(NSUB)]
    pc = torch.clamp(p_ct, 0, n_ct - 1).to(torch.int64)
    empty = torch.tensor([[BIG] * 3 + [-BIG] * 3], dtype=F32, device=dev)
    ab = torch.cat([torch.cat([bmin, bmax], dim=1), empty])  # [T + 1, 6]
    pair_ab = ab[torch.where(p_tid >= 0, p_tid, nt).to(torch.int64)]
    live, _ = R._obox_vs_aabb(sub[0][pc], sub[1][pc], sub[2][pc], sub[3][pc],
                              pair_ab[:, None, 0:3], pair_ab[:, None, 3:6])  # [P, NSUB]
    weights = torch.ones(NSUB, dtype=I32, device=dev) << torch.arange(NSUB, dtype=I32, device=dev)
    p_bits = torch.where(p_tid >= 0, torch.where(live, weights, 0).sum(dim=1, dtype=I32), 0)

    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    feats = torch.stack([
        dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx,
        ox, oy, oz, tmx, tmn,
    ]).reshape(NF, n_ct, RPG).permute(1, 0, 2).contiguous()
    slabs = _plucker_slabs(wt, scene.prim_ids, L)
    args = (feats, slabs, p_tid.contiguous(), p_tlb.contiguous(), p_bits.contiguous(),
            t_start, t_end)
    return args, order, empty_ct, overflow


def trace_rays(scene: R.RasterScene, rays: Rays, tr, cand_cap: int = 512,
               pair_cap: int = 16384, group: int = 32, occlusion: bool = False):
    """Closest-hit trace of an arbitrary ray set (per-ray tmin < t < tmax).
    With `occlusion` only the boolean answer is meaningful (prim_idx >= 0
    where some hit lies in range). Returns (HitInfo in input ray order,
    counts i32[R] = prims swept per ray, overflow bool[]); on overflow (a
    group above `cand_cap` candidate treelets, or more than `pair_cap`
    pairs) the outputs are undefined."""
    n_in = rays.origin.shape[0]
    args, order, empty_ct, overflow = prepare_trace(scene, rays, tr, cand_cap, pair_cap, group)
    out_t, out_p, out_u, out_v, out_c = ray_sweep_kernel(*args, occlusion)
    # every ray is written by the sweep; groups without pairs are patched
    # to miss here as well
    e = empty_ct[:, None]
    sorted_out = (torch.where(e, BIG, out_t), torch.where(e, -1, out_p),
                  torch.where(e, 0.0, out_u), torch.where(e, 0.0, out_v),
                  torch.where(e, 0, out_c))
    t, prim, u, v, counts = (_unsort(x.reshape(-1), order)[:n_in] for x in sorted_out)
    miss = (prim < 0) | (t >= BIG)
    hit = HitInfo(prim_idx=torch.where(miss, -1, prim), t=torch.where(miss, FLT_MAX, t),
                  u=torch.where(miss, 0.0, u), v=torch.where(miss, 0.0, v))
    return hit, counts, overflow


def _unsort(x, order):
    """Back to input order: out[order[k]] = x[k]."""
    out = torch.empty_like(x)
    out[order] = x
    return out


def shadow_occlusion(scene: R.RasterScene, points, live, light, tr, eps: float,
                     cand_cap: int = 512, pair_cap: int = 8192, group: int = 32):
    """Point-light occlusion of surface points, traced reversed: rays from
    the light to each point, so every group's origin box is a point and
    the sort groups rays into cones from the light. The reversed segment
    [light + eps l, point - eps l] is the forward one, so the boolean
    answer is the forward query's. points f32[N, 3] (world space), live
    bool[N] (dead entries get tmax = -1 and cost nothing), light f32[3],
    eps in world units. Returns (occluded bool[N], counts i32[N],
    overflow bool[])."""
    rays = shadow_rays(points, live, light, eps)
    hit, counts, overflow = trace_rays(scene, rays, tr, cand_cap, pair_cap, group,
                                       occlusion=True)
    return (hit.prim_idx >= 0) & live, counts, overflow


def shadow_rays(points, live, light, eps: float) -> Rays:
    """The reversed shadow rays of `shadow_occlusion`: from the light to
    each point, over (eps, dist - eps); dead points get tmax = -1."""
    n = points.shape[0]
    dvec = points - light[None, :]
    dist = torch.linalg.norm(dvec, dim=1)
    return Rays(
        origin=light[None, :].expand(n, 3),
        direction=dvec / torch.clamp(dist, min=1e-9)[:, None],
        tmin=torch.full((n,), eps, dtype=F32, device=points.device),
        tmax=torch.where(live, dist - eps, -1.0),
    )
