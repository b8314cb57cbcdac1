"""Raster render on the GPU: coarse binning and pair prep in PyTorch, the
sweep in `csrc/raster.cu` (the port of `tpu_bvh.ops.raster_tpu`).

* Coarse binning at 64x64-pixel tiles: a dense [CT, T] cone test, then a
  per-tile sort by conservative entry t gives each tile's candidate
  treelets front to back.
* Pair list: (coarse tile, treelet) pairs, flattened per tile and padded
  to whole groups of `group` pairs; tile ct owns pairs
  [t_start[ct], t_end[ct]). `overflow` is set when the list exceeds
  `pair_cap` or a tile exceeds `cand_cap` candidates; outputs are then
  undefined.
* Fine culling: the per-(pair, 16x16 subtile) cone test gives one
  bitmask per pair (`p_bits`).
* Sweep: `raster_sweep`, which launches the kernel on CUDA tensors and runs
  `raster_sweep_reference` on CPU tensors. The plain version walks each
  subtile's pairs in order; the kernel splits them into chunks over the
  SMs and finds the same stop pair and winners (the argument is in its
  source note).
"""
from __future__ import annotations

import torch

from ..types import FLT_MAX, HitInfo, Rays
from ..utils import kernels, work
from ..utils.platform import on_cuda
from . import raster as R
from .aabb import transform_point

I32 = torch.int32
F32 = torch.float32
BIG = R.BIG
SUB = 16  # subtile edge in pixels
CGRID = 4  # subtiles per coarse-tile edge (coarse tile = 64x64 px)
RPT = SUB * SUB  # rays per subtile
RPC = RPT * CGRID * CGRID  # rays per coarse tile (4096)
NSUB = CGRID * CGRID  # 16
PRIM_WORDS = 16  # floats per prim in a slab
# the largest leaf size: two slabs of L * 64 B in shared memory (an opt-in
# above 48 KB); the hit key holds the row in 10 bits
MAX_L = 768
MAX_P = 1 << 22  # pair indices fill 22 bits of the kernel's 64-bit hit key
CHUNK = 2  # pair slots per work item of the split sweep (kChunk in the .cu)
STATS = 4 + 1024  # the kernel's counters (kStats + kSmSlots in the .cu)
# the last call's device counters, i64[STATS]: ray-prim tests run, pair
# sweeps, subtiles re-swept serially, 0, then pair sweeps per SM id
last_stats = None


def _to_coarse_layout(arr_wh, W: int, H: int):
    """[W, H, C] x-major -> [CT, 4096, C] in (coarse, subtile, within) order."""
    cw, ch = W // (SUB * CGRID), H // (SUB * CGRID)
    t = arr_wh.reshape(cw, CGRID, SUB, ch, CGRID, SUB, -1)
    t = t.permute(0, 3, 1, 4, 2, 5, 6)  # [cw, ch, sx, sy, wx, wy, C]
    return t.reshape(cw * ch, RPC, -1)


def _from_coarse_layout(arr_ct, W: int, H: int):
    """Inverse of `_to_coarse_layout` for [CT, 4096, C] arrays."""
    cw, ch = W // (SUB * CGRID), H // (SUB * CGRID)
    t = arr_ct.reshape(cw, ch, CGRID, CGRID, SUB, SUB, -1)
    t = t.permute(0, 2, 4, 1, 3, 5, 6)
    return t.reshape(W * H, -1)


def _build_slabs(wt, prim_ids, eye, leaf_size: int):
    """Per-treelet prim slabs f32[T, L, 16]: cu, cv, cw, cden (12 floats),
    t0, the prim id's int bits, two zeros. Padding prims get t0 = 0, which
    never hits (t0 * den > 0 fails)."""
    coefs, t0 = R._moller_coefs(wt, eye)  # [P, 4, 3], [P]
    t0 = torch.where(prim_ids >= 0, t0, 0.0)
    p = wt.shape[0]
    rows = torch.cat([
        coefs.reshape(p, 12),
        t0[:, None],
        prim_ids.to(I32).contiguous().view(F32)[:, None],
        torch.zeros((p, 2), dtype=F32, device=wt.device),
    ], dim=1)
    return rows.reshape(p // leaf_size, leaf_size, PRIM_WORDS).contiguous()


def _prepare_pairs(eye, dirs_ct, bmin, bmax, n_ct, cand_cap, pair_cap, group):
    """Coarse binning -> flat padded pair list (see `_compact_pairs`)."""
    dmin = dirs_ct.amin(dim=2)
    dmax = dirs_ct.amax(dim=2)
    possible, t_lb = R._cone_vs_aabb(
        eye, dmin[:, None, :], dmax[:, None, :], bmin[None], bmax[None]
    )  # [CT, T]
    return _compact_pairs(possible, t_lb, n_ct, cand_cap, pair_cap, group)


def _compact_pairs(possible, t_lb, n_ct, cand_cap, pair_cap, group):
    """[CT, T] candidate mask + entry t -> per-tile front-to-back pair list.

    Returns (p_tid i32[P] (-1 pad), p_tlb f32[P], p_ct i32[P], t_start
    i32[CT], t_end i32[CT], empty_ct bool[CT], overflow bool[]). Tiles
    with zero candidates own no pairs."""
    dev = possible.device
    nt = possible.shape[1]
    key = torch.where(possible, t_lb, BIG)
    key_s, tid_s = torch.sort(key, dim=1, stable=True)  # per tile, ascending
    counts = possible.sum(dim=1, dtype=I32)
    # columns: a multiple of the group so every padded slot has one owner
    cc = max(group, ((min(cand_cap, nt) + group - 1) // group) * group)
    in_cnt = torch.arange(nt, device=dev)[None, :] < counts[:, None]
    cand = torch.where(in_cnt, tid_s.to(I32), -1)
    tlb = torch.where(in_cnt, key_s, BIG)
    if nt >= cc:
        cand, tlb = cand[:, :cc], tlb[:, :cc]
    else:
        cand = torch.cat([cand, torch.full((n_ct, cc - nt), -1, dtype=I32, device=dev)], 1)
        tlb = torch.cat([tlb, torch.full((n_ct, cc - nt), BIG, dtype=F32, device=dev)], 1)

    pc = ((torch.clamp(counts, max=cc) + group - 1) // group) * group
    end = torch.cumsum(pc, dim=0, dtype=torch.int64)
    off = end - pc
    overflow = (end[-1] > pair_cap) | (counts > cand_cap).any()

    rank = torch.arange(cc, device=dev)[None, :]
    dump = n_ct * cc  # slot for entries past each tile's padded count
    slot = torch.where(rank < pc[:, None], off[:, None] + rank, dump).reshape(-1)
    size = max(dump, pair_cap) + 1
    p_tid = torch.full((size,), -1, dtype=I32, device=dev).scatter_(0, slot, cand.reshape(-1))
    p_tlb = torch.full((size,), BIG, dtype=F32, device=dev).scatter_(0, slot, tlb.reshape(-1))
    ct_ids = torch.arange(n_ct, dtype=I32, device=dev)[:, None].expand(n_ct, cc)
    p_ct = torch.full((size,), n_ct - 1, dtype=I32, device=dev).scatter_(
        0, slot, ct_ids.reshape(-1)
    )
    t_start = torch.clamp(off, max=pair_cap).to(I32)
    t_end = torch.clamp(end, max=pair_cap).to(I32)
    return (p_tid[:pair_cap], p_tlb[:pair_cap], p_ct[:pair_cap], t_start, t_end,
            counts == 0, overflow)


def _pair_bits(dirs_ct, bmin, bmax, eye, p_tid, p_ct):
    """Per-(pair, subtile) cone test -> one i32 bitmask per pair."""
    n_ct = dirs_ct.shape[0]
    nt = bmin.shape[0]
    dev = dirs_ct.device
    dsub = dirs_ct.reshape(n_ct, 3, NSUB, RPT)
    dmin_s = dsub.amin(dim=3).permute(0, 2, 1)  # [CT, NSUB, 3]
    dmax_s = dsub.amax(dim=3).permute(0, 2, 1)
    empty = torch.tensor([[BIG] * 3 + [-BIG] * 3], dtype=F32, device=dev)
    ab = torch.cat([bmin - eye, bmax - eye], dim=1)  # [T, 6]
    ab = torch.cat([ab, empty - torch.cat([eye, eye])[None]])
    safe_tid = torch.where(p_tid >= 0, p_tid, nt).to(torch.int64)
    pair_ab = ab[safe_tid]  # [P, 6]
    pc = p_ct.to(torch.int64)
    live, _ = R._cone_vs_aabb(
        torch.zeros(3, dtype=F32, device=dev),
        dmin_s[pc], dmax_s[pc], pair_ab[:, None, 0:3], pair_ab[:, None, 3:6],
    )  # [P, NSUB]
    weights = torch.ones(NSUB, dtype=I32, device=dev) << torch.arange(NSUB, dtype=I32, device=dev)
    bits = torch.where(live, weights[None, :], 0).sum(dim=1, dtype=I32)
    return torch.where(p_tid >= 0, bits, 0)


def raster_sweep(dirs_ct, slabs, p_tid, p_tlb, p_bits, t_start, t_end):
    """Closest hits of every ray over its tile's pairs; dispatch by device.
    dirs_ct f32[CT, 3, 4096]; slabs f32[T, L, 16]; per pair p_tid, p_tlb,
    p_bits [P]; per tile t_start, t_end [CT]. Returns (t, prim, u, v,
    count), each [CT, 4096] (prim and count i32)."""
    if on_cuda(dirs_ct):
        return _raster_sweep_cuda(dirs_ct, slabs, p_tid, p_tlb, p_bits, t_start, t_end)
    return raster_sweep_reference(dirs_ct, slabs, p_tid, p_tlb, p_bits, t_start, t_end)


def raster_sweep_reference(dirs_ct, slabs, p_tid, p_tlb, p_bits, t_start, t_end):
    """Plain PyTorch version (any device): loops over pair rank within a
    tile, vectorised across tiles and subtiles, with the kernel's skip rule
    and arithmetic order (so the counts and bits agree too)."""
    n_ct = dirs_ct.shape[0]
    L = slabs.shape[1]
    dev = dirs_ct.device
    d = dirs_ct.reshape(n_ct, 3, NSUB, RPT).permute(0, 2, 3, 1)  # [CT, 16, 256, 3]
    best_t = torch.full((n_ct, NSUB, RPT), BIG, dtype=F32, device=dev)
    best_p = torch.full((n_ct, NSUB, RPT), -1, dtype=I32, device=dev)
    best_u = torch.zeros((n_ct, NSUB, RPT), dtype=F32, device=dev)
    best_v = torch.zeros((n_ct, NSUB, RPT), dtype=F32, device=dev)
    count = torch.zeros((n_ct, NSUB, RPT), dtype=I32, device=dev)
    tmax = torch.full((n_ct, NSUB), BIG, dtype=F32, device=dev)
    sbit = torch.ones(NSUB, dtype=I32, device=dev) << torch.arange(NSUB, dtype=I32, device=dev)
    n_pairs = (t_end - t_start).to(torch.int64)
    rows = torch.arange(L, device=dev)
    last = max(p_tid.shape[0] - 1, 0)
    for rank in range(int(n_pairs.max()) if n_ct else 0):
        k = torch.clamp(t_start.to(torch.int64) + rank, max=last)
        live = ((rank < n_pairs)[:, None] & ((p_bits[k][:, None] & sbit) != 0)
                & (p_tlb[k][:, None] < tmax))
        ci, si = torch.nonzero(live, as_tuple=True)
        if ci.numel() == 0:
            continue
        count[ci, si] += L
        c = slabs[p_tid[k[ci]].to(torch.int64)][:, None]  # [N, 1, L, 16]
        dd = d[ci, si][..., None]  # [N, 256, 3, 1]
        dx, dy, dz = dd[:, :, 0], dd[:, :, 1], dd[:, :, 2]

        def plane(j):
            return c[..., j] * dx + c[..., j + 1] * dy + c[..., j + 2] * dz  # [N, 256, L]

        un, vn, wn, den = plane(0), plane(3), plane(6), plane(9)
        tn = c[..., 12]
        ok = (un * den > 0) & (vn * den > 0) & (wn * den > 0) & (tn * den > 0)
        inv = 1.0 / torch.where(den != 0, den, 1.0)
        tp = torch.where(ok, tn * inv, BIG)
        tmin = tp.amin(dim=-1)
        win = torch.where(tp == tmin[..., None], rows, L).amin(dim=-1, keepdim=True)
        win = torch.clamp(win, max=L - 1)
        u_best = (un * inv).gather(-1, win)[..., 0]
        v_best = (vn * inv).gather(-1, win)[..., 0]
        pid = c[:, 0, :, 13].contiguous().view(I32).gather(1, win[..., 0])
        better = tmin < best_t[ci, si]
        best_t[ci, si] = torch.where(better, tmin, best_t[ci, si])
        best_p[ci, si] = torch.where(better, pid, best_p[ci, si])
        best_u[ci, si] = torch.where(better, u_best, best_u[ci, si])
        best_v[ci, si] = torch.where(better, v_best, best_v[ci, si])
        tmax[ci, si] = best_t[ci, si].amax(dim=-1)
    flat = lambda x: x.reshape(n_ct, RPC)
    return flat(best_t), flat(best_p), flat(best_u), flat(best_v), flat(count)


def _raster_sweep_cuda(dirs_ct, slabs, p_tid, p_tlb, p_bits, t_start, t_end):
    """The split sweep of `csrc/raster.cu`. Needs p_tlb non-decreasing
    within each tile's [t_start, t_end), as `prepare_sweep` makes it."""
    global last_stats
    n_ct = dirs_ct.shape[0]
    nt, L = slabs.shape[0], slabs.shape[1]
    P = p_tid.shape[0]
    kernels.require(dirs_ct, "dirs_ct", F32, (n_ct, 3, RPC))
    kernels.require(slabs, "slabs", F32, (nt, L, PRIM_WORDS))
    kernels.require(p_tid, "p_tid", I32, (P,))
    kernels.require(p_tlb, "p_tlb", F32, (P,))
    kernels.require(p_bits, "p_bits", I32, (P,))
    kernels.require(t_start, "t_start", I32, (n_ct,))
    kernels.require(t_end, "t_end", I32, (n_ct,))
    if n_ct == 0 or not 1 <= L <= MAX_L:
        raise ValueError(f"raster_sweep needs n_ct >= 1 and 1 <= L <= {MAX_L}, got {n_ct}, {L}")
    if P >= MAX_P:
        raise ValueError(f"raster_sweep needs P < 2^22 = {MAX_P} pairs (the hit key), got {P}")
    dev = dirs_ct.device
    out = [torch.empty((n_ct, RPC), dtype=dt, device=dev) for dt in (F32, I32, F32, F32, I32)]
    # scratch: a 64-bit hit key and an event index per ray, a stop bound and
    # a state per subtile, the first event, chunk count and order per tile,
    # the ticket, and per chunk level its item offset and two tile counts
    keys = torch.empty((n_ct * RPC,), dtype=torch.int64, device=dev)
    ints = torch.empty((n_ct * (RPC + 2 * NSUB + 3) + 4 + 3 * (P // CHUNK + 2),), dtype=I32,
                       device=dev)
    stats = torch.empty((STATS,), dtype=torch.int64, device=dev)
    ins = (dirs_ct, slabs, p_tid, p_tlb, p_bits, t_start, t_end)
    kernels.launch("raster_sweep", "tbvh_raster_sweep", *ins, n_ct, P, L, *out, keys, ints,
                   stats, like=dirs_ct, count=lambda: work.sweep("raster_sweep", ins, out),
                   symbols=("rt_init", "rt_sweep", "rt_finish"))
    last_stats = stats
    return tuple(out)


def prepare_sweep(scene: R.RasterScene, rays: Rays, tr, width: int, height: int,
                  cand_cap: int, pair_cap: int, group: int):
    """Everything before the sweep, for width and height that are multiples
    of 64. Returns (the argument tuple of `raster_sweep`, empty_ct bool[CT],
    overflow bool[])."""
    L = scene.leaf_size
    n_ct = (width * height) // RPC
    wt = transform_point(scene.tris_sorted, tr.scale, tr.quat, tr.translation)
    bmin, bmax = R._treelet_aabbs(wt, scene.prim_ids, L)
    eye = rays.origin[0]
    dirs_ct = _to_coarse_layout(rays.direction.reshape(width, height, 3), width, height)
    dirs_ct = dirs_ct.permute(0, 2, 1).contiguous()  # [CT, 3, 4096]
    p_tid, p_tlb, p_ct, t_start, t_end, empty_ct, overflow = _prepare_pairs(
        eye, dirs_ct, bmin, bmax, n_ct, cand_cap, pair_cap, group
    )
    p_bits = _pair_bits(dirs_ct, bmin, bmax, eye, p_tid, p_ct)
    slabs = _build_slabs(wt, scene.prim_ids, eye, L)
    args = (dirs_ct, slabs, p_tid.contiguous(), p_tlb.contiguous(), p_bits.contiguous(),
            t_start, t_end)
    return args, empty_ct, overflow


def pad_rays(rays: Rays, width: int, height: int):
    """Pad a frame's rays to whole 64x64 coarse tiles by replicating the
    last column and row. Returns (Rays, padded width, padded height)."""
    edge = SUB * CGRID
    wp = -(-width // edge) * edge
    hp = -(-height // edge) * edge
    dev = rays.direction.device
    d = rays.direction.reshape(width, height, 3)
    xi = torch.clamp(torch.arange(wp, device=dev), max=width - 1)
    yi = torch.clamp(torch.arange(hp, device=dev), max=height - 1)
    d = d[xi][:, yi]
    rp = Rays(
        origin=rays.origin[0].expand(wp * hp, 3),
        direction=d.reshape(wp * hp, 3),
        tmin=torch.zeros((wp * hp,), dtype=F32, device=dev),
        tmax=torch.full((wp * hp,), FLT_MAX, dtype=F32, device=dev),
    )
    return rp, wp, hp


def render_raster_gpu(
    scene: R.RasterScene,
    rays: Rays,
    tr,
    width: int,
    height: int,
    cand_cap: int = 1024,
    pair_cap: int = 8192,
    group: int = 32,
):
    """Raster render of a pinhole frame (all rays share `rays.origin[0]`).
    Returns (HitInfo in x-major ray order, counts i32[R] = prims swept per
    ray, overflow bool[])."""
    edge = SUB * CGRID
    if width % edge or height % edge:
        # pad to coarse-tile multiples with edge-replicated rays, then crop
        rp, wp, hp = pad_rays(rays, width, height)
        hit, counts, overflow = render_raster_gpu(
            scene, rp, tr, wp, hp, cand_cap, pair_cap, group
        )
        crop = lambda x: x.reshape(wp, hp)[:width, :height].reshape(-1)
        return HitInfo(*(crop(f) for f in hit)), crop(counts), overflow

    sweep_args, empty_ct, overflow = prepare_sweep(
        scene, rays, tr, width, height, cand_cap, pair_cap, group
    )
    out_t, out_p, out_u, out_v, out_c = raster_sweep(*sweep_args)
    # every ray is written by the sweep; tiles without pairs are patched to
    # miss here as well, so no output depends on an unvisited tile
    e = empty_ct[:, None]
    out_t = torch.where(e, BIG, out_t)
    out_p = torch.where(e, -1, out_p)
    out_u = torch.where(e, 0.0, out_u)
    out_v = torch.where(e, 0.0, out_v)
    out_c = torch.where(e, 0, out_c)
    flat = lambda x: _from_coarse_layout(x[:, :, None], width, height)[:, 0]
    t, prim, u, v, counts = (flat(x) for x in (out_t, out_p, out_u, out_v, out_c))
    miss = (prim < 0) | (t >= BIG)
    hit = HitInfo(
        prim_idx=torch.where(miss, -1, prim),
        t=torch.where(miss, FLT_MAX, t),
        u=torch.where(miss, 0.0, u),
        v=torch.where(miss, 0.0, v),
    )
    return hit, counts, overflow
