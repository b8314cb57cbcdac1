"""Tile-binned raster render: scene packing, the shared math, and the
XLA engine's port.

Morton-sorted triangles are chopped into treelets of L prims; screen tiles
cull treelets with a conservative direction-cone test; a tile sweeps its
surviving treelets front to back. For a pinhole frame every ray shares the
eye, so Möller's numerators and denominator are linear in the direction:
four 3-vectors per prim (`_moller_coefs`). On the card the sweep is
`raster_gpu.render_raster_gpu` (B4). `render_raster_xla` is the port of
JAX's engine off the TPU (tiles of 16 x 16 rays, two passes over the
candidate lists), in plain torch ops: the app's raster path on the CPU,
where its t, u, v equal JAX's op-by-op run bit for bit. Nothing on the
card takes it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..types import FLT_MAX, Bvh2, HitInfo, Rays, Transformation
from .aabb import _cross, transform_point

I32 = torch.int32
F32 = torch.float32
BIG = 3.0e38


class RasterScene(NamedTuple):
    """Morton-sorted triangles in object space, chopped into treelets of
    `leaf_size` prims (treelet t holds rows [t*L, (t+1)*L))."""

    tris_sorted: torch.Tensor  # f32[T*L, 3, 3] (padding rows are zero)
    prim_ids: torch.Tensor  # i32[T*L] original prim index (-1 = padding)
    n_real: int
    leaf_size: int


def pack_raster(bvh: Bvh2, tris, leaf_size: int = 64) -> RasterScene:
    """Gather triangles into the tree's sorted leaf order and pad to whole
    treelets."""
    prim = bvh.left[bvh.n_internal:]
    ts = tris[torch.clamp(prim, 0, tris.shape[0] - 1).to(torch.int64)]
    return pack_raster_sorted(ts, prim, leaf_size)


def pack_raster_sorted(tris_sorted, prim_ids, leaf_size: int = 64) -> RasterScene:
    """Packing straight from sorted-leaf products."""
    n = tris_sorted.shape[0]
    pad = (-n) % leaf_size
    if pad:
        dev = tris_sorted.device
        tris_sorted = torch.cat([tris_sorted, torch.zeros((pad, 3, 3), dtype=F32, device=dev)])
        prim_ids = torch.cat([prim_ids, torch.full((pad,), -1, dtype=I32, device=dev)])
    return RasterScene(tris_sorted=tris_sorted, prim_ids=prim_ids, n_real=n, leaf_size=leaf_size)


def _treelet_aabbs(world_tris, prim_ids, leaf_size: int):
    """Treelet AABBs f32[T, 3] by segmented reduce (padding rows stay empty)."""
    nt = world_tris.shape[0] // leaf_size
    v = world_tris.reshape(nt, leaf_size, 3, 3)
    real = (prim_ids >= 0).reshape(nt, leaf_size, 1, 1)
    mn = torch.where(real, v, BIG).amin(dim=(1, 2))
    mx = torch.where(real, v, -BIG).amax(dim=(1, 2))
    return mn, mx


def _moller_coefs(world_tris, eye):
    """Fixed-origin Möller coefficients. For origin e and direction d:

      u_num = ((v0+v2-2e) x (v2-v0)) . d
      v_num = ((v1+v0-2e) x (v0-v1)) . d
      w_num = ((v2+v1-2e) x (v1-v2)) . d
      den   = 2 * ((v0-v1) x (v2-v0)) . d
      t_num = 2 * (v0 - e) . normal          (constant per prim)

    Returns (coefs f32[P, 4, 3] rows (cu, cv, cw, cden), t0 f32[P])."""
    v0, v1, v2 = world_tris[:, 0], world_tris[:, 1], world_tris[:, 2]
    edge0 = v2 - v0
    edge1 = v0 - v1
    normal = _cross(edge1, edge0)
    edge2 = v1 - v2
    cu = _cross(v0 + v2 - 2.0 * eye, edge0)
    cv = _cross(v1 + v0 - 2.0 * eye, edge1)
    cw = _cross(v2 + v1 - 2.0 * eye, edge2)
    cden = 2.0 * normal
    t0 = 2.0 * ((v0 - eye) * normal).sum(dim=-1)
    return torch.stack([cu, cv, cw, cden], dim=1), t0


def _cone_vs_aabb(eye, dmin, dmax, bmin, bmax):
    """Can any ray from `eye` with direction in the box [dmin, dmax] hit
    the AABB [bmin, bmax]? Conservative (axes treated independently).
    Returns (possible bool[...], t_lower f32[...]); last axis is xyz."""
    return _interval_cull(bmin - eye, bmax - eye, dmin, dmax)


def _obox_vs_aabb(omin, omax, dmin, dmax, bmin, bmax):
    """`_cone_vs_aabb` widened from a point eye to an origin box
    [omin, omax]: can any ray with its origin in the box and its direction
    in [dmin, dmax] hit the AABB? Per axis the reachable interval at t >= 0
    is [omin + t*dmin, omax + t*dmax]. Used by the general-ray sweep
    (`ray_sweep.py`), where rays do not share an eye."""
    return _interval_cull(bmin - omax, bmax - omin, dmin, dmax)


def _interval_cull(a, b, dmin, dmax):
    """Exists t >= 0 with t*dmax >= a and t*dmin <= b on every axis."""
    one = torch.ones((), dtype=F32, device=a.device)
    zero = torch.zeros((), dtype=F32, device=a.device)
    big = torch.full((), BIG, dtype=F32, device=a.device)
    lo1 = torch.where((dmax > 0) & (a > 0), a / torch.where(dmax > 0, dmax, one), zero)
    hi1 = torch.where((dmax < 0) & (a <= 0), a / torch.where(dmax < 0, dmax, one), big)
    empty1 = (dmax <= 0) & (a > 0)
    hi2 = torch.where(dmin > 0, b / torch.where(dmin > 0, dmin, one), big)
    lo2 = torch.where((dmin < 0) & (b < 0), b / torch.where(dmin < 0, dmin, one), zero)
    empty2 = (dmin >= 0) & (b < 0)
    lo = torch.maximum(lo1, lo2).amax(dim=-1)
    hi = torch.minimum(hi1, hi2).amin(dim=-1)
    empty = (empty1 | empty2).any(dim=-1)
    possible = (~empty) & (lo <= hi)
    return possible, torch.where(possible, lo, big)


def tile_order(width: int, height: int, tile: int):
    """Permutation p with dirs_tile_major = dirs_xmajor[p] for the flat ray
    layout (index = x * height + y): tile (tx, ty) in x-major order, then
    the tile's rays x-major. i64[W * H]."""
    if width % tile or height % tile:
        raise ValueError(f"{width}x{height} is not a whole number of {tile}-pixel tiles")
    flat = torch.arange(width * height, dtype=torch.int64).reshape(width, height)
    t = flat.reshape(width // tile, tile, height // tile, tile).permute(0, 2, 1, 3)
    return t.reshape(-1)


class RasterBins(NamedTuple):
    """Per-frame binning: for each tile, up to `cap` candidate treelets in
    front-to-back (eye-distance) order, padded with -1."""

    cand: torch.Tensor  # i32[tiles, cap] treelet ids, -1 padding
    t_lb: torch.Tensor  # f32[tiles, cap] conservative entry-t lower bound
    counts: torch.Tensor  # i32[tiles]
    overflow: torch.Tensor  # bool[]


def bin_treelets(eye, dirs_tile_major, bmin, bmax, n_tiles: int, rays_per_tile: int,
                 cap: int) -> RasterBins:
    """Dense cone-vs-AABB culling of every (tile, treelet) and compaction
    of each tile's survivors in eye-distance order (a stable argsort of
    the treelets' squared center distances, summed as XLA sums them)."""
    d = dirs_tile_major.reshape(n_tiles, rays_per_tile, 3)
    dmin = d.amin(dim=1)
    dmax = d.amax(dim=1)

    c = (bmin + bmax) * 0.5 - eye
    sq = c * c
    dist = ((sq[:, 0] + 0.0) + sq[:, 1]) + sq[:, 2]
    order = torch.argsort(dist, stable=True).to(I32)
    possible, t_lb = _cone_vs_aabb(eye, dmin[:, None, :], dmax[:, None, :],
                                   bmin[order][None], bmax[order][None])  # [tiles, T]

    pos = torch.cumsum(possible.to(I32), dim=1)
    counts = pos[:, -1].to(I32)
    slot = torch.clamp(torch.where(possible, pos - 1, cap), max=cap).to(torch.int64)
    cand = torch.full((n_tiles, cap + 1), -1, dtype=I32, device=eye.device)
    tlb = torch.full((n_tiles, cap + 1), BIG, dtype=F32, device=eye.device)
    # a tile's survivors take distinct slots; the rest land in the dropped
    # column `cap`
    cand.scatter_(1, slot, order[None].expand(n_tiles, -1).contiguous())
    tlb.scatter_(1, slot, t_lb)
    return RasterBins(cand=cand[:, :cap], t_lb=tlb[:, :cap], counts=counts,
                      overflow=(counts > cap).any())


def _sweep(dirs, coefs, t0):
    """Dense ray-vs-prim sweep: dirs f32[..., R, 3], coefs f32[..., P, 4, 3],
    t0 f32[..., P] (0 never hits), leading dimensions batched. Returns per
    ray the best in the slab: (t f32[..., R] (BIG = miss), local prim
    i32[..., R], u, v f32[..., R]); among equal t the lowest prim."""
    p = coefs.shape[-3]
    c = coefs.reshape(*coefs.shape[:-3], 1, p * 4, 3)
    d = dirs[..., :, None, :]
    planes = d[..., 0] * c[..., 0] + d[..., 1] * c[..., 1] + d[..., 2] * c[..., 2]
    planes = planes.reshape(*dirs.shape[:-1], p, 4)
    un, vn, wn, den = planes.unbind(-1)
    tn = t0[..., None, :]
    valid = torch.minimum(torch.minimum(un * den, vn * den),
                          torch.minimum(wn * den, tn * den)) > 0
    safe_den = torch.where(den != 0, den, 1.0)
    t = torch.where(valid, tn / safe_den, BIG)
    tmin = t.amin(dim=-1)
    lp = torch.arange(p, dtype=I32, device=dirs.device)
    prim = torch.where(t == tmin[..., None], lp, p).amin(dim=-1)
    best = lp == prim[..., None]  # exactly one column per ray that hits
    inv = 1.0 / safe_den
    u = torch.where(best, un * inv, BIG).amin(dim=-1)
    v = torch.where(best, vn * inv, BIG).amin(dim=-1)
    return tmin, prim, u, v


def _combine(acc, new):
    """Closest-hit merge of two (t, prim, u, v) tuples."""
    better = new[0] < acc[0]
    return tuple(torch.where(better, n, a) for n, a in zip(new, acc))


def render_raster_xla(scene: RasterScene, rays: Rays, tr: Transformation, width: int,
                      height: int, tile: int = 16, cap_a: int = 16, cap_b: int = 256,
                      tiles_b: int = 64):
    """Raster render in plain torch ops, JAX's engine off the TPU. Pass A
    sweeps the first `cap_a` candidate treelets of every tile; the tiles
    with more candidates are compacted into `tiles_b` slots and sweep
    their slots [cap_a, cap_b) in pass B, run only when some tile needs it.

    Returns (HitInfo in the flat x-major ray order, counts i32[R] = prims
    swept per ray, overflow bool[]: a tile had more than cap_b candidates
    or more than tiles_b tiles needed pass B)."""
    return _render_xla_impl(scene.tris_sorted, scene.prim_ids, rays, tr, width, height, tile,
                            cap_a, cap_b, tiles_b, scene.leaf_size)


# elements of one pass's [tiles, rays, 4 * prims] plane tensor swept at once
_SWEEP_ELEMS = 1 << 23


def _render_xla_impl(tris_sorted, prim_ids, rays: Rays, tr: Transformation, width: int,
                     height: int, tile: int, cap_a: int, cap_b: int, tiles_b: int,
                     leaf_size: int):
    L = leaf_size
    dev = tris_sorted.device
    n_rays = width * height
    rpt = tile * tile
    n_tiles = n_rays // rpt
    perm = tile_order(width, height, tile).to(dev)

    wt = transform_point(tris_sorted, tr.scale, tr.quat, tr.translation)
    bmin, bmax = _treelet_aabbs(wt, prim_ids, L)
    eye = rays.origin[0]
    coefs, t0 = _moller_coefs(wt, eye)
    t0 = torch.where(prim_ids >= 0, t0, 0.0)  # padding prims never hit
    nt = bmin.shape[0]
    coefs_t = coefs.reshape(nt, L, 4, 3)
    t0_t = t0.reshape(nt, L)

    dirs_tm = rays.direction[perm].reshape(n_tiles, rpt, 3)
    bins = bin_treelets(eye, dirs_tm.reshape(-1, 3), bmin, bmax, n_tiles, rpt, cap_b)

    def sweep_slots(d, ids):
        """Sweep the treelets `ids` i32[B, k] (-1 padded at the back) for
        the tiles' rays d f32[B, rpt, 3]. Returns (t, sorted-leaf prim, u,
        v), each [B, rpt], in chunks of tiles that bound the plane tensor.
        A padding slot never hits (t0 = 0), so only the first slots up to
        the most any tile fills are swept: the hits, the lowest-index rule
        among equal t and the misses (t BIG, prim -1) are unchanged."""
        k = int((ids >= 0).sum(dim=1).amax()) if ids.numel() else 0
        n = ids.shape[0]
        if k == 0:
            big = torch.full((n, rpt), BIG, dtype=F32, device=dev)
            return big, torch.full((n, rpt), -1, dtype=I32, device=dev), big, big
        ids = ids[:, :k]
        step = max(1, _SWEEP_ELEMS // (rpt * k * L * 4))
        outs = []
        for a in range(0, n, step):
            sid = torch.clamp(ids[a:a + step], 0, nt - 1).to(torch.int64)
            b = sid.shape[0]
            c = coefs_t[sid].reshape(b, k * L, 4, 3)
            tt = torch.where((ids[a:a + step] >= 0)[:, :, None], t0_t[sid], 0.0).reshape(b, k * L)
            t2, lp, u2, v2 = _sweep(d[a:a + step], c, tt)
            lp = torch.clamp(lp, 0, k * L - 1).to(torch.int64)
            gprim = (torch.gather(sid, 1, lp // L) * L + lp % L).to(I32)
            outs.append((t2, torch.where(t2 < BIG, gprim, -1), u2, v2))
        return tuple(torch.cat(x) for x in zip(*outs))

    # pass A: the first cap_a candidates of every tile
    t, prim, u, v = sweep_slots(dirs_tm, bins.cand[:, :cap_a])

    # pass B: the tiles with more candidates sweep slots [cap_a, cap_b)
    over = bins.counts > cap_a
    n_over = int(over.sum())
    if n_over > 0:
        opos = torch.cumsum(over.to(I32), dim=0) - 1
        slot = torch.where(over, torch.clamp(opos, max=tiles_b - 1), tiles_b).to(torch.int64)
        # past tiles_b overflowing tiles several share the last slot: the
        # highest tile keeps it, as the last write of XLA's scatter does
        tsel = torch.full((tiles_b + 1,), n_tiles, dtype=torch.int64, device=dev)
        tsel.scatter_reduce_(0, slot, torch.arange(n_tiles, dtype=torch.int64, device=dev),
                             reduce="amax", include_self=False)
        tsel = tsel[:tiles_b]
        tclip = torch.clamp(tsel, max=n_tiles - 1)
        ids_b = torch.where((tsel < n_tiles)[:, None], bins.cand[tclip, cap_a:], -1)
        tb, pb, ub, vb = sweep_slots(dirs_tm[tclip], ids_b)
        # scatter back as XLA's scatter does, the last write to a tile
        # winning (tclip is non-decreasing; the padding slots write the
        # last tile after any real one)
        last = torch.ones_like(tclip, dtype=torch.bool)
        last[:-1] = tclip[1:] != tclip[:-1]
        dst = tclip[last]
        scattered = []
        for fill, src in ((BIG, tb), (-1, pb), (0.0, ub), (0.0, vb)):
            full = torch.full_like(t if src.dtype == F32 else prim, fill)
            full[dst] = src[last]
            scattered.append(full)
        t, prim, u, v = _combine((t, prim, u, v), scattered)

    counts = (torch.clamp(bins.counts, max=cap_b) * L).to(I32)
    counts = counts[:, None].expand(n_tiles, rpt).reshape(-1)

    t = t.reshape(-1)
    prim_sorted = prim.reshape(-1)
    u = u.reshape(-1)
    v = v.reshape(-1)
    miss = prim_sorted < 0
    safe = torch.clamp(prim_sorted, 0, prim_ids.shape[0] - 1).to(torch.int64)
    prim_orig = torch.where(miss, -1, prim_ids[safe])

    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n_rays, dtype=torch.int64, device=dev)
    hit = HitInfo(
        prim_idx=prim_orig[inv].to(I32),
        t=torch.where(miss, FLT_MAX, t)[inv],
        u=torch.where(miss, 0.0, u)[inv],
        v=torch.where(miss, 0.0, v)[inv],
    )
    overflow = bins.overflow | (n_over > tiles_b)
    return hit, counts[inv], overflow
