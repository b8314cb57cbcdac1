"""Tile-binned raster render: scene packing and the shared math.

Morton-sorted triangles are chopped into treelets of L prims; screen tiles
cull treelets with a conservative direction-cone test; a tile sweeps its
surviving treelets front to back. For a pinhole frame every ray shares the
eye, so Möller's numerators and denominator are linear in the direction:
four 3-vectors per prim (`_moller_coefs`). The sweep itself is
`raster_gpu.render_raster_gpu`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..types import Bvh2
from .aabb import _cross

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
