"""Scene fixtures: cornellbox, the procedural benchmark scenes, and the
camera/transform presets. Same generators and seeds as `tpu_bvh.utils.scenes`,
so both packages build the same triangles. Also the caterpillar scene of
the JAX collapse tests, the deep chain of its traversal tests and the JAX
bench's shadow workload."""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..types import Camera, Transformation
from .obj import load_obj


# the reference checkout's cornellbox, where the JAX package looks for it
_REFERENCE_CORNELLBOX = "/root/reference/src/Meshes/cornellbox/cornellBox.obj"


def cornellbox() -> np.ndarray:
    """The cornellbox, found as the JAX package finds it: the OBJ named by
    `TPU_BVH_CORNELLBOX`, else the reference's (32 triangles) at
    `_REFERENCE_CORNELLBOX`; when that file does not exist, a procedural
    box of the same layout (36 triangles)."""
    path = os.environ.get("TPU_BVH_CORNELLBOX", _REFERENCE_CORNELLBOX)
    if os.path.exists(path):
        return load_obj(path)
    return _procedural_cornellbox()


def _procedural_cornellbox() -> np.ndarray:
    """5-wall box + light + two blocks ([-3, 2.5] x [0, 5.3] x [-5.8, 0])."""
    quads = []

    def quad(a, b, c, d):
        quads.append((a, b, c))
        quads.append((a, c, d))

    lo = np.array([-3.0, -0.16, -5.84])
    hi = np.array([2.55, 5.33, -0.25])
    # floor, ceiling, back wall, left, right
    quad((lo[0], lo[1], lo[2]), (hi[0], lo[1], lo[2]), (hi[0], lo[1], hi[2]), (lo[0], lo[1], hi[2]))
    quad((lo[0], hi[1], lo[2]), (lo[0], hi[1], hi[2]), (hi[0], hi[1], hi[2]), (hi[0], hi[1], lo[2]))
    quad((lo[0], lo[1], lo[2]), (lo[0], hi[1], lo[2]), (hi[0], hi[1], lo[2]), (hi[0], lo[1], lo[2]))
    quad((lo[0], lo[1], lo[2]), (lo[0], lo[1], hi[2]), (lo[0], hi[1], hi[2]), (lo[0], hi[1], lo[2]))
    quad((hi[0], lo[1], lo[2]), (hi[0], hi[1], lo[2]), (hi[0], hi[1], hi[2]), (hi[0], lo[1], hi[2]))

    def box(cmin, cmax):
        x0, y0, z0 = cmin
        x1, y1, z1 = cmax
        quad((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0))
        quad((x0, y0, z1), (x0, y1, z1), (x1, y1, z1), (x1, y0, z1))
        quad((x0, y0, z0), (x0, y1, z0), (x0, y1, z1), (x0, y0, z1))
        quad((x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0))
        quad((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1))
        quad((x0, y0, z0), (x0, y0, z1), (x1, y0, z1), (x1, y0, z0))

    box((-1.9, -0.16, -4.4), (-0.4, 3.1, -2.9))
    box((0.5, -0.16, -3.4), (1.9, 1.5, -2.0))
    quad((-0.88, 5.32, -3.57), (0.42, 5.32, -3.57), (0.42, 5.32, -2.52), (-0.88, 5.32, -2.52))
    return np.asarray(quads, dtype=np.float32)


def bunny_like(n_tris: int = 150_000, seed: int = 0) -> np.ndarray:
    """Compact object at bunny scale: a UV sphere with smooth pseudo-random
    radial displacement. Deterministic."""
    lon = max(8, int(math.sqrt(n_tris / 2.0)))
    lat = max(4, n_tris // (2 * lon))
    phi = np.linspace(0.0, math.pi, lat + 1)
    theta = np.linspace(0.0, 2 * math.pi, lon + 1)
    pp, tt = np.meshgrid(phi, theta, indexing="ij")
    rng = np.random.default_rng(seed)
    r = np.ones_like(pp)
    for _ in range(6):
        fa, fb = rng.integers(1, 5, size=2)
        pa, pb, amp = rng.uniform(0, 2 * math.pi), rng.uniform(0, 2 * math.pi), rng.uniform(0.02, 0.12)
        r = r + amp * np.sin(fa * pp + pa) * np.cos(fb * tt + pb)
    x = r * np.sin(pp) * np.cos(tt)
    y = r * np.cos(pp)
    z = r * np.sin(pp) * np.sin(tt)
    grid = np.stack([x, y, z], axis=-1).astype(np.float32)  # [lat+1, lon+1, 3]
    a = grid[:-1, :-1]
    b = grid[:-1, 1:]
    c = grid[1:, 1:]
    d = grid[1:, :-1]
    t1 = np.stack([a, b, c], axis=-2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], axis=-2).reshape(-1, 3, 3)
    return np.concatenate([t1, t2], axis=0)


def sponza_like(n_tris: int = 262_000, seed: int = 1) -> np.ndarray:
    """Architectural interior at sponza scale: a colonnade hall (floor,
    walls, rows of faceted columns) and a field of small clutter boxes.
    Deterministic."""
    rng = np.random.default_rng(seed)
    tris: list[np.ndarray] = []

    def add_quad(a, b, c, d):
        a, b, c, d = (np.asarray(p, np.float32) for p in (a, b, c, d))
        tris.append(np.stack([a, b, c]))
        tris.append(np.stack([a, c, d]))

    def add_box(cmin, cmax):
        x0, y0, z0 = cmin
        x1, y1, z1 = cmax
        add_quad((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0))
        add_quad((x0, y0, z1), (x0, y1, z1), (x1, y1, z1), (x1, y0, z1))
        add_quad((x0, y0, z0), (x0, y1, z0), (x0, y1, z1), (x0, y0, z1))
        add_quad((x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0))
        add_quad((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1))
        add_quad((x0, y0, z0), (x0, y0, z1), (x1, y0, z1), (x1, y0, z0))

    # hall shell: 40 x 15 x 20
    add_box((-20, -0.2, -10), (20, 0, 10))  # floor slab
    add_box((-20, 15, -10), (20, 15.2, 10))  # ceiling
    add_box((-20.2, 0, -10), (-20, 15, 10))
    add_box((20, 0, -10), (20.2, 15, 10))
    add_box((-20, 0, -10.2), (20, 15, -10))
    add_box((-20, 0, 10), (20, 15, 10.2))

    n_seg = 16

    def add_column(cx, cz, radius, height):
        ang = np.linspace(0, 2 * math.pi, n_seg + 1)
        xs = cx + radius * np.cos(ang)
        zs = cz + radius * np.sin(ang)
        for i in range(n_seg):
            add_quad(
                (xs[i], 0, zs[i]),
                (xs[i + 1], 0, zs[i + 1]),
                (xs[i + 1], height, zs[i + 1]),
                (xs[i], height, zs[i]),
            )
        add_box((cx - radius * 1.3, height, cz - radius * 1.3), (cx + radius * 1.3, height + 0.6, cz + radius * 1.3))

    for cx in np.linspace(-17, 17, 12):
        add_column(cx, -6.0, 0.8, 9.0)
        add_column(cx, 6.0, 0.8, 9.0)

    base = np.stack(tris)
    # clutter: small boxes (12 tris each) up to the target count
    remaining = max(0, n_tris - base.shape[0])
    n_boxes = remaining // 12
    centers = rng.uniform([-19, 0, -9], [19, 2.5, 9], size=(n_boxes, 3))
    sizes = rng.uniform(0.05, 0.5, size=(n_boxes, 3))
    tris = []
    for ctr, sz in zip(centers, sizes):
        add_box(ctr - sz, ctr + sz)
    clutter = np.stack(tris) if tris else np.zeros((0, 3, 3), np.float32)
    return np.concatenate([base, clutter], axis=0).astype(np.float32)


CATERPILLAR_CLUSTER = 330  # tiny triangles in the caterpillar's cluster
CATERPILLAR_CHAIN = 26  # its outliers, one Morton top bit each
SHADOW_SLICE = 65536  # rays in the shadow workload's strided forward slice


def caterpillar() -> np.ndarray:
    """A chain-shaped crown: a tight cluster of tiny triangles plus outliers
    at x = 2^-26 ... 0.5, each adding one Morton top bit. Every chain
    ancestor's leaf range holds the whole cluster, so the long-node count
    exceeds the fast collapse's bushy-tree capacity (its overflow branch)."""
    tris = []
    for i in range(CATERPILLAR_CLUSTER):
        x = 1e-4 * (i / CATERPILLAR_CLUSTER)
        tris.append([[x, 0, 0], [x + 1e-6, 1e-6, 0], [x, 0, 1e-6]])
    for i in range(CATERPILLAR_CHAIN):
        x = 2.0 ** (i - CATERPILLAR_CHAIN)
        tris.append([[x, 0, 0], [x + 1e-6, 1e-6, 0], [x, 0, 1e-6]])
    return np.asarray(tris, np.float32)


def deep_chain(n_leaves: int = 64, hot_prim: int = 60) -> dict:
    """A hand-built Bvh2 deeper than the traversal's stack (the chain of
    the JAX traversal tests): internal node i has left = leaf i and right =
    internal i + 1, every box is [-10, 10]^3, so both children always hit
    and a far leaf is pushed at every level. Only `hot_prim`'s triangle
    crosses the first ray (at t = 2); the second ray misses the boxes.
    Returns numpy arrays: node_min, node_max f32[M, 3], left, right i32[M],
    tris f32[n, 3, 3], origin, direction f32[2, 3]."""
    n, ni, m = n_leaves, n_leaves - 1, 2 * n_leaves - 1
    left = np.full(m, -1, np.int32)
    right = np.full(m, -1, np.int32)
    left[:ni] = ni + np.arange(ni)
    right[:ni] = np.append(np.arange(1, ni), m - 1)
    left[ni:] = np.arange(n)
    dx = np.where(np.arange(n) == hot_prim, 0.0, 6.0)[:, None]
    tris = np.zeros((n, 3, 3), np.float32)
    tris[:, :, 2] = 1.0
    tris[:, 0, :2] = np.concatenate([-1 + dx, np.full_like(dx, -1)], axis=1)
    tris[:, 1, :2] = np.concatenate([2 + dx, np.full_like(dx, -1)], axis=1)
    tris[:, 2, :2] = np.concatenate([dx, np.full_like(dx, 2)], axis=1)
    return {"node_min": np.full((m, 3), -10.0, np.float32),
            "node_max": np.full((m, 3), 10.0, np.float32), "left": left, "right": right,
            "tris": tris, "origin": np.array([[0.0, 0.0, -1.0], [50.0, 50.0, -1.0]], np.float32),
            "direction": np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)}


def signed_zero_soup(n: int = 512, seed: int = 0) -> np.ndarray:
    """n triangles with coordinates drawn from {-0.0, +0.0, 1.0}, half of
    them replaced by uniform draws (`np.where` keeps the -0.0): a soup on
    which every min and max must order the signed zeros as JAX does."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, 3, (n, 3, 3))
    f32 = np.float32
    coords = np.where(pick == 0, f32(-0.0), np.where(pick == 1, f32(0.0), f32(1.0)))
    draws = rng.random((n, 3, 3), dtype=f32)
    return np.where(rng.random((n, 3, 3)) < 0.5, coords, draws).astype(f32)


def random_meshes(n: int, max_prims: int, seed: int = 0) -> list:
    """n random soups of 2..max_prims triangles each, for batched builds:
    a uniform base in [-10, 10]^3 and normal vertex offsets of 0.5, as the
    JAX tests' `random_tris`."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(2, max_prims + 1, n)
    tris = rng.uniform(-10, 10, (n, 1, 1, 3)) + rng.normal(0, 0.5, (n, max_prims, 3, 3))
    return [t[:k] for t, k in zip(tris.astype(np.float32), sizes)]


def block_meshes() -> dict:
    """name -> (meshes, capacity) of the batched block kernel's four inputs:
    (a) 1024 random meshes at capacity 1024 (sizes 2-1024: heavy padding),
    (b) 16,384 of 2-128 at 128, (c) 4096 of 2-65 at 65, (d) the +-0 soup in
    meshes of 128 beside meshes of one triangle repeated (every code
    equal) at 128."""
    rng = np.random.default_rng(7)
    tri = random_meshes(1, 2, 8)[0][:1]
    one_tri = [np.repeat(tri, int(n), axis=0) for n in rng.integers(2, 129, 16)]
    soup = list(signed_zero_soup(2048, seed=1).reshape(-1, 128, 3, 3))
    return {"1024x1024": (random_meshes(1024, 1024, 4), 1024),
            "16384x128": (random_meshes(16_384, 128, 5), 128),
            "4096x65": (random_meshes(4096, 65, 6), 65),
            "signed_zero_one_tri128": (soup + one_tri, 128)}


def shadow_workload(tris, rays, hit):
    """The JAX bench's shadow workload (bench.py:719-780) from a primary
    frame: the live hits compacted and padded to a multiple of 4096 (pad
    entries dead), a point light above the soup's object-space box,
    eps = 1e-3 x the box diagonal, the forward shadow rays from the hit
    points to the light over (0, dist - 2 eps), and a strided slice of at
    most SHADOW_SLICE of them. Returns (points f32[P, 3], live bool[P], light
    f32[3], eps, forward (origin, direction, tmin, tmax), slice indices
    i64[S], number of live points)."""
    tb = tris.reshape(-1, 3)
    smin3, smax3 = tb.amin(dim=0), tb.amax(dim=0)
    diag = float(torch.linalg.norm(smax3 - smin3))
    light = torch.stack([(smin3[0] + smax3[0]) * 0.5, smax3[1] + 0.1 * diag,
                         (smin3[2] + smax3[2]) * 0.5])
    eps = 1e-3 * diag
    idx_live = torch.nonzero(hit.prim_idx >= 0).squeeze(1)
    n_live = int(idx_live.numel())
    n_pad = -(-n_live // 4096) * 4096
    sel = torch.cat([idx_live, idx_live[:1].expand(n_pad - n_live)])
    live = torch.arange(n_pad, device=tris.device) < n_live
    t_sel = torch.clamp(hit.t[sel], max=2.0 * diag)
    points = rays.origin[sel] + rays.direction[sel] * t_sel[:, None]
    dvec = light[None, :] - points
    dist = torch.linalg.norm(dvec, dim=1)
    dl = dvec / torch.clamp(dist, min=1e-9)[:, None]
    fwd = (points + dl * eps, dl, torch.zeros_like(dist), torch.where(live, dist - 2 * eps, -1.0))
    nv = min(SHADOW_SLICE, n_pad)
    vsel = torch.linspace(0, n_pad - 1, nv, dtype=torch.float64, device=tris.device)
    return points, live, light, eps, fwd, vsel.to(torch.int64), n_live


def _quat_axis_angle(x, y, z, w):
    axis = np.array([x, y, z], np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.array([*(axis * math.sin(w / 2.0)), math.cos(w / 2.0)], dtype=np.float32)


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def preset(name: str, device="cuda") -> tuple[Transformation, Camera]:
    """Scene poses (object transform, camera) for cornellbox, bunny, sponza,
    on the GPU unless `device` says otherwise (device="cpu" for the plain
    paths)."""
    fov = np.float32(45.0 * math.pi / 180.0)
    down_z = _quat_axis_angle(0.0, 0.0, 1.0, -1.57)
    ident = [0.0, 0.0, 0.0, 1.0]
    if name == "cornellbox":
        tr = ([0.0, 0.0, -5.0], np.ones(3), ident)
        cam = ([0.0, 2.5, 5.8], down_z)
    elif name == "bunny":
        tr = ([0.0, 0.0, -3.0], np.full(3, 3.0), ident)
        cam = ([0.0, 2.5, 5.8], down_z)
    elif name == "sponza":
        tr = ([0.0, 0.0, -3.0], np.ones(3), _quat_axis_angle(1.0, 0.0, 0.0, 1.57))
        cam = ([-20.0, 18.5, 10.8], _quat_axis_angle(0.0, 1.0, 0.0, -1.57))
    else:
        raise ValueError(f"unknown preset {name!r}")
    t = Transformation(*(_f32(x, device) for x in tr))
    c = Camera(
        eye=_f32(cam[0], device),
        quat=_f32(cam[1], device),
        fov=_f32(fov, device),
        near=_f32(0.0, device),
        far=_f32(100000.0, device),
    )
    return t, c
