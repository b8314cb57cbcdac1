"""Vectorized AABB, triangle and quaternion math on `[..., 3]` tensors.

`fmin` / `fmax` compute what `jnp.minimum` / `jnp.maximum` compute,
signed zeros included; every min and max of a box the build path stores
goes through them or through `min_key`, their integer form.

The traversal's helpers (`slab_intersect`, `intersect_triangle`,
`inv_transform_point`) keep the JAX package's order of operations: a
3-term sum is `((0 + p0) + p1) + p2`, as XLA sums `jnp.sum(..., axis=-1)`
on the CPU, and a quotient by `denom` is a product with `1 / denom`, so
the results equal JAX's (under `jax.disable_jit()`) and the CUDA kernel's
bit for bit.
"""
from __future__ import annotations

import torch

from ..types import FLT_MAX

I32 = torch.int32
F32 = torch.float32


def fmin(a, b):
    """Elementwise min as `jnp.minimum` computes it: -0.0 < +0.0, so equal
    values give the OR of their bits and the result does not depend on the
    order of the arguments (`torch.minimum` keeps its first argument on
    equal zeros); NaN propagates, a's first, with its own bits, as `jmin`
    does in `csrc/common.cuh` (`torch.minimum`'s vectorized CPU loop gives
    all-ones NaN bits instead)."""
    r = torch.where((a < b) | (a != a), a, b)
    return torch.where(a == b, (a.view(I32) | b.view(I32)).view(F32), r)


def fmax(a, b):
    """Elementwise max as `jnp.maximum` computes it: +0.0 > -0.0 (equal
    values give the AND of their bits); NaN propagates, a's first."""
    r = torch.where((a > b) | (a != a), a, b)
    return torch.where(a == b, (a.view(I32) & b.view(I32)).view(F32), r)


def min_key(x):
    """An i32 key of each f32 whose integer order is `fmin`'s: the total
    order of the floats (-0.0 < +0.0) with every NaN below all, so the
    min of keys (`torch.minimum`, `amin`: one exact op, in any order) is
    the key of the `fmin` of the floats (`from_min_key`)."""
    b = x.view(I32)
    key = b ^ ((b >> 31) & 0x7FFFFFFF)
    return torch.where(x != x, torch.iinfo(torch.int32).min, key)


def from_min_key(key):
    """The f32 of a `min_key` (a NaN comes back with all bits set)."""
    return (key ^ ((key >> 31) & 0x7FFFFFFF)).view(F32)


def packed_bounds(v, vertex_dim: int, coord_dim: int):
    """The box of the vertices `v`, packed (min xyz, -max xyz) along
    `coord_dim`: the `fmin` over `vertex_dim` of the coordinates and of
    their negations (fmax(a, b) == -fmin(-a, -b) bit for bit), taken as
    one exact `amin` of `min_key`s."""
    keys = min_key(torch.cat([v, -v], dim=coord_dim))
    return from_min_key(keys.amin(dim=vertex_dim))


def _cross(a, b):
    """a x b over the last axis, in the component order of `jnp.cross`."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _dot(a, b):
    """`jnp.sum(a * b, axis=-1)` in XLA's order on the CPU: from +0.0, left
    to right (so three products of -0.0 sum to +0.0)."""
    p = a * b
    return ((p[..., 0] + 0.0) + p[..., 1]) + p[..., 2]


def triangle_aabbs(tris):
    """Per-triangle AABB. tris: f32[N, 3, 3] (vertex-major)."""
    packed = packed_bounds(tris, -2, -1)
    return packed[..., :3], -packed[..., 3:]


def empty_aabb(shape=(), device="cuda"):
    """An inverted box, the identity of `union`: min +FLT_MAX and max
    -FLT_MAX, f32[*shape, 3] each, on `device` (the GPU unless the caller
    names another)."""
    mn = torch.full((*shape, 3), FLT_MAX, dtype=F32, device=device)
    return mn, torch.full((*shape, 3), -FLT_MAX, dtype=F32, device=device)


def union(amin, amax, bmin, bmax):
    """The box holding both boxes, with `jnp.minimum` / `jnp.maximum`'s
    signed zeros and NaNs (`fmin`, `fmax`)."""
    return fmin(amin, bmin), fmax(amax, bmax)


def center(amin, amax):
    return (amin + amax) * 0.5


def extent(amin, amax):
    return amax - amin


def max_extent_dim(amin, amax):
    """The widest axis as int32: 0 if x is strictly wider than y and z,
    else 1 if y is strictly wider than z, else 2."""
    d = amax - amin
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.where((x > y) & (x > z), 0, torch.where(y > z, 1, 2)).to(I32)


def offset(amin, amax, p):
    """The position of p in the box, 0 to 1 along each axis; an axis of no
    extent passes the raw offset p - amin through."""
    o = p - amin
    e = amax - amin
    return torch.where(e > 0, o / torch.where(e > 0, e, 1.0), o)


def area(amin, amax):
    """Surface area of [..., 3] boxes."""
    e = amax - amin
    return 2.0 * (e[..., 0] * e[..., 1] + e[..., 0] * e[..., 2] + e[..., 1] * e[..., 2])


def qt_rotate(q, p):
    """Rotate vector p by quaternion q = (x, y, z, w)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * _cross(qv.expand_as(p), p)
    return p + qw * t + _cross(qv.expand_as(t), t)


def qt_rotation(axis_angle):
    """Axis-angle (x, y, z, angle) -> quaternion (x, y, z, w): the unit axis
    times sin(angle / 2), then cos(angle / 2)."""
    axis = axis_angle[..., :3]
    axis = axis / torch.sqrt(_dot(axis, axis))[..., None]
    half = axis_angle[..., 3:] / 2.0
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def transform_point(p, scale, quat, translation):
    """Object to world: rotate(scale * p) + translation."""
    return qt_rotate(quat, scale * p) + translation


def qt_invert(q):
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def qt_inv_rotate(q, p):
    return qt_rotate(qt_invert(q), p)


def inv_transform_point(p, scale, quat, translation):
    """World to object: rotate back(p - translation) / scale."""
    return qt_inv_rotate(quat, p - translation) / scale


def _amin3(x):
    """`jnp.min(x, axis=-1)` bit for bit: one exact min of `min_key`s."""
    return from_min_key(min_key(x).amin(dim=-1))


def _amax3(x):
    return -from_min_key(min_key(-x).amin(dim=-1))


def slab_intersect(amin, amax, origin, inv_dir, max_t):
    """Slab test of [..., 3] boxes against rays: (t_near, t_far), a hit iff
    t_near <= t_far. Every min and max is `jnp.minimum` / `jnp.maximum`'s:
    NaN propagates (a coordinate on a box plane times an infinite inverse
    direction), so a NaN t_far makes the box a miss."""
    d_far = (amax - origin) * inv_dir
    d_near = (amin - origin) * inv_dir
    t_far = _amin3(fmax(d_far, d_near))
    t_near = _amax3(fmin(d_far, d_near))
    t_far = fmin(max_t, t_far)
    t_near = fmax(torch.zeros_like(t_near), t_near)
    return t_near, t_far


def intersect_triangle(v0, v1, v2, ray_org, ray_dir):
    """(u, v, w, t) of the rays against the triangles; a hit needs u, v, w
    and t above 0 and t below the closest hit so far (the callers test)."""
    pos0 = v0 - ray_org
    pos1 = v1 - ray_org
    pos2 = v2 - ray_org
    edge0 = v2 - v0
    edge1 = v0 - v1
    edge2 = v1 - v2
    normal = _cross(edge1, edge0)
    u = _dot(_cross(pos0 + pos2, edge0), ray_dir)
    v = _dot(_cross(pos1 + pos0, edge1), ray_dir)
    w = _dot(_cross(pos2 + pos1, edge2), ray_dir)
    t = _dot(pos0, normal) * 2.0
    denom = _dot(normal, ray_dir) * 2.0
    inv = 1.0 / denom
    return u * inv, v * inv, w * inv, t * inv
