"""Vectorized AABB, triangle and quaternion math on `[..., 3]` tensors."""
from __future__ import annotations

import torch


def _cross(a, b):
    """a x b over the last axis, in the component order of `jnp.cross`."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def triangle_aabbs(tris):
    """Per-triangle AABB. tris: f32[N, 3, 3] (vertex-major)."""
    return tris.amin(dim=-2), tris.amax(dim=-2)


def center(amin, amax):
    return (amin + amax) * 0.5


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


def transform_point(p, scale, quat, translation):
    """Object to world: rotate(scale * p) + translation."""
    return qt_rotate(quat, scale * p) + translation
