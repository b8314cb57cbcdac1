"""Early split clipping: pre-split large-AABB primitives into several
PrimRefs before the build, the port of `tpu_bvh.utils.split_clip`.

A host (numpy) step, as in the JAX package: while a reference's box area
exceeds `sa_max`, it is halved at its center along its longest axis (the
box is clipped, not the triangle), every oversized reference at once per
round. The default `sa_max` = inf is the identity.
"""
from __future__ import annotations

import numpy as np


def _area(mn, mx):
    e = mx - mn
    return 2.0 * (e[:, 0] * e[:, 1] + e[:, 0] * e[:, 2] + e[:, 1] * e[:, 2])


def early_split_clipping(tris: np.ndarray, sa_max: float = np.inf, max_rounds: int = 32):
    """tris f32[N, 3, 3] -> (aabb_min f32[R, 3], aabb_max f32[R, 3],
    prim_idx i32[R]) with every reference's box area <= sa_max (after at
    most `max_rounds` rounds of halving)."""
    mn = tris.min(axis=1).astype(np.float32)
    mx = tris.max(axis=1).astype(np.float32)
    idx = np.arange(tris.shape[0], dtype=np.int32)
    if not np.isfinite(sa_max):
        return mn, mx, idx

    done_mn, done_mx, done_idx = [], [], []
    for _ in range(max_rounds):
        small = _area(mn, mx) <= sa_max
        if small.all():
            break
        done_mn.append(mn[small])
        done_mx.append(mx[small])
        done_idx.append(idx[small])
        mn, mx, idx = mn[~small], mx[~small], idx[~small]

        ext = mx - mn
        dim = np.where((ext[:, 0] > ext[:, 1]) & (ext[:, 0] > ext[:, 2]), 0,
                       np.where(ext[:, 1] > ext[:, 2], 1, 2))
        center = (mn + mx) * 0.5
        rows = np.arange(mn.shape[0])
        l_mx = mx.copy()
        l_mx[rows, dim] = center[rows, dim]
        r_mn = mn.copy()
        r_mn[rows, dim] = center[rows, dim]
        mn = np.concatenate([mn, r_mn], axis=0)
        mx = np.concatenate([l_mx, mx], axis=0)
        idx = np.concatenate([idx, idx], axis=0)

    done_mn.append(mn)
    done_mx.append(mx)
    done_idx.append(idx)
    return (np.concatenate(done_mn, axis=0), np.concatenate(done_mx, axis=0),
            np.concatenate(done_idx, axis=0))
