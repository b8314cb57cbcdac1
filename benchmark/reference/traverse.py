"""Plain reference traversal: the closest hit of each ray through a Bvh2 tuple.

A ray walks from the root with a stack, near child first (the left child when
its entry distance is below the right one's, else the right), and pops on a miss. A box is
entered when t_near <= t_far for the slabs (max - o) / d and (min - o) / d, with
t_far capped by the closest hit so far and t_near floored at 0; a NaN slab (a
ray in a box plane, 0 * inf) misses. A triangle (v0, v1, v2) is hit at t when
its three edge functions u, v, w and t are all above 0 and t is below the
closest hit so far, with the reference renderer's edge test:

    e0 = v2 - v0, e1 = v0 - v1, e2 = v1 - v2, p_k = v_k - o, n = e1 x e0,
    u = ((p0 + p2) x e0) . d / den, v = ((p1 + p0) x e1) . d / den,
    w = ((p2 + p1) x e2) . d / den, t = 2 (p0 . n) / den, den = 2 (n . d),

each quotient taken as a product with 1 / den and each dot product summed
left to right from +0.0. A hit is (primitive, t, u, v); a miss is
(-1, FLT_MAX, 0, 0).
"""
from __future__ import annotations

import torch

I32, I64, F32 = torch.int32, torch.int64, torch.float32
FLT_MAX = 3.402823466e38
STACK = 128  # slots; a deeper walk raises


def _cross(a, b):
    a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
    b0, b1, b2 = b[:, 0], b[:, 1], b[:, 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=1)


def _dot(a, b):
    p = a * b
    return ((p[:, 0] + 0.0) + p[:, 1]) + p[:, 2]


def _slab(lo, hi, o, inv, t_max):
    d_far = (hi - o) * inv
    d_near = (lo - o) * inv
    t_far = torch.maximum(d_far, d_near).amin(dim=1)
    t_near = torch.minimum(d_far, d_near).amax(dim=1)
    t_far = torch.minimum(t_max, t_far)
    t_near = torch.clamp(t_near, min=0.0)
    return t_near, t_near <= t_far


def triangle_test(v0, v1, v2, o, d):
    """(u, v, w, t) of rays [R, 3] against triangles [R, 3]."""
    p0, p1, p2 = v0 - o, v1 - o, v2 - o
    e0, e1, e2 = v2 - v0, v0 - v1, v1 - v2
    nrm = _cross(e1, e0)
    u = _dot(_cross(p0 + p2, e0), d)
    v = _dot(_cross(p1 + p0, e1), d)
    w = _dot(_cross(p2 + p1, e2), d)
    t = _dot(p0, nrm) * 2.0
    inv = 1.0 / (_dot(nrm, d) * 2.0)
    return u * inv, v * inv, w * inv, t * inv


def closest_hits(bvh, tris, origin, direction, dtype=F32):
    """Hits (prim i32[R], t f32[R], u f32[R], v f32[R]) of rays [R, 3] through
    the Bvh2 tuple `bvh` over `tris` f32[N, 3, 3], in `dtype` arithmetic."""
    packed_t, left, right, root = bvh
    dev = origin.device
    n_rays = origin.shape[0]
    m = (left.shape[0] - 1) // 2
    lo = packed_t[0:3].T.to(dtype)
    hi = (-packed_t[3:6]).T.to(dtype)
    left, right = left.long(), right.long()
    tri = tris.to(dtype)
    o_all, d_all = origin.to(dtype), direction.to(dtype)
    inv_all = 1.0 / d_all

    prim = torch.full((n_rays,), -1, dtype=I64, device=dev)
    best_t = torch.full((n_rays,), min(FLT_MAX, torch.finfo(dtype).max), dtype=dtype, device=dev)
    best_u = torch.zeros((n_rays,), dtype=dtype, device=dev)
    best_v = torch.zeros((n_rays,), dtype=dtype, device=dev)
    ray = torch.arange(n_rays, device=dev)  # the live rays
    node = torch.full((n_rays,), int(root), dtype=I64, device=dev)
    stack = torch.full((n_rays, STACK), -1, dtype=I64, device=dev)
    top = torch.zeros((n_rays,), dtype=I64, device=dev)  # slots in use
    while ray.numel():
        o, d, inv, t_best = o_all[ray], d_all[ray], inv_all[ray], best_t[ray]
        at_leaf = node >= m
        # internal nodes: both child slabs, near first, the far one pushed
        l, r = left[node.clamp(max=m - 1)], right[node.clamp(max=m - 1)]
        tl, hl = _slab(lo[l], hi[l], o, inv, t_best)
        tr, hr = _slab(lo[r], hi[r], o, inv, t_best)
        near = torch.where(tl < tr, l, r)
        far = torch.where(tl < tr, r, l)
        both = hl & hr & ~at_leaf
        if bool((top[both] >= STACK).any()):
            raise RuntimeError(f"reference traversal: a walk deeper than {STACK} slots")
        rows = torch.nonzero(both).flatten()
        stack[rows, top[rows]] = far[rows]
        top = top + both.long()
        # leaves: the triangle test
        p = left[node.clamp(min=m)]
        t3 = tri[p.clamp(max=tri.shape[0] - 1)]
        u, v, w, t = triangle_test(t3[:, 0], t3[:, 1], t3[:, 2], o, d)
        good = at_leaf & (u > 0) & (v > 0) & (w > 0) & (t > 0) & (t < t_best)
        g = ray[good]
        prim[g], best_t[g], best_u[g], best_v[g] = p[good], t[good], u[good], v[good]
        # the next node: a hit child, else the top of the stack
        nxt = torch.where(both, near, torch.where(hl, l, r))
        go_down = ~at_leaf & (hl | hr)
        popped = top > 0
        top_after = torch.where(go_down, top, (top - 1).clamp(min=0))
        from_stack = stack[torch.arange(ray.numel(), device=dev), top_after.clamp(max=STACK - 1)]
        node = torch.where(go_down, nxt, torch.where(popped, from_stack, -1))
        top = top_after
        alive = node >= 0
        if not bool(alive.all()):
            ray, node, top, stack = ray[alive], node[alive], top[alive], stack[alive]
    return prim.to(I32), best_t.to(F32), best_u.to(F32), best_v.to(F32)
