"""Wavefront BVH2 traversal: the closest hit of every ray, four schedules.

The port of `tpu_bvh.ops.traverse`. The reference's four traversal
shaders (`TraversalKernel.h:28-451`) differ only in how they schedule
node tests against leaf tests:

* `if_if`: one node step, then a leaf step where the ray sits at a leaf;
* `while_while`: four node steps, then a leaf step;
* `speculative`: node steps until no ray sits at an internal node (the
  `!__any(searchingLeaf)` vote), then a leaf step;
* `restart_trail`: the stackless walk with a 64-bit trail
  (`TraversalKernel.h:28-146`).

Each ray walks near child first with a stack of STACK_DEPTH slots (slot 0
the INVALID sentinel), tests its slabs in object space against the current
closest t (the reference's mixed-space clamp) and its triangles in world
space, and counts its leaf visits (the heat-map signal,
`TraversalKernel.h:191`). A ray that wants to push onto a full stack is
walked again from the root through the restart-trail engine with a fresh
hit and count, so trees deeper than the stack still give the right hits.
All schedules give each ray the same steps, hence the same hits and
counts; `traverse_packed` walks the one-row-per-node layout of `pack_bvh2`
with the `if_if` schedule and gives the same results too.

On a CUDA tensor `traverse_bvh2` and `traverse_packed` launch
`csrc/traverse.cu` (persistent lanes that fetch their rays, a lane taking
its next ray when its own ends; one launch and one memset a call, counted
in `kernels.launches` as `traverse_<kernel>`; `last_stats` holds the
launch's node steps, leaf steps and overflowed rays, `last_warp_steps` its
warp steps, whence `simd_efficiency`; with `count_rows` set, `last_rows`
holds the distinct internal and leaf rows its steps stood on). The rays
are read in place at their row strides. On a CPU tensor they take the
plain engine, `traverse_bvh2_reference` and `traverse_packed_reference`, whose
loops read `.any()` once a step (a host sync a step on the card: the plain
engine is the kernel's oracle, not a path to run there).

Counts come back as int32 (JAX's are uint32; torch's uint32 has few ops).
The restart-trail engine keeps JAX's (hi, lo) pairs of 32-bit words, held
in int64 tensors and masked to 32 bits: torch's `>>` on int64 is
arithmetic, so a 64-bit word with its top bit set is never shifted.
"""
from __future__ import annotations

import torch

from ..types import FLT_MAX, Bvh2, HitInfo, Rays, Transformation
from ..utils import introspect, kernels, timer, work
from ..utils.platform import on_cuda
from . import aabb as A

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
INVALID = -1
STACK_DEPTH = 48  # kStackDepth in csrc/traverse.cu
BLOCK = 256  # kBlock: threads a block of the persistent grid while rays outnumber lanes
SMALL_BLOCK = 128  # kSmallBlock: threads a block otherwise
FETCH = 64  # kFetch: rays a block takes from the kernel's ray counter at once
STATS = 5  # kStats: node steps, leaf steps, overflowed rays, warp steps, the ray counter
VARIANTS = ("if_if", "while_while", "speculative", "restart_trail")
_NODE_STEPS = {"if_if": 1, "while_while": 4}
_SHAPES = {"if_if": 0, "while_while": 1, "speculative": 2, "restart_trail": 3}  # kernel's Shape
KERNELS = ("packed", *VARIANTS)  # traverse_packed's kernel, then traverse_bvh2's
last_stats = None  # the last launch's i64[3]: node steps, leaf steps, overflowed rays
last_warp_steps = None  # and its warp steps (i64[]): see simd_efficiency
count_rows = False  # when set, each launch marks the rows its steps stand on
last_rows = None  # then the last launch's i64[2]: distinct internal rows, distinct leaf rows


def _check_variant(variant):
    if variant not in VARIANTS:
        raise ValueError(f"unknown traversal variant {variant!r}; expected one of {VARIANTS}")


def traverse_bvh2(bvh: Bvh2, tris, rays: Rays, tr: Transformation, variant="speculative"):
    """Closest hit of every ray: (HitInfo, leaf visits i32[R]). A CUDA tensor
    launches the kernel of `variant`; a CPU tensor takes the plain engine."""
    _check_variant(variant)
    if on_cuda(rays.origin):
        return _launch_bvh2(bvh, tris, rays, tr, variant)
    return traverse_bvh2_reference(bvh, tris, rays, tr, variant)


def traverse_packed(packed, n_internal, root, rays: Rays, tr: Transformation):
    """`traverse_bvh2`'s results over the `pack_bvh2` layout, one row a step;
    dispatch by device."""
    if on_cuda(rays.origin):
        return _launch_packed(packed, n_internal, root, rays, tr)
    return traverse_packed_reference(packed, n_internal, root, rays, tr)


def traverse_by_name(kernel, bvh: Bvh2, tris, rays: Rays, tr: Transformation, packed=None,
                     plain=False):
    """One of KERNELS by its name, or its plain engine (`plain`):
    `traverse_packed` over `packed` (`pack_bvh2` of the tree when None),
    else `traverse_bvh2` with that variant."""
    if kernel == "packed":
        fn = traverse_packed_reference if plain else traverse_packed
        packed = pack_bvh2(bvh, tris) if packed is None else packed
        return fn(packed, bvh.n_internal, bvh.root, rays, tr)
    fn = traverse_bvh2_reference if plain else traverse_bvh2
    return fn(bvh, tris, rays, tr, kernel)


def pack_bvh2(bvh: Bvh2, tris):
    """The traversal layout: one i32[16] row a node, floats as their bits.

    Internal row: [min_l(3), max_l(3), min_r(3), max_r(3), left, right, 0, 0]
    Leaf row:     [v0(3), v1(3), v2(3), prim, 0, ...]
    The max rows are packed_t's negated maxes with the sign bit flipped
    back (bits(-x) == bits(x) ^ 2^31), so they equal `bvh.node_max`'s bits.
    """
    ni = bvh.n_internal
    mm = bvh.n_nodes
    dev = bvh.left.device
    left = bvh.left
    l = left[:ni].clamp(0, mm - 1).long()
    r = bvh.right[:ni].clamp(0, mm - 1).long()
    pk = bvh.packed_t.contiguous().view(I32)  # [6, M]: min xyz, -max xyz
    neg = torch.iinfo(I32).min  # the sign bit
    col_l = pk[:, l]
    col_r = pk[:, r]
    internal = torch.cat([col_l[0:3], col_l[3:6] ^ neg, col_r[0:3], col_r[3:6] ^ neg,
                          left[None, :ni], bvh.right[None, :ni],
                          torch.zeros((2, ni), dtype=I32, device=dev)], dim=0).T
    prim = left[ni:].clamp(0, tris.shape[0] - 1).long()
    tv = tris[prim].reshape(-1, 9).contiguous().view(I32)
    leaf = torch.cat([tv, left[ni:, None], torch.zeros((mm - ni, 6), dtype=I32, device=dev)],
                     dim=1)
    return torch.cat([internal, leaf], dim=0).contiguous()


# ---------------------------------------------------------------- the plain engine


def _transform_rays(rays: Rays, tr: Transformation):
    """Object-space origins and inverse directions."""
    origin = A.inv_transform_point(rays.origin, tr.scale, tr.quat, tr.translation)
    zero = torch.zeros(3, dtype=F32, device=rays.origin.device)
    direction = A.inv_transform_point(rays.direction, tr.scale, tr.quat, zero)
    return origin, 1.0 / direction


def _fresh_hit(n, dev) -> HitInfo:
    return HitInfo(prim_idx=torch.full((n,), INVALID, dtype=I32, device=dev),
                   t=torch.full((n,), FLT_MAX, dtype=F32, device=dev),
                   u=torch.zeros(n, dtype=F32, device=dev),
                   v=torch.zeros(n, dtype=F32, device=dev))


def _reset_hit(hit: HitInfo, mask) -> HitInfo:
    """A fresh HitInfo where `mask`, `hit` elsewhere."""
    fresh = _fresh_hit(mask.shape[0], mask.device)
    return HitInfo(*(torch.where(mask, f, h) for f, h in zip(fresh, hit)))


def _roots(root, n, dev):
    return torch.zeros(n, dtype=I32, device=dev) + torch.as_tensor(root, device=dev).to(I32)


def _init_state(root, n, dev):
    node = _roots(root, n, dev)
    stack = torch.full((n, STACK_DEPTH), INVALID, dtype=I32, device=dev)
    top = torch.ones(n, dtype=I32, device=dev)  # slot 0 holds the INVALID sentinel
    return node, stack, top, _fresh_hit(n, dev), torch.zeros(n, dtype=I32, device=dev)


def _leaf_hit(hit: HitInfo, counts, is_leaf, v0, v1, v2, prim, rays: Rays, tr: Transformation):
    """The world-space triangle test of the rays at a leaf, the closest-hit
    update and their visit count."""
    w0, w1, w2 = (A.transform_point(x, tr.scale, tr.quat, tr.translation) for x in (v0, v1, v2))
    u, v, w, t = A.intersect_triangle(w0, w1, w2, rays.origin, rays.direction)
    good = is_leaf & (u > 0) & (v > 0) & (w > 0) & (t > 0) & (t < hit.t)
    hit = HitInfo(prim_idx=torch.where(good, prim, hit.prim_idx), t=torch.where(good, t, hit.t),
                  u=torch.where(good, u, hit.u), v=torch.where(good, v, hit.v))
    return hit, counts + is_leaf.to(I32)


def _push_or_flag(stack, top, far, want_push, ovf, ray_ids):
    """Push `far` where `want_push` and the stack has room; flag the rest."""
    do_push = want_push & (top < STACK_DEPTH)
    ovf = ovf | (want_push & (top >= STACK_DEPTH))
    stack[ray_ids, torch.where(do_push, top, 0).long()] = torch.where(do_push, far, stack[:, 0])
    return torch.where(do_push, top + 1, top), ovf


def _node_step(nodes, t_origin, t_inv_dir, node, stack, top, hit_t, active, ovf, ray_ids):
    """One internal-node step of the `active` rays: test both children, go
    near first and push the far one, or pop on a miss."""
    node_min, node_max, left, right = nodes
    mm = left.shape[0]
    safe = node.clamp(0, mm - 1).long()
    l = left[safe]
    r = right[safe]
    sl = l.clamp(0, mm - 1).long()
    sr = r.clamp(0, mm - 1).long()
    t0n, t0f = A.slab_intersect(node_min[sl], node_max[sl], t_origin, t_inv_dir, hit_t)
    t1n, t1f = A.slab_intersect(node_min[sr], node_max[sr], t_origin, t_inv_dir, hit_t)
    hit_l = t0n <= t0f
    hit_r = t1n <= t1f
    both = hit_l & hit_r
    near = torch.where(t0n < t1n, l, r)
    far = torch.where(t0n < t1n, r, l)
    top, ovf = _push_or_flag(stack, top, far, active & both, ovf, ray_ids)
    next_hit = torch.where(both, near, torch.where(hit_l, l, r))
    any_hit = hit_l | hit_r
    top_pop = (top - 1).clamp(min=0)
    popped = stack[ray_ids, top_pop.long()]
    node_new = torch.where(any_hit, next_hit, popped)
    top = torch.where(active & ~any_hit, top_pop, top)
    return torch.where(active, node_new, node), top, ovf


def _leaf_step(nodes, tris, tr, rays, node, stack, top, hit, counts, active, ray_ids):
    """One leaf step of the `active` rays: the triangle test, then a pop."""
    left = nodes[2]
    safe = node.clamp(0, left.shape[0] - 1).long()
    prim = left[safe]
    tri = tris[prim.clamp(0, tris.shape[0] - 1).long()]  # [R, 3, 3]
    hit, counts = _leaf_hit(hit, counts, active, tri[:, 0], tri[:, 1], tri[:, 2], prim, rays, tr)
    top_pop = (top - 1).clamp(min=0)
    node = torch.where(active, stack[ray_ids, top_pop.long()], node)
    return node, torch.where(active, top_pop, top), hit, counts


def traverse_bvh2_reference(bvh: Bvh2, tris, rays: Rays, tr: Transformation,
                            variant="speculative"):
    """The plain engine (any device): `tpu_bvh.ops.traverse.traverse_bvh2`
    with each `lax.while_loop` a Python loop on `.any()`."""
    _check_variant(variant)
    if variant == "restart_trail":
        return _traverse_restart_trail(bvh, tris, rays, tr)
    dev = rays.origin.device
    n = rays.origin.shape[0]
    t_origin, t_inv_dir = _transform_rays(rays, tr)
    n_internal = bvh.n_internal
    nodes = bvh.node_min, bvh.node_max, bvh.left, bvh.right
    node, stack, top, hit, counts = _init_state(bvh.root, n, dev)
    ovf = torch.zeros(n, dtype=torch.bool, device=dev)
    ray_ids = torch.arange(n, device=dev)

    def internal(nd):
        return (nd != INVALID) & (nd < n_internal)

    while bool((node != INVALID).any()):
        if variant == "speculative":
            act = internal(node)
            while bool(act.any()):  # node steps until no ray sits at an internal node
                node, top, ovf = _node_step(nodes, t_origin, t_inv_dir, node, stack, top, hit.t,
                                            act, ovf, ray_ids)
                act = internal(node)
        else:
            for _ in range(_NODE_STEPS[variant]):
                node, top, ovf = _node_step(nodes, t_origin, t_inv_dir, node, stack, top, hit.t,
                                            internal(node), ovf, ray_ids)
        leaf_act = (node != INVALID) & (node >= n_internal)
        node, top, hit, counts = _leaf_step(nodes, tris, tr, rays, node, stack, top, hit, counts,
                                            leaf_act, ray_ids)
    # the rays that overflowed their stack walk again through the stackless
    # engine (its loop runs no step when none did)
    return _restart_trail_engine(_bvh2_fetch(bvh, tris), n_internal, bvh.root, rays, tr,
                                 t_origin, t_inv_dir, ~ovf, _reset_hit(hit, ovf),
                                 torch.where(ovf, 0, counts))


def traverse_packed_reference(packed, n_internal, root, rays: Rays, tr: Transformation):
    """The plain engine over the packed layout (any device): one row a step,
    read both ways (two child slabs, or the triangle)."""
    dev = rays.origin.device
    n = rays.origin.shape[0]
    n_internal = int(n_internal)
    t_origin, t_inv_dir = _transform_rays(rays, tr)
    node, stack, top, hit, counts = _init_state(root, n, dev)
    ovf = torch.zeros(n, dtype=torch.bool, device=dev)
    ray_ids = torch.arange(n, device=dev)
    while bool((node != INVALID).any()):
        node, top, hit, counts, ovf = _packed_step(packed, n_internal, rays, tr, t_origin,
                                                   t_inv_dir, node, stack, top, hit, counts, ovf,
                                                   ray_ids, node != INVALID)
    return _restart_trail_engine(_packed_fetch(packed), n_internal, root, rays, tr, t_origin,
                                 t_inv_dir, ~ovf, _reset_hit(hit, ovf), torch.where(ovf, 0, counts))


def _packed_step(packed, n_internal, rays: Rays, tr: Transformation, t_origin, t_inv_dir, node,
                 stack, top, hit: HitInfo, counts, ovf, ray_ids, alive):
    """One step of the `alive` rays over the packed rows (their nodes valid):
    at an internal row the two child slabs, near first and the far one
    pushed, or a pop on a miss; at a leaf row the triangle test and a pop.
    Returns (node, top, hit, counts, ovf)."""
    mm = packed.shape[0]
    is_leaf = alive & (node >= n_internal)
    act_int = alive & ~is_leaf
    row = packed[node.clamp(0, mm - 1).long()]  # i32[R, 16]
    f = row[:, 0:12].view(F32)
    l_idx = row[:, 12]
    r_idx = row[:, 13]
    t0n, t0f = A.slab_intersect(f[:, 0:3], f[:, 3:6], t_origin, t_inv_dir, hit.t)
    t1n, t1f = A.slab_intersect(f[:, 6:9], f[:, 9:12], t_origin, t_inv_dir, hit.t)
    hit_l = t0n <= t0f
    hit_r = t1n <= t1f
    both = hit_l & hit_r
    near = torch.where(t0n < t1n, l_idx, r_idx)
    far = torch.where(t0n < t1n, r_idx, l_idx)
    top, ovf = _push_or_flag(stack, top, far, act_int & both, ovf, ray_ids)
    next_int = torch.where(both, near, torch.where(hit_l, l_idx, r_idx))
    int_miss = act_int & ~(hit_l | hit_r)
    hit, counts = _leaf_hit(hit, counts, is_leaf, f[:, 0:3], f[:, 3:6], f[:, 6:9], row[:, 9],
                            rays, tr)
    pop_t = (top - 1).clamp(min=0)
    popped = stack[ray_ids, pop_t.long()]
    need_pop = is_leaf | int_miss
    node = torch.where(act_int & ~int_miss, next_int, torch.where(need_pop, popped, node))
    top = torch.where(need_pop, pop_t, top)
    return node, top, hit, counts, ovf


def _bvh2_fetch(bvh: Bvh2, tris):
    """Node fetcher over the Bvh2 for the restart-trail engine: node ->
    (min_l, max_l, min_r, max_r, left, right, v0, v1, v2, prim)."""
    node_min, node_max, left, right = bvh.node_min, bvh.node_max, bvh.left, bvh.right
    mm = left.shape[0]

    def fetch(node):
        safe = node.clamp(0, mm - 1).long()
        l = left[safe]
        r = right[safe]
        sl = l.clamp(0, mm - 1).long()
        sr = r.clamp(0, mm - 1).long()
        tri = tris[l.clamp(0, tris.shape[0] - 1).long()]
        return (node_min[sl], node_max[sl], node_min[sr], node_max[sr], l, r,
                tri[:, 0], tri[:, 1], tri[:, 2], l)

    return fetch


def _packed_fetch(packed):
    """Node fetcher over the packed layout (`pack_bvh2`)."""
    mm = packed.shape[0]

    def fetch(node):
        row = packed[node.clamp(0, mm - 1).long()]
        f = row[:, 0:12].view(F32)
        return (f[:, 0:3], f[:, 3:6], f[:, 6:9], f[:, 9:12], row[:, 12], row[:, 13],
                f[:, 0:3], f[:, 3:6], f[:, 6:9], row[:, 9])

    return fetch


def _traverse_restart_trail(bvh: Bvh2, tris, rays: Rays, tr: Transformation):
    t_origin, t_inv_dir = _transform_rays(rays, tr)
    n = rays.origin.shape[0]
    dev = rays.origin.device
    return _restart_trail_engine(_bvh2_fetch(bvh, tris), bvh.n_internal, bvh.root, rays, tr,
                                 t_origin, t_inv_dir, torch.zeros(n, dtype=torch.bool, device=dev),
                                 _fresh_hit(n, dev), torch.zeros(n, dtype=I32, device=dev))


# 64-bit words as (hi, lo) pairs of 32-bit values in int64 tensors
_M32 = 0xFFFFFFFF


def _u64_add(a, b):
    lo = a[1] + b[1]
    return (a[0] + b[0] + (lo >> 32)) & _M32, lo & _M32


def _u64_neg(a):
    return _u64_add((a[0] ^ _M32, a[1] ^ _M32), (torch.zeros_like(a[0]), torch.ones_like(a[1])))


def _u64_shr1(a):
    return a[0] >> 1, (a[1] >> 1) | ((a[0] & 1) << 31)


def _u64_where(pred, new, old):
    return torch.where(pred, new[0], old[0]), torch.where(pred, new[1], old[1])


def _trail_start(root, n, dev):
    """The restart trail's walk state of n rays at the root: (node, trail,
    level, pop_level), the words as (hi, lo) pairs."""
    def word(hi, lo):
        return (torch.full((n,), hi, dtype=I64, device=dev),
                torch.full((n,), lo, dtype=I64, device=dev))

    return _roots(root, n, dev), word(0x80000000, 0), word(0x80000000, 0), word(0, 0)


def _trail_step(fetch, n_internal, roots, rays: Rays, tr: Transformation, t_origin, t_inv_dir,
                walk, hit: HitInfo, counts, active):
    """One step of the restart trail (`TraversalKernel.h:28-146`) for the
    `active` rays over any node storage through `fetch`: a leaf test, or the
    two child slabs and the trail's descent; then a climb of the trail,
    restarting from the root (`roots`) unless it is spent. Returns (walk,
    hit, counts, exited)."""
    node, trail, level, pop_level = walk
    n = node.shape[0]
    dev = node.device
    top_bit = (torch.full((n,), 0x80000000, dtype=I64, device=dev),
               torch.zeros(n, dtype=I64, device=dev))
    one64 = (torch.zeros(n, dtype=I64, device=dev), torch.ones(n, dtype=I64, device=dev))
    is_leaf = active & (node >= n_internal)
    minl, maxl, minr, maxr, l, r, v0, v1, v2, prim = fetch(node)
    hit, counts = _leaf_hit(hit, counts, is_leaf, v0, v1, v2, prim, rays, tr)

    is_int = active & ~is_leaf
    t0n, t0f = A.slab_intersect(minl, maxl, t_origin, t_inv_dir, hit.t)
    t1n, t1f = A.slab_intersect(minr, maxr, t_origin, t_inv_dir, hit.t)
    hit_l = t0n <= t0f
    hit_r = t1n <= t1f
    both = is_int & hit_l & hit_r
    one = is_int & (hit_l ^ hit_r)
    none = is_int & ~(hit_l | hit_r)
    near = torch.where(t0n < t1n, l, r)
    far = torch.where(t0n < t1n, r, l)
    # both hit: level >>= 1; node = (trail & level) ? far : near
    level_b = _u64_shr1(level)
    take_far = ((trail[0] & level_b[0]) | (trail[1] & level_b[1])) != 0
    # one hit: level >>= 1; descend and trail |= level, unless level is
    # popLevel, where the ray pops
    at_pop_level = (level_b[0] == pop_level[0]) & (level_b[1] == pop_level[1])
    level = _u64_where(both | one, level_b, level)
    node = torch.where(both, torch.where(take_far, far, near), node)
    descend_one = one & ~at_pop_level
    node = torch.where(descend_one, torch.where(hit_r, r, l), node)
    trail = _u64_where(descend_one, (trail[0] | level_b[0], trail[1] | level_b[1]), trail)

    # climb the trail and restart from the root unless it is exhausted
    # (`TraversalKernel.h:33-47`)
    need_pop = is_leaf | none | (one & at_pop_level)
    neg = _u64_neg(level)
    trail_new = _u64_add((trail[0] & neg[0], trail[1] & neg[1]), level)
    temp = _u64_shr1(trail_new)
    dec = _u64_add(temp, _u64_neg(one64))
    level_new = _u64_add((dec[0] ^ temp[0], dec[1] ^ temp[1]), one64)
    exit_now = (trail_new[0] & 0x80000000) == 0
    cont = need_pop & ~exit_now
    trail = _u64_where(need_pop, trail_new, trail)
    pop_level = _u64_where(cont, level_new, pop_level)
    level = _u64_where(cont, top_bit, _u64_where(need_pop & exit_now, level_new, level))
    node = torch.where(cont, roots, node)
    return (node, trail, level, pop_level), hit, counts, need_pop & exit_now


def _restart_trail_engine(fetch, n_internal, root, rays: Rays, tr: Transformation, t_origin,
                          t_inv_dir, init_done, hit: HitInfo, counts):
    """The stackless restart-trail walk (`TraversalKernel.h:28-146`) over any
    node storage through `fetch`. Rays with `init_done` keep the hit and
    counts they are given."""
    n = rays.origin.shape[0]
    dev = rays.origin.device
    n_internal = int(n_internal)
    walk = _trail_start(root, n, dev)
    roots = walk[0]
    done = init_done
    while bool((~done).any()):
        walk, hit, counts, exited = _trail_step(fetch, n_internal, roots, rays, tr, t_origin,
                                                t_inv_dir, walk, hit, counts, ~done)
        done = done | exited
    return hit, counts


# ---------------------------------------------------------------- the kernels


def _rows(x, name, n):
    """Rays' rows of 3 f32 as the kernel reads them, in place at their row
    stride (a camera's origin is one row expanded: stride 0), and that
    stride; a copy only when a row's floats do not lie side by side."""
    if x.device.type != "cuda" or x.dtype != F32 or tuple(x.shape) != (n, 3):
        raise ValueError(f"{name}: expected CUDA f32 rows of shape ({n}, 3), got {x.device} "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.stride(1) != 1 or x.stride(0) > torch.iinfo(I32).max:
        x = x.contiguous()
    return x, x.stride(0)


def _ray_args(rays: Rays, tr: Transformation):
    """The kernel's ray and transform arguments: origin, its row stride,
    direction, its row stride, n, translation, scale, quat."""
    n = rays.origin.shape[0]
    origin, o_stride = _rows(rays.origin, "rays.origin", n)
    direction, d_stride = _rows(rays.direction, "rays.direction", n)
    vecs = []
    for name, x, k in (("translation", tr.translation, 3), ("scale", tr.scale, 3),
                       ("quat", tr.quat, 4)):
        x = x.contiguous()
        kernels.require(x, f"tr.{name}", F32, (k,))
        vecs.append(x)
    return origin, o_stride, direction, d_stride, n, *vecs


def _root_arg(root, dev):
    r = torch.as_tensor(root, device=dev).to(I32).reshape(())
    kernels.require(r, "root", I32)
    return r


def _outputs(n, mm, dev):
    """The hits and counts, the device counters and ray counter (u64[STATS],
    cleared by the kernel's entry) and, with `count_rows`, the byte map of
    rows stood on (cleared there too; else a null pointer)."""
    outs = (torch.empty(n, dtype=I32, device=dev), torch.empty(n, dtype=F32, device=dev),
            torch.empty(n, dtype=F32, device=dev), torch.empty(n, dtype=F32, device=dev),
            torch.empty(n, dtype=I32, device=dev))
    stats = torch.empty(STATS, dtype=I64, device=dev)
    marks = count_rows or introspect.recording()  # a cost_analysis counts the rows too
    touched = torch.empty(mm, dtype=torch.uint8, device=dev) if marks else None
    return outs, stats, touched


def _rows_of(touched, n_internal):
    return torch.stack([touched[:n_internal].sum(), touched[n_internal:].sum()])


def _launch(key, entry, args, ray_args, outs, stats, touched, n_internal):
    """Launch the C entry of kernel `key` on `args`, then the ray arguments,
    the outputs, the counters and the row marks; keep its counters."""
    global last_stats, last_warp_steps, last_rows
    kernels.launch(
        f"traverse_{key}", entry, *args, *ray_args, *outs, stats, touched, like=ray_args[0],
        count=lambda: work.traverse(stats[:3].tolist(), _rows_of(touched, n_internal).tolist(),
                                    key, outs[0].shape[0]),
        symbols="traverse_kernel<PackedNodes" if key == "packed" else "traverse_kernel<Bvh2Nodes")
    last_stats = stats[:3]
    last_warp_steps = stats[3]
    if count_rows:
        last_rows = _rows_of(touched, n_internal)
    return HitInfo(*outs[:4]), outs[4]


def simd_efficiency(stats, warp_steps):
    """Lane steps over 32 x warp steps: the share of a warp's lanes that run
    each node or leaf step (`last_stats`, `last_warp_steps` of a launch)."""
    return (int(stats[0]) + int(stats[1])) / (32 * max(int(warp_steps), 1))


def _launch_bvh2(bvh: Bvh2, tris, rays: Rays, tr: Transformation, variant):
    """One launch of the variant's kernel over the Bvh2 SoA (none for no rays)."""
    ray_args = _ray_args(rays, tr)
    n = ray_args[4]
    dev = ray_args[0].device
    mm = bvh.n_nodes
    kernels.require(bvh.packed_t, "bvh.packed_t", F32, (6, mm))
    kernels.require(bvh.left, "bvh.left", I32, (mm,))
    kernels.require(bvh.right, "bvh.right", I32, (mm,))
    kernels.require(tris, "tris", F32, (tris.shape[0], 3, 3))
    if mm < 1 or tris.shape[0] < 1:
        raise ValueError("traverse_bvh2: the tree and the triangles must not be empty")
    root = _root_arg(bvh.root, dev)
    outs, stats, touched = _outputs(n, mm, dev)
    if n == 0:
        return HitInfo(*outs[:4]), outs[4]
    return _launch(variant, "tbvh_traverse_bvh2",
                   (_SHAPES[variant], bvh.packed_t, bvh.left, bvh.right, mm, bvh.n_internal, root,
                    tris, tris.shape[0]), ray_args, outs, stats, touched, bvh.n_internal)


def _launch_packed(packed, n_internal, root, rays: Rays, tr: Transformation):
    """One launch of the packed kernel (none for no rays); what precedes the
    launch is the span `bvh.traverse_prep` under a running profiler."""
    with timer.span("bvh.traverse_prep"):
        ray_args = _ray_args(rays, tr)
        n = ray_args[4]
        dev = ray_args[0].device
        mm = packed.shape[0]
        kernels.require(packed, "packed", I32, (mm, 16))
        if mm < 1:
            raise ValueError("traverse_packed: the tree must not be empty")
        if packed.data_ptr() % 16:
            raise ValueError("packed: rows are read as 16-byte words; "
                             "expected a 16-byte aligned base")
        root_t = _root_arg(root, dev)
        outs, stats, touched = _outputs(n, mm, dev)
    if n == 0:
        return HitInfo(*outs[:4]), outs[4]
    return _launch("packed", "tbvh_traverse_packed", (packed, mm, int(n_internal), root_t),
                   ray_args, outs, stats, touched, int(n_internal))
