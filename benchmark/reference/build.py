"""Plain reference builds: the front half, the single-pass LBVH and PLOC++.

Semantics (the reference renderer's, as the JAX package states them):

* A leaf box is the min and max of its triangle's vertices, where -0.0 orders
  below +0.0 (`jnp.minimum`); boxes are rows (min x, y, z, -max x, y, z).
* The scene box is the min of the leaf mins and the max of the leaf maxes. A
  leaf's centroid (min + max) * 0.5 is normalised as (c - scene min) / extent
  (an extent of 0 divides by 1) and coded by the extended 30-bit Morton code
  (HIPRT's `computeExtendedMortonCode`: leading bits for the dominant axes by
  their extent ratios, then a 2D or 3D interleave), with u32 wrap-around and
  "a shift by 32 or more gives 0".
* Leaves are ordered by (code, primitive index).
* LBVH (single pass, Apetrei layout): the binary radix tree of the 64-bit keys
  (code << 32) | position. Internal node i sits at the boundary between sorted
  leaves i and i + 1 and covers exactly the keys that share the first
  delta(i) = clz64(key_i ^ key_i+1) bits with key i; a node is the right child
  of the boundary left of its range when that boundary's delta is the larger
  (out of range counts -1), else the left child of the boundary at its right
  end. Leaf j is node n - 1 + j, its `left` its primitive, its `right` -1.
* PLOC++ (radius R, the configuration's `radius`; PLOC++ takes 8): each round
  every live cluster takes as neighbour the lexicographic minimum of (area of the union box, cluster index) over the
  clusters within R of it in cluster order, the area being
  2 * ((ex * ey + ex * ez) + ey * ez) with ex = max x - min x; mutual pairs
  merge into a node whose id is the next free one in cluster order, which takes
  the left partner's place, and the right partner leaves; rounds run until one
  cluster is left. Node ids are then flipped so that the root is 0: internal
  id c becomes n - 2 - c, leaves keep theirs.

Bvh2 here is the tuple (packed_t f32[6, 2n - 1], left i32[2n - 1],
right i32[2n - 1], root), internal nodes first.
"""
from __future__ import annotations

import torch

I32, I64, F32 = torch.int32, torch.int64, torch.float32
M32 = 0xFFFFFFFF
MORTON_BITS = 30
BIG_AREA = 3.0e38  # "no candidate"


# ---------------------------------------------------------------- exact min and max

def order_key(x):
    """An i32 key of each f32 whose integer order is the float order with
    -0.0 below +0.0, so a min of keys is `jnp.minimum`'s min."""
    b = x.contiguous().view(I32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def from_key(k):
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(F32)


def fmin(a, b):
    return from_key(torch.minimum(order_key(a), order_key(b)))


# ---------------------------------------------------------------- front half

def leaf_boxes(tris, dtype=F32):
    """Packed boxes f32[6, n] of the triangles f32[n, 3, 3] (vertex-major),
    the coordinates first rounded to `dtype`."""
    v = tris.to(dtype).to(F32).permute(2, 1, 0)  # [coordinate, vertex, n]
    return torch.cat([from_key(order_key(v).amin(dim=1)), from_key(order_key(-v).amin(dim=1))])


def scene_box(packed):
    """(scene min f32[3], scene max f32[3]) of packed boxes."""
    lo = from_key(order_key(packed[0:3]).amin(dim=1))
    hi = -from_key(order_key(packed[3:6]).amin(dim=1))
    return lo, hi


def _shl(x, s: int):
    if s >= 32:
        return x * 0 if isinstance(x, torch.Tensor) else 0
    return (x << s) & M32


def _shr(x, s: int):
    if s >= 32:
        return x * 0 if isinstance(x, torch.Tensor) else 0
    return x >> s


def _spread2(v):
    v = v & 0x0000FFFF
    v = (v ^ (v << 8)) & 0x00FF00FF
    v = (v ^ (v << 4)) & 0x0F0F0F0F
    v = (v ^ (v << 2)) & 0x33333333
    return (v ^ (v << 1)) & 0x55555555


def _spread3(x):
    x = (x * 0x00010001) & 0xFF0000FF
    x = (x * 0x00000101) & 0x0F00F00F
    x = (x * 0x00000011) & 0xC30C30C3
    return (x * 0x00000005) & 0x49249249


def _layout(ext):
    """The extended code's per-scene choices from the f32 extent (host
    floats): (axis order, bits per axis, prebits, swap)."""
    x, y, z = ext
    xy, xz, yz = x < y, x < z, y < z
    if xy and xz and yz:
        order = (2, 1, 0)
    elif xy and xz:
        order = (1, 2, 0)
    elif xy:
        order = (1, 0, 2)
    elif yz and xz:
        order = (2, 0, 1)
    elif yz:
        order = (0, 2, 1)
    else:
        order = (0, 1, 2)

    def ilog2(a, b):  # floor(log2(ea / eb)), the quotient and log2 in f32
        ea, eb = ext[a], ext[b]
        if not (ea > 0 and eb > 0):
            return 0
        q = torch.tensor(ea, dtype=F32) / torch.tensor(eb, dtype=F32)
        return int(torch.floor(torch.log2(q)))

    a0, a1, a2 = order
    pre = (ilog2(a0, a1), ilog2(a1, a2), ilog2(a0, a2))
    nmb = MORTON_BITS
    swap = pre[2] - (pre[0] + pre[1])
    pre_x = min(pre[0], nmb)
    pre_y = min(pre[1] * 2, nmb - pre_x) // 2
    prebits = pre_x + pre_y * 2
    if prebits == nmb:
        swap = 0
    else:
        prebits += swap
    bits_z = max(0, (nmb - prebits) // 3) if ext[order[2]] != 0.0 else 0
    if swap > 0:
        bits_x = max(0, (nmb - bits_z - prebits) // 2 + pre_y + pre_x + 1)
        bits_y = nmb - bits_x - bits_z
    else:
        bits_y = max(0, (nmb - bits_z - prebits) // 2 + pre_y)
        bits_x = nmb - bits_y - bits_z
    return order, (bits_x, bits_y, bits_z), (pre_x, pre_y), prebits, swap


def extended_morton(nrm, ext, dtype=F32):
    """Codes i64[n] (u32 values) of normalised centroids nrm [3, n] for the
    scene extent ext (three host floats)."""
    order, (bits_x, bits_y, bits_z), (pre_x, pre_y), prebits, swap = _layout(ext)
    use_swap, have_pre = swap > 0, prebits > 0

    def axis_code(p, nbits):
        scale = float(_shl(1, nbits & M32))
        hi = float(torch.tensor(scale, dtype=F32) - 1.0)
        q = torch.clamp(torch.clamp(p.to(dtype) * scale, min=0.0), max=hi)
        return q.to(I64)

    cx = axis_code(nrm[order[0]], bits_x)
    cy = axis_code(nrm[order[1]], bits_y)
    cz = axis_code(nrm[order[2]], bits_z)
    ubx, uby, ubz = bits_x & M32, bits_y & M32, bits_z & M32
    upx, upy = pre_x & M32, pre_y & M32
    delta0 = delta1 = 0
    m = cx * 0
    if have_pre:
        bx1 = (ubx - upx) & M32
        m = _shr(cx & _shl((_shl(1, upx) - 1) & M32, bx1), bx1)
        m = _shl(m, (upy * 2) & M32)
        bx2 = (bx1 - upy) & M32
        by1 = (uby - upy) & M32
        t0 = _spread2(_shr(cx & _shl((_shl(1, upy) - 1) & M32, bx2), bx2))
        t1 = _spread2(_shr(cy & _shl((_shl(1, upy) - 1) & M32, by1), by1))
        m = m | ((t0 * 2 + t1) & M32)
        bx3 = (bx2 - 1) & M32 if use_swap else bx2
        if use_swap:
            m = _shl(m, 1) | _shr(cx & _shl(1, bx3), bx3)
        m = _shl(m, (bx3 + by1 + ubz) & M32)
        px = cx & ((_shl(1, bx3) - 1) & M32)
        py = cy & ((_shl(1, by1) - 1) & M32)
        if use_swap:
            delta0, delta1 = (by1 - bx3) & M32, (by1 - ubz) & M32
            px = _shl(px, delta0)
        else:
            delta0, delta1 = (bx3 - by1) & M32, (bx3 - ubz) & M32
            py = _shl(py, delta0)
        cx, cy, cz = px, py, _shl(cz, delta1)
    if bits_z == 0:
        tail = (_spread2(cx) * 2 + _spread2(cy)) & M32
    else:
        sx = torch.where(cx > 0, _spread3(cx), 0)
        sy = torch.where(cy > 0, _spread3(cy), 0)
        sz = torch.where(cz > 0, _spread3(cz), 0)
        t3 = (sy * 4 + sx * 2 + sz) if use_swap else (sx * 4 + sy * 2 + sz)
        tail = _shr(t3 & M32, (delta0 + delta1) & M32)
    return m | tail


def front_half(tris, dtype=F32):
    """The sorted leaves of a triangle soup: (codes i64[n] sorted,
    leaf_packed f32[6, n] in sorted order, leaf_prim i32[n])."""
    packed = leaf_boxes(tris, dtype)
    lo, hi = scene_box(packed)
    ext = hi.to(dtype) - lo.to(dtype)
    safe = torch.where(ext > 0, ext, torch.ones_like(ext))
    mn, mx = packed[0:3].to(dtype), (-packed[3:6]).to(dtype)
    nrm = ((mn + mx) * 0.5 - lo.to(dtype)[:, None]) / safe[:, None]
    codes = extended_morton(nrm, [float(e) for e in ext.to(F32).cpu()], dtype)
    codes, order = torch.sort(codes, stable=True)
    return codes, packed[:, order], order.to(I32)


# ---------------------------------------------------------------- LBVH

def bit_length(x):
    """Bits needed for each value of x (int64, 0 <= x < 2^32)."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        n = n + big.to(x.dtype) * s
        x = torch.where(big, x >> s, x)
    return n + (x > 0).to(x.dtype)


def radix_deltas(codes):
    """delta(i) = clz64 of key_i ^ key_i+1 for keys (code << 32) | position."""
    n = codes.shape[0]
    pos = torch.arange(n, dtype=I64, device=codes.device)
    x = codes[:-1] ^ codes[1:]
    return torch.where(x != 0, 32 - bit_length(x), 64 - bit_length(pos[:-1] ^ pos[1:]))


def _range_min_keys(keys, first, last):
    """Per range [first, last] (length >= 1) the min over columns of i32 keys
    [6, n], by a sparse table built one level at a time."""
    out = keys[:, first.long()].clone()
    length = (last - first + 1).to(I64)
    level = bit_length(length) - 1
    table = keys
    for k in range(1, int(level.max()) + 1 if length.numel() else 1):
        w = 1 << (k - 1)
        table = torch.minimum(table[:, :-w], table[:, w:])
        at = torch.nonzero(level == k).squeeze(1)
        if at.numel():
            f, l = first[at].long(), last[at].long()
            out[:, at] = torch.minimum(table[:, f], table[:, l - (1 << k) + 1])
    return out


def lbvh(codes, leaf_packed, leaf_prim):
    """The single-pass (Apetrei-layout) LBVH over sorted leaves; Bvh2 tuple."""
    n = codes.shape[0]
    m = n - 1
    dev = codes.device
    delta = radix_deltas(codes)
    keys = (codes << 32) | torch.arange(n, dtype=I64, device=dev)
    s = 64 - delta
    lo = (keys[:-1] >> s) << s
    hi = lo + (torch.ones_like(s) << s)
    first = torch.searchsorted(keys, lo)
    last = torch.searchsorted(keys, hi) - 1
    # internal nodes [0, m), then leaves: each with its range and parent side
    idx = torch.arange(2 * n - 1, dtype=I64, device=dev)
    f_all = torch.cat([first, idx[:n]])
    l_all = torch.cat([last, idx[:n]])
    neg = torch.full((1,), -1, dtype=delta.dtype, device=dev)
    dpad = torch.cat([neg, delta, neg])  # dpad[b + 1] = delta(b), -1 outside
    dl = dpad[f_all]  # delta(first - 1)
    dr = dpad[l_all + 1]  # delta(last)
    is_root = (f_all == 0) & (l_all == m)
    is_right = dl > dr
    left = torch.full((2 * n - 1,), -1, dtype=I64, device=dev)
    right = torch.full((2 * n - 1,), -1, dtype=I64, device=dev)
    sel = ~is_root & is_right
    right[(f_all - 1)[sel]] = idx[sel]
    sel = ~is_root & ~is_right
    left[l_all[sel]] = idx[sel]
    left[m:] = leaf_prim.to(I64)
    boxes = from_key(_range_min_keys(order_key(leaf_packed), first, last))
    root = torch.nonzero(is_root).flatten()[0]
    return (torch.cat([boxes, leaf_packed], dim=1), left.to(I32), right.to(I32), root.to(I32))


# ---------------------------------------------------------------- PLOC++

def _area(u, dtype):
    u = u.to(dtype)
    ex, ey, ez = -u[3] - u[0], -u[4] - u[1], -u[5] - u[2]
    return (2.0 * (ex * ey + ex * ez + ey * ez)).to(F32)


def ploc(leaf_packed, leaf_prim, radius: int, dtype=F32):
    """PLOC++ over sorted leaves (one segment); Bvh2 tuple with root 0."""
    n = leaf_packed.shape[1]
    m = n - 1
    dev = leaf_packed.device
    box = leaf_packed.clone()
    ids = torch.arange(n, dtype=I64, device=dev) + m
    node_l = torch.full((max(m, 0),), -1, dtype=I64, device=dev)
    node_r = torch.full((max(m, 0),), -1, dtype=I64, device=dev)
    node_box = torch.zeros((6, max(m, 0)), dtype=F32, device=dev)
    made, nc = 0, n
    while nc > 1:
        lane = torch.arange(nc, device=dev)
        fwd = torch.full((radius, nc), BIG_AREA, dtype=F32, device=dev)
        for d in range(1, min(radius, nc - 1) + 1):
            fwd[d - 1, :nc - d] = _area(fmin(box[:, :nc - d], box[:, d:]), dtype)
        bwd = torch.full((radius, nc), BIG_AREA, dtype=F32, device=dev)
        for d in range(1, min(radius, nc - 1) + 1):
            bwd[d - 1, d:] = fwd[d - 1, :nc - d]
        # candidates in index order: i - R .. i - 1, then i + 1 .. i + R; the
        # first minimum is the smallest index among equal areas
        cand = torch.cat([bwd.flip(0), fwd])
        arg = torch.argmin(cand, dim=0)
        nn = lane + torch.where(arg < radius, arg - radius, arg - radius + 1)
        nn_c = nn.clamp(0, nc - 1)
        mutual = (nn >= 0) & (nn < nc) & (nn_c[nn_c] == lane)
        merge = torch.nonzero(mutual & (nn > lane)).flatten()
        nm = int(merge.numel())
        partner = nn[merge]
        union = fmin(box[:, merge], box[:, partner])
        node_l[made:made + nm] = ids[merge]
        node_r[made:made + nm] = ids[partner]
        node_box[:, made:made + nm] = union
        ids[merge] = torch.arange(made, made + nm, dtype=I64, device=dev)
        box[:, merge] = union
        keep = ~(mutual & (nn < lane))
        box, ids = box[:, keep], ids[keep]
        made += nm
        nc -= nm
        if nm == 0:
            raise RuntimeError(f"PLOC reference: no merge with {nc} clusters left")
    remap = lambda v: torch.where(v < m, m - 1 - v, v)
    left = torch.cat([remap(node_l.flip(0)), leaf_prim.to(I64)]).to(I32)
    right = torch.cat([remap(node_r.flip(0)), torch.full((n,), -1, dtype=I64, device=dev)])
    return (torch.cat([node_box.flip(1), leaf_packed], dim=1), left, right.to(I32),
            torch.zeros((), dtype=I32, device=dev))


def build_lbvh(tris, config: dict, dtype=F32):
    """The reference single-pass LBVH of a triangle soup (a configuration's
    `"reference": "benchmark.reference.build:build_lbvh"`)."""
    codes, leaf_packed, leaf_prim = front_half(tris, dtype)
    return lbvh(codes, leaf_packed, leaf_prim)


def build_ploc(tris, config: dict, dtype=F32):
    """The reference PLOC++ tree of a triangle soup with the configuration's
    `radius`."""
    _, leaf_packed, leaf_prim = front_half(tris, dtype)
    return ploc(leaf_packed, leaf_prim, int(config["radius"]), dtype)
