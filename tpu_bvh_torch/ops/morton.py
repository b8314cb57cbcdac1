"""Morton codes (plain 30-bit and extended), bit-exact with `tpu_bvh.ops.morton`.

PyTorch has thin uint32 support, so codes live in int64 tensors holding
u32 values and every op that could leave 32 bits is masked. The extended
code's axis and bit-budget decisions depend only on the scene extent: they
are computed once on the host from the f32 extent (one device sync per
build), with u32 wrap-around and XLA's "shift by >= 32 gives 0" rule
reproduced in Python integers. Per-primitive work stays on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import timer

M32 = 0xFFFFFFFF


def _shl(x, s: int):
    """u32 logical shift left by a host scalar (0 when s >= 32)."""
    if s >= 32:
        return x * 0 if isinstance(x, torch.Tensor) else 0
    if isinstance(x, torch.Tensor):
        return (x & ((1 << (32 - s)) - 1)) << s
    return (x << s) & M32


def _shr(x, s: int):
    """u32 logical shift right by a host scalar (0 when s >= 32)."""
    if s >= 32:
        return x * 0 if isinstance(x, torch.Tensor) else 0
    return x >> s


def _spread2(v):
    """16 -> 32 bit spread."""
    v = v & 0x0000FFFF
    v = (v ^ (v << 8)) & 0x00FF00FF
    v = (v ^ (v << 4)) & 0x0F0F0F0F
    v = (v ^ (v << 2)) & 0x33333333
    v = (v ^ (v << 1)) & 0x55555555
    return v


def _spread3(x):
    """10 -> 30 bit spread; the multiplies wrap at 32 bits via the masks."""
    x = (x * 0x00010001) & 0xFF0000FF
    x = (x * 0x00000101) & 0x0F00F00F
    x = (x * 0x00000011) & 0xC30C30C3
    x = (x * 0x00000005) & 0x49249249
    return x


def morton30_cols(nx, ny, nz):
    """Plain 30-bit Morton code from normalized [0, 1) coordinate columns.
    Returns int64 tensor of u32 values."""

    def q(p):
        return torch.clamp(p * 1024.0, 0.0, 1023.0).to(torch.int64)

    return (_spread3(q(nx)) * 4 + _spread3(q(ny)) * 2 + _spread3(q(nz))) & M32


def morton30(normalized_pos):
    """Row form of `morton30_cols` (f32[N, 3] -> int64 [N] of u32 values)."""
    return morton30_cols(normalized_pos[:, 0], normalized_pos[:, 1], normalized_pos[:, 2])


def _axis_order(ext):
    """Sorted axis order (largest extent first) and prebit counts, as host
    ints: num_prebits = (ilog2(e0/e1), ilog2(e1/e2), ilog2(e0/e2)) with
    `floor(log2(ratio))` evaluated in f32 like the reference."""
    e = ext.detach().to("cpu", torch.float32)
    x, y, z = (float(v) for v in e)
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

    def ilog2_ratio(a, b):
        ea, eb = e[a], e[b]
        if not (eb > 0 and ea > 0):
            return 0
        return int(torch.floor(torch.log2(ea / eb)))

    a0, a1, a2 = order
    return order, (ilog2_ratio(a0, a1), ilog2_ratio(a1, a2), ilog2_ratio(a0, a2))


def extended_morton30(normalized_pos, scene_extent):
    """Row form of `extended_morton30_cols`: normalized_pos f32[N, 3],
    scene_extent f32[3] -> int64 [N] of u32 values."""
    return extended_morton30_cols(normalized_pos[:, 0], normalized_pos[:, 1],
                                  normalized_pos[:, 2], scene_extent)


def normalize_centroids(centroids, scene_min, scene_extent):
    """Centroid -> [0, 1)^3: (c - min) / extent, an IEEE f32 division (a
    zero extent divides by 1), as the builders' column form computes it."""
    safe = torch.where(scene_extent > 0, scene_extent, 1.0)
    return (centroids - scene_min) / safe


class BitBudget(NamedTuple):
    """The extended code's scene-wide decisions (host ints): the axes from
    widest to narrowest, the bits each takes, the leading bits of the two
    widest (`pre_x`, `pre_y`; `prebits_sum` > 0 turns the prebit path on)
    and the swap of the x and y interleave slots."""
    start_axis: tuple
    bits_x: int
    bits_y: int
    bits_z: int
    pre_x: int
    pre_y: int
    prebits_sum: int
    use_swap: bool


def bit_budget(scene_extent) -> BitBudget:
    """`BitBudget` of the scene extent f32[3], as `tpu_bvh.ops.morton.
    extended_morton30_cols` decides it. It copies the extent to the host,
    the front half's one host sync, counted here; both the plain code and
    the kernel's arguments (`ops/front_half.py`) take it from here."""
    ext = scene_extent.detach().to("cpu", torch.float32)  # the one host sync
    timer.count_host_sync()
    nmb = 30
    start_axis, pre = _axis_order(ext)
    swap = pre[2] - (pre[0] + pre[1])

    pre_x = min(pre[0], nmb)
    pre_y = min(pre[1] * 2, nmb - pre_x) // 2
    prebits_sum = pre_x + pre_y * 2
    at_cap = prebits_sum == nmb
    if at_cap:
        swap = 0
    else:
        prebits_sum = prebits_sum + swap

    ext_smallest = float(ext[start_axis[2]])
    bits_z = max(0, (nmb - prebits_sum) // 3) if ext_smallest != 0.0 else 0
    use_swap = swap > 0
    if use_swap:
        bits_x = max(0, (nmb - bits_z - prebits_sum) // 2 + pre_y + pre_x + 1)
        bits_y = nmb - bits_x - bits_z
    else:
        bits_y = max(0, (nmb - bits_z - prebits_sum) // 2 + pre_y)
        bits_x = nmb - bits_y - bits_z
    return BitBudget(start_axis, bits_x, bits_y, bits_z, pre_x, pre_y, prebits_sum, use_swap)


def extended_morton30_cols(px, py, pz, scene_extent):
    """Extended Morton code: extra leading bits on the dominant axes (by
    extent ratio) before the 2D/3D interleave. Returns int64 of u32 values."""
    b = bit_budget(scene_extent)
    start_axis, bits_x, bits_y, bits_z = b.start_axis, b.bits_x, b.bits_y, b.bits_z
    pre_x, pre_y, prebits_sum, use_swap = b.pre_x, b.pre_y, b.prebits_sum, b.use_swap

    cols = (px, py, pz)

    def axis_code(p, nbits):
        scale = float(_shl(1, nbits & M32))
        hi = float(np.float32(scale) - np.float32(1.0))  # f32 rounding, as XLA
        return torch.clamp(torch.clamp(p * scale, min=0.0), max=hi).to(torch.int64)

    code_x = axis_code(cols[start_axis[0]], bits_x)
    code_y = axis_code(cols[start_axis[1]], bits_y)
    code_z = axis_code(cols[start_axis[2]], bits_z)

    have_pre = prebits_sum > 0
    ubx, uby, ubz = bits_x & M32, bits_y & M32, bits_z & M32
    upx, upy = pre_x & M32, pre_y & M32

    # prebit path, evaluated unconditionally and selected at the end
    bx1 = (ubx - upx) & M32
    m = _shr(code_x & _shl((_shl(1, upx) - 1) & M32, bx1), bx1)
    m = _shl(m, (upy * 2) & M32)
    bx2 = (bx1 - upy) & M32
    by1 = (uby - upy) & M32
    t0 = _spread2(_shr(code_x & _shl((_shl(1, upy) - 1) & M32, bx2), bx2))
    t1 = _spread2(_shr(code_y & _shl((_shl(1, upy) - 1) & M32, by1), by1))
    m = m | ((t0 * 2 + t1) & M32)

    bx3 = (bx2 - 1) & M32 if (use_swap and have_pre) else bx2
    if use_swap:
        m = _shl(m, 1) | _shr(code_x & _shl(1, bx3), bx3)
    m = _shl(m, (bx3 + by1 + ubz) & M32)

    cx_pre = code_x & ((_shl(1, bx3) - 1) & M32)
    cy_pre = code_y & ((_shl(1, by1) - 1) & M32)
    if use_swap:
        delta0, delta1 = (by1 - bx3) & M32, (by1 - ubz) & M32
        cx_pre = _shl(cx_pre, delta0)
    else:
        delta0, delta1 = (bx3 - by1) & M32, (bx3 - ubz) & M32
        cy_pre = _shl(cy_pre, delta0)
    cz_pre = _shl(code_z, delta1)

    if have_pre:
        cx, cy, cz = cx_pre, cy_pre, cz_pre
    else:
        cx, cy, cz = code_x, code_y, code_z
        m = code_x * 0
        delta0 = delta1 = 0

    # final interleave
    if bits_z == 0:
        tail = (_spread2(cx) * 2 + _spread2(cy)) & M32
    else:
        sx = torch.where(cx > 0, _spread3(cx), 0)
        sy = torch.where(cy > 0, _spread3(cy), 0)
        sz = torch.where(cz > 0, _spread3(cz), 0)
        t3 = (sy * 4 + sx * 2 + sz) if use_swap else (sx * 4 + sy * 2 + sz)
        tail = _shr(t3 & M32, (delta0 + delta1) & M32)
    return m | tail

