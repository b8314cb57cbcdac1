"""Primary-ray generation (pinhole camera from quaternion + fov).

Flat ray index = x * height + y; 0.024 sensor; the `normalize(eye + dir *
far)` direction quirk of the reference renderer is kept. The reference's
TEA/LCG pixel jitter (`isMultiSamples`, off there) is behind `jitter=`,
off by default. TEA and the LCG are u32 arithmetic: here int64 tensors
hold u32 values and every sum or product is masked to 32 bits (an XOR or
a right shift of a masked value needs no mask), so the jittered rays
equal JAX's bit for bit.
"""
from __future__ import annotations

import torch

from ..ops.aabb import qt_rotate
from ..types import FLT_MAX, Camera, Rays

M32 = 0xFFFFFFFF


def tea(val0, val1, rounds: int = 16):
    """TEA hash (`CommonBlocksKernel.h:414-430`) of u32 values (int64
    tensors, or a scalar for val1). Returns (v0, v1), int64 of u32 values."""
    v0 = val0.to(torch.int64) & M32
    v1 = torch.as_tensor(val1, dtype=torch.int64, device=v0.device).expand_as(v0) & M32
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) ^ (v1 + s0)) ^ ((v1 >> 5) + 0xC8013EA4))) & M32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) ^ (v0 + s0)) ^ ((v0 >> 5) + 0x7E95761E))) & M32
    return v0, v1


def lcg_randf(seed):
    """One LCG step (`CommonBlocksKernel.h:400-412`) of u32 seeds (int64):
    returns (f32 in [0, 1), the advanced seed)."""
    seed = (1103515245 * seed + 12345) & M32
    return (seed & 0x00FFFFFF).to(torch.float32) / float(0x01000000), seed


def generate_rays(cam: Camera, width: int, height: int, jitter: bool = False) -> Rays:
    """One primary ray per pixel, through its center, or with `jitter`
    through the offset of one `lcg_randf` draw (seeded by
    `tea(x + y * width, 0)`) on both axes, as the reference does."""
    dev = cam.eye.device
    x = torch.arange(width, dtype=torch.float32, device=dev)
    y = torch.arange(height, dtype=torch.float32, device=dev)
    gx, gy = torch.meshgrid(x, y, indexing="ij")  # [W, H]
    gx = gx.reshape(-1)
    gy = gy.reshape(-1)

    sensor_x = 0.024 * (width / float(height))
    sensor_y = 0.024
    if jitter:
        seed, _ = tea((gx + gy * width).to(torch.int64), 0)
        offset, _ = lcg_randf(seed)
    else:
        offset = 0.5
    px = (gx + offset) / width - 0.5
    py = (gy + offset) / height - 0.5
    focal = sensor_y / (2.0 * torch.tan(cam.fov / 2.0))
    d = torch.stack([px * sensor_x, py * sensor_y, focal.expand_as(px)], dim=-1)

    def axis(v):
        return qt_rotate(cam.quat, torch.tensor(v, dtype=torch.float32, device=dev))

    hol, up, view = axis([1.0, 0.0, 0.0]), axis([0.0, -1.0, 0.0]), axis([0.0, 0.0, -1.0])
    dirs = d[:, 0:1] * hol + d[:, 1:2] * up + d[:, 2:3] * view
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)

    n = width * height
    target = cam.eye + dirs * cam.far
    direction = target / torch.linalg.norm(target, dim=-1, keepdim=True)
    return Rays(
        origin=cam.eye.expand(n, 3),
        direction=direction,
        tmin=torch.zeros(n, dtype=torch.float32, device=dev),
        tmax=torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev),
    )
