"""Primary-ray generation (pinhole camera from quaternion + fov).

Flat ray index = x * height + y; 0.024 sensor; the `normalize(eye + dir *
far)` direction quirk of the reference renderer is kept. The JAX
package's optional TEA/LCG pixel jitter is not ported (off on the slice).
"""
from __future__ import annotations

import torch

from ..ops.aabb import qt_rotate
from ..types import FLT_MAX, Camera, Rays


def generate_rays(cam: Camera, width: int, height: int) -> Rays:
    """One primary ray per pixel through its center (no jitter)."""
    dev = cam.eye.device
    x = torch.arange(width, dtype=torch.float32, device=dev)
    y = torch.arange(height, dtype=torch.float32, device=dev)
    gx, gy = torch.meshgrid(x, y, indexing="ij")  # [W, H]
    gx = gx.reshape(-1)
    gy = gy.reshape(-1)

    sensor_x = 0.024 * (width / float(height))
    sensor_y = 0.024
    px = (gx + 0.5) / width - 0.5
    py = (gy + 0.5) / height - 0.5
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
