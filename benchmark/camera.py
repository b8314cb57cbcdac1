"""Camera poses and jittered primary rays, made on the device from the seed.

The pinhole arithmetic is a torch copy of the port's `utils/camera.py`: a
quaternion (x, y, z, w) turns the camera axes (1, 0, 0), (0, -1, 0) and
(0, 0, -1); the sensor is 0.024 high with the frame's aspect; pixel (x, y)
is ray x * height + y; each ray's direction is normalize(eye + d * far) with
far = 100000, the reference renderer's quirk. Unlike the port's TEA jitter,
which repeats every frame, each frame draws its own sub-pixel offset per
pixel (one draw for both axes, as the reference's one LCG draw).

Poses lie on a path inside the hall drawn from the mix's own `path_seed`: the
eye uniform over [-16, 16] x [eye_y_lo, eye_y_hi] x [-7, 7], the yaw uniform
over a turn and the pitch uniform over [pitch_lo, pitch_hi] radians. Every run
seed sees the same poses, in an order and with sub-pixel offsets of its own,
so that the seed does not change how much work a frame is.

A mix names this generator as `"inputs": "benchmark.camera:frames"`, called as
`frames(config, traffic, scene, seed, device)`.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
SENSOR = 0.024
FAR = 100000.0
EYE_X = (-16.0, 16.0)
EYE_Z = (-7.0, 7.0)


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def rotate(q, p):
    """Rotate p by the unit quaternion q = (x, y, z, w)."""
    qv, qw = q[..., :3], q[..., 3:4]
    t = 2.0 * _cross(qv.expand_as(p), p)
    return p + qw * t + _cross(qv.expand_as(t), t)


def _quat_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return (aw * bx + ax * bw + ay * bz - az * by, aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw, aw * bw - ax * bx - ay * by - az * bz)


def poses(n: int, eye_y: tuple, pitch: tuple, gen: torch.Generator, device):
    """n poses: (eye f32[n, 3], quat f32[n, 4]) from `gen`."""
    u = torch.rand((n, 5), generator=gen, device=device, dtype=torch.float64).cpu().tolist()
    eyes, quats = [], []
    for ux, uy, uz, uyaw, upitch in u:
        eyes.append((EYE_X[0] + (EYE_X[1] - EYE_X[0]) * ux, eye_y[0] + (eye_y[1] - eye_y[0]) * uy,
                     EYE_Z[0] + (EYE_Z[1] - EYE_Z[0]) * uz))
        yaw = 2 * math.pi * uyaw
        pit = pitch[0] + (pitch[1] - pitch[0]) * upitch
        q_yaw = (0.0, math.sin(yaw / 2), 0.0, math.cos(yaw / 2))
        q_pitch = (math.sin(pit / 2), 0.0, 0.0, math.cos(pit / 2))
        quats.append(_quat_mul(q_yaw, q_pitch))
    return (torch.tensor(eyes, dtype=F32, device=device),
            torch.tensor(quats, dtype=F32, device=device))


def primary_rays(eye, quat, fov_deg: float, width: int, height: int, gen: torch.Generator):
    """One jittered ray a pixel: (origin f32[W*H, 3], the eye's row expanded
    with stride 0; direction f32[W*H, 3])."""
    dev = eye.device
    x = torch.arange(width, dtype=F32, device=dev)
    y = torch.arange(height, dtype=F32, device=dev)
    gx, gy = torch.meshgrid(x, y, indexing="ij")
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    offset = torch.rand(gx.shape, generator=gen, device=dev, dtype=F32)
    px = (gx + offset) / width - 0.5
    py = (gy + offset) / height - 0.5
    fov = torch.tensor(math.radians(fov_deg), dtype=F32, device=dev)
    focal = SENSOR / (2.0 * torch.tan(fov / 2.0))
    d = torch.stack([px * (SENSOR * (width / float(height))), py * SENSOR,
                     focal.expand_as(px)], dim=-1)

    def axis(v):
        return rotate(quat, torch.tensor(v, dtype=F32, device=dev))

    hol, up, view = axis([1.0, 0.0, 0.0]), axis([0.0, -1.0, 0.0]), axis([0.0, 0.0, -1.0])
    dirs = d[:, 0:1] * hol + d[:, 1:2] * up + d[:, 2:3] * view
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    target = eye + dirs * FAR
    direction = target / torch.linalg.norm(target, dim=-1, keepdim=True)
    return eye.expand(gx.shape[0], 3), direction.contiguous()


class Frames:
    """The trace mix's rays: `origin[p]`, `direction[p]` of pose p."""

    def __init__(self, n_poses: int, width: int, height: int, fov_deg: float, eye_y, pitch,
                 path_seed: int, seed: int, device):
        path = torch.Generator(device=device)
        path.manual_seed(int(path_seed))
        eyes, quats = poses(n_poses, tuple(eye_y), tuple(pitch), path, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) ^ 0x5EED)
        order = torch.randperm(n_poses, generator=gen, device=device).tolist()
        self.origin, self.direction = [], []
        for p in order:
            o, d = primary_rays(eyes[p], quats[p], fov_deg, width, height, gen)
            self.origin.append(o)
            self.direction.append(d)
        self.n_rays = width * height
        self.sizes = {"rays": self.n_rays}


def frames(config: dict, traffic: dict, scene, seed: int, device) -> Frames:
    """The mix's poses and rays: `poses`, `width`, `height`, `fov_deg`,
    `eye_y` and `pitch` ranges and `path_seed`."""
    return Frames(traffic["poses"], traffic["width"], traffic["height"], traffic["fov_deg"],
                  traffic["eye_y"], traffic["pitch"], traffic["path_seed"], seed, device)
