"""The benchmark's scenes: a vectorised copy of the port's `sponza_like` recipe,
made on the device from the seed, with moving clutter.

A configuration names its scene generator (`"scene": "benchmark.scene:sponza_like"`),
called as `generator(config, traffic, seed, device)`; what it returns has
`frames` (f32[N, 3, 3] each, on the device), `n_tris` and `sizes`, the names
that the hand kernels' byte formulas read.

The hall (a 40 x 15 x 20 shell of six slabs) and its 24 faceted columns are the
recipe's fixed geometry. Clutter boxes (12 triangles each) fill the scene up to
the configuration's triangle count; their centres are uniform in the recipe's
[-19, 19] x [0, 2.5] x [-9, 9] and their half-sizes uniform in [0.05, 0.5] times
(occupancy_tris / n_tris)^(1/3), so that a larger scene fills the hall as the
recipe's own 262K scene does. Frame f > 0 moves every clutter box by a seeded
offset of up to `motion` times its own half-size on each axis; the hall and the
columns stay put.

All random draws come from one `torch.Generator` on the target device, in a few
large calls, so the same seed gives the same triangles on that device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32

# add_box's six quads as corner bits (x, y, z): 1 takes the box's max, 0 its min
_QUADS = (
    ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)),
    ((0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1)),
    ((0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1)),
    ((1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0)),
    ((0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1)),
    ((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0)),
)
# each quad (a, b, c, d) gives the triangles (a, b, c) and (a, c, d)
_BOX_BITS = np.array([[q[i] for tri in ((0, 1, 2), (0, 2, 3)) for i in tri] for q in _QUADS],
                     dtype=bool).reshape(12, 3, 3)
TRIS_PER_BOX = 12
CLUTTER_LO = (-19.0, 0.0, -9.0)
CLUTTER_HI = (19.0, 2.5, 9.0)
HALF_SIZE = (0.05, 0.5)


def box_triangles(lo, hi):
    """The 12 triangles of each axis-aligned box [lo, hi] (f32[B, 3] each), in
    the recipe's vertex order: f32[B * 12, 3, 3]."""
    bits = torch.as_tensor(_BOX_BITS, device=lo.device)
    tris = torch.where(bits, hi[:, None, None, :], lo[:, None, None, :])
    return tris.reshape(-1, 3, 3)


def _np_box(lo, hi):
    """`box_triangles` of one box, in float64."""
    t = torch.tensor([lo, hi], dtype=torch.float64)
    return box_triangles(t[:1], t[1:]).numpy()


def hall() -> np.ndarray:
    """The fixed geometry: the shell's six slabs, then for each of 12 column
    positions from x = -17 to 17 a column at z = -6 and one at z = 6 (16 facets
    and a capital box each). f32[1128, 3, 3]."""
    parts = [_np_box(lo, hi) for lo, hi in (
        ((-20, -0.2, -10), (20, 0, 10)), ((-20, 15, -10), (20, 15.2, 10)),
        ((-20.2, 0, -10), (-20, 15, 10)), ((20, 0, -10), (20.2, 15, 10)),
        ((-20, 0, -10.2), (20, 15, -10)), ((-20, 0, 10), (20, 15, 10.2)))]
    n_seg, radius, height = 16, 0.8, 9.0
    ang = np.linspace(0, 2 * math.pi, n_seg + 1)
    for cx in np.linspace(-17, 17, 12):
        for cz in (-6.0, 6.0):
            xs = cx + radius * np.cos(ang)
            zs = cz + radius * np.sin(ang)
            a = np.stack([xs[:-1], np.zeros(n_seg), zs[:-1]], -1)
            b = np.stack([xs[1:], np.zeros(n_seg), zs[1:]], -1)
            c = np.stack([xs[1:], np.full(n_seg, height), zs[1:]], -1)
            d = np.stack([xs[:-1], np.full(n_seg, height), zs[:-1]], -1)
            quads = np.stack([np.stack([a, b, c], 1), np.stack([a, c, d], 1)], 1)
            parts.append(quads.reshape(-1, 3, 3))
            r = radius * 1.3
            parts.append(_np_box((cx - r, height, cz - r), (cx + r, height + 0.6, cz + r)))
    return np.concatenate(parts).astype(np.float32)


class Scene:
    """The frames of one seed: `frames[f]` is f32[N, 3, 3] on the device."""

    def __init__(self, n_tris: int, occupancy_tris: int, n_frames: int, motion: float,
                 seed: int, device):
        fixed = torch.as_tensor(hall(), device=device)
        n_boxes = max(0, n_tris - fixed.shape[0]) // TRIS_PER_BOX
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        lo = torch.tensor(CLUTTER_LO, dtype=F32, device=device)
        hi = torch.tensor(CLUTTER_HI, dtype=F32, device=device)
        centres = lo + (hi - lo) * torch.rand((n_boxes, 3), generator=gen, device=device)
        scale = (occupancy_tris / n_tris) ** (1.0 / 3.0)
        h0, h1 = HALF_SIZE
        half = (h0 + (h1 - h0) * torch.rand((n_boxes, 3), generator=gen, device=device)) * scale
        moves = (2 * torch.rand((max(n_frames - 1, 0), n_boxes, 3), generator=gen,
                                device=device) - 1) * half * motion
        self.frames = []
        for f in range(n_frames):
            c = centres if f == 0 else centres + moves[f - 1]
            self.frames.append(torch.cat([fixed, box_triangles(c - half, c + half)]))
        self.n_tris = int(self.frames[0].shape[0])
        self.sizes = {"n": self.n_tris}


def sponza_like(config: dict, traffic: dict, seed: int, device) -> Scene:
    """The recipe's hall filled with clutter up to the configuration's
    `n_tris`, in the mix's `frames` (default 1) moved by its `motion`."""
    return Scene(config["n_tris"], config["occupancy_tris"], traffic.get("frames", 1),
                 traffic.get("motion", 0.0), seed, device)
