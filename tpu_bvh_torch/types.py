"""Core data model: NamedTuples of tensors in the layouts of `tpu_bvh.types`.

Index convention: an N-leaf BVH2 has 2N-1 node slots; internal nodes occupy
[0, N-2], leaves [N-1, 2N-2]. A leaf's `left` holds its primitive index and
its `right` is -1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

FLT_MAX = 3.402823466e38


class Bvh2(NamedTuple):
    """Binary BVH. Node AABBs are `packed_t` f32[6, M] with rows
    (min x, min y, min z, -max x, -max y, -max z), so every range union is
    a single `minimum`."""

    packed_t: torch.Tensor  # f32[6, M]
    left: torch.Tensor  # i32[M]
    right: torch.Tensor  # i32[M]
    root: torch.Tensor  # i32[] scalar

    @property
    def node_min(self) -> torch.Tensor:
        """Row-major f32[M, 3] view."""
        return self.packed_t[0:3].T

    @property
    def node_max(self) -> torch.Tensor:
        return -self.packed_t[3:6].T

    @property
    def n_nodes(self) -> int:
        return self.left.shape[-1]

    @property
    def n_leaves(self) -> int:
        return (self.left.shape[-1] + 1) // 2

    @property
    def n_internal(self) -> int:
        return self.n_leaves - 1


class Camera(NamedTuple):
    """Pinhole camera."""

    eye: torch.Tensor  # f32[3]
    quat: torch.Tensor  # f32[4] (x, y, z, w)
    fov: torch.Tensor  # f32[] radians
    near: torch.Tensor  # f32[]
    far: torch.Tensor  # f32[]


class Transformation(NamedTuple):
    """Object-to-world scale, rotate, translate."""

    translation: torch.Tensor  # f32[3]
    scale: torch.Tensor  # f32[3]
    quat: torch.Tensor  # f32[4]


class Rays(NamedTuple):
    origin: torch.Tensor  # f32[R, 3]
    direction: torch.Tensor  # f32[R, 3]
    tmin: torch.Tensor  # f32[R]
    tmax: torch.Tensor  # f32[R]


class HitInfo(NamedTuple):
    """Closest hit per ray; prim_idx -1 and t FLT_MAX on a miss."""

    prim_idx: torch.Tensor  # i32[R]
    t: torch.Tensor  # f32[R]
    u: torch.Tensor  # f32[R]
    v: torch.Tensor  # f32[R]

