"""Core data model: NamedTuples of tensors in the layouts of `tpu_bvh.types`.

Index convention: an N-leaf BVH2 has 2N-1 node slots; internal nodes occupy
[0, N-2], leaves [N-1, 2N-2]. A leaf's `left` holds its primitive index and
its `right` is -1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

INVALID_IDX = -1  # an absent child or node id
FLT_MAX = 3.402823466e38
PLOC_RADIUS = 8  # PLOC nearest-neighbour search radius in Morton order
MAX_BATCHED_PRIMS = 32  # default mesh capacity of the batched builder (the reference's block)


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

    @classmethod
    def from_rows(cls, node_min, node_max, left, right, root) -> "Bvh2":
        """Build from row-major f32[M, 3] node boxes (a contiguous packed_t)."""
        packed = torch.cat([node_min, -node_max], dim=-1)
        return cls(packed_t=packed.transpose(-1, -2).contiguous(), left=left, right=right,
                   root=root)

    @property
    def n_nodes(self) -> int:
        return self.left.shape[-1]

    @property
    def n_leaves(self) -> int:
        return (self.left.shape[-1] + 1) // 2

    @property
    def n_internal(self) -> int:
        return self.n_leaves - 1


class Bvh4(NamedTuple):
    """4-wide BVH from a BVH2 collapse. A child id `c < n_internal_cap`
    is another wide node; otherwise it is wide leaf slot
    `c - n_internal_cap` (its primitive is `leaf_prim[c - cap]`). Slot
    AABBs are lane-major: `slot_packed_t[k, :, x]` = slot k of wide node x
    as (min xyz, -max xyz). The queue-ordered collapse numbers wide nodes
    in BFS order from root 0; the fast collapse keeps each wide node at
    its bvh2 index (unused ids have child_count 0) and `root` is the
    bvh2 root."""

    slot_packed_t: torch.Tensor  # f32[4, 6, K]
    child_t: torch.Tensor  # i32[4, K] (-1 for empty slots)
    parent: torch.Tensor  # i32[K]
    child_count: torch.Tensor  # i32[K]
    n_nodes: torch.Tensor  # i32[] wide internal nodes in use
    leaf_prim: torch.Tensor  # i32[N] primitive of each wide leaf slot
    leaf_parent: torch.Tensor  # i32[N]
    root: torch.Tensor  # i32[]

    @property
    def n_internal_cap(self) -> int:
        """Capacity of the wide-node array; also the leaf id bias."""
        return self.child_t.shape[-1]

    @property
    def child(self) -> torch.Tensor:
        """Row-major i32[K, 4] view."""
        return self.child_t.T

    @property
    def child_min(self) -> torch.Tensor:
        """Row-major f32[K, 4, 3] view."""
        return self.slot_packed_t[:, 0:3, :].permute(2, 0, 1)

    @property
    def child_max(self) -> torch.Tensor:
        return -self.slot_packed_t[:, 3:6, :].permute(2, 0, 1)

    @classmethod
    def from_rowmajor(cls, child_min, child_max, child, **kw) -> "Bvh4":
        """Build from [K, 4, 3] slot AABBs and [K, 4] child ids."""
        sp = torch.cat([child_min.permute(1, 2, 0), -child_max.permute(1, 2, 0)], dim=1)
        return cls(slot_packed_t=sp.contiguous(), child_t=child.T.contiguous(), **kw)


class PrimRefs(NamedTuple):
    """Primitive references: one AABB and source primitive per reference
    (one per triangle without split clipping)."""

    aabb_min: torch.Tensor  # f32[R, 3]
    aabb_max: torch.Tensor  # f32[R, 3]
    prim_idx: torch.Tensor  # i32[R]


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


def identity_transform(device="cuda") -> Transformation:
    """No scale, rotation or translation, on `device` (the GPU unless the
    caller names another)."""
    return Transformation(
        translation=torch.zeros(3, dtype=torch.float32, device=device),
        scale=torch.ones(3, dtype=torch.float32, device=device),
        quat=torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32, device=device),
    )
