"""Batched builder: one BVH per mesh for thousands of tiny meshes; the port
of `tpu_bvh.models.batched`.

Meshes are padded to a fixed prim capacity (the reference caps a block at
`MaxBatchedBlockSize` = 32, `Common.h:597`); padding triangles collapse to
the mesh's first vertex, so they never produce hits, and `prim_count`
records the real size of each mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import batched_block, batched_build
from ..types import MAX_BATCHED_PRIMS, Bvh2
from . import lbvh


def pad_meshes(meshes: list, capacity: int = MAX_BATCHED_PRIMS, device="cuda"):
    """Stack triangle soups (array-likes of [n, 3, 3]) into tris_b
    f32[B, capacity, 3, 3] and prim_count i32[B], on `device` (the GPU
    unless the caller names another). Padding repeats each mesh's first
    vertex (zero-area triangles)."""
    out = np.zeros((len(meshes), capacity, 3, 3), np.float32)
    counts = np.zeros((len(meshes),), np.int32)
    for i, mesh in enumerate(meshes):
        mesh = np.asarray(mesh, np.float32)
        n = mesh.shape[0]
        if n > capacity:
            raise ValueError(f"mesh {i} has {n} > {capacity} prims")
        out[i, :n] = mesh
        out[i, n:] = mesh[0, 0]  # degenerate point triangles
        counts[i] = n
    return torch.from_numpy(out).to(device), torch.from_numpy(counts).to(device)


def build_batched(tris_b) -> Bvh2:
    """tris_b: f32[B, M, 3, 3] -> batch-stacked Bvh2 (every field gains a
    leading B axis, root is i32[B]), built with plain 30-bit Morton codes
    as the batched reference kernel does (`BatchedBuildKernel.h:266-287`).

    The capacity M picks the path, as JAX's `build_batched` does by shape:
    M <= 64 takes the dense form (`ops/batched_build.py`: one launch of the
    warp-a-mesh kernel for the whole batch on a CUDA tensor, the all-pairs
    plain version on a CPU tensor); 64 < M <= 1024 the vmapped single-pass
    build's contract (`ops/batched_block.py`: one launch of the
    block-a-mesh kernel on a CUDA tensor, its plain version on a CPU
    tensor); M > 1024 builds each mesh with `lbvh.build_single_pass(...,
    use_extended=False)` and stacks the trees (on a CUDA tensor that
    launches B1 and B2 once a mesh). Each size takes its path by this
    rule, not as a fallback."""
    B, M = tris_b.shape[:2]
    if M <= batched_build.MAX_PRIMS:
        return Bvh2(*batched_build.batched_build(tris_b))
    if M <= batched_block.MAX_PRIMS:
        return Bvh2(*batched_block.batched_block(tris_b))
    if B == 0:  # no tree to stack: JAX's shapes and dtypes
        dev = tris_b.device
        return Bvh2(torch.empty((0, 6, 2 * M - 1), dtype=torch.float32, device=dev),
                    torch.empty((0, 2 * M - 1), dtype=torch.int32, device=dev),
                    torch.empty((0, 2 * M - 1), dtype=torch.int32, device=dev),
                    torch.empty((0,), dtype=torch.int32, device=dev))
    trees = [lbvh.build_single_pass(t, use_extended=False) for t in tris_b]
    return Bvh2(*(torch.stack(f) for f in zip(*trees)))


def _build_batched_small(tris_b) -> Bvh2:
    """The dense path's plain version on any device (JAX's
    `_build_batched_small`): the oracle of the card's kernel."""
    return Bvh2(*batched_build.batched_build_reference(tris_b))
