"""PyTorch + CUDA port of tpu_bvh: the four builders, the batched build,
both BVH2 -> BVH4 collapses, the raster render, the general-ray sweep,
the wavefront traversal and the CLI app (`python -m tpu_bvh_torch.app`).

The JAX package `tpu_bvh` is the reference. This package keeps its module
names, public signatures and array layouts, runs plain PyTorch on CPU
tensors, and launches hand-written CUDA kernels (`csrc/`) on CUDA tensors.
It never imports jax or tpu_bvh.
"""
from .types import Bvh2, Bvh4, Camera, HitInfo, Rays, Transformation  # noqa: F401
