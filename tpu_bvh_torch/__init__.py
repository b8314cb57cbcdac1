"""PyTorch + CUDA port of the tpu_bvh LBVH build and raster render.

The JAX package `tpu_bvh` is the reference. This package keeps its module
names, public signatures and array layouts, runs plain PyTorch on CPU
tensors, and launches hand-written CUDA kernels (`csrc/`) on CUDA tensors.
It never imports jax or tpu_bvh.
"""
from .types import Bvh2, Camera, HitInfo, Rays, Transformation  # noqa: F401
