"""Scene extent reduction (deterministic min/max, no atomics)."""
from __future__ import annotations


def scene_extents(aabb_min, aabb_max):
    """Whole-scene AABB from per-primitive AABBs f32[N, 3].
    Returns (scene_min f32[3], scene_max f32[3])."""
    return aabb_min.amin(dim=0), aabb_max.amax(dim=0)
