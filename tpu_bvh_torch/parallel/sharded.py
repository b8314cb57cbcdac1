"""Multi-device scaling over `torch.distributed` ranks: the port of
`tpu_bvh.parallel.sharded`.

JAX shards arrays over a `Mesh` axis 'dp' under `shard_map`; here every
rank runs the same call (SPMD). Each public function is called on every
rank of the group with the whole input, as JAX's are, slices its own
shard by rank and returns that shard:

* batch parallelism: one BVH per mesh, meshes sharded over the ranks
  (`build_batched_sharded`; no communication);
* primitive sharding: the scene extents of a sharded triangle array, local
  mins and maxes then a `pmin` / `pmax` over the ranks
  (`sharded_scene_extents`);
* ray parallelism: rays sharded, BVH replicated (`traverse_sharded`), and
  the raster render by vertical strips (`render_raster_sharded`).
"""
from __future__ import annotations

from ..models import batched
from ..ops import aabb as A
from ..ops import raster_gpu, traverse
from ..types import Rays
from .comm import Mesh


def default_mesh(n_devices: int | None = None) -> Mesh:
    """The initialised process group as a one-axis mesh. `n_devices`, if
    given, must be its world size: a rank outside a smaller mesh would
    have no part in the calls."""
    mesh = Mesh()
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"n_devices={n_devices} but the process group has {mesh.size} ranks")
    return mesh


def _shard(mesh: Mesh, x, what: str):
    """This rank's contiguous chunk of `x` along axis 0 (which `P('dp')`
    requires to divide evenly)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{what}: {n} rows do not split over {mesh.size} ranks")
    k = n // mesh.size
    return x[mesh.rank * k:(mesh.rank + 1) * k]


def build_batched_sharded(mesh: Mesh, tris_b):
    """Shard the mesh batch over the ranks; each rank builds its local
    BVHs with no communication. Returns this rank's batch-stacked Bvh2."""
    return batched.build_batched(_shard(mesh, tris_b, "build_batched_sharded"))


def sharded_scene_extents(mesh: Mesh, tris):
    """Scene AABB (lo f32[3], hi f32[3]) of a triangle array sharded over
    the ranks: local min/max then an all-reduce, replicated on every rank.
    Deterministic: the mins and maxes are taken on `aabb.min_key`s, whose
    integer order is `jnp.minimum`'s (signed zeros included)."""
    local = _shard(mesh, tris, "sharded_scene_extents")
    keys = mesh.pmin(A.min_key(A.packed_bounds(local, -2, -1)).amin(dim=0))  # min xyz, -max xyz
    return A.from_min_key(keys[:3]), -A.from_min_key(keys[3:])


def traverse_sharded(mesh: Mesh, bvh, tris, rays: Rays, tr, variant="speculative"):
    """Rays sharded over the ranks, BVH and triangles replicated: the
    multi-device render. Returns this rank's (HitInfo, leaf-visit counts)."""
    local = Rays(*(_shard(mesh, f, "traverse_sharded") for f in rays))
    return traverse.traverse_bvh2(bvh, tris, local, tr, variant=variant)


def render_raster_sharded(mesh: Mesh, scene, rays: Rays, tr, width: int, height: int, **kw):
    """Raster render with the image split into vertical strips over the
    ranks (rays are x-major, so a rank's contiguous chunk is a strip
    `width / p` wide), the scene replicated: each rank runs the whole
    raster pipeline (binning and the sweep, B4 on the card) on its strip
    with no communication. Caps as JAX's: `cand_cap` (256), `pair_cap`
    (2048), `group` (8). Returns this rank's HitInfo."""
    p = mesh.size
    if width % (64 * p):
        raise ValueError(f"width {width} must split into {p} strips of whole 64 px tiles")
    w_local = width // p
    local = Rays(*(_shard(mesh, f, "render_raster_sharded") for f in rays))
    hit, _counts, _overflow = raster_gpu.render_raster_gpu(
        scene, local, tr, w_local, height, kw.get("cand_cap", 256), kw.get("pair_cap", 2048),
        kw.get("group", 8))
    return hit
