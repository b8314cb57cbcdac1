"""The multi-device dry run: the port of `__graft_entry__.dryrun_multichip`.

`dryrun_multichip(n_devices)` starts `n_devices` ranks and runs, once, at
the reference's tiny shapes: (1) the batched build with meshes sharded
over the ranks, (2) the scene extents of a sharded soup (an all-reduce),
(3) the traversal with rays sharded and the BVH replicated, (4) the raster
render by vertical strips, and (5) the sharded single-scene build, whose
assembled tree must equal the single-device `lbvh.build_single_pass` tree
bit for bit.

    python -m tpu_bvh_torch.parallel.dryrun --ranks 4           # NCCL, a card a rank
    python -m tpu_bvh_torch.parallel.dryrun --ranks 4 --backend gloo  # ranks share a card
    python -m tpu_bvh_torch.parallel.dryrun --ranks 4 --cpu     # gloo on the CPU
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models import batched, lbvh
from ..ops import raster
from ..utils import camera, scenes
from . import comm, sharded, sharded_build


def _steps(dev):
    """The five steps on this rank; returns what each produced here."""
    mesh = sharded.default_mesh()
    n_devices = mesh.size
    out = {}

    # 1) batch parallelism: one tiny BVH per mesh, the batch sharded
    rng = np.random.default_rng(0)
    meshes = [(rng.normal(size=(8, 3, 3)) * 0.3 + rng.normal(size=(1, 1, 3))).astype(np.float32)
              for _ in range(n_devices * 2)]
    tris_b, _counts = batched.pad_meshes(meshes, capacity=8, device=dev)
    bvhs = sharded.build_batched_sharded(mesh, tris_b)
    out["batched roots"] = bvhs.root.tolist()

    # 2) primitive sharding: scene extents through an all-reduce
    big = scenes.bunny_like(n_devices * 64)
    pad = (-big.shape[0]) % n_devices
    if pad:
        big = np.concatenate([big, np.repeat(big[:1], pad, axis=0)], axis=0)
    lo, hi = sharded.sharded_scene_extents(mesh, torch.from_numpy(big).to(dev))
    out["extents"] = (lo.tolist(), hi.tolist())

    # 3) ray parallelism: a replicated BVH, rays sharded
    tris = torch.from_numpy(scenes.cornellbox()).to(dev)
    bvh = lbvh.build_two_pass(tris)
    tr, cam = scenes.preset("cornellbox", device=dev)
    rays = camera.generate_rays(cam, 8 * n_devices, 8)
    hit, _counts = sharded.traverse_sharded(mesh, bvh, tris, rays, tr)
    out["traverse hits"] = int((hit.prim_idx >= 0).sum())

    # 4) the raster render by vertical strips (B4 on the card)
    packed = raster.pack_raster(bvh, tris, leaf_size=8)
    W, H = 64 * n_devices, 64
    hit_r = sharded.render_raster_sharded(mesh, packed, camera.generate_rays(cam, W, H), tr, W,
                                          H, cand_cap=16, pair_cap=128, group=4)
    out["raster hits"] = int((hit_r.prim_idx >= 0).sum())

    # 5) the sharded single-scene build: bit-identical to a single device.
    # bunny_like rounds its size (242 triangles for 256), which JAX's step
    # takes as it comes and then fails its own n % p rule at p = 4; here the
    # soup is padded to 64 * p with copies of its first triangle, as step 2
    # pads
    n_tris = 64 * n_devices
    soup = np.asarray(scenes.bunny_like(n_tris), np.float32)
    soup = np.concatenate([soup, np.repeat(soup[:1], n_tris - soup.shape[0], axis=0)])
    soup = torch.from_numpy(soup).to(dev)
    sb = sharded_build.build_single_pass_sharded(mesh, soup)
    if bool(sb.overflow):
        raise AssertionError("the sharded build overflowed its routing capacity")
    got = sharded_build.to_bvh2(sb, n_tris, mesh)
    want = lbvh.build_single_pass(soup)
    for f in ("packed_t", "left", "right", "root"):
        g, w = getattr(got, f), getattr(want, f)
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            raise AssertionError(f"sharded build: {f} differs from the single-device build")
    out["sharded build root"] = int(got.root)
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda", backend: str | None = None,
                     timeout: float = 600.0) -> list:
    """Run the five steps once on `n_devices` ranks; returns each rank's
    summary. `backend` is NCCL on the card (one card a rank) and gloo on
    the CPU unless named; ranks that share a card need backend="gloo"."""
    return comm.spawn(_steps, n_devices, device=device, backend=backend, timeout=timeout)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, required=True, help="number of ranks (processes)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo)")
    ap.add_argument("--backend", choices=("gloo", "nccl"),
                    help="collective backend (default: nccl on the card, gloo on the CPU)")
    args = ap.parse_args(argv)
    for rank, summary in enumerate(dryrun_multichip(args.ranks, "cpu" if args.cpu else "cuda",
                                                    args.backend)):
        print(f"rank {rank}: {summary}", flush=True)
    print(f"dryrun_multichip({args.ranks}): the five steps done on every rank", flush=True)


if __name__ == "__main__":
    main()
