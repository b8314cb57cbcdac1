"""Drive the port end to end through its public API, the counterpart of
`tools/e2e_drive.py`: load the cornellbox, build it with both LBVH
builders, collapse each to a BVH4 and print the SAH costs, trace 256 x 256
primary rays with the four traversal variants and check that they agree,
check the raster render against them, and write the render and the heat
map as PNGs.

    python -m tpu_bvh_torch.e2e_drive [--cpu] [--out-dir DIR]

Runs on the card unless `--cpu` is given; without a card and without
`--cpu` it raises.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from .models import lbvh
from .ops import collapse, raster, traverse
from .ops.aabb import triangle_aabbs
from .utils import camera, image, scenes
from .utils.cost import sah_cost_bvh2, sah_cost_bvh4

SIZE = 256


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--out-dir", default=tempfile.gettempdir())
    a = p.parse_args(argv)
    device = torch.device("cpu" if a.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")

    tris_np = scenes.cornellbox()
    print("cornellbox tris:", tris_np.shape)
    tris = torch.from_numpy(tris_np).to(device)
    tr, cam = scenes.preset("cornellbox", device=device)
    rays = camera.generate_rays(cam, SIZE, SIZE)

    for name, build in (("two_pass", lbvh.build_two_pass), ("single_pass", lbvh.build_single_pass)):
        bvh = build(tris)
        b4 = collapse.collapse_bvh2_to_bvh4(bvh)
        c4 = float(sah_cost_bvh4(b4, *triangle_aabbs(tris)))
        print(f"{name}: root={int(bvh.root)} sah_bvh2={float(sah_cost_bvh2(bvh)):.4f} "
              f"sah_bvh4={c4:.4f} wide_nodes={int(b4.n_nodes)}")

    bvh = lbvh.build_two_pass(tris)
    hits = {}
    for variant in traverse.VARIANTS:
        t0 = time.perf_counter()
        hit, counts = traverse.traverse_bvh2(bvh, tris, rays, tr, variant=variant)
        hits[variant] = type(hit)(*(x.cpu().numpy() for x in hit))
        print(f"{variant}: hits={int((hits[variant].prim_idx >= 0).sum())}/{SIZE * SIZE} "
              f"mean_leaf_visits={float(counts.double().mean()):.2f} "
              f"({time.perf_counter() - t0:.1f}s)")
    base = hits["speculative"]
    hm = base.prim_idx >= 0
    for v, h in hits.items():
        if not np.array_equal(h.prim_idx, base.prim_idx):
            raise AssertionError(f"{v}: prim ids differ from speculative's")
        if not np.allclose(h.t[hm], base.t[hm], rtol=1e-5):
            raise AssertionError(f"{v}: t differs from speculative's")
    print("all 4 traversal variants agree")

    render = os.path.join(a.out_dir, "cornell_render.png")
    heat = os.path.join(a.out_dir, "cornell_heatmap.png")
    image.write_png(render, image.shade_barycentric(base.prim_idx, base.u, base.v, SIZE, SIZE))
    image.write_png(heat, image.heatmap(counts, SIZE, SIZE))
    print(f"wrote {render} {heat}")

    # the raster render (B4 on the card, the XLA engine's port on the CPU)
    # against the wavefront variants: the hit mask, t, and prims but for ties
    packed = raster.pack_raster(bvh, tris, leaf_size=16)
    if device.type == "cuda":
        from .ops import raster_gpu

        hit_r, _, overflow = raster_gpu.render_raster_gpu(packed, rays, tr, SIZE, SIZE)
    else:
        hit_r, _, overflow = raster.render_raster_xla(packed, rays, tr, SIZE, SIZE, tile=16,
                                                      cap_a=8, cap_b=64, tiles_b=32)
    pr, tr_ = hit_r.prim_idx.cpu().numpy(), hit_r.t.cpu().numpy()
    if bool(overflow):
        raise AssertionError("raster bin overflow")
    if not np.array_equal(pr >= 0, hm) or not np.allclose(tr_[hm], base.t[hm], rtol=1e-4):
        raise AssertionError("raster render differs from the wavefront variants")
    tied = int((hm & (pr != base.prim_idx)).sum())
    if tied > 0.001 * hm.sum() + 2:
        raise AssertionError(f"raster prim mismatches: {tied}")
    print(f"raster agrees (ties: {tied})")
    return {"hits": hits, "render": render, "heatmap": heat}


if __name__ == "__main__":
    main()
