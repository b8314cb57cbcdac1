"""Demo driver, the port of `tpu_bvh.app`: the reference's `main.cpp` as a
CLI, `python -m tpu_bvh_torch.app --builder <b> --traversal <t> --scene <s>`.

It loads a scene, builds (staged, each phase timed apart, as the
reference's perf block), validates, prints the SAH costs, renders primary
rays to `test.png` and, with `--heatmap`, the leaf-visit heat map to
`colorMap.png`. Everything runs on the card unless `--cpu` asks for the
CPU; with no card and no `--cpu` it raises. On the card the app reaches
B4 (`--traversal raster`), B6 and B7 (`--builder ploc|hploc`), the
traversal kernels (the four wavefront variants) and the batched kernel
(`--builder batched`); the rest of its work is torch ops, as JAX's is
XLA ops. The phase times it prints are the host clock to a synchronize;
on the card the CUDA-event times follow them, since host-bound phases
are mostly launch overhead.
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from .config import EngineConfig, parse_args

BATCHED_COPIES = 4096  # the reference's batched demo (`main.cpp:39-47`)
BATCHED_MAX_PRIMS = 32  # its meshes' size limit (JAX's `n <= 32`)


def _load_scene(cfg: EngineConfig, device):
    from .utils import scenes

    if cfg.scene.endswith(".obj"):
        from .utils.obj import load_obj

        tris = load_obj(cfg.scene)
        preset = "cornellbox"
    elif cfg.scene == "cornellbox":
        tris = scenes.cornellbox()
        preset = "cornellbox"
    elif cfg.scene == "bunny_like":
        tris = scenes.bunny_like()
        preset = "bunny"
    elif cfg.scene == "sponza_like":
        tris = scenes.sponza_like()
        preset = "sponza"
    else:
        raise ValueError(f"unknown scene {cfg.scene!r}")
    tr, cam = scenes.preset(preset, device=device)
    return tris, tr, cam


def build_staged(cfg: EngineConfig, tris_np, device, timer):
    """The staged pipeline: split clipping, extents, Morton codes, the
    (code, index) sort, the topology and its refit, each timed under its
    token. Returns the Bvh2."""
    from .ops import aabb, extents, morton, radix_tree, refit, sort
    from .ops import ploc as ploc_ops
    from .types import Bvh2, PrimRefs
    from .utils import split_clip
    from .utils.timer import TimerCodes

    mn, mx, pidx = split_clip.early_split_clipping(tris_np, cfg.split_clip_sa_max)
    refs = PrimRefs(*(torch.from_numpy(a).to(device) for a in (mn, mx, pidx)))
    scene_min, scene_max = timer.measure(TimerCodes.CALCULATE_CENTROID_EXTENTS,
                                         extents.scene_extents, refs.aabb_min, refs.aabb_max)

    def codes_of(refs, smin, smax):
        ctr = aabb.center(refs.aabb_min, refs.aabb_max)
        norm = morton.normalize_centroids(ctr, smin, smax - smin)
        if cfg.use_extended_morton:
            return morton.extended_morton30(norm, smax - smin)
        return morton.morton30(norm)

    codes = timer.measure(TimerCodes.CALCULATE_MORTON_CODES, codes_of, refs, scene_min, scene_max)
    order = torch.arange(codes.shape[0], dtype=torch.int32, device=device)
    sorted_codes, sorted_pos = timer.measure(TimerCodes.SORTING, sort.sort_pairs, codes, order)

    def topology(codes, refs, sorted_pos):
        pos = sorted_pos.to(torch.int64)
        leaf_min, leaf_max, leaf_prim = refs.aabb_min[pos], refs.aabb_max[pos], refs.prim_idx[pos]
        nl = leaf_min.shape[0]
        root = torch.zeros((), dtype=torch.int32, device=device)
        if cfg.builder == "two_pass":
            left, right, _p, first, last = radix_tree.karras_topology(codes)
            imin, imax = refit.refit_ranges(leaf_min, leaf_max, first, last)
        elif cfg.builder == "single_pass":
            left, right, _p, first, last, root = radix_tree.apetrei_topology(codes)
            imin, imax = refit.refit_ranges(leaf_min, leaf_max, first, last)
        else:  # ploc / hploc: B6 rounds and the B7 finisher on the card
            l2, r2, imin, imax = ploc_ops.ploc_build_topology(leaf_min, leaf_max, codes,
                                                              hploc=cfg.builder == "hploc")
            left = torch.cat([l2, torch.zeros((nl,), dtype=torch.int32, device=device)])
            right = torch.cat([r2, torch.full((nl,), -1, dtype=torch.int32, device=device)])
        left = left.clone()
        left[nl - 1:] = leaf_prim
        node_min = torch.cat([imin, leaf_min])
        node_max = torch.cat([imax, leaf_max])
        return Bvh2.from_rows(node_min, node_max, left, right, root)

    return timer.measure(TimerCodes.BVH_BUILD, topology, sorted_codes, refs, sorted_pos)


def run(cfg: EngineConfig) -> dict:
    """Run the demo. Returns {"total_ms", "sah_bvh4" (when collapsed),
    "device_ms": {token name: CUDA-event ms}} as JAX's app does, plus the
    tree it traced ("bvh", a Bvh2; "bvh" is the first tree of the batched
    demo) and its hits ("hit", "counts") for callers that check them."""
    from .models import batched, binned_sah
    from .ops import aabb, collapse, raster, traverse
    from .utils import camera, image, validate
    from .utils.cost import sah_cost_bvh2, sah_cost_bvh4
    from .utils.timer import Timer, TimerCodes

    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the app runs on the card; pass --cpu "
                           "(device='cpu') to run on the CPU")
    tris_np, tr, cam = _load_scene(cfg, device)
    n = tris_np.shape[0]
    print(f"scene: {cfg.scene} ({n} tris), builder: {cfg.builder}")
    tris = torch.from_numpy(np.ascontiguousarray(tris_np, np.float32)).to(device)
    timer = Timer(device)
    results: dict = {}

    def finish():
        print(timer.report())
        results["total_ms"] = timer.total_ms
        results["device_ms"] = {t.value: timer.device_ms(t) for t in TimerCodes
                                if device.type == "cuda" and timer.ms(t)}
        if results["device_ms"]:
            print("CUDA events (device ms): " + ", ".join(
                f"{k} : {v:.3f}ms" for k, v in results["device_ms"].items()))
        return results

    if cfg.builder == "batched":
        # the reference's batched demo: copies of the scene, one BVH a mesh
        if n > BATCHED_MAX_PRIMS:
            raise ValueError(f"the batched demo requires meshes of <= {BATCHED_MAX_PRIMS} "
                             f"prims, the scene has {n}")
        tris_b, _ = batched.pad_meshes([tris_np] * BATCHED_COPIES, device=device)
        with timer.span(TimerCodes.BVH_BUILD):
            bvhs = batched.build_batched(tris_b)
        one = type(bvhs)(*[f[0] for f in bvhs])
        if not validate.check_bvh2_correctness(one, tris_b.shape[1]):
            raise RuntimeError("the batched demo's first tree is not a valid BVH2")
        print(f"built {BATCHED_COPIES} BVHs")
        results["bvh"] = one
        return finish()

    if cfg.builder == "binned_sah":
        with timer.span(TimerCodes.BVH_BUILD):
            sah = binned_sah.build_binned_sah(tris_np)
        bvh = binned_sah.to_bvh2(sah, device=device)
        print(f"Binned Sah Cost : {binned_sah.sah_cost(sah):.4f}")
    else:
        bvh = build_staged(cfg, tris_np, device, timer)
        if not validate.check_bvh2_correctness(bvh, None):
            raise RuntimeError(f"the {cfg.builder} build is not a valid BVH2")
        print(f"Bvh Cost : {float(sah_cost_bvh2(bvh)):.4f}")
        if cfg.collapse:
            wide = timer.measure(TimerCodes.COLLAPSE_BVH, collapse.collapse_bvh2_to_bvh4, bvh)
            c4 = float(sah_cost_bvh4(wide, *aabb.triangle_aabbs(tris)))
            print(f"Bvh4 Cost : {c4:.4f}")
            results["sah_bvh4"] = c4
    results["bvh"] = bvh

    rays = timer.measure(TimerCodes.RAY_GEN, camera.generate_rays, cam, cfg.width, cfg.height)
    if cfg.traversal == "raster":
        rpack = raster.pack_raster(bvh, tris, leaf_size=16 if n < 4096 else 64)

        def render():
            if device.type == "cuda":  # B4, as JAX runs its kernel on the TPU
                from .ops import raster_gpu

                return raster_gpu.render_raster_gpu(rpack, rays, tr, cfg.width, cfg.height)
            return raster.render_raster_xla(rpack, rays, tr, cfg.width, cfg.height)

        hit, counts, overflow = timer.measure(TimerCodes.TRAVERSAL, render)
        if bool(overflow):
            print("raster: candidate lists overflowed; hits are not defined")
    else:
        hit, counts = timer.measure(
            TimerCodes.TRAVERSAL,
            lambda: traverse.traverse_bvh2(bvh, tris, rays, tr, variant=cfg.traversal))
    results["hit"], results["counts"] = hit, counts
    img = image.shade_barycentric(hit.prim_idx, hit.u, hit.v, cfg.width, cfg.height)
    codec = image.write_png(cfg.out_image, img)
    print(f"wrote {cfg.out_image} ({codec} PNG codec)")
    if cfg.heatmap:
        codec = image.write_png(cfg.out_heatmap, image.heatmap(counts, cfg.width, cfg.height))
        print(f"wrote {cfg.out_heatmap} ({codec} PNG codec)")
    return finish()


TRACE_DIR = os.path.join(tempfile.gettempdir(), "tpu_bvh_torch_trace")


def main(argv=None) -> dict:
    """CLI entry; `--profile` wraps the run in a torch.profiler trace
    written to `TRACE_DIR`. Returns `run`'s dict."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--profile" in argv:
        from .utils.introspect import profiler_trace

        argv = [a for a in argv if a != "--profile"]
        with profiler_trace(TRACE_DIR):
            out = run(parse_args(argv))
        print(f"profiler trace written to {TRACE_DIR}")
        return out
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
