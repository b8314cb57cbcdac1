"""Where the time of the port's main path goes, on one GPU.

On `sponza_like(262_000)` it times `lbvh.build_single_pass`,
`lbvh.build_two_pass`, `ploc.build_ploc`, `ploc.build_hploc`,
`collapse_fast.collapse_lbvh_to_bvh4`, `raster_gpu.render_raster_gpu` at
512^2 and 1920x1080 (leaf 64, the caps of chip_smoke.py) and
`ray_sweep.shadow_occlusion` on the live hits of the 1080p frame (the JAX
bench's shadow workload, caps 4096/32768/32), the gather-free topologies
`radix_tree.apetrei_topology_fast` and `karras_topology_fast` on the
sorted codes, the kernels off the main path on sponza's deltas
(`child_positions_auto`, the two `scan32` halves) and `plane_scan` (min
forward on the [m, 64] threshold plane; on the main path only inside the
sharded build), and the kernels whose
CUDA-event times in chip_smoke.py are set by the host's launch path, each
alone at the main path's shapes: B1 `scan32` (`scan_core`) on sponza's raw
deltas, B2 `refit_dense` on sponza's `mat`
(radius 24), B3 `collapse_block` on sponza's rows, one PLOC round (B6
`ploc_round_pp` and B8 `ploc_round_fused` on PLOC's first-round state,
B10 `ploc_nn_round_raw` at shift 32 and, as `ploc_nn_hploc`, at HPLOC's
first shift, with its SM cycles per phase, and B9 `ploc_emit_compact` on
it), B12
`psv_nsv_packed` and B14
`psv_nsv_payload_auto` on sponza's deltas, B5 `ray_sweep_kernel` on
the shadow rays (occlusion), B4 `raster_sweep` at both render sizes and
B7 `ploc_finish` on the HPLOC hand-over states at FIN_WIDTH and at 4096;
and `batched.build_batched` (one kernel launch) on the reference's demo,
4096 copies of the cornellbox at its own size, on 65,536 random meshes of
2-32 prims at capacity 32, on 4096 of 2-64 prims at capacity 64 and on
4096 of 2-M at M = 40, 48, 56, either side of the warp kernel's cutover
from the refit walk to the tables (the warp kernel; `batched_4096x<M>`),
and on 1024 random meshes of 2-1024 prims at capacity 1024 and 16,384 of
2-128 at 128 (the block kernel; `batched_block_1024`, `batched_block_128`,
`scenes.block_meshes`' (a) and (b)); and
the wavefront traversal of the 512^2 frame (`traverse.traverse_packed` as
`traverse_packed_512`, `traverse.traverse_bvh2` with each variant as
`traverse_<variant>_512`) and of the reversed shadow slice (65,536 rays
from the light toward the 1080p frame's hit points, all hit; the origin
one row expanded, stride 0) as `traverse_packed_shadow_rev` and
`traverse_<variant>_shadow_rev`; and the sharded single-scene build
(`parallel.sharded_build.build_single_pass_sharded` with `to_bvh2`) on a
one-rank NCCL group in this process as `sharded_build_world1`:
first the median host-clock ms to a synchronize and the median CUDA-event
ms around the call, without the profiler, then `--reps` calls each under
torch.profiler (CPU + CUDA).
From each Chrome trace it reads:

* device busy: the union of the GPU's kernel, memcpy and memset intervals,
  per call;
* busy share: device busy over the wall time per call under the profiler
  (the profiler slows the host, so this share is an upper bound);
* kernels and memsets per call, and the kernels with the most device time.

Usage: python3 -m tpu_bvh_torch.profile_slice [--reps 10] [--out DIR] [--calls NAME ...]
The traces are written to DIR (default: a temporary directory); the last
line of the output is a JSON summary.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch

from .models import batched, lbvh, ploc
from .parallel import sharded, sharded_build
from .ops import (collapse_block, collapse_fast, plane_scan, ploc_nn, ploc_round, radix_tree,
                  raster, raster_gpu, ray_sweep, refit, refit_dense, scan32, threshold_core,
                  traverse)
from .ops import ploc as ploc_ops
from .types import FLT_MAX, PLOC_RADIUS, Rays
from .utils import camera, scenes

SPONZA_TRIS = 262_000
LEAF = 64
RENDERS = {(512, 512): (1024, 4096, 32), (1920, 1080): (1024, 8192, 32)}
SHADOW_CAPS = (4096, 32768, 32)
BATCHED_DEMO = 4096  # copies of the cornellbox
BATCHED_RANDOM = 65_536  # random meshes of 2-32 prims at capacity 32
BATCHED_WIDE = 4096  # random meshes of 2-64 prims at capacity 64
BATCHED_CUTOVER = (40, 48, 56)  # capacities of 4096 random meshes between the walk and the tables
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def reversed_shadow_slice(light, fwd, vsel):
    """The shadow workload's strided slice reversed (`scenes.shadow_workload`'s
    light, forward rays and slice indices): from the point light toward each
    hit point, so every ray hits; the origin is the light's one row expanded
    (stride 0)."""
    direction = -fwd[1][vsel]
    n = direction.shape[0]
    dev = direction.device
    return Rays(light.expand(n, 3), direction, torch.zeros(n, device=dev),
                torch.full((n,), FLT_MAX, device=dev))


def _busy_us(events):
    """Length of the union of [ts, ts + dur) over `events` (microseconds)."""
    total, end = 0.0, float("-inf")
    for ts, dur in sorted((e["ts"], e["dur"]) for e in events):
        if ts + dur > end:
            total += ts + dur - max(ts, end)
            end = ts + dur
    return total


def _host_ms(fn, reps):
    """Median host-clock ms of a call to a synchronize, and median CUDA-event
    ms around the call on its stream."""
    walls, events = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        events.append(a.elapsed_time(b))
    return statistics.median(walls), statistics.median(events)


def profile(name, fn, reps, out_dir, top=8):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    host_ms, events_ms = _host_ms(fn, reps)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    path = os.path.join(out_dir, f"trace_{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in GPU_CATS]
    if not events:
        raise RuntimeError(f"{name}: the trace holds no GPU activity")
    by_name = collections.Counter()
    for e in events:
        if e["cat"] == "kernel":
            by_name[e["name"][:120]] += e["dur"]
    busy_ms = _busy_us(events) / 1e3 / reps
    return {
        "name": name,
        "host_ms": host_ms,
        "events_ms": events_ms,
        "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms,
        "busy_share_profiled": busy_ms / wall_ms,
        "kernels_per_call": sum(e["cat"] == "kernel" for e in events) / reps,
        "memsets_per_call": sum(e["cat"] == "gpu_memset" for e in events) / reps,
        "top_kernels_us_per_call": [(k, us / reps) for k, us in by_name.most_common(top)],
        "trace": path,
    }


def _world1_build(tris):
    """The sharded build and its assembly on a one-rank NCCL group, which
    this process joins at the first call (rendezvous through a file)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        init = "file://" + os.path.join(tempfile.mkdtemp(prefix="tpu_bvh_torch_world1_"), "rdv")
        dist.init_process_group("nccl", init_method=init, rank=0, world_size=1)
    mesh = sharded.default_mesh()
    return sharded_build.to_bvh2(sharded_build.build_single_pass_sharded(mesh, tris),
                                 tris.shape[0], mesh)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None, help="directory for the Chrome traces")
    ap.add_argument("--calls", nargs="*", default=None,
                    help="profile only these calls (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA device")
    out_dir = args.out or tempfile.mkdtemp(prefix="tpu_bvh_torch_prof_")
    os.makedirs(out_dir, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    dev = torch.device("cuda:0")
    tris = torch.from_numpy(scenes.sponza_like(SPONZA_TRIS)).to(dev)
    tr, cam = scenes.preset("sponza", dev)
    aux = lbvh.build_single_pass_aux(tris)
    packed = raster.pack_raster(aux[0], tris, leaf_size=LEAF)
    calls = {"build": lambda: lbvh.build_single_pass(tris),
             "build_two_pass": lambda: lbvh.build_two_pass(tris),
             "build_ploc": lambda: ploc.build_ploc(tris),
             "build_hploc": lambda: ploc.build_hploc(tris),
             "collapse": lambda: collapse_fast.collapse_lbvh_to_bvh4(*aux)}
    for (w, h), caps in RENDERS.items():
        rays = camera.generate_rays(cam, w, h)
        calls[f"render_{w}x{h}"] = (
            lambda rays=rays, w=w, h=h, caps=caps:
            raster_gpu.render_raster_gpu(packed, rays, tr, w, h, *caps)
        )
    rays = camera.generate_rays(cam, 1920, 1080)
    hit = raster_gpu.render_raster_gpu(packed, rays, tr, 1920, 1080, *RENDERS[(1920, 1080)])[0]
    points, live, light, eps, fwd, vsel, _ = scenes.shadow_workload(tris, rays, hit)
    calls["shadow_occlusion"] = lambda: ray_sweep.shadow_occlusion(
        packed, points, live, light, tr, eps, *SHADOW_CAPS)
    codes = lbvh._sorted_leaves_from_tris(tris, True)[0]
    calls["apetrei_topology_fast"] = lambda: radix_tree.apetrei_topology_fast(codes)
    calls["karras_topology_fast"] = lambda: radix_tree.karras_topology_fast(codes)
    dlt_raw = radix_tree.adjacent_deltas(codes)
    calls["scan32"] = lambda: scan32.scan_core(dlt_raw)
    # B2 on sponza's `mat` (radius 24) and B3 on sponza's rows, alone
    mat = refit_dense.cols_mat(lbvh._sorted_leaves_from_tris(tris, True)[1], aux[2], aux[3])
    calls["refit_dense"] = lambda: refit_dense.refit_dense(mat, mat.shape[1], refit.RADIUS)
    c_rows = collapse_fast.kernel_inputs(*aux)
    calls["collapse_block"] = lambda: collapse_block.collapse_block(*c_rows, aux[0].n_internal)
    dlt = scan32.remap_deltas(dlt_raw)
    below = dlt[:, None] < torch.arange(threshold_core.V, device=dev)[None, :]
    packed_keys = torch.arange(dlt.shape[0], dtype=torch.int32, device=dev) * 64 + dlt
    plane = torch.where(below, packed_keys[:, None], threshold_core.BIG)
    calls["plane_scan"] = lambda: plane_scan.plane_scan(plane, is_min=True, reverse=False)
    calls["child_positions"] = lambda: threshold_core.child_positions_auto(dlt)
    dlt32 = scan32.dlt32_from_raw(dlt_raw)
    flipped = torch.flip(dlt32, [0])
    calls["scan32_halves"] = lambda: (scan32.scan_fwd(dlt32),
                                      scan32.scan_rev(flipped, dlt32.shape[0]))
    pay = (torch.arange(dlt.shape[0], dtype=torch.int32, device=dev) * 7919) % (1 << 22)
    calls["psv_nsv_packed"] = lambda: threshold_core.psv_nsv_packed(dlt)
    calls["psv_nsv_payload"] = lambda: threshold_core.psv_nsv_payload_auto(dlt, pay)
    leaf_codes, leaf_packed_t, _ = lbvh._sorted_leaves_packed(
        lbvh.prim_refs_from_triangles(tris), True)
    mat0 = ploc_ops.initial_state(leaf_packed_t, leaf_codes)
    n = mat0.shape[1]
    nodes, spare = torch.zeros((8, n - 1), dtype=torch.int32, device=dev), torch.empty_like(mat0)
    work = ploc_round.round_work(n, dev)
    nn = ploc_nn.ploc_nn_round_raw(mat0, n, 32, PLOC_RADIUS)
    calls["ploc_round"] = lambda: ploc_round.ploc_round_pp(mat0, spare, nodes, n, 32, 0,
                                                           PLOC_RADIUS, work)
    calls["ploc_round_fused"] = lambda: ploc_round.ploc_round_fused(mat0, nodes, n, 32, 0,
                                                                    PLOC_RADIUS)
    calls["ploc_nn"] = lambda: ploc_nn.ploc_nn_round_raw(mat0, n, 32, PLOC_RADIUS)
    calls["ploc_nn_hploc"] = lambda: ploc_nn.ploc_nn_round_raw(mat0, n, ploc.HPLOC_SHIFT0,
                                                               PLOC_RADIUS)
    nn_shifts = {"ploc_nn": 32, "ploc_nn_hploc": ploc.HPLOC_SHIFT0}
    calls["ploc_emit_compact"] = lambda: ploc_round.ploc_emit_compact(mat0, nn, nodes, n, 0)
    sweep = ray_sweep.prepare_trace(packed, ray_sweep.shadow_rays(points, live, light, eps), tr,
                                    *SHADOW_CAPS)[0]
    calls["ray_sweep"] = lambda: ray_sweep.ray_sweep_kernel(*sweep, True)
    for (w, h), caps in RENDERS.items():
        rr, wp, hp = raster_gpu.pad_rays(camera.generate_rays(cam, w, h), w, h)
        r_args = raster_gpu.prepare_sweep(packed, rr, tr, wp, hp, *caps)[0]
        calls[f"raster_sweep_{w}x{h}"] = lambda r_args=r_args: raster_gpu.raster_sweep(*r_args)
    # B7 on the HPLOC states where the round loop hands over at FIN_WIDTH
    # and at 4096 (its width before the cluster design)
    mat, nc, shift = mat0, n, ploc.HPLOC_SHIFT0
    for width in sorted({ploc_round.FIN_WIDTH, 4096}, reverse=True):
        while nc > width:
            mat, _, nm = ploc_round.ploc_round_reference(mat, nodes, nc, shift, n - nc,
                                                         PLOC_RADIUS)
            nc -= int(nm)
            shift = min(shift + ploc.HPLOC_SHIFT_STEP, 32)
        calls[f"ploc_finish_{width}"] = lambda st=(mat, nc, shift): ploc_round.ploc_finish(
            st[0], nodes, st[1], st[2], n - st[1], PLOC_RADIUS, ploc.HPLOC_SHIFT_STEP)
    box = scenes.cornellbox()
    demo = batched.pad_meshes([box] * BATCHED_DEMO, box.shape[0], device=dev)[0]
    calls["batched_demo"] = lambda: batched.build_batched(demo)
    many = batched.pad_meshes(scenes.random_meshes(BATCHED_RANDOM, 32, 2), 32, device=dev)[0]
    calls[f"batched_{BATCHED_RANDOM}"] = lambda: batched.build_batched(many)
    wide = batched.pad_meshes(scenes.random_meshes(BATCHED_WIDE, 64, 3), 64, device=dev)[0]
    calls[f"batched_{BATCHED_WIDE}x64"] = lambda: batched.build_batched(wide)
    for cap in BATCHED_CUTOVER:
        cut = batched.pad_meshes(scenes.random_meshes(BATCHED_WIDE, cap, 3), cap, device=dev)[0]
        calls[f"batched_{BATCHED_WIDE}x{cap}"] = lambda cut=cut: batched.build_batched(cut)
    blocks = {name: batched.pad_meshes(meshes, cap, device=dev)[0]
              for name, (meshes, cap) in scenes.block_meshes().items()}
    calls["batched_block_1024"] = lambda: batched.build_batched(blocks["1024x1024"])
    calls["batched_block_128"] = lambda: batched.build_batched(blocks["16384x128"])
    # the wavefront traversal (one kernel launch a call) of the 512^2 frame
    # and of the reversed shadow slice
    t_packed = traverse.pack_bvh2(aux[0], tris)
    for what, t_rays in (("512", camera.generate_rays(cam, 512, 512)),
                         ("shadow_rev", reversed_shadow_slice(light, fwd, vsel))):
        calls[f"traverse_packed_{what}"] = lambda t_rays=t_rays: traverse.traverse_packed(
            t_packed, aux[0].n_internal, aux[0].root, t_rays, tr)
        for v in traverse.VARIANTS:
            calls[f"traverse_{v}_{what}"] = (
                lambda v=v, t_rays=t_rays: traverse.traverse_bvh2(aux[0], tris, t_rays, tr, v))
    calls["sharded_build_world1"] = lambda: _world1_build(tris)
    if args.calls:
        calls = {k: v for k, v in calls.items() if k in args.calls}
    print(f"card: {smi} | torch {torch.__version__} | cuda {torch.version.cuda}", flush=True)
    rows = []
    for name, fn in calls.items():
        row = profile(name, fn, args.reps, out_dir)
        rows.append(row)
        print(f"{name}: host {row['host_ms']!r} ms, events {row['events_ms']!r} ms | under "
              f"profiler: wall "
              f"{row['wall_ms_profiled']!r} ms, device busy {row['device_busy_ms']!r} ms, "
              f"busy share {row['busy_share_profiled']!r}, kernels/call "
              f"{row['kernels_per_call']!r}, memsets/call {row['memsets_per_call']!r}", flush=True)
        for k, us in row["top_kernels_us_per_call"]:
            print(f"    {us:10.3f} us  {k}", flush=True)
        if name in nn_shifts:  # B10's SM cycles per phase, from one more call
            row["phase_cycles"] = ploc_nn.phase_cycles(mat0, n, nn_shifts[name], PLOC_RADIUS)
            print(f"    phase clocks (SM cycles, median and most over the blocks): "
                  f"{row['phase_cycles']}", flush=True)
    print(json.dumps({"card": smi, "calls": rows}), flush=True)


if __name__ == "__main__":
    main()
