#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (`tpu_bvh_torch`) on one card.

Drives the port's main path at sponza scale (262K triangles): the
single-pass and two-pass LBVH builds, the fast BVH2 -> BVH4 collapse,
`pack_raster` and the raster render at 512^2 and 1920x1080, the shadow
path (reversed point-light occlusion of the 1080p primary hits, and the
general closest-hit trace on a 64K strided slice of the forward shadow
rays), the PLOC++ and HPLOC builds, and the gather-free topologies
(`apetrei_topology_fast`, `karras_topology_fast`); the batched builder
on the reference's demo (`pad_meshes` and `build_batched` on 4096 copies of
the cornellbox, one tree each) and on meshes of 65-1024 prims
(`build_batched` at capacities 1024 and 128); and the wavefront traversal of the 512^2
frame (`pack_bvh2`, `traverse_packed` and the four variants of
`traverse_bvh2`: the JAX bench's wavefront row); and the app
(`tpu_bvh_torch.app.main`, as `python -m tpu_bvh_torch.app` runs) on
sponza 262K at 512^2 with the four staged builds, each with the raster
render and the speculative traversal (one run also writes the heat map),
binned SAH on the cornellbox and the batched demo on a 32-triangle box.
On the way it

1. prints the card (name and power limit from nvidia-smi) and versions;
2. builds the CUDA kernels from `tpu_bvh_torch/csrc/` (one nvcc per
   source, all started together) and times it;
3. holds each kernel against its plain PyTorch version on the card, bit
   for bit in every output (floats compared as their i32 bits): the
   topology scan, the dense refit (both entries) and the collapse kernel
   on sponza, on a soup of duplicated triangles (tie-heavy Morton codes)
   and on a soup whose coordinates hold both +0.0 and -0.0, and there
   the single-pass tail (B1's links form against the plain links, B2's
   tree mode and L against the CPU refit joined with the leaves); the raster
   sweep at 512^2 and at 1920x1080 with the renders' caps, printing its
   split's device counters (tests run against counted, pair sweeps on the
   busiest SM, re-swept subtiles); the ray sweep in occlusion mode on every live
   shadow ray (caps 4096/32768/32) and in closest-hit mode on the 64K
   slice (caps 4096/24576/32) and on the 1080p primary rays (caps that
   cannot overflow), where most rays hit, printing for each the ray-prim
   tests the split sweep ran beside the ones the serial rule counts, and
   its pair sweeps on the busiest SM; the PLOC nearest-neighbour
   stage on sponza's first-round state at shift 32 and 9 (printing its
   SM cycles per phase: tile load, pair areas, best_rel, mutual check
   and writes), at its tiles' edges and on boxes with NaN and +-0
   faces, the emission
   and the whole round (ping-pong and allocating) on three states along
   the sponza HPLOC build, and the finisher on the HPLOC states where the
   round loop hands over at 4096 (its width before the cluster design)
   and at 16384 (the TPU kernel's and the port's), and at its
   shared-memory width limit (one cluster more is refused), printing its
   device counters (rounds and clock64 cycles per regime and phase); the
   threshold scans (B12/B13, B14, B15) on sponza's and the dup soup's
   deltas and on 262,144 random deltas in [0, 53) (values repeat), B15
   also on a soup of a few repeated deltas, on equal deltas and at m = 1,
   the plane scan (B11) on sponza's [m, 64] threshold plane, min and max,
   forward and reverse, and on planes of other shapes (rows that are no
   multiple of its tile, widths 3 and 130, one row), one launch a call,
   and the two V=32 scan halves (B16) on sponza's
   and dup's deltas, forward and flipped, also against B1's outputs; B1
   on the deltas of 2^22 sorted random codes and B12/B13, B14 on 2^23
   random deltas in [0, 63], where each block walks many tiles (printing
   the grid the occupancy query gave); the front half's three kernels (A
   `tri_rows`, B `keys`, C `gather`: `ops/front_half.py`) on sponza, on the
   +-0 soup and on a 4M-triangle frame of the benchmark's scene
   (`benchmark/scene.py`, frame 0), every output bit for bit (the scene
   minimum by value: the plain amin keeps either zero), B with the extended
   and the plain code, B and C from triangles and from shuffled PrimRefs;
   the batched build (one warp a mesh)
   on the demo, on 65,536 random meshes of 2-32 prims at capacity 32, on
   4096 of 2-64 at capacity 64 and on the +-0 soup in meshes of 32, with
   every tree of each checked valid, and its refusal of capacity 65 before
   a launch; the block kernel (one block a mesh, 65-1024 prims) on 1024
   random meshes of 2-1024 prims at capacity 1024, 16,384 of 2-128 at 128,
   4096 of 2-65 at 65 and the +-0 soup in meshes of 128 beside meshes of one
   triangle repeated, one launch a call, every tree valid, and its refusal
   of capacities 64 and 1025 before a launch; the traversal kernels (`traverse_packed` and the four
   variants: persistent lanes that fetch their rays) on sponza's 512^2
   frame and on the reversed shadow slice (65,536 rays from the light
   toward the 1080p frame's hit points, every one a hit; the origin one
   row, stride 0) against their plain versions on every ray, their device
   counters (node steps, leaf steps, overflowed rays) against the pins of
   the one-thread-a-ray kernel, and on the 64-deep chain built with
   `Bvh2.from_rows`, whose stack overflows (prim 60 at t = 2, a miss);
4. runs the main path path by path (build, topology, collapse, render,
   shadow, ploc, batched, batched block, wavefront, app), every launch counter set to 0 just
   before each and read
   just after, and checks: every kernel of each path launched (the front
   half's three once a build on the build and ploc paths, B1, B2 and L
   once a build on the build path; the collapse's
   P1, P2 and B3 once on the collapse path; on the
   ploc path one fused-round launch per round and none of B9's or B10's,
   host syncs = rounds + 1 per build); the fast
   topologies equal B1's route (`apetrei_build_packed_full`,
   `karras_build_packed`), the plain oracles (`apetrei_topology`,
   `karras_topology`) on the card and the port's CPU run, on sponza and
   on dup; the GPU Bvh2s
   (single-pass, two-pass, PLOC, HPLOC) and the Bvh4 are bit-identical
   to the port's CPU builds and collapse, and the PLOC and HPLOC trees to
   the plain round loop's on the card; the validity checks; the BVH2 SAHs
   and the BVH4 SAH against their pins; the PLOC tree's queue-ordered
   collapse is a valid Bvh4; the collapse's isomorphism to the sequential
   oracle `collapse_cpu` on sponza_like(16384); a caterpillar scene takes
   the collapse's overflow branch on the card and still equals the CPU
   collapse; on the +-0 soup the four GPU Bvh2s and the Bvh4 equal the
   CPU ones bit for bit; no raster or shadow overflow; the reversed
   occlusion mask equals the forward trace's capped answer outside the
   boundary strips; the 512^2 image is written as a PNG; the batched demo's
   trees equal the port's CPU build, are all valid and all the same;
   `build_batched` at capacities 1024 and 128 launches the block kernel
   once each and B1, B2 and the warp kernel no time, its trees equal the
   kernel's checked ones and, for the first 8 meshes, the port's CPU build; the
   four traversal variants find the same prims, the stack variants and
   the packed engine the same hits and counts; bench.py's
   raster_matches_wavefront (the 512^2 render against `traverse_packed`)
   and shadow_matches_wavefront (`trace_rays` on the slice against
   `traverse_packed` capped at tmax); `trace_rays`' closest hits against
   `traverse_packed` on every ray of the slice, forward and reversed (from
   the light), out past the scene's edge; the leaf-visit heat map is
   written beside the image; then the app path (counters set to 0
   before it): B4, B6, B7, `traverse_speculative` and `batched_build`
   launched; each staged Bvh2 equals the same staged build on the CPU bit
   for bit and is valid, its printed SAH lines the CPU build's; the
   raster hits match the speculative ones (bench.py's
   raster_matches_wavefront); the binned-SAH tree is valid; the batched
   demo's first tree equals the CPU build; the app's perf block and
   CUDA-event times per phase are printed beside the card's name and
   power limit; then the sharded path (`tpu_bvh_torch.parallel`), its
   ranks started by `comm.spawn` after the kernels are built: NCCL at world
   size 1 (`build_single_pass_sharded` and `to_bvh2` on sponza 262K), then
   4 gloo ranks sharing the card (NCCL refuses two ranks on one card),
   which drive the sharded build, `to_bvh2`, `sharded_scene_extents`,
   `build_batched_sharded` on the demo (1024 meshes a rank),
   `traverse_sharded` and `render_raster_sharded` on the 512^2 frame over
   the assembled tree, counters set to 0 just before and read just after
   on each rank; rank 0 gathers the counts and checks that the build ran
   B11 twice on every rank (its psv and nsv plane scans; at both world
   sizes) and that B4, the speculative traversal and the batched build
   launched on every rank;
   both assembled trees equal the GPU single-pass build bit for bit
   without overflow, the gloo tree is valid and on its SAH pin, the
   extents equal the unsharded ones, and the batched trees, the
   traversal's hits and counts and the raster strips, concatenated in rank
   order, equal the unsharded calls' on the card bit for bit; each
   sharded call's host and CUDA-event ms on every rank are printed beside
   the unsharded call's (the cost of sharding on one card, not scaling);
5. times the builds, the fast topologies, the collapse, the renders,
   `shadow_occlusion` and `trace_rays` (medians after warm-up, on CUDA events and on the host
   clock; PLOC and HPLOC in 10 alternating pairs, with the gap per
   pair, at the hand-over widths 4096 and 16384 in turn), prints each
   PLOC build's rounds, finisher launches and host syncs, and times each
   kernel beside its plain version and computes its bound from this run's
   inputs (B11 also beside `torch.cummin`), and B4 at both sizes with its
   split's counters; the batched kernels (events) beside their plain
   versions and `build_batched` (host clock, meshes/s) on their four
   inputs each, each with its bound and the share reached, the per-mesh
   single-pass loop (the route before the block kernel) on 32 meshes of
   1024, and both kernels' clock64 cycles per phase;
   the traversal kernels on the 512^2 frame and on the reversed
   shadow slice (events and host clock, Mrays/s, the plain version on the
   slice), with bounds and their shares from the rows their steps stood on
   (counted by a launch that marks them; pinned on the frame), their step
   counters and SIMD efficiency (lane steps over 32 x warp steps); every
   bound from the kernel's count in `tpu_bvh_torch/utils/work.py`, and
   `introspect.cost_analysis` of one call of each hand kernel, whose
   bytes, flops and optimal_seconds must equal that count and bound; the
   front half's kernels also at 4M (events, device us from a profiler
   trace, plain ms and its kernel count, bound);
6. checks, from one torch.profiler trace each, that the dense refit (both
   entries), the collapse kernel, the topology scan (B1), the psv/nsv
   scans (B12/B13, B14), the child positions (B15), the plane scan (B11),
   the two V=32 scan halves (B16), the emission (B9), `build_batched`
   (the demo and capacity 1024) and the front half's three kernels launch
   one kernel a call, all but the refit and the collapse with no memset,
   that each
   traversal kernel on the frame's camera rays (a stride-0 origin) is one
   kernel and one memset a call,
   and prints the grid of B1's and B12's launch on sponza and
   B12's SM cycles per phase (its clock64 stamps).

Any failure raises. The last three lines are the kernels JSON line (B1 to
B16, then the two batched builds, the five traversal kernels and the front
half's three, which replace no TPU kernel; each row's `launches` counts every
path in this process,
`app_launches` the app path alone, `sharded_launches` the sharded path
summed over its ranks; a traversal row also holds its host ms, SIMD
efficiency and, under `shadow_rev`, its numbers on the reversed slice; a
front-half row its device us and plain kernels, and under `at_4m` its
numbers on the 4M frame), the
nvidia-smi line and {"ok": true, "device": {...}}. Needs one CUDA device
and nvcc; it imports no JAX.

Usage: python3 chip_smoke.py [--image PATH]
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

SPONZA_TRIS = 262_000
SAH_PIN = 333.01  # BVH2 SAH of the sponza_like single-pass tree (a tree property)
SAH4_PIN = 159.13  # its BVH4 SAH after the collapse (a tree property)
PLOC_SAH_PINS = {"ploc": 280.94, "hploc": 281.14}  # the sponza_like trees (bench.py:91-92)
LEAF = 64
SIGNED_ZERO_TRIS = 512  # the +-0 soup
HAND_OVERS = (4096, 16384)  # B7's hand-over widths to check: before this design, the TPU's
RENDERS = {  # (width, height): (cand_cap, pair_cap, group), as the JAX bench uses them
    (512, 512): (1024, 4096, 32),
    (1920, 1080): (1024, 8192, 32),
}
SHADOW_CAPS = (4096, 32768, 32)  # shadow_occlusion on every live ray
TRACE_CAPS = (4096, 24576, 32)  # trace_rays on the 64K slice
CLOSEST_CAPS = (4096, 1 << 21, 32)  # the slice's rays out to the scene's edge
PRIMARY_CAPS = (4096, 1 << 21, 32)  # 1080p primary rays: 507 groups x 4096 pairs fit
ROUND_SOURCE = "tpu_bvh_torch/csrc/ploc_round_fused.cu"
THR_SOURCE = "tpu_bvh_torch/csrc/threshold_scan.cu"
THR_TPU = "tpu_bvh/ops/pallas/threshold_core.py"
TRAVERSE_SOURCE = "tpu_bvh_torch/csrc/traverse.cu"
FRONT_SOURCE = "tpu_bvh_torch/csrc/front_half.cu"
KERNELS = {  # name: (TPU kernel, source, the TPU kernel it replaces), B1 to B16
    "scan32": ("B1", "tpu_bvh_torch/csrc/scan32.cu", "tpu_bvh/ops/pallas/scan32.py:280"),
    "refit_dense": ("B2", "tpu_bvh_torch/csrc/refit_dense.cu",
                    "tpu_bvh/ops/pallas/refit_dense.py:102"),
    "collapse_block": ("B3", "tpu_bvh_torch/csrc/collapse_block.cu",
                       "tpu_bvh/ops/pallas/collapse_block.py:481"),
    "raster_sweep": ("B4", "tpu_bvh_torch/csrc/raster.cu", "tpu_bvh/ops/raster_tpu.py:366"),
    "ray_sweep": ("B5", "tpu_bvh_torch/csrc/ray_sweep.cu", "tpu_bvh/ops/ray_sweep.py:283"),
    # B6 and B8 share one kernel: a round is one launch
    "ploc_round": ("B6", ROUND_SOURCE, "tpu_bvh/ops/pallas/ploc_round.py:401"),
    "ploc_finish": ("B7", "tpu_bvh_torch/csrc/ploc_finish.cu",
                    "tpu_bvh/ops/pallas/ploc_round.py:616"),
    "ploc_round_fused": ("B8", ROUND_SOURCE, "tpu_bvh/ops/pallas/ploc_round.py:337"),
    "ploc_emit_compact": ("B9", "tpu_bvh_torch/csrc/ploc_round.cu",
                          "tpu_bvh/ops/pallas/ploc_round.py:171"),
    "ploc_nn": ("B10", "tpu_bvh_torch/csrc/ploc_nn.cu", "tpu_bvh/ops/pallas/ploc_nn.py:152"),
    "plane_scan": ("B11", "tpu_bvh_torch/csrc/plane_scan.cu",
                   "tpu_bvh/ops/pallas/plane_scan.py:60"),
    # B12 and B13 (the TPU's sublane and lane layouts) are one kernel here
    "psv_nsv_packed": ("B12", THR_SOURCE, f"{THR_TPU}:256"),
    "psv_nsv_packed_lanes": ("B13", THR_SOURCE, f"{THR_TPU}:204"),
    "psv_nsv_payload": ("B14", THR_SOURCE, f"{THR_TPU}:482"),
    "child_positions": ("B15", "tpu_bvh_torch/csrc/child_scan.cu", f"{THR_TPU}:673"),
    "scan32_halves": ("B16", "tpu_bvh_torch/csrc/scan32.cu", "tpu_bvh/ops/pallas/scan32.py:260"),
    # no TPU kernel: JAX's batched builds are XLA ops, not a pl.pallas_call (the dense
    # form up to 64 prims a mesh, the vmapped single-pass build past it)
    "batched_build": (None, "tpu_bvh_torch/csrc/batched_build.cu", "tpu_bvh/models/batched.py:64"),
    "batched_block": (None, "tpu_bvh_torch/csrc/batched_block.cu", "tpu_bvh/models/batched.py:59"),
    # no TPU kernel: JAX's wavefront traversal is XLA ops in lax.while_loop
    "traverse_packed": (None, TRAVERSE_SOURCE, "tpu_bvh/ops/traverse.py:271"),
    "traverse_if_if": (None, TRAVERSE_SOURCE, "tpu_bvh/ops/traverse.py:134"),
    "traverse_while_while": (None, TRAVERSE_SOURCE, "tpu_bvh/ops/traverse.py:134"),
    "traverse_speculative": (None, TRAVERSE_SOURCE, "tpu_bvh/ops/traverse.py:134"),
    "traverse_restart_trail": (None, TRAVERSE_SOURCE, "tpu_bvh/ops/traverse.py:437"),
    # no TPU kernel: JAX's front half is XLA ops, which XLA fuses (A: the boxes and the
    # scene box, B: the codes and the key, C: the sort's payload)
    "front_tri_box": (None, FRONT_SOURCE, "tpu_bvh/models/lbvh.py:124"),
    "front_keys": (None, FRONT_SOURCE, "tpu_bvh/models/lbvh.py:76"),
    "front_gather": (None, FRONT_SOURCE, "tpu_bvh/models/lbvh.py:98"),
}
FRONT_WORK = {"front_tri_box": "tri_box", "front_keys": "keys", "front_gather": "gather"}
FRONT_KERNELS = tuple(FRONT_WORK)
# the collapse's prep (P1) and coarse stage (P2), csrc/collapse_prep.cu: no TPU kernel
COLLAPSE_PREP_KERNELS = ("collapse_prep", "collapse_coarse")
# the kernels whose launches a path counts (`kernels.launches`, by kernel
# name); B12 and B13 are one kernel, counted under B12's name; refit_long is
# the single-pass tail's L (csrc/refit_long.cu: no TPU kernel)
COUNTED = (*KERNELS, *COLLAPSE_PREP_KERNELS, "refit_long")
COUNTED_AS = {"psv_nsv_packed_lanes": "psv_nsv_packed"}
FRONT_FRAME = {"n_tris": 4_000_000, "occupancy_tris": 262_000, "seed": 22}  # benchmark/scene.py
TRAVERSALS = ("packed", "if_if", "while_while", "speculative", "restart_trail")
WAVEFRONT = (512, 512)  # the JAX bench's wavefront row: sponza 262K, 512^2 primary rays
# the traversal's inputs: the 512^2 frame (mostly misses) and the reversed
# shadow slice (from the light toward the 1080p frame's hit points)
TRAVERSE_INPUTS = {"frame": f"sponza {WAVEFRONT[0]}x{WAVEFRONT[1]}",
                   "shadow_rev": "the reversed shadow slice"}
# each traversal kernel's device counters on them (node steps, leaf steps,
# overflowed rays: they depend only on each ray's own walk, on the stack
# kernels and the restart trail) and, on the frame, the internal and leaf
# rows its steps stood on
TRAVERSE_PINS = {("frame", "stack"): (880_752, 78_616, 0, 872, 382),
                 ("frame", "restart_trail"): (1_489_452, 69_812, 0, 846, 377),
                 ("shadow_rev", "stack"): (1_217_710, 147_026, 0),
                 ("shadow_rev", "restart_trail"): (2_662_562, 141_471, 0)}
BATCHED_DEMO = 4096  # the reference's batched demo: copies of the cornellbox (main.cpp:39-47)
BATCHED_RANDOM = 65_536  # random meshes of 2-32 prims at capacity 32
BATCHED_WIDE = 4096  # random meshes of 2-64 prims at capacity 64
BLOCK_LOOP = 32  # meshes of input (a) that the per-mesh single-pass loop builds, timed
APP_SIZE = (512, 512)  # the app phase: sponza 262K at 512^2, as a user runs it
APP_BUILDERS = ("two_pass", "single_pass", "ploc", "hploc")  # the staged builds
APP_HEATMAP = ("two_pass", "speculative")  # the run that also writes the heat map
APP_BATCHED_TRIS = 32  # the batched demo's mesh limit: the procedural box's first 32
SHARDED_RANKS = 4  # gloo ranks sharing the one card (NCCL refuses two ranks on one card)
SHARDED_REPS = 5  # timed calls of each sharded call, after one warm-up
SHARDED_DEADLINE = 600.0  # seconds for one launch of ranks; they are killed past it
# the sharded calls, each beside the unsharded call it shards
SHARDED_CALLS = {"build_single_pass_sharded": "lbvh.build_single_pass",
                 "sharded_scene_extents": "the extents' min_key reduction",
                 "build_batched_sharded": "batched.build_batched",
                 "traverse_sharded": "traverse.traverse_bvh2 (speculative)",
                 "render_raster_sharded": "raster_gpu.render_raster_gpu"}
SHARDED_KERNELS = ("raster_sweep", "traverse_speculative", "batched_build")  # on every rank
SHARDED_BUILD_KERNELS = {"plane_scan": 2}  # launches a sharded build makes on every rank


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", default=os.path.join(tempfile.gettempdir(),
                                                    "tpu_bvh_torch_sponza_512.png"),
                    help="where to write the 512^2 render (PNG); its leaf-visit heat map "
                         "goes beside it (_heatmap.png)")
    return ap.parse_args()


def write_obj(path, tris):
    """A triangle soup as an OBJ (every vertex written exactly)."""
    with open(path, "w") as f:
        for v in tris.reshape(-1, 3):
            f.write("v %.9g %.9g %.9g\n" % tuple(v))
        for k in range(len(tris)):
            f.write(f"f {3 * k + 1} {3 * k + 2} {3 * k + 3}\n")


def time_ms(torch, fn, reps, warmup=2):
    """Median milliseconds of `fn` after warm-up, two ways: between CUDA
    events on the stream, and on the host clock up to the end of a
    synchronize. End-to-end times (build, collapse, render, shadow) are
    read on the host clock: those calls are bound by the host's launch
    rate, which the events do not fully see."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events, walls = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        b.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        events.append(a.elapsed_time(b))
    return statistics.median(events), statistics.median(walls)


def require(ok, what):
    if not ok:
        raise AssertionError(f"chip_smoke: check failed: {what}")
    print(f"  ok: {what}", flush=True)


def max_err(got, want):
    return max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))


def bound(count):
    """(bound ms, what sets it) of a kernel call's (bytes, flops, info)
    count (`tpu_bvh_torch/utils/work.py`): the larger of the bytes over the
    memory rate and the f32 operations over the f32 peak
    (`introspect.optimal_seconds`)."""
    from tpu_bvh_torch.utils import introspect

    n_bytes, flops = count[:2]
    by_bytes = n_bytes / introspect.HBM_BYTES_PER_S >= flops / introspect.F32_FLOPS
    return (introspect.optimal_seconds(n_bytes, flops) * 1e3,
            "bytes" if by_bytes else "operations")


def bounded(count):
    """((bound ms, what sets it), what the count found)."""
    return bound(count), count[2]


def split_info(torch, stats, out, L, unit="subgroups"):
    """What a split sweep (B4, B5) did (its device counters) beside what the
    serial rule counts (the count output)."""
    s = stats.cpu()
    counted = int(out[4].sum(dtype=torch.int64))
    return (f"ray-prim tests run {int(s[0])} against {counted} counted "
            f"({int(s[0]) / max(counted, 1)!r}x), {int(s[1])} pair sweeps, most on one SM "
            f"{int(s[4:].max())} (of {int((s[4:] > 0).sum())} SMs), "
            f"{int(s[2])} {unit} re-swept; L {L}")


FIN_PHASES = ("nn", "scan", "emit", "compact", "barrier")
FIN_REGIMES = ("cluster", "one CTA", "one warp")


def finish_info(stats, sm_mhz):
    """B7's device counters (clock64 deltas of one thread, per regime):
    rounds, cycles and the share of each phase."""
    out = []
    for name, row in zip(FIN_REGIMES, stats.cpu().tolist()):
        if row[0] == 0:
            continue
        total = max(row[1], 1)
        shares = ", ".join(f"{p} {row[2 + j] / total:.3f}" for j, p in enumerate(FIN_PHASES))
        out.append(f"{name}: {row[0]} rounds, {row[1]} cycles ({row[1] / sm_mhz!r} us at "
                   f"{sm_mhz} MHz; {shares})")
    return "; ".join(out)


def batched_valid(torch, trees, M):
    """Every tree of a batch-stacked Bvh2 of M leaves, checked on the card:
    its leaves hold a permutation of the prims; a walk from the root meets
    every node once and ends (no cycle, nothing unreached); the root box
    equals the min of the leaf boxes, bit for bit; every internal box equals
    the min of its children's (values)."""
    from tpu_bvh_torch.ops.aabb import from_min_key, min_key

    B, W = trees.left.shape
    m = M - 1
    ar = torch.arange(M, device=trees.left.device)
    perm = bool(torch.equal(trees.left[:, m:].sort(dim=1).values, ar.expand(B, M).to(torch.int32)))
    visits = torch.zeros((B, W), dtype=torch.int32, device=trees.left.device)
    front = torch.zeros_like(visits).scatter_(1, trees.root[:, None].long(), 1)
    kids = torch.cat([trees.left[:, :m], trees.right[:, :m]], dim=1).long()
    for _ in range(M):
        visits += front
        front = torch.zeros_like(visits).scatter_add_(1, kids, front[:, :m].repeat(1, 2))
    walk = bool((visits == 1).all()) and not bool(front.any())
    box = trees.packed_t
    leaf_min = from_min_key(min_key(box[:, :, m:]).amin(dim=2))
    root_box = box.gather(2, trees.root[:, None, None].long().expand(B, 6, 1))[:, :, 0]
    root_ok = bool(torch.equal(leaf_min.view(torch.int32), root_box.view(torch.int32)))
    kid_box = torch.minimum(box.gather(2, trees.left[:, None, :m].long().expand(B, 6, m)),
                            box.gather(2, trees.right[:, None, :m].long().expand(B, 6, m)))
    nest = bool(torch.equal(kid_box, box[:, :, :m]))
    return perm and walk and root_ok and nest


def traced_events(torch, fn, calls=1, sessions=3):
    """The complete events of one torch.profiler trace (its Chrome trace)
    of `calls` calls of `fn`, after a warm-up call. A session that recorded
    no GPU event at all (a later profiler session in one process sometimes
    sees none; the launch counters show the call launched) is run again,
    up to `sessions` sessions."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(sessions):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        events = [e for e in events if e.get("ph") == "X"]
        if any(e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy") for e in events):
            break
    return events


def kernels_per_call(torch, fn, sessions=3):
    """CUDA kernels and memsets in one torch.profiler trace of one call of
    `fn`: the names of its kernel events, and the count of its memset
    events (`traced_events`)."""
    events = traced_events(torch, fn, 1, sessions)
    return ([e["name"] for e in events if e.get("cat") == "kernel"],
            sum(e.get("cat") == "gpu_memset" for e in events))


def device_us(torch, fn, symbol, calls=5):
    """Device microseconds a call of `fn` spends in the kernels whose names
    hold `symbol`, from one torch.profiler trace of `calls` calls."""
    events = traced_events(torch, fn, calls)
    return sum(e["dur"] for e in events
               if e.get("cat") == "kernel" and symbol in e["name"]) / calls


def nn_edge_cases(T):
    """(width, live lanes, shift, radius, state) of B10's edge inputs for a
    tile of T lanes: widths of one tile, one lane past it and part of a
    third; live lanes ending just before, at and just past a tile's end;
    radius 1, 3 and 8; segments at shifts 0 and 9; the sponza state and
    boxes with NaN and +-0 faces (`nn_special_state`)."""
    cases = [(T, T, 32, 8, "sponza"), (T + 1, T + 1, 9, 8, "sponza"),
             (2 * T + 17, T - 1, 0, 3, "sponza"), (2 * T + 17, 2 * T, 32, 1, "sponza")]
    cases += [(3 * T + 5, nc, shift, r, "NaN and +-0")
              for nc, shift, r in ((3 * T + 5, 32, 8), (2 * T + 1, 9, 3), (T - 7, 0, 1))]
    return cases


def nn_special_state(torch, np, width, dev, seed=7):
    """A PLOC state of `width` lanes whose box faces take -1, -0.0, +0.0
    and 0.5, one face in 40 a NaN, with many equal areas; sorted codes in
    runs of about 8 equal values above bit 9 (segments of several lanes at
    shifts 0 and 9) and random node ids."""
    rng = np.random.default_rng(seed)
    mn = rng.choice(np.array([-1.0, -0.0, 0.0, 0.5], np.float32), (3, width))
    mx = mn + rng.choice(np.array([0.0, 0.5], np.float32), (3, width))
    cols = np.concatenate([mn, -mx]).astype(np.float32)
    cols[rng.random(cols.shape) < 1 / 40] = np.nan
    codes = np.sort(rng.integers(0, max(width // 8, 1), width)) << 9
    node = rng.integers(0, 2 * width, width)
    mat = np.concatenate([cols.view(np.int32), codes[None], node[None]]).astype(np.int32)
    return torch.from_numpy(mat).to(dev)


KERNEL_SYMBOLS = {"front_tri_box": "front_box_kernel", "front_keys": "front_keys_kernel",
                  "front_gather": "front_gather_kernel"}


def front_calls(inputs):
    """kernel -> (kernel call, plain call) of the front half's three on one
    scene's `(tris, rows, scene_min, extent, sorted keys, pos)` from
    triangles, B with the extended code as the builds run it."""
    from tpu_bvh_torch.ops import front_half as fh

    tris, rows, lo, ext, skey, pos = inputs
    return {"front_tri_box": (lambda: fh.tri_rows(tris), lambda: fh.tri_rows_reference(tris)),
            "front_keys": (lambda: fh.keys(rows, None, lo, ext, True),
                           lambda: fh.keys_reference(rows, None, lo, ext, True)),
            "front_gather": (lambda: fh.gather(skey, pos, rows, None),
                             lambda: fh.gather_reference(skey, pos, rows, None))}


def read_counts():
    """`kernels.launches` by the rows of COUNTED."""
    from tpu_bvh_torch.utils import kernels

    return {name: kernels.launches[COUNTED_AS.get(name, name)] for name in COUNTED}


def sharded_rank(dev, sponza, cbox, full):
    """One rank of the sharded phase (`comm.spawn` runs it in a process of
    its own): the sharded path on sponza with every launch counter set to 0
    just before it and read just after, then each sharded call timed on
    this rank (CUDA events on its stream and the host clock). `full` drives
    the whole path (build, `to_bvh2`, extents, the batched demo, the
    traversal and the raster render of the 512^2 frame over the assembled
    tree), else the build alone. Rank 0 checks that the build's kernels
    launched as often as it runs them on every rank and, with `full`, that
    B4, the speculative traversal and the batched build did. Returns numpy:
    the assembled tree (rank 0), this rank's shards, counts and times."""
    import torch
    from tpu_bvh_torch.models import batched
    from tpu_bvh_torch.ops import raster
    from tpu_bvh_torch.parallel import sharded, sharded_build
    from tpu_bvh_torch.utils import camera, kernels, scenes

    mesh = sharded.default_mesh()
    tris = torch.from_numpy(sponza).to(dev)
    n = tris.shape[0]
    tr, cam = scenes.preset("sponza", dev)
    rays = camera.generate_rays(cam, *WAVEFRONT)
    demo = batched.pad_meshes([cbox] * BATCHED_DEMO, cbox.shape[0], device=dev)[0]
    caps = dict(zip(("cand_cap", "pair_cap", "group"), RENDERS[WAVEFRONT]))

    def build():
        sb = sharded_build.build_single_pass_sharded(mesh, tris)
        return sb, sharded_build.to_bvh2(sb, n, mesh)

    kernels.launches.clear()
    sb, bvh = build()
    calls = {}
    if full:
        packed = raster.pack_raster(bvh, tris, leaf_size=LEAF)
        calls = {
            "sharded_scene_extents": lambda: sharded.sharded_scene_extents(mesh, tris),
            "build_batched_sharded": lambda: sharded.build_batched_sharded(mesh, demo),
            "traverse_sharded": lambda: sharded.traverse_sharded(mesh, bvh, tris, rays, tr),
            "render_raster_sharded": lambda: sharded.render_raster_sharded(
                mesh, packed, rays, tr, *WAVEFRONT, **caps)}
    res = {k: f() for k, f in calls.items()}
    torch.cuda.synchronize()
    counts = read_counts()
    names = list(counts)
    every = mesh.all_gather(torch.tensor([counts[k] for k in names], device=dev)).tolist()
    if mesh.axis_index() == 0:
        print(f"  sharded path ({mesh.size} rank(s), {mesh.backend}): launches by rank "
              f"{[{k: c for k, c in zip(names, row) if c} for row in every]}", flush=True)
        for k, want in SHARDED_BUILD_KERNELS.items():
            if not all(row[names.index(k)] == want for row in every):
                raise AssertionError(f"{k} did not launch {want} times on every rank of the "
                                     f"sharded build")
        for k in SHARDED_KERNELS if full else ():
            if not all(row[names.index(k)] > 0 for row in every):
                raise AssertionError(f"{k} did not launch on every rank of the sharded path")
    out = {"rank": mesh.axis_index(), "overflow": bool(sb.overflow),
           "counts": dict(zip(names, every[mesh.axis_index()])),
           "times": {k: time_ms(torch, f, SHARDED_REPS, warmup=1)
                     for k, f in {"build_single_pass_sharded": build, **calls}.items()}}
    to_np = lambda nt: [f.cpu().numpy() for f in nt]  # noqa: E731
    if mesh.axis_index() == 0:
        out["bvh"] = to_np(bvh)
    if full:
        out["extents"] = [x.cpu().numpy() for x in res["sharded_scene_extents"]]
        out["batched"] = to_np(res["build_batched_sharded"])
        hit, hcounts = res["traverse_sharded"]
        out["traverse"] = to_np(hit) + [hcounts.cpu().numpy()]
        out["raster"] = to_np(res["render_raster_sharded"])
    return out


def main():
    args = parse_args()
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_bvh_torch.models import batched, lbvh, ploc
    from tpu_bvh_torch.ops import (aabb, batched_block, batched_build, collapse, collapse_block,
                                   collapse_fast, front_half,
                                   plane_scan, ploc_nn, ploc_round, radix_tree, raster, raster_gpu,
                                   ray_sweep, refit, refit_dense, scan32, threshold_core,
                                   traverse)
    from tpu_bvh_torch.ops import ploc as ploc_ops
    from tpu_bvh_torch.ops.aabb import triangle_aabbs
    from tpu_bvh_torch.types import PLOC_RADIUS, Bvh2, Bvh4, Rays, identity_transform
    from tpu_bvh_torch.utils import camera, image, introspect, kernels, scenes, validate, work
    from tpu_bvh_torch.utils.cost import sah_cost_bvh2, sah_cost_bvh4
    from tpu_bvh_torch.utils.cpu_reference import collapse_cpu
    from tpu_bvh_torch.utils.timer import Timer
    from tpu_bvh_torch import app, config
    from tpu_bvh_torch.profile_slice import reversed_shadow_slice

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    sm_mhz = int(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip())
    # phase 1: the card
    print(f"[1] device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch "
          f"{torch.__version__} | cuda {torch.version.cuda} | python {sys.version.split()[0]}",
          flush=True)

    # phase 2: build the kernels from the sources in this checkout
    t0 = time.perf_counter()
    kernels.lib()
    if kernels.build_seconds is None:
        print(f"[2] kernel library found built: {kernels.build()}", flush=True)
    else:
        print(kernels.build_report, flush=True)
        print(f"[2] kernel build: {time.perf_counter() - t0:.2f} s (nvcc, "
              f"{len({src for _, src, _ in KERNELS.values()})} sources in parallel: "
              f"{kernels.build_seconds:.2f} s)", flush=True)

    # phase 3: each kernel against its plain version on the card
    print(f"[3] kernels vs plain versions (at {time.perf_counter() - t_start:.1f} s)", flush=True)
    sponza = scenes.sponza_like(SPONZA_TRIS)
    rng = np.random.default_rng(0)
    dup = np.repeat(sponza[rng.choice(len(sponza), 4096, replace=False)], 64, axis=0)
    errs = {name: 0.0 for name in KERNELS}
    inputs = {}
    topo_inputs = {}  # scene: (sorted codes, leaf_packed_t)
    pay_rng = np.random.default_rng(1)

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    def same_outputs(got, want, name, what):
        for k, (g, w) in enumerate(zip(got, want)):
            require(g.dtype == w.dtype and torch.equal(bits(g), bits(w)),
                    f"{name} kernel output {k} == plain, bit for bit, {what}")
        errs[name] = max(errs[name], max_err(got, want))

    def check_threshold(dlt, what):
        """B12/B13, B14 (a random payload) and B15 on deltas in [0, 63]."""
        pay = torch.from_numpy(pay_rng.integers(0, 1 << 22, dlt.shape[0]).astype(np.int32))
        pay = pay.to(dev)
        cases = (("psv_nsv_packed", threshold_core.psv_nsv_packed,
                  threshold_core.psv_nsv_packed_reference, (dlt,)),
                 ("psv_nsv_packed_lanes", threshold_core.psv_nsv_packed_lanes,
                  threshold_core.psv_nsv_packed_reference, (dlt,)),
                 ("psv_nsv_payload", threshold_core.psv_nsv_payload_auto,
                  threshold_core.psv_nsv_payload_reference, (dlt, pay)),
                 ("child_positions", threshold_core.child_positions_auto,
                  threshold_core.child_positions_reference, (dlt,)))
        for name, kfn, pfn, a in cases:
            got = kfn(*a)
            want = pfn(*a)
            torch.cuda.synchronize()
            same_outputs(got, want, name, what)
        return pay

    sz = scenes.signed_zero_soup(SIGNED_ZERO_TRIS)
    for name, soup in (("sponza", sponza), ("dup", dup), ("+-0 soup", sz)):
        tris = torch.from_numpy(soup).to(dev)
        codes, leaf_packed_t, _ = lbvh._sorted_leaves_from_tris(tris, True)
        dlt_raw = radix_tree.adjacent_deltas(codes)
        m = dlt_raw.shape[0]
        got = scan32.scan_core(dlt_raw)
        want = scan32.scan_core_reference(dlt_raw)
        torch.cuda.synchronize()
        same_outputs(got, want, "scan32", f"{name} m={m}")
        b1 = got
        dlt32 = scan32.dlt32_from_raw(dlt_raw)
        flipped = torch.flip(dlt32, [0])
        got = (*scan32.scan_fwd(dlt32), *scan32.scan_rev(flipped, m))
        want = (*scan32.scan_fwd_reference(dlt32), *scan32.scan_rev_reference(flipped, m))
        torch.cuda.synchronize()
        same_outputs(got, want, "scan32_halves", f"{name} V=32 deltas, forward and flipped")
        require(all(torch.equal(g, w) for g, w in zip(
            (*got[:3], *(torch.flip(x, [0]) for x in got[3:])), b1)),
            f"B16's halves (the reverse flipped back) == B1's outputs, {name}")
        dlt = scan32.remap_deltas(dlt_raw)
        pay = check_threshold(dlt, f"{name} deltas, m={m}")
        topo_inputs[name] = (codes, leaf_packed_t)
        first, last = b1[0] + 1, b1[3]
        n = m + 1
        mat = refit_dense.cols_mat(leaf_packed_t, first, last)
        want = refit_dense.refit_dense_reference(mat, n, refit.RADIUS)
        got = refit_dense.refit_dense(mat, n, refit.RADIUS)
        torch.cuda.synchronize()
        same_outputs(got, want, "refit_dense", f"{name} n={n}, the mat entry")
        got = refit_dense.refit_dense_cols(leaf_packed_t, first, last, n, refit.RADIUS)
        torch.cuda.synchronize()
        same_outputs(got, want, "refit_dense", f"{name} n={n}, the column entry")
        # the single-pass tail: B1's links form, B2's tree mode and L
        prim = torch.randperm(n, device=dev).to(torch.int32)
        require(all(torch.equal(g, w) for g, w in zip(scan32.topology_links(codes, prim),
                                                       radix_tree.apetrei_links_reference(
                                                           codes, prim))),
                f"B1's links form == the plain links (scan_core and its glue), {name}")
        want = torch.cat([refit.refit_anchored_packed(*(x.cpu() for x in (leaf_packed_t, first,
                                                                          last))),
                          leaf_packed_t.cpu()], dim=1)
        require(torch.equal(bits(refit.refit_tree(leaf_packed_t, first, last)).cpu(), bits(want)),
                f"refit_tree (B2's tree mode, L) == the CPU refit and the leaf columns, {name}")
        aux = lbvh.build_single_pass_aux(tris)
        rows = collapse_fast.kernel_inputs(*aux)
        got_m, got_a = collapse_block.collapse_block(*rows, aux[0].n_internal)
        want_m, want_a = collapse_block.collapse_block_reference(*rows, aux[0].n_internal)
        torch.cuda.synchronize()
        same_outputs([got_m, *got_a], [want_m, *want_a], "collapse_block", f"{name} W={n}")
        if name == "sponza":
            inputs["scan"] = dlt_raw
            inputs["halves"] = (dlt32, flipped, m)
            inputs["threshold"] = (dlt, pay)
            # B11 on the threshold planes of the scans' plain versions
            packed = torch.arange(m, dtype=torch.int32, device=dev) * 64 + dlt
            below = dlt[:, None] < torch.arange(threshold_core.V, device=dev)[None, :]
            planes = {True: torch.where(below, packed[:, None], threshold_core.BIG),
                      False: torch.where(below, packed[:, None], -1)}
            for is_min in (True, False):
                for reverse in (False, True):
                    got = plane_scan.plane_scan(planes[is_min], is_min=is_min, reverse=reverse)
                    want = plane_scan.plane_scan_reference(planes[is_min], is_min=is_min,
                                                           reverse=reverse)
                    torch.cuda.synchronize()
                    same_outputs([got], [want], "plane_scan",
                                 f"sponza's threshold plane {tuple(got.shape)}, "
                                 f"{'min' if is_min else 'max'}, "
                                 f"{'reverse' if reverse else 'forward'}")
            inputs["planes"] = planes
            inputs["refit"] = (mat, n, leaf_packed_t, first, last)
            inputs["collapse"] = (rows, aux[0].n_internal, [got_m, *got_a])

    # the front half's kernels against their plain steps on the same card
    # inputs: A's rows and extent bit for bit, its scene minimum by value
    # (the plain amin keeps either zero); B from triangles (prim_idx arange)
    # and from shuffled PrimRefs, plain and extended code; C on B's sorted
    # extended keys (from triangles it reads no pos); and the whole front half
    from benchmark.scene import Scene

    frame_4m = Scene(FRONT_FRAME["n_tris"], FRONT_FRAME["occupancy_tris"], 1, 0.0,
                     FRONT_FRAME["seed"], dev).frames[0]
    perm_gen = torch.Generator(device=dev).manual_seed(FRONT_FRAME["seed"])
    front_inputs = {}  # scene: (tris, rows, scene_min, extent, sorted keys, pos) from triangles
    for name, t in (("sponza", torch.from_numpy(sponza).to(dev)),
                    ("+-0 soup", torch.from_numpy(sz).to(dev)), ("4M frame", frame_4m)):
        n_f = t.shape[0]
        what = f"{name} n={n_f}"
        got = front_half.tri_rows(t)
        want = front_half.tri_rows_reference(t)
        torch.cuda.synchronize()
        same_outputs([got[0], got[2]], [want[0], want[2]], "front_tri_box",
                     f"{what}: rows and extent")
        require(torch.equal(got[1], want[1]), f"front_tri_box scene minimum == plain by value, "
                                              f"{what}")
        f_rows, f_min, f_ext = want
        prim = torch.randperm(n_f, generator=perm_gen, device=dev).to(torch.int32)
        for p_idx, route in ((None, "from triangles"), (prim, "from shuffled PrimRefs")):
            for extended in (False, True):
                key = front_half.keys(f_rows, p_idx, f_min, f_ext, extended)
                want = front_half.keys_reference(f_rows, p_idx, f_min, f_ext, extended)
                torch.cuda.synchronize()
                same_outputs([key], [want], "front_keys",
                             f"{what}, {route}, {'extended' if extended else 'plain'} code")
            skey, pos = torch.sort(key)
            got = front_half.gather(skey, pos, f_rows, p_idx)
            want = front_half.gather_reference(skey, pos, f_rows, p_idx)
            torch.cuda.synchronize()
            same_outputs(got, want, "front_gather", f"{what}, {route}")
            if p_idx is None:
                front_inputs[name] = (t, f_rows, f_min, f_ext, skey, pos)
        got = lbvh._sorted_leaves_from_tris(t, True)
        want = front_half.from_tris_reference(t, True)
        torch.cuda.synchronize()
        require(all(g.dtype == w.dtype and torch.equal(bits(g), bits(w)) for g, w in zip(got, want)),
                f"the front half's sorted leaves (codes, rows, prims) == plain, bit for bit, {what}")
    del prim, key, skey, pos, got, want

    draws = torch.from_numpy(rng.integers(0, 53, 262_144).astype(np.int32)).to(dev)
    check_threshold(draws, "262,144 random deltas in [0, 53)")
    # B15 where deltas repeat: a soup of a few values (63 included: its <=
    # answers are the neighbours), every delta equal, one row
    odd_rng = np.random.default_rng(16)  # its own draws: `rng`'s later inputs stay as they were
    soup = odd_rng.choice(np.array([0, 5, 5, 17, 62, 63], np.int32), 262_144)
    for what, d in (("a soup of 262,144 deltas in {0, 5, 17, 62, 63}", soup),
                    ("262,144 equal deltas", np.full(262_144, 7, np.int32)),
                    ("one delta", np.array([9], np.int32))):
        d = torch.from_numpy(d).to(dev)
        got = threshold_core.child_positions_auto(d)
        want = threshold_core.child_positions_reference(d)
        torch.cuda.synchronize()
        same_outputs(got, want, "child_positions", what)
    # B11 on planes of other shapes: rows that are no multiple of its tile,
    # widths below one strip and past two (no 16-byte rows), one row
    for m_p, v_p in ((3 * plane_scan.TILE_ROWS + 5, 64), (1000, 3), (777, 130), (1, 64),
                     (1, 5)):
        x = torch.from_numpy(odd_rng.integers(-(2**31), 2**31, size=(m_p, v_p),
                                              dtype=np.int64).astype(np.int32)).to(dev)
        for is_min in (True, False):
            for reverse in (False, True):
                before = kernels.launches["plane_scan"]
                got = plane_scan.plane_scan(x, is_min=is_min, reverse=reverse)
                require(kernels.launches["plane_scan"] == before + 1,
                        "plane_scan: one launch a call")
                want = plane_scan.plane_scan_reference(x, is_min=is_min, reverse=reverse)
                torch.cuda.synchronize()
                same_outputs([got], [want], "plane_scan",
                             f"a [{m_p}, {v_p}] plane, {'min' if is_min else 'max'}, "
                             f"{'reverse' if reverse else 'forward'}")
    # B1 and B12/B13, B14 where a block walks many tiles: B1 at its largest
    # m (the deltas of 2^22 sorted random codes), the psv/nsv scans on 2^23
    # random deltas in [0, 63]
    big_raw = radix_tree.adjacent_deltas(
        torch.from_numpy(np.sort(rng.integers(0, 1 << 30, 1 << 22))).to(dev))
    big_d = torch.from_numpy(rng.integers(0, 64, 1 << 23).astype(np.int32)).to(dev)
    big_pay = torch.from_numpy(rng.integers(0, 1 << 22, 1 << 23).astype(np.int32)).to(dev)
    for name, x, topo_grid in (("scan32", big_raw, True), ("psv_nsv_packed", big_d, False)):
        grid = threshold_core.launch_grid(x.shape[0], dev, topology=topo_grid)
        print(f"  {name} at m={x.shape[0]}: grid {grid}", flush=True)
        require(grid["tiles_a_block"] > 1, f"{name} at m={x.shape[0]}: a block walks many tiles")
    same_outputs(scan32.scan_core(big_raw), scan32.scan_core_reference(big_raw), "scan32",
                 f"the deltas of 2^22 sorted random codes, m={big_raw.shape[0]}")
    for name, kfn, pfn, a in (
            ("psv_nsv_packed", threshold_core.psv_nsv_packed,
             threshold_core.psv_nsv_packed_reference, (big_d,)),
            ("psv_nsv_payload", threshold_core.psv_nsv_payload_auto,
             threshold_core.psv_nsv_payload_reference, (big_d, big_pay))):
        same_outputs(kfn(*a), pfn(*a), name, "2^23 random deltas in [0, 63]")
    del big_raw, big_d, big_pay

    tris = torch.from_numpy(sponza).to(dev)
    tr, cam = scenes.preset("sponza", dev)
    bvh = lbvh.build_single_pass(tris)
    packed = raster.pack_raster(bvh, tris, leaf_size=LEAF)
    # The sweeps are bit-exact by design (no FMA, IEEE division, the plain
    # version's order), so all five outputs must be equal, at the shapes
    # and caps of the main path (1080p padded to 1920x1088).
    for (rw, rh), caps in RENDERS.items():
        rays, w, h = raster_gpu.pad_rays(camera.generate_rays(cam, rw, rh), rw, rh)
        sweep, _, ovf = raster_gpu.prepare_sweep(packed, rays, tr, w, h, *caps)
        require(not bool(ovf), f"{rw}x{rh} pair list fits its caps {caps}")
        got = raster_gpu.raster_sweep(*sweep)
        split = split_info(torch, raster_gpu.last_stats, got, sweep[1].shape[1], "subtiles")
        want = raster_gpu.raster_sweep_reference(*sweep)
        torch.cuda.synchronize()
        same_outputs(got, want, "raster_sweep", f"{rw}x{rh}")
        require(bool((got[1] >= 0).any()), f"raster {rw}x{rh}: {int((got[1] >= 0).sum())} hits")
        print(f"  raster sweep {rw}x{rh}: {split}", flush=True)
        inputs[f"raster_{rw}x{rh}"] = (sweep, got)
        if (rw, rh) == (512, 512):
            inputs["raster"] = (sweep, got)

    rays_1080 = camera.generate_rays(cam, 1920, 1080)
    hit_1080, _, ovf = raster_gpu.render_raster_gpu(packed, rays_1080, tr, 1920, 1080,
                                                    *RENDERS[(1920, 1080)])
    require(not bool(ovf), "1920x1080 primary render for the shadow rays: no overflow")
    points, live, light, eps, fwd, vsel, n_shadow = scenes.shadow_workload(
        tris, rays_1080, hit_1080)
    slice_rays = Rays(*(x[vsel] for x in fwd))
    for key, what, rays, caps, occlusion in (
            ("occl", "occlusion mode, shadow_occlusion's rays",
             ray_sweep.shadow_rays(points, live, light, eps), SHADOW_CAPS, True),
            ("closest", f"closest-hit mode, trace_rays on the {vsel.numel()}-ray slice", slice_rays,
             TRACE_CAPS, False),
            ("primary", "closest-hit mode, the 1920x1080 primary rays", rays_1080, PRIMARY_CAPS,
             False)):
        sweep, _, _, ovf = ray_sweep.prepare_trace(packed, rays, tr, *caps)
        require(not bool(ovf), f"ray sweep {what}: fits its caps {caps}")
        got = ray_sweep.ray_sweep_kernel(*sweep, occlusion)
        split = split_info(torch, ray_sweep.last_stats, got, sweep[1].shape[1])
        want = ray_sweep.ray_sweep_reference(*sweep, occlusion)
        torch.cuda.synchronize()
        same_outputs(got, want, "ray_sweep", what)
        require(bool((got[1] >= 0).any()), f"ray sweep {what}: {int((got[1] >= 0).sum())} hits")
        print(f"  ray sweep {what}: {split}", flush=True)
        inputs[f"ray_sweep_{key}"] = (sweep, got)

    # the PLOC kernels: B10 on sponza's first-round state; B9 and the round
    # (B6 ping-pong, B8 allocating) on three states along the sponza HPLOC
    # build (the plain rounds on the card); B7 on its hand-over state and on
    # the first MAX_FIN_WIDTH sorted leaves. Node buffers start as junk, so
    # a column written by one version only shows.
    R = PLOC_RADIUS
    codes, leaf_packed_t, _ = lbvh._sorted_leaves_packed(lbvh.prim_refs_from_triangles(tris), True)
    n = leaf_packed_t.shape[1]
    mat0 = ploc_ops.initial_state(leaf_packed_t, codes)

    def junk(shape):
        return torch.full(shape, -3, dtype=torch.int32, device=dev)

    for shift in (32, ploc.HPLOC_SHIFT0):
        got = ploc_nn.ploc_nn_round_raw(mat0, n, shift, R)
        want = ploc_nn.ploc_nn_round_raw_reference(mat0, n, shift, R)
        torch.cuda.synchronize()
        same_outputs([got], [want], "ploc_nn", f"sponza first round, n={n}, shift {shift}")
        if shift == 32:
            inputs["ploc"] = (mat0, got)
        print(f"  ploc_nn phase clocks, sponza first round, shift {shift} (SM cycles: median and "
              f"most over the {-(-n // ploc_nn.TILE)} blocks; at most {sm_mhz} MHz): "
              f"{ploc_nn.phase_cycles(mat0, n, shift, R)}", flush=True)
    # B10 at its tiles' edges (widths and live counts on either side of a
    # tile's end) and on boxes with NaN and +-0 faces, where the areas'
    # hardware min must make jnp.minimum's choices
    T = ploc_nn.TILE
    for s_w, nc, shift, radius, what in nn_edge_cases(T):
        st = (mat0[:, :s_w].contiguous() if what == "sponza"
              else nn_special_state(torch, np, s_w, dev))
        got = ploc_nn.ploc_nn_round_raw(st, nc, shift, radius)
        want = ploc_nn.ploc_nn_round_raw_reference(st, nc, shift, radius)
        torch.cuda.synchronize()
        same_outputs([got], [want], "ploc_nn",
                     f"{what} state, width {s_w}, nc {nc}, shift {shift}, radius {radius}")
    # the HPLOC state where the round loop hands over at each width in
    # HAND_OVERS (the finisher's width before this design, the TPU kernel's,
    # the port's)
    widths = sorted({*HAND_OVERS, ploc_round.FIN_WIDTH}, reverse=True)
    states, hand_overs, mat, nc, shift = [], {}, mat0, n, ploc.HPLOC_SHIFT0
    sink = junk((8, n - 1))
    while widths:
        if nc <= widths[0]:
            hand_overs[widths.pop(0)] = (mat, nc, shift)
            continue
        if nc > ploc_round.FIN_WIDTH:
            states.append((mat, nc, shift))
        mat, _, nm = ploc_round.ploc_round_reference(mat, sink, nc, shift, n - nc, R)
        nc -= int(nm)
        shift = min(shift + ploc.HPLOC_SHIFT_STEP, 32)
    hand_over = hand_overs[ploc_round.FIN_WIDTH]
    for k in sorted({0, len(states) // 2, len(states) - 1}):
        st, nc, shift = states[k]
        base = n - nc
        what = f"HPLOC round {k} of the {len(states)} before the hand-over, nc={nc}, shift {shift}"
        nn = ploc_nn.ploc_nn_round_raw_reference(st, nc, shift, R)
        got = ploc_round.ploc_emit_compact(st, nn, junk((8, n - 1)), nc, base)
        want = ploc_round.ploc_emit_compact_reference(st, nn, junk((8, n - 1)), nc, base)
        torch.cuda.synchronize()
        same_outputs(got, want, "ploc_emit_compact", what)
        got = ploc_round.ploc_round_pp(st, junk(st.shape), junk((8, n - 1)), nc, shift, base, R)
        want = ploc_round.ploc_round_pp_reference(st, junk(st.shape), junk((8, n - 1)), nc, shift,
                                                  base, R)
        torch.cuda.synchronize()
        same_outputs(got, want, "ploc_round", what + ", ping-pong (B6)")
        got = ploc_round.ploc_round_fused(st, junk((8, n - 1)), nc, shift, base, R)
        want = ploc_round.ploc_round_reference(st, junk((8, n - 1)), nc, shift, base, R)
        torch.cuda.synchronize()
        same_outputs(got, want, "ploc_round_fused", what + ", allocating (B8)")
    step = ploc.HPLOC_SHIFT_STEP
    for width, (mat, nc, shift) in sorted(hand_overs.items()):
        got = ploc_round.ploc_finish(mat, junk((8, n - 1)), nc, shift, n - nc, R, step)
        want = ploc_round.ploc_finish_reference(mat, junk((8, n - 1)), nc, shift, n - nc, R, step)
        torch.cuda.synchronize()
        same_outputs([got], [want], "ploc_finish",
                     f"HPLOC hand-over state at FIN_WIDTH {width}, nc={nc}, shift {shift}")
        print(f"  B7 counters, hand-over at {width}: "
              f"{finish_info(ploc_round.last_finish_stats, sm_mhz)}", flush=True)
    mat, nc, shift = hand_over
    inputs["finish"] = (mat, nc, shift, n - nc)
    inputs["hand_overs"] = {w: (m, c, s, n - c) for w, (m, c, s) in hand_overs.items()}
    W = ploc_round.MAX_FIN_WIDTH
    lim = mat0[:, :W + 1].contiguous()  # the first W + 1 sorted leaves
    for shift in (32, ploc.HPLOC_SHIFT0):
        got = ploc_round.ploc_finish(lim, junk((8, W)), W, shift, 0, R, step)
        want = ploc_round.ploc_finish_reference(lim, junk((8, W)), W, shift, 0, R, step)
        torch.cuda.synchronize()
        same_outputs([got], [want], "ploc_finish",
                     f"at its width limit, {W} clusters, shift {shift}")
        print(f"  B7 counters, {W} clusters, shift {shift}: "
              f"{finish_info(ploc_round.last_finish_stats, sm_mhz)}", flush=True)
    before = kernels.launches["ploc_finish"]
    try:
        ploc_round.ploc_finish(lim, junk((8, W)), W + 1, 32, 0, R, step)
        refused = False
    except ValueError:
        refused = True
    require(refused and kernels.launches["ploc_finish"] == before,
            f"ploc_finish refuses {W + 1} clusters before the launch")

    # the batched build (one warp a mesh) on its four inputs: the demo (the
    # cornellbox at its own size, as bench.py stacks it), random meshes at
    # capacity 32 and 64, and the +-0 soup cut into meshes; every output bit
    # for bit against the plain version on the card, every tree valid
    cbox = scenes.cornellbox()
    demo_what = f"the demo, {BATCHED_DEMO} cornellbox copies"
    b_inputs = {
        demo_what: batched.pad_meshes([cbox] * BATCHED_DEMO, cbox.shape[0], device=dev)[0],
        f"{BATCHED_RANDOM} random meshes": batched.pad_meshes(
            scenes.random_meshes(BATCHED_RANDOM, 32, 2), 32, device=dev)[0],
        f"{BATCHED_WIDE} random meshes": batched.pad_meshes(
            scenes.random_meshes(BATCHED_WIDE, 64, 3), 64, device=dev)[0],
        "the +-0 soup in meshes of 32": torch.from_numpy(sz).to(dev).reshape(-1, 32, 3, 3),
    }
    for what, t in b_inputs.items():
        B, M = t.shape[:2]
        got = Bvh2(*batched_build.batched_build(t))
        want = batched._build_batched_small(t)  # [B, 6, m, M] temporaries: 1.6 GB at most
        torch.cuda.synchronize()
        same_outputs(got, want, "batched_build", f"{what}, {B} meshes at capacity {M}")
        ends = [Bvh2(*(f[b] for f in got)) for b in (0, B - 1)]
        require(batched_valid(torch, got, M) and all(
            validate.check_bvh2_correctness(one, M) and validate.check_root_aabb(one)
            for one in ends), f"batched_build, {what}: all {B} trees valid")
    before = kernels.launches["batched_build"]
    try:
        batched_build.batched_build(torch.zeros((1, batched_build.MAX_PRIMS + 1, 3, 3), device=dev))
        refused = False
    except ValueError:
        refused = True
    require(refused and kernels.launches["batched_build"] == before,
            f"batched_build refuses capacity {batched_build.MAX_PRIMS + 1} before the launch")

    # the block kernel (one block a mesh, 65-1024 prims) on its four inputs:
    # (a) 1024 random meshes of 2-1024 prims at capacity 1024, (b) 16,384 of
    # 2-128 at 128, (c) 4096 of 2-65 at 65, (d) the +-0 soup in meshes of
    # 128 beside meshes of one triangle repeated; one launch a call, every
    # output bit for bit against the plain version on the card, every tree
    # valid; capacities 64 and 1025 refused before a launch
    t_block = time.perf_counter()
    k_inputs = {name: batched.pad_meshes(meshes, cap, device=dev)[0]
                for name, (meshes, cap) in scenes.block_meshes().items()}
    k_what = {"1024x1024": "(a) 1024 random meshes", "16384x128": "(b) 16,384 random meshes",
              "4096x65": "(c) 4096 random meshes",
              "signed_zero_one_tri128": "(d) the +-0 soup and one-triangle meshes"}
    k_got = {}
    for name, t in k_inputs.items():
        B, M = t.shape[:2]
        before = kernels.launches["batched_block"]
        got = Bvh2(*batched_block.batched_block(t))
        want = batched_block.batched_block_reference(t)
        torch.cuda.synchronize()
        require(kernels.launches["batched_block"] == before + 1,
                f"batched_block, {k_what[name]}: one launch a call")
        same_outputs(got, want, "batched_block", f"{k_what[name]}, {B} meshes at capacity {M}")
        ends = [Bvh2(*(f[b] for f in got)) for b in (0, B - 1)]
        require(batched_valid(torch, got, M) and all(
            validate.check_bvh2_correctness(one, M) and validate.check_root_aabb(one)
            for one in ends), f"batched_block, {k_what[name]}: all {B} trees valid")
        k_got[name] = got
    for cap in (batched_build.MAX_PRIMS, batched_block.MAX_PRIMS + 1):
        before = kernels.launches["batched_block"]
        try:
            batched_block.batched_block(torch.zeros((1, cap, 3, 3), device=dev))
            refused = False
        except ValueError:
            refused = True
        require(refused and kernels.launches["batched_block"] == before,
                f"batched_block refuses capacity {cap} before the launch")
    print(f"  the block kernel's checks: {time.perf_counter() - t_block:.1f} s", flush=True)

    # the traversal kernels on sponza's 512^2 primary frame and on the
    # reversed shadow slice, each against its plain version on the card on
    # every ray, floats by their bits
    t_packed = traverse.pack_bvh2(bvh, tris)
    t_rays = camera.generate_rays(cam, *WAVEFRONT)

    def traversal(v, rays, plain=False):
        return traverse.traverse_by_name(v, bvh, tris, rays, tr, t_packed, plain)

    t_inputs = {"frame": t_rays, "shadow_rev": reversed_shadow_slice(light, fwd, vsel)}
    for what, rays in t_inputs.items():
        for v in TRAVERSALS:
            hit, counts = traversal(v, rays)
            stats = traverse.last_stats.cpu().tolist()
            t0 = time.perf_counter()
            want = traversal(v, rays, plain=True)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            same_outputs([*hit, counts], [*want[0], want[1]], f"traverse_{v}",
                         f"{TRAVERSE_INPUTS[what]}, every ray ({rays.origin.shape[0]} rays, "
                         f"{int((hit.prim_idx >= 0).sum())} hits; the plain version "
                         f"{plain_s:.2f} s)")
            pin = TRAVERSE_PINS[(what, "restart_trail" if v == "restart_trail" else "stack")]
            require(stats == list(pin[:3]) and stats[1] == int(counts.sum()),
                    f"traverse_{v} on {TRAVERSE_INPUTS[what]}: device counters {stats} (node "
                    f"steps, leaf steps, overflowed rays), the one-thread-a-ray kernel's "
                    f"{list(pin[:3])}; the leaf steps are the counts' sum")
    # the deep chain: the stack overflows, the ray walks again stackless
    chain = {k: torch.from_numpy(x).to(dev) for k, x in scenes.deep_chain().items()}
    c_bvh = Bvh2.from_rows(chain["node_min"], chain["node_max"], chain["left"], chain["right"],
                           torch.tensor(0, dtype=torch.int32, device=dev))
    c_rays = Rays(chain["origin"], chain["direction"], torch.zeros(2, device=dev),
                  torch.full((2,), 3.4e38, device=dev))
    chain_args = (c_bvh, chain["tris"], c_rays, identity_transform(dev))
    for v in TRAVERSALS:
        hit, counts = traverse.traverse_by_name(v, *chain_args)
        stats = traverse.last_stats.cpu()
        want = traverse.traverse_by_name(v, *chain_args, plain=True)
        torch.cuda.synchronize()
        same_outputs([*hit, counts], [*want[0], want[1]], f"traverse_{v}", "the deep chain")
        require(hit.prim_idx.tolist() == [60, -1] and abs(float(hit.t[0]) - 2.0) < 1e-5
                and int(stats[2]) == (0 if v == "restart_trail" else 1),
                f"traverse_{v}, the 64-deep chain: prim 60 at t = {float(hit.t[0])!r}, a miss, "
                f"{int(stats[2])} overflowed ray(s)")

    # phase 4: the main path through the entry points a user calls, path by
    # path, each with every launch counter set to 0 just before it
    print(f"[4] main path on sponza_like({SPONZA_TRIS}): build -> topology -> collapse -> render "
          f"-> shadow -> ploc; then the batched demo and block path, the wavefront traversal, the "
          f"app and the "
          f"sharded path (at "
          f"{time.perf_counter() - t_start:.1f} s)", flush=True)
    launches = {}

    def run_path(path, names, fn):
        kernels.launches.clear()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"  launches in the {path} path: {counts}", flush=True)
        require(all(counts[nm] > 0 for nm in names), f"every kernel of the {path} path launched")
        for nm, c in counts.items():  # over the whole main path
            launches[nm] = launches.get(nm, 0) + c
        return out, counts

    ((bvh, parent, first, last), bvh_two), l_counts = run_path(
        "build", ["scan32", "refit_dense", "refit_long", *FRONT_KERNELS],
        lambda: (lbvh.build_single_pass_aux(tris), lbvh.build_two_pass(tris)))
    require(all(l_counts[k] == 2 for k in ("scan32", "refit_dense", "refit_long", *FRONT_KERNELS)),
            "build path: each front-half kernel, B1, B2 and L launched once a build (2 builds)")
    t_codes = topo_inputs["sponza"][0]
    topo, _ = run_path("topology", ["psv_nsv_packed", "psv_nsv_packed_lanes", "psv_nsv_payload"],
                       lambda: (radix_tree.apetrei_topology_fast(t_codes),
                                radix_tree.karras_topology_fast(t_codes)))
    wide, c_counts = run_path("collapse", ["collapse_block", *COLLAPSE_PREP_KERNELS],
                              lambda: collapse_fast.collapse_lbvh_to_bvh4(bvh, parent, first, last))
    require(all(c_counts[k] == 1 for k in ("collapse_block", *COLLAPSE_PREP_KERNELS))
            and collapse_fast.last_build["launches"] == 3,
            "collapse path: P1, P2 and B3 launched once each")

    def render():
        pk = raster.pack_raster(bvh, tris, leaf_size=LEAF)
        out = {}
        for (rw, rh), caps in RENDERS.items():
            rr = camera.generate_rays(cam, rw, rh)
            out[(rw, rh)] = (rr, raster_gpu.render_raster_gpu(pk, rr, tr, rw, rh, *caps))
        return pk, out

    (packed, renders), _ = run_path("render", ["raster_sweep"], render)

    def shadow():
        rr, (hit, _, _) = renders[(1920, 1080)]
        shadow_work = scenes.shadow_workload(tris, rr, hit)
        pts, lv, lt, ep, fw, vs, _ = shadow_work
        occ = ray_sweep.shadow_occlusion(packed, pts, lv, lt, tr, ep, *SHADOW_CAPS)
        trace = ray_sweep.trace_rays(packed, Rays(*(x[vs] for x in fw)), tr, *TRACE_CAPS)
        return shadow_work, occ, trace

    (shadow_work, (occ, _, ovf_occ), (hit_v, _, ovf_v)), _ = run_path("shadow", ["ray_sweep"],
                                                                      shadow)

    def ploc_builds():
        out = {}
        for name, build in (("ploc", ploc.build_ploc), ("hploc", ploc.build_hploc)):
            out[name] = (build(tris), dict(ploc_ops.last_build))
        return out

    plocs, p_counts = run_path("ploc", ["ploc_round", "ploc_finish", *FRONT_KERNELS], ploc_builds)
    require(all(p_counts[k] == 2 for k in FRONT_KERNELS),
            "ploc path: each front-half kernel launched once a build (2 builds)")
    n_rounds = sum(info["rounds"] for _, info in plocs.values())
    require(p_counts["ploc_round"] == n_rounds and p_counts["ploc_nn"] == 0
            and p_counts["ploc_emit_compact"] == 0,
            f"ploc path: {p_counts['ploc_round']} fused-round launches for {n_rounds} rounds, "
            f"no B10 (ploc_nn) or B9 (ploc_emit_compact) launch")
    require(all(i["host_syncs"] == i["rounds"] + i["finish"] for _, i in plocs.values()),
            "ploc path: host syncs per build = rounds + 1 (the finisher's flag)")
    # the batched demo as a user runs it: pad the copies, build one tree each
    demo, b_counts = run_path("batched", ["batched_build"], lambda: batched.build_batched(
        batched.pad_meshes([cbox] * BATCHED_DEMO, cbox.shape[0], device=dev)[0]))
    require(b_counts["batched_build"] == 1, "batched path: one batched_build launch")
    # meshes of 65-1024 prims as a user builds them: capacities 1024 and 128
    wide_trees, w_counts = run_path("batched block", ["batched_block"], lambda: [
        batched.build_batched(k_inputs[name]) for name in ("1024x1024", "16384x128")])
    require(w_counts["batched_block"] == 2 and w_counts["batched_build"] == 0
            and w_counts["scan32"] == 0 and w_counts["refit_dense"] == 0,
            "batched block path: build_batched at capacities 1024 and 128 launches the block "
            "kernel once each and B1 (scan32), B2 (refit_dense) and the warp kernel no time")

    # the wavefront traversal of the 512^2 frame as a user runs it: pack the
    # tree, trace the packed layout and each variant of traverse_bvh2
    def wavefront():
        pk = traverse.pack_bvh2(bvh, tris)
        rr = renders[WAVEFRONT][0]
        out = {"packed": (traverse.traverse_packed(pk, bvh.n_internal, bvh.root, rr, tr),
                          traverse.last_stats)}
        for v in traverse.VARIANTS:
            out[v] = (traverse.traverse_bvh2(bvh, tris, rr, tr, v), traverse.last_stats)
        return pk, out

    (w_packed, waves), w_counts = run_path(
        "wavefront", [f"traverse_{v}" for v in TRAVERSALS], wavefront)
    require(all(w_counts[f"traverse_{v}"] == 1 for v in TRAVERSALS),
            "wavefront path: one launch of each traversal kernel")

    # the build
    cpu = lbvh.build_single_pass_aux(tris.cpu())
    gpu = (bvh, parent, first, last)
    same = all(torch.equal(bits(g.cpu()), bits(c)) and g.dtype == c.dtype
               for g, c in zip(list(gpu[0]) + list(gpu[1:]), list(cpu[0]) + list(cpu[1:])))
    require(same, "GPU Bvh2 (packed_t, left, right, root, parent, first, last) == CPU build")
    require(validate.check_root_aabb(bvh), "check_root_aabb")
    require(validate.check_bvh2_correctness(bvh, tris.shape[0]), "check_bvh2_correctness")
    require(validate.check_parent_child_consistency(bvh), "check_parent_child_consistency")
    sah = float(sah_cost_bvh2(bvh))
    require(abs(sah - SAH_PIN) <= 0.01 * SAH_PIN, f"BVH2 SAH {sah:.4f} within 1% of {SAH_PIN}")

    def same_bvh(got, want):
        return all(g.dtype == w.dtype and torch.equal(bits(g.cpu()), bits(w.cpu()))
                   for g, w in zip(got, want))

    def valid_bvh2(tree, what, pin):
        require(validate.check_root_aabb(tree) and validate.check_bvh2_correctness(tree, n_tris)
                and validate.check_parent_child_consistency(tree),
                f"{what}: check_root_aabb, check_bvh2_correctness, check_parent_child_consistency")
        cost = float(sah_cost_bvh2(tree))
        require(abs(cost - pin) <= 0.01 * pin, f"{what}: BVH2 SAH {cost:.4f} within 1% of {pin}")

    n_tris = tris.shape[0]
    require(same_bvh(bvh_two, lbvh.build_two_pass(tris.cpu())),
            "GPU two-pass Bvh2 (packed_t, left, right, root) == CPU build")
    valid_bvh2(bvh_two, "two-pass", SAH_PIN)

    # the fast topologies against B1's route, the plain oracles on the card
    # and the port's CPU run
    def same_all(got, want):
        return all(g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))

    for name, (c, lv) in topo_inputs.items():
        ape, kar = topo if name == "sponza" else (radix_tree.apetrei_topology_fast(c),
                                                  radix_tree.karras_topology_fast(c))
        b1_ape = radix_tree.apetrei_build_packed_full(c, lv)  # (l, r, parent, aabbs, root, f, l)
        b1_kar = radix_tree.karras_build_packed(c, lv)
        n_c = c.shape[0]
        require(same_all(ape, [b1_ape[k] for k in (0, 1, 2, 5, 6, 4)]),
                f"{name} (n={n_c}): apetrei_topology_fast == apetrei_build_packed_full's left, "
                f"right, parent, first, last, root (B1's route)")
        require(same_all(kar[:2], b1_kar[:2]),
                f"{name}: karras_topology_fast's left, right == karras_build_packed's (B1's route)")
        require(same_all(ape, radix_tree.apetrei_topology(c)),
                f"{name}: apetrei_topology_fast == the plain apetrei_topology on the card")
        require(same_all(kar, radix_tree.karras_topology(c)),
                f"{name}: karras_topology_fast == the plain karras_topology on the card")
        t0 = time.perf_counter()
        cpu_topo = (radix_tree.apetrei_topology_fast(c.cpu()), radix_tree.karras_topology_fast(c.cpu()))
        require(same_all(ape, cpu_topo[0]) and same_all(kar, cpu_topo[1]),
                f"{name}: both fast topologies == the port's CPU run "
                f"({time.perf_counter() - t0:.2f} s on the CPU)")

    # the collapse
    wide_cpu = collapse_fast.collapse_lbvh_to_bvh4(*cpu)
    require(same_bvh([getattr(wide, f) for f in Bvh4._fields],
                     [getattr(wide_cpu, f) for f in Bvh4._fields]),
            "GPU Bvh4 (every field) == the port's CPU collapse, bit for bit")
    require(validate.check_bvh4_correctness(wide, tris.shape[0]), "check_bvh4_correctness")
    sah4 = float(sah_cost_bvh4(wide, *triangle_aabbs(tris)))
    require(abs(sah4 - SAH4_PIN) <= 0.01 * SAH4_PIN,
            f"BVH4 SAH {sah4:.4f} within 1% of {SAH4_PIN} (BVH2 {sah:.4f})")
    small = torch.from_numpy(scenes.sponza_like(16_384)).to(dev)
    saux = lbvh.build_single_pass_aux(small)
    require(validate.check_bvh4_isomorphic(collapse_fast.collapse_lbvh_to_bvh4(*saux),
                                           collapse_cpu(saux[0])),
            "GPU fast collapse of sponza_like(16384) isomorphic to collapse_cpu")
    cat = torch.from_numpy(scenes.caterpillar())
    caux = lbvh.build_single_pass_aux(cat.to(dev))
    n_long = int(((caux[3] - caux[2] + 1) > collapse_block.S_LEN).sum())
    ccap = 2 * caux[0].n_leaves // (collapse_block.S_LEN + 1) + 2
    require(n_long > ccap, f"caterpillar: {n_long} long nodes > capacity {ccap} (overflow branch)")
    cgot = collapse_fast.collapse_lbvh_to_bvh4(*caux)
    cwant = collapse_fast.collapse_lbvh_to_bvh4(*lbvh.build_single_pass_aux(cat))
    require(all(torch.equal(getattr(cgot, f).cpu(), getattr(cwant, f)) for f in Bvh4._fields)
            and validate.check_bvh4_correctness(cgot, cat.shape[0]),
            "caterpillar: GPU Bvh4 == CPU collapse, check_bvh4_correctness")

    # the +-0 soup: each GPU Bvh2 and the Bvh4 == the port's CPU one, bit for bit
    sz_gpu = torch.from_numpy(sz).to(dev)
    zeros = sz_gpu[sz_gpu == 0]
    require(bool(torch.signbit(zeros).any()) and bool((~torch.signbit(zeros)).any()),
            f"the {SIGNED_ZERO_TRIS}-triangle +-0 soup holds +0.0 and -0.0")
    for name, build in (("single-pass", lbvh.build_single_pass), ("two-pass", lbvh.build_two_pass),
                        ("PLOC", ploc.build_ploc), ("HPLOC", ploc.build_hploc)):
        require(same_bvh(build(sz_gpu), build(sz_gpu.cpu())),
                f"+-0 soup: GPU {name} Bvh2 (packed_t, left, right, root) == CPU build, bit for bit")
    sz_wide = [collapse_fast.collapse_lbvh_to_bvh4(*lbvh.build_single_pass_aux(x)) for x in
               (sz_gpu, sz_gpu.cpu())]
    require(same_bvh(*([getattr(w, f) for f in Bvh4._fields] for w in sz_wide)),
            "+-0 soup: GPU Bvh4 == CPU collapse, bit for bit")

    # the renders
    for (rw, rh), (rr, (hit, counts, ovf)) in renders.items():
        n_hit = int((hit.prim_idx >= 0).sum())
        good = (hit.prim_idx.shape == (rw * rh,) and bool(torch.isfinite(hit.t).all())
                and bool(torch.isfinite(hit.u).all()) and 0 < n_hit)
        require(not bool(ovf), f"{rw}x{rh}: no overflow")
        require(good, f"{rw}x{rh}: {n_hit} hits, finite t/u/v of shape ({rw * rh},)")
    hit512 = renders[(512, 512)][1][0]
    image.write_png(args.image, image.shade_barycentric(hit512.prim_idx, hit512.u, hit512.v, 512, 512))
    print(f"  image: {args.image}", flush=True)

    # the shadow path: the reversed mask against the forward trace's capped
    # answer, outside the boundary strips (a blocker within 10 eps of either
    # end of a segment may flip either way); the forward trace reaches 20
    # eps past each segment so every hit within 10 eps of its end is seen
    points, live, light, eps, fwd, vsel, n_shadow = shadow_work
    require(not bool(ovf_occ) and not bool(ovf_v), "shadow_occlusion and trace_rays: no overflow")
    tmax = fwd[3][vsel]
    ext = Rays(fwd[0][vsel], fwd[1][vsel], fwd[2][vsel],
               torch.where(live[vsel], tmax + 20 * eps, -1.0))
    hit_f, _, ovf_f = ray_sweep.trace_rays(packed, ext, tr, *TRACE_CAPS)
    require(not bool(ovf_f), "forward trace 20 eps past the segments: no overflow")
    t_f = torch.where(hit_f.prim_idx >= 0, hit_f.t, torch.inf)
    occ_fwd = t_f < tmax
    boundary = ((t_f - tmax).abs() < 10 * eps) | (t_f < 10 * eps)
    occ_rev = occ[vsel]
    n_occ = int(occ.sum())
    require(0 < n_occ < n_shadow and not bool(occ[~live].any()),
            f"shadow_occlusion: {n_occ} of {n_shadow} live points occluded, no dead point")
    bad = int(((occ_rev != occ_fwd) & ~boundary).sum())
    require(bad == 0, f"reversed mask == forward capped answer outside the boundary strips "
                      f"({int(boundary.sum())} boundary rays of {vsel.numel()})")
    hit_s = hit_v.prim_idx >= 0
    require(bool(hit_s.any()) and bool((hit_s == occ_fwd)[~boundary].all()),
            f"trace_rays on the slice: {int(hit_s.sum())} hits ({int((hit_s & ~boundary).sum())} "
            f"outside the boundary strips), the forward trace's rays outside them")

    # the PLOC and HPLOC builds: the kernel path against the plain round loop on
    # the card and against the port's CPU build, all at full size
    m_int = n_tris - 1
    for name, hploc in (("ploc", False), ("hploc", True)):
        tree, info = plocs[name]
        left, right, int_packed_t = ploc_ops.ploc_build_topology_packed_reference(
            leaf_packed_t, codes, hploc=hploc, shift0=ploc.HPLOC_SHIFT0,
            shift_step=ploc.HPLOC_SHIFT_STEP)
        require(torch.equal(tree.left[:m_int], left) and torch.equal(tree.right[:m_int], right)
                and torch.equal(bits(tree.packed_t[:, :m_int]), bits(int_packed_t)),
                f"GPU {name} tree == the plain round loop's on the card ({info})")
        t0 = time.perf_counter()
        tree_cpu = getattr(ploc, f"build_{name}")(tris.cpu())
        require(same_bvh(tree, tree_cpu), f"GPU {name} Bvh2 (packed_t, left, right, root) == CPU "
                                          f"build ({time.perf_counter() - t0:.2f} s on the CPU)")
        valid_bvh2(tree, name, PLOC_SAH_PINS[name])
    wide_ploc = collapse.collapse_bvh2_to_bvh4(plocs["ploc"][0])
    require(validate.check_bvh4_correctness(wide_ploc, n_tris),
            "collapse_bvh2_to_bvh4 of the PLOC tree: check_bvh4_correctness")

    # the batched demo: the port's CPU build, every tree valid, every copy's
    # tree the same
    t0 = time.perf_counter()
    demo_cpu = batched.build_batched(b_inputs[demo_what].cpu())
    require(same_bvh(demo, demo_cpu), f"batched demo: GPU trees (packed_t, left, right, root) == "
                                      f"CPU build ({time.perf_counter() - t0:.2f} s on the CPU)")
    require(batched_valid(torch, demo, cbox.shape[0])
            and all(torch.equal(bits(f), bits(f[:1]).expand_as(f)) for f in demo),
            f"batched demo: all {BATCHED_DEMO} trees valid, each copy's tree the same")
    require(all(same_bvh(Bvh2(*got), k_got[name])
                for got, name in zip(wide_trees, ("1024x1024", "16384x128"))),
            "batched block path: build_batched's trees == the kernel's checked ones, bit for bit")
    few = k_inputs["1024x1024"][:8]
    require(same_bvh(Bvh2(*(f[:8] for f in wide_trees[0])), batched.build_batched(few.cpu())),
            "batched block path: the first 8 trees of (a) == the port's CPU build")

    # the wavefront traversal: the four variants find the same prims, the
    # stack variants and the packed engine the same hits and counts, bit for bit
    (base_hit, base_counts), _ = waves["if_if"]
    for v in TRAVERSALS:
        (hit, counts), st = waves[v]
        require(torch.equal(hit.prim_idx, base_hit.prim_idx),
                f"traverse_{v}: the prim ids of traverse_bvh2(if_if)")
        if v != "restart_trail":
            require(all(torch.equal(bits(g), bits(w)) for g, w in zip(hit, base_hit))
                    and torch.equal(counts, base_counts),
                    f"traverse_{v}: the hits and counts of traverse_bvh2(if_if), bit for bit")
        st = st.cpu().tolist()
        print(f"  traverse_{v}: {int((hit.prim_idx >= 0).sum())} hits of {counts.numel()} rays, "
              f"mean leaf visits {float(counts.double().mean())!r}, most {int(counts.max())}; "
              f"device counters: {st[0]} node steps, {st[1]} leaf steps, {st[2]} overflowed rays",
              flush=True)
    heat_path = os.path.splitext(args.image)[0] + "_heatmap.png"
    image.write_png(heat_path, image.heatmap(waves["packed"][0][1], *WAVEFRONT))
    print(f"  heat map: {heat_path}", flush=True)
    # bench.py's raster_matches_wavefront (683-695): the raster render of
    # the 512^2 frame against traverse_packed
    hit_o = waves["packed"][0][0]
    pk_, po = hit512.prim_idx.cpu().numpy(), hit_o.prim_idx.cpu().numpy()
    tk, to = hit512.t.cpu().numpy(), hit_o.t.cpu().numpy()
    both = pk_ >= 0
    diff = both & (pk_ != po)
    require(np.array_equal(pk_ >= 0, po >= 0) and np.allclose(tk[both], to[both], rtol=1e-4)
            and (np.allclose(tk[diff], to[diff], rtol=1e-3) if diff.any() else True),
            f"raster_matches_wavefront: {int(both.sum())} hits, prim match "
            f"{int((both & (pk_ == po)).sum())}/{int(both.sum())}")
    # bench.py's shadow_matches_wavefront (850-878): trace_rays on the
    # strided slice against traverse_packed capped at tmax
    srays = Rays(*(x[vsel] for x in fwd))
    hit_so, _ = traverse.traverse_packed(w_packed, bvh.n_internal, bvh.root, srays, tr)
    ps, ts = hit_v.prim_idx.cpu().numpy(), hit_v.t.cpu().numpy()
    po2, to2 = hit_so.prim_idx.cpu().numpy(), hit_so.t.cpu().numpy()
    tmax_np = srays.tmax.cpu().numpy()
    occ_w = (po2 >= 0) & (to2 < tmax_np)
    to_safe = np.where(po2 >= 0, to2, np.inf)
    boundary_w = (np.abs(to_safe - tmax_np) < 10 * eps) | (to_safe < 10 * eps)
    both_s = (ps >= 0) & occ_w
    dmask = both_s & (ps != po2)
    require(not (((ps >= 0) != occ_w) & ~boundary_w).any()
            and np.allclose(ts[both_s], to2[both_s], rtol=1e-3, atol=1e-3)
            and (np.allclose(ts[dmask], to2[dmask], rtol=1e-3, atol=1e-3) if dmask.any() else True),
            f"shadow_matches_wavefront: {int(both_s.sum())} occluded, prim match "
            f"{int((both_s & (ps == po2)).sum())}/{int(both_s.sum())} "
            f"({int(boundary_w.sum())} boundary rays of {ps.shape[0]}; "
            f"{int((occ_w & ~boundary_w).sum())} wavefront occluders outside the strips)")
    # B5's closest hits on every ray of the slice against traverse_packed,
    # each ray's tmax past its exit from the scene's world box (beyond every
    # triangle), the hit/miss sets equal on every ray: the forward rays,
    # whose hits all lie within 10 eps of their origins, with bench.py's
    # shadow tolerance (t and ties within 1e-3: a t of a few thousandths
    # carries the coordinates' rounding); and the same segments reversed,
    # from the light to each point (every ray hits), with its raster rule
    # (t within rtol 1e-4, other prims only on t ties within rtol 1e-3)
    wv = aabb.transform_point(tris.reshape(-1, 3), tr.scale, tr.quat, tr.translation)
    w_lo, w_hi = wv.amin(dim=0), wv.amax(dim=0)

    def to_the_edge(origin, direction):
        inv = 1.0 / direction
        exit_t = torch.fmax((w_lo - origin) * inv, (w_hi - origin) * inv).amin(dim=1)
        return Rays(origin, direction, torch.zeros_like(exit_t), exit_t + 10 * eps)

    n_s = srays.origin.shape[0]
    for what, s_rays, rtol, atol in (
            ("forward", to_the_edge(srays.origin, srays.direction), 1e-3, 1e-3),
            ("reversed", to_the_edge(light.expand(n_s, 3).contiguous(), -srays.direction), 1e-4,
             1e-8)):
        hit_c, _, ovf_c = ray_sweep.trace_rays(packed, s_rays, tr, *CLOSEST_CAPS)
        hit_w, _ = traverse.traverse_packed(w_packed, bvh.n_internal, bvh.root, s_rays, tr)
        pc, tc = hit_c.prim_idx.cpu().numpy(), hit_c.t.cpu().numpy()
        pw, tw = hit_w.prim_idx.cpu().numpy(), hit_w.t.cpu().numpy()
        both_c = pc >= 0
        diff_c = both_c & (pc != pw)
        flips = int(((pc >= 0) != (pw >= 0)).sum())
        worst = float(np.max(np.abs(tc[both_c] - tw[both_c]) / tw[both_c], initial=0.0))
        require(not bool(ovf_c) and flips == 0
                and np.allclose(tc[both_c], tw[both_c], rtol=rtol, atol=atol)
                and (np.allclose(tc[diff_c], tw[diff_c], rtol=1e-3, atol=atol)
                     if diff_c.any() else True),
                f"trace_rays closest hits == traverse_packed on the slice's {what} rays: "
                f"{int(both_c.sum())} hits of {n_s} rays, {flips} hit/miss flips, prim match "
                f"{int((both_c & (pc == pw)).sum())}/{int(both_c.sum())}, largest relative t "
                f"difference {worst!r}, overflow {bool(ovf_c)}")

    # the app as a user runs it (python -m tpu_bvh_torch.app) on sponza 262K at
    # 512^2: the staged builds with the raster (B4) and the speculative
    # traversal, binned SAH on the cornellbox, the batched demo on a
    # 32-triangle box; every launch counter set to 0 just before
    def app_phase():
        """Drive and check the app path; returns its launch counts."""
        app_dir = tempfile.mkdtemp(prefix="tpu_bvh_torch_app_")
        box32 = os.path.join(app_dir, "cornellbox32.obj")
        write_obj(box32, scenes._procedural_cornellbox()[:APP_BATCHED_TRIS])
        wh = ["--width", str(APP_SIZE[0]), "--height", str(APP_SIZE[1])]
        app_runs = {(b, t): ["--builder", b, "--traversal", t, "--scene", "sponza_like", *wh,
                             "--out", f"app_{b}_{t}.png"]
                    + (["--heatmap"] if (b, t) == APP_HEATMAP else [])
                    for b in APP_BUILDERS for t in ("raster", "speculative")}
        app_runs[("binned_sah", "speculative")] = [
            "--builder", "binned_sah", "--scene", "cornellbox", *wh, "--out", "app_binned_sah.png"]
        app_runs[("batched", None)] = ["--builder", "batched", "--scene", box32]

        def app_path():
            out = {}
            cwd = os.getcwd()
            os.chdir(app_dir)  # the app writes its PNGs to the working directory
            try:
                for key, argv in app_runs.items():
                    print(f"  python -m tpu_bvh_torch.app {' '.join(argv)} (at "
                          f"{time.perf_counter() - t_start:.1f} s; {smi})", flush=True)
                    buf = io.StringIO()
                    with contextlib.redirect_stdout(buf):
                        res = app.main(argv)
                    print("    " + buf.getvalue().rstrip().replace("\n", "\n    "), flush=True)
                    out[key] = (res, buf.getvalue())
            finally:
                os.chdir(cwd)
            return out

        apps, app_counts = run_path("app", ["raster_sweep", "ploc_round", "ploc_finish",
                                            "traverse_speculative", "batched_build"], app_path)
        sponza_np = scenes.sponza_like(SPONZA_TRIS)
        cpu_dev = torch.device("cpu")
        tri_aabbs_cpu = triangle_aabbs(torch.from_numpy(sponza_np))

        def cost_of(text, what):
            (line,) = [ln for ln in text.splitlines() if ln.startswith(f"{what} : ")]
            return float(line.split(" : ")[1])

        for b in APP_BUILDERS:
            t0 = time.perf_counter()
            want = app.build_staged(config.parse_args(["--cpu", "--builder", b]), sponza_np,
                                    cpu_dev, Timer(cpu_dev))
            cpu_s = time.perf_counter() - t0
            sah2 = float(sah_cost_bvh2(want))
            sah4 = float(sah_cost_bvh4(collapse.collapse_bvh2_to_bvh4(want), *tri_aabbs_cpu))
            for t in ("raster", "speculative"):
                res, text = apps[(b, t)]
                require(same_bvh(res["bvh"], want)
                        and validate.check_bvh2_correctness(res["bvh"], n_tris),
                        f"app {b}/{t}: staged Bvh2 (packed_t, left, right, root) == the staged CPU "
                        f"build ({cpu_s:.2f} s on the CPU), valid")
                got2, got4 = cost_of(text, "Bvh Cost"), cost_of(text, "Bvh4 Cost")
                require(abs(got2 - sah2) <= 1e-6 * sah2 + 5e-5
                        and abs(got4 - sah4) <= 1e-6 * sah4 + 5e-5,
                        f"app {b}/{t}: SAH lines {got2} / {got4} == the CPU build's {sah2!r} / "
                        f"{sah4!r} (printed to 4 decimals)")
            hit_r, hit_s = apps[(b, "raster")][0]["hit"], apps[(b, "speculative")][0]["hit"]
            pr, ps = hit_r.prim_idx.cpu().numpy(), hit_s.prim_idx.cpu().numpy()
            tr_, ts_ = hit_r.t.cpu().numpy(), hit_s.t.cpu().numpy()
            both = pr >= 0
            diff = both & (pr != ps)
            require(np.array_equal(pr >= 0, ps >= 0) and both.any()
                    and np.allclose(tr_[both], ts_[both], rtol=1e-4)
                    and (np.allclose(tr_[diff], ts_[diff], rtol=1e-3) if diff.any() else True),
                    f"app {b}: raster_matches_wavefront (raster against speculative): "
                    f"{int(both.sum())} hits, prim match {int((both & (pr == ps)).sum())}/"
                    f"{int(both.sum())}")
        res, text = apps[("binned_sah", "speculative")]
        require(validate.check_bvh2_correctness(res["bvh"], cbox.shape[0])
                and "Binned Sah Cost : " in text and bool((res["hit"].prim_idx >= 0).any()),
                "app binned_sah on the cornellbox: valid Bvh2, its SAH line, hits")
        res, _ = apps[("batched", None)]
        box_b = batched.pad_meshes([scenes._procedural_cornellbox()[:APP_BATCHED_TRIS]],
                                   device=cpu_dev)[0]
        box_first = Bvh2(*(f[0] for f in batched.build_batched(box_b)))
        require(same_bvh(res["bvh"], box_first),
                f"app batched demo: the first of {app.BATCHED_COPIES} trees == the CPU build")
        for key, (res, _) in apps.items():
            print(f"  app {key}: host ms {res['total_ms']!r} (extents + Morton + sort + build); "
                  f"CUDA events ms {res['device_ms']} on {smi}", flush=True)
        shutil.rmtree(app_dir)
        return app_counts

    app_counts = app_phase()

    # the sharded path (tpu_bvh_torch.parallel) on ranks of their own
    # processes: NCCL at world size 1, then SHARDED_RANKS gloo ranks sharing
    # the card; each output against the unsharded call's on the card
    def sharded_phase():
        """Drive and check the sharded path; returns its launches summed
        over the ranks."""
        from tpu_bvh_torch.parallel import comm

        print(f"  sharded path (at {time.perf_counter() - t_start:.1f} s)", flush=True)
        s_np = sponza[:(sponza.shape[0] // SHARDED_RANKS) * SHARDED_RANKS]
        require(s_np.shape[0] == n_tris, f"sponza's {n_tris} triangles split over "
                f"{SHARDED_RANKS} ranks: the main path's tree is the single-device build")

        def same_np(got, want):
            return all(g.dtype == w.cpu().numpy().dtype and g.tobytes() == w.cpu().numpy().tobytes()
                       for g, w in zip(got, want))

        runs = {}
        for world, backend, full in ((1, "nccl", False), (SHARDED_RANKS, "gloo", True)):
            t0 = time.perf_counter()
            runs[backend] = comm.spawn(sharded_rank, world, device="cuda", backend=backend,
                                       args=(s_np, cbox, full), timeout=SHARDED_DEADLINE)
            print(f"  {world} {backend} rank(s) on {torch.cuda.get_device_name(0)}: "
                  f"{time.perf_counter() - t0:.1f} s with start-up", flush=True)
            r0 = runs[backend][0]
            require(not any(r["overflow"] for r in runs[backend]) and same_np(r0["bvh"], bvh),
                    f"{backend}, world size {world}: to_bvh2(build_single_pass_sharded) on "
                    f"sponza {n_tris} == the GPU build_single_pass (packed_t, left, right, root) "
                    f"bit for bit, no overflow")
        ranks = runs["gloo"]
        tree = Bvh2(*(torch.from_numpy(f).to(dev) for f in ranks[0]["bvh"]))
        valid_bvh2(tree, f"the sharded build over {SHARDED_RANKS} gloo ranks", SAH_PIN)
        keys = aabb.min_key(bvh.packed_t[:, n_tris - 1:]).amin(dim=1)  # every leaf box
        want_ext = [aabb.from_min_key(keys[:3]), -aabb.from_min_key(keys[3:])]
        require(all(same_np(r["extents"], want_ext) for r in ranks),
                "sharded_scene_extents on every rank == the unsharded extents, bit for bit")

        def cat(key):
            return [np.concatenate(parts) for parts in zip(*(r[key] for r in ranks))]

        require(same_np(cat("batched"), demo), f"build_batched_sharded on the demo "
                f"({BATCHED_DEMO // SHARDED_RANKS} meshes a rank) == build_batched, bit for bit")
        hit_w, counts_w = waves["speculative"][0]
        require(same_np(cat("traverse"), [*hit_w, counts_w]),
                f"traverse_sharded on the {WAVEFRONT[0]}x{WAVEFRONT[1]} frame == traverse_bvh2 "
                f"on every ray (hits and counts, bit for bit)")
        require(same_np(cat("raster"), renders[WAVEFRONT][1][0]),
                f"render_raster_sharded at {WAVEFRONT[0]}x{WAVEFRONT[1]} ({SHARDED_RANKS} strips) "
                f"== render_raster_gpu on every pixel, bit for bit")

        # times: the cost of sharding on one card (ranks share the card and
        # move their collectives through host memory), not scaling
        rr = renders[WAVEFRONT][0]
        caps = RENDERS[WAVEFRONT]
        plain = {"build_single_pass_sharded": lambda: lbvh.build_single_pass(tris),
                 "sharded_scene_extents": lambda: aabb.min_key(
                     aabb.packed_bounds(tris, -2, -1)).amin(0),
                 "build_batched_sharded": lambda: batched.build_batched(b_inputs[demo_what]),
                 "traverse_sharded": lambda: traverse.traverse_bvh2(bvh, tris, rr, tr),
                 "render_raster_sharded": lambda: raster_gpu.render_raster_gpu(
                     packed, rr, tr, *WAVEFRONT, *caps)}
        for call, unsharded in SHARDED_CALLS.items():
            u_ev, u_wall = time_ms(torch, plain[call], SHARDED_REPS, warmup=1)
            ev = [r["times"][call][0] for r in ranks]
            wall = [r["times"][call][1] for r in ranks]
            line = (f"  {call}, {SHARDED_RANKS} gloo ranks on one card (the cost of sharding on "
                    f"one card, not scaling): host ms by rank {wall}, CUDA-event ms by rank {ev}; "
                    f"unsharded {unsharded}: host {u_wall!r}, events {u_ev!r} ms")
            if call == "build_single_pass_sharded":
                one = runs["nccl"][0]["times"][call]
                line += f"; NCCL world size 1: host {one[1]!r}, events {one[0]!r} ms"
            print(line + f" ({smi})", flush=True)
        return {k: sum(r["counts"][k] for run in runs.values() for r in run) for k in COUNTED}

    sharded_counts = sharded_phase()

    # phase 5: timings (medians after warm-up; host clock end to end)
    print(f"[5] timings on {smi} (ms: CUDA events / host clock to synchronize; at "
          f"{time.perf_counter() - t_start:.1f} s)", flush=True)
    ev, wall = time_ms(torch, lambda: lbvh.build_single_pass(tris), reps=10)
    print(f"  sponza_like {SPONZA_TRIS} single-pass build: {ev!r} / {wall!r} ms", flush=True)
    ev, wall = time_ms(torch, lambda: lbvh.build_two_pass(tris), reps=10)
    print(f"  two-pass build: {ev!r} / {wall!r} ms", flush=True)
    for topo_fn in (radix_tree.apetrei_topology_fast, radix_tree.karras_topology_fast):
        ev, wall = time_ms(torch, lambda: topo_fn(t_codes), reps=10)
        print(f"  {topo_fn.__name__} (sponza codes, n={t_codes.shape[0]}): {ev!r} / {wall!r} ms",
              flush=True)
    # PLOC and HPLOC run the same host code, so they are timed in 10
    # alternating pairs: a gap that holds in every pair is not host drift.
    # The hand-over widths take turns in the same loop.
    fin_width = ploc_round.FIN_WIDTH
    b_widths = sorted({*HAND_OVERS, fin_width})
    b_times = {(w, name): ([], []) for w in b_widths for name in ("ploc", "hploc")}
    p_info = {}
    for rep in range(12):  # two warm-up rounds
        for w, name in b_times:
            ploc_round.FIN_WIDTH = w
            ev, wall = time_ms(torch, lambda: getattr(ploc, f"build_{name}")(tris), reps=1,
                               warmup=0)
            p_info[(w, name)] = dict(ploc_ops.last_build)
            if rep >= 2:
                b_times[(w, name)][0].append(ev)
                b_times[(w, name)][1].append(wall)
    ploc_round.FIN_WIDTH = fin_width
    for (w, name), (evs, walls) in b_times.items():
        info = p_info[(w, name)]
        print(f"  build_{name} (FIN_WIDTH {w}{', the default' if w == fin_width else ''}): "
              f"{statistics.median(evs)!r} / {statistics.median(walls)!r} ms "
              f"(10 runs, alternating); {info['rounds']} rounds of B6, {info['finish']} B7 "
              f"launch, {info['host_syncs']} host syncs in the round loop; host ms per run "
              f"{[round(w, 3) for w in walls]}", flush=True)
    p_times = {name: b_times[(fin_width, name)] for name in ("ploc", "hploc")}
    gaps = [[h - p for h, p in zip(p_times["hploc"][k], p_times["ploc"][k])] for k in (0, 1)]
    print(f"  build_hploc - build_ploc per pair (median; pairs with HPLOC slower): events "
          f"{statistics.median(gaps[0])!r} ms ({sum(g > 0 for g in gaps[0])}/10), host "
          f"{statistics.median(gaps[1])!r} ms ({sum(g > 0 for g in gaps[1])}/10)", flush=True)
    ev, wall = time_ms(torch, lambda: collapse_fast.collapse_lbvh_to_bvh4(bvh, parent, first, last),
                       reps=10)
    print(f"  collapse_lbvh_to_bvh4: {ev!r} / {wall!r} ms", flush=True)
    for (rw, rh), caps in RENDERS.items():
        rr = renders[(rw, rh)][0]
        ev, wall = time_ms(
            torch, lambda: raster_gpu.render_raster_gpu(packed, rr, tr, rw, rh, *caps), reps=10
        )
        print(f"  render {rw}x{rh}: {ev!r} / {wall!r} ms = {rw * rh / wall / 1e3!r} Mrays/s "
              f"(host clock)", flush=True)
    ev, wall = time_ms(torch, lambda: ray_sweep.shadow_occlusion(
        packed, points, live, light, tr, eps, *SHADOW_CAPS), reps=10)
    print(f"  shadow_occlusion ({n_shadow} live of {live.numel()} rays): {ev!r} / {wall!r} ms = "
          f"{n_shadow / wall / 1e3!r} Mrays/s (host clock)", flush=True)
    srays = Rays(*(x[vsel] for x in fwd))
    ev, wall = time_ms(torch, lambda: ray_sweep.trace_rays(packed, srays, tr, *TRACE_CAPS), reps=10)
    print(f"  trace_rays ({vsel.numel()} rays): {ev!r} / {wall!r} ms = "
          f"{vsel.numel() / wall / 1e3!r} Mrays/s (host clock)", flush=True)
    warp_fns = (batched_build.batched_build, batched_build.batched_build_reference)
    block_fns = (batched_block.batched_block, batched_block.batched_block_reference)
    b_timed = [("batched_build", what, t, *warp_fns) for what, t in b_inputs.items()]
    b_timed += [("batched_block", k_what[name], t, *block_fns) for name, t in k_inputs.items()]
    for kname, what, t, kernel, plain in b_timed:
        B, M = t.shape[:2]
        k_ev = time_ms(torch, lambda: kernel(t), reps=20)[0]
        p_ev = time_ms(torch, lambda: plain(t), reps=3, warmup=1)[0]
        host = time_ms(torch, lambda: batched.build_batched(t), reps=20)[1]
        b_ms = bound(work.batched(t))[0]
        print(f"  {kname}, {what} ({B} x {M}), {smi}: kernel {k_ev!r} ms (events), plain "
              f"{p_ev!r} ms; build_batched {host!r} ms (host clock) = {B / host * 1e3!r} "
              f"meshes/s; bound {b_ms!r} ms (bytes), {b_ms / k_ev!r} of it reached", flush=True)
    few = k_inputs["1024x1024"][:BLOCK_LOOP]
    loop_ms = time_ms(torch, lambda: [lbvh.build_single_pass(t, use_extended=False)
                                      for t in few], reps=3, warmup=1)[1]
    print(f"  the per-mesh single-pass loop (the route before the block kernel) on {BLOCK_LOOP} "
          f"meshes of (a), {smi}: {loop_ms!r} ms (host clock) = {BLOCK_LOOP / loop_ms * 1e3!r} "
          f"meshes/s", flush=True)
    for what, fn, t in (("batched_build", batched_build.phase_cycles, b_inputs[demo_what]),
                        ("batched_build", batched_build.phase_cycles,
                         b_inputs[f"{BATCHED_WIDE} random meshes"]),
                        ("batched_build", batched_build.phase_cycles,
                         b_inputs[f"{BATCHED_RANDOM} random meshes"]),
                        ("batched_block", batched_block.phase_cycles, k_inputs["1024x1024"]),
                        ("batched_block", batched_block.phase_cycles, k_inputs["16384x128"])):
        print(f"  {what} phase clocks, {tuple(t.shape[:2])} (SM cycles: median, largest, sum over "
              f"the meshes; at most {sm_mhz} MHz): {fn(t)}", flush=True)
    n_wave = t_rays.origin.shape[0]
    # each traversal kernel on each input: the rows its steps stand on (the
    # same launch with the byte map set, after the main path's counts), its
    # counters and SIMD efficiency, then its events and host clock
    t_rows, t_stats, t_simd, t_times = {}, {}, {}, {}
    for what, rays in t_inputs.items():
        traverse.count_rows = True
        for v in TRAVERSALS:
            traversal(v, rays)
            t_rows[(what, v)] = traverse.last_rows.cpu().tolist()
        traverse.count_rows = False
        for v in TRAVERSALS:
            traversal(v, rays)
            t_stats[(what, v)] = traverse.last_stats.cpu().tolist()
            t_simd[(what, v)] = traverse.simd_efficiency(t_stats[(what, v)],
                                                         traverse.last_warp_steps)
        hits = traversal("packed", rays)[0].prim_idx
        n_prims = int(torch.unique(hits[hits >= 0]).numel())
        rows_v = {v: t_rows[(what, v)] for v in TRAVERSALS}
        require(all(r[0] >= 1 and r[1] >= n_prims for r in rows_v.values())
                and len({tuple(rows_v[v]) for v in TRAVERSALS[:4]}) == 1
                and (what != "frame" or all(
                    rows_v[v] == list(TRAVERSE_PINS[(what, "restart_trail" if v == "restart_trail"
                                                     else "stack")][3:]) for v in TRAVERSALS)),
                f"traversal rows stood on (internal, leaf), {TRAVERSE_INPUTS[what]}: {rows_v}; "
                f"the stack kernels and the packed one the same, every kernel the leaves of the "
                f"{n_prims} prims hit" + ("; the one-thread-a-ray kernel's" if what == "frame"
                                          else ""))
        n_r = rays.origin.shape[0]
        for v in TRAVERSALS:
            ev, wall = time_ms(torch, lambda: traversal(v, rays), reps=20)
            p_ms = (time_ms(torch, lambda: traversal(v, rays, plain=True), 1, warmup=0)[0]
                    if what != "frame" else None)  # the frame's plain time: the kernels line
            (b_ms, b_by), info = bounded(work.traverse(t_stats[(what, v)], t_rows[(what, v)], v,
                                                       n_r))
            t_times[(what, v)] = {"rays": n_r, "ms": ev, "host_ms": wall, "plain_ms": p_ms,
                                  "bound_ms": b_ms, "bound_by": b_by,
                                  "simd_efficiency": t_simd[(what, v)]}
            print(f"  traverse_{v}, {TRAVERSE_INPUTS[what]} ({n_r} rays), {smi}: {ev!r} / "
                  f"{wall!r} ms (events / host clock) = {n_r / ev / 1e3!r} / "
                  f"{n_r / wall / 1e3!r} Mrays/s; bound {b_ms!r} ms ({b_by}; {b_ms / ev!r} of it "
                  f"reached); SIMD efficiency {t_simd[(what, v)]!r}"
                  + (f"; plain {p_ms!r} ms" if p_ms is not None else "") + f"; {info}",
                  flush=True)

    mat, n, r_pt, r_first, r_last = inputs["refit"]
    rows, m_c, c_out = inputs["collapse"]
    r_args, r_out = inputs["raster"]
    so_args, so_out = inputs["ray_sweep_occl"]
    scan_out = scan32.scan_core(inputs["scan"])
    refit_out = refit_dense.refit_dense(mat, n, refit.RADIUS)
    demo_t = b_inputs[demo_what]
    wide_t = k_inputs["1024x1024"]
    # each kernel's count (bytes, flops, what it found; utils/work.py) at
    # the main path's shapes: the traversal kernels from the steps of the
    # main path's run and the rows stood on counted by the same kernel on
    # the same rays; PLOC's first round (all clusters, shift 32) for B10, B9
    # and the round; the HPLOC hand-over state for B7, whose work is the
    # clusters of each of its rounds; the threshold scans and B16 per row of
    # sponza's deltas
    p_mat, p_nn = inputs["ploc"]
    p_nodes, p_spare = junk((8, n_tris - 1)), junk(p_mat.shape)
    p_work = ploc_round.round_work(n_tris, dev)
    p_merged, p_dropped = (int((p_nn[7, :n_tris] == k).sum()) for k in (1, 2))
    f_mat, f_nc, f_shift, f_base = inputs["finish"]
    t_dlt, t_pay = inputs["threshold"]
    h32, h32f, h_m = inputs["halves"]
    plane = inputs["planes"][True]
    m_t = t_dlt.shape[0]
    half = work.per_row("scan32_half", m_t)
    counts = {
        "scan32": work.scan32(inputs["scan"], scan_out),
        "refit_dense": work.refit_dense(mat[0:6], mat[6], mat[7], refit_out),
        "collapse_block": work.collapse_block(rows[0], rows[3], c_out[0], c_out[1:], m_c),
        "raster_sweep": work.sweep("raster_sweep", r_args, r_out),
        "ray_sweep": work.sweep("ray_sweep", so_args, so_out),
        "ploc_round": work.ploc_round(n_tris, p_merged, p_dropped, R, 32),
        "ploc_finish": work.ploc_finish(f_mat, f_nc, f_shift, R, step, ploc_round.FIN_CTAS),
        "ploc_round_fused": work.ploc_round_fused(n_tris, p_merged, p_dropped, R, 32),
        "ploc_emit_compact": work.ploc_emit_compact(n_tris, p_merged, p_dropped,
                                                    p_mat.shape[1]),
        "ploc_nn": work.ploc_nn(n_tris, R, 32),
        "plane_scan": work.plane_scan(plane),
        "psv_nsv_packed": work.per_row("psv_nsv_packed", m_t),
        "psv_nsv_packed_lanes": work.per_row("psv_nsv_packed", m_t),
        "psv_nsv_payload": work.per_row("psv_nsv_payload", m_t),
        "child_positions": work.per_row("child_positions", m_t),
        "scan32_halves": (2 * half[0], 2 * half[1], f"{half[2]}, both halves"),
        "batched_build": work.batched(demo_t),
        "batched_block": work.batched(wide_t),
        **{f"traverse_{v}": work.traverse(waves[v][1].cpu(), t_rows[("frame", v)], v, n_wave)
           for v in TRAVERSALS},
        **{k: work.front_half(kind, front_inputs["sponza"][0].shape[0])
           for k, kind in FRONT_WORK.items()},
    }
    bounds = {name: bounded(c) for name, c in counts.items()}
    timed = {  # kernel, plain, kernel reps, plain reps, plain warm-up
        "scan32": (lambda: scan32.scan_core(inputs["scan"]),
                   lambda: scan32.scan_core_reference(inputs["scan"]), 20, 5, 1),
        "refit_dense": (lambda: refit_dense.refit_dense(mat, n, refit.RADIUS),
                        lambda: refit_dense.refit_dense_reference(mat, n, refit.RADIUS), 20, 5, 1),
        "collapse_block": (lambda: collapse_block.collapse_block(*rows, m_c),
                           lambda: collapse_block.collapse_block_reference(*rows, m_c), 20, 5, 1),
        "raster_sweep": (lambda: raster_gpu.raster_sweep(*r_args),
                         lambda: raster_gpu.raster_sweep_reference(*r_args), 20, 3, 1),
        "ray_sweep": (lambda: ray_sweep.ray_sweep_kernel(*so_args, True),
                      lambda: ray_sweep.ray_sweep_reference(*so_args, True), 20, 3, 1),
        "ploc_round": (
            lambda: ploc_round.ploc_round_pp(p_mat, p_spare, p_nodes, n_tris, 32, 0, R, p_work),
            lambda: ploc_round.ploc_round_pp_reference(p_mat, p_spare, p_nodes, n_tris, 32, 0, R),
            20, 5, 1),
        "ploc_finish": (
            lambda: ploc_round.ploc_finish(f_mat, p_nodes, f_nc, f_shift, f_base, R, step),
            lambda: ploc_round.ploc_finish_reference(f_mat, p_nodes, f_nc, f_shift, f_base, R,
                                                     step), 20, 3, 1),
        "ploc_emit_compact": (
            lambda: ploc_round.ploc_emit_compact(p_mat, p_nn, p_nodes, n_tris, 0),
            lambda: ploc_round.ploc_emit_compact_reference(p_mat, p_nn, p_nodes, n_tris, 0),
            20, 5, 1),
        "ploc_nn": (lambda: ploc_nn.ploc_nn_round_raw(p_mat, n_tris, 32, R),
                    lambda: ploc_nn.ploc_nn_round_raw_reference(p_mat, n_tris, 32, R), 20, 5, 1),
        "ploc_round_fused": (
            lambda: ploc_round.ploc_round_fused(p_mat, p_nodes, n_tris, 32, 0, R),
            lambda: ploc_round.ploc_round_reference(p_mat, p_nodes, n_tris, 32, 0, R), 20, 5, 1),
        "plane_scan": (lambda: plane_scan.plane_scan(plane, is_min=True, reverse=False),
                       lambda: plane_scan.plane_scan_reference(plane, is_min=True, reverse=False),
                       20, 3, 1),
        "psv_nsv_packed": (lambda: threshold_core.psv_nsv_packed(t_dlt),
                           lambda: threshold_core.psv_nsv_packed_reference(t_dlt), 20, 5, 1),
        "psv_nsv_packed_lanes": (lambda: threshold_core.psv_nsv_packed_lanes(t_dlt),
                                 lambda: threshold_core.psv_nsv_packed_reference(t_dlt), 20, 5, 1),
        "psv_nsv_payload": (lambda: threshold_core.psv_nsv_payload_auto(t_dlt, t_pay),
                            lambda: threshold_core.psv_nsv_payload_reference(t_dlt, t_pay), 20, 5,
                            1),
        "child_positions": (lambda: threshold_core.child_positions_auto(t_dlt),
                            lambda: threshold_core.child_positions_reference(t_dlt), 20, 3, 1),
        "scan32_halves": (lambda: (scan32.scan_fwd(h32), scan32.scan_rev(h32f, h_m)),
                          lambda: (scan32.scan_fwd_reference(h32),
                                   scan32.scan_rev_reference(h32f, h_m)), 20, 3, 1),
        "batched_build": (lambda: batched_build.batched_build(demo_t),
                          lambda: batched._build_batched_small(demo_t), 20, 5, 1),
        "batched_block": (lambda: batched_block.batched_block(wide_t),
                          lambda: batched_block.batched_block_reference(wide_t), 20, 3, 1),
        **{f"traverse_{v}": (lambda v=v: traversal(v, t_rays),
                             lambda v=v: traversal(v, t_rays, plain=True), 20, 1, 0)
           for v in TRAVERSALS},
        **{k: (*front_calls(front_inputs["sponza"])[k], 20, 5, 1) for k in FRONT_KERNELS},
    }
    timed = {nm: timed[nm] for nm in KERNELS}  # rows in the order B1 to B16, then the rest
    # one PyTorch call that computes the same function, timed as a yardstick
    library = {"plane_scan": lambda: torch.cummin(plane, dim=0)}
    notes = {  # what a row's launches count, where it is not kernel launches
        "refit_dense": "launches of refit_dense or refit_dense_cols (one CUDA launch each)",
        "collapse_block": "calls of collapse_block (one CUDA launch each)",
        "raster_sweep": "calls of raster_sweep (3 CUDA launches each: init, sweep, finish)",
        "ploc_finish": f"cluster launches of ploc_finish ({ploc_round.FIN_CTAS} CTAs each)",
        "ray_sweep": "calls of ray_sweep_kernel (3 CUDA launches each: init, sweep, finish)",
        "ploc_round": "rounds of ploc_round_pp (one fused-kernel launch each)",
        "ploc_round_fused": "rounds of ploc_round_fused (one fused-kernel launch each)",
        "psv_nsv_packed": "calls of the one psv/nsv kernel that B12 and B13 share",
        "psv_nsv_packed_lanes": "calls of the one psv/nsv kernel that B12 and B13 share",
        "scan32_halves": "launches of either half",
        "batched_build": "calls of batched_build (one CUDA launch each)",
        "batched_block": "calls of batched_block (one CUDA launch each)",
        "traverse_packed": "calls of traverse_packed (one CUDA launch each)",
        "front_keys": "calls of keys (one CUDA launch each; its events include the extended "
                      "code's extent copy to the host)",
        **{f"traverse_{v}": f"calls of traverse_bvh2(variant={v!r}) (one CUDA launch each)"
           for v in TRAVERSALS[1:]},
    }
    # the front half's kernels on the 4M frame, as the benchmark's rebuild
    # cells run them (the main path's 262K are the rows' own)
    front_4m = {}
    f_calls = front_calls(front_inputs["4M frame"])
    n_4m = front_inputs["4M frame"][0].shape[0]
    for name in FRONT_KERNELS:
        kfn, pfn = f_calls[name]
        k_ms = time_ms(torch, kfn, 20)[0]
        p_ms = time_ms(torch, pfn, 5, warmup=1)[0]
        b_ms, b_by = bound(work.front_half(FRONT_WORK[name], n_4m))
        front_4m[name] = {"n": n_4m, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                          "bound_by": b_by}
        print(f"  {name} on the 4M frame (n={n_4m}), {smi}: kernel {k_ms!r} ms (events), plain "
              f"{p_ms!r} ms, bound {b_ms!r} ms ({b_by})", flush=True)
    rows_json = []
    for name, (kfn, pfn, kreps, preps, pwarm) in timed.items():
        k_ms, k_wall = time_ms(torch, kfn, kreps)
        p_ms, p_wall = time_ms(torch, pfn, preps, warmup=pwarm)
        lib_ms = time_ms(torch, library[name], kreps)[0] if name in library else None
        (b_ms, b_by), info = bounds[name]
        tpu, source, replaces = KERNELS[name]
        print(f"  {tpu or 'no TPU kernel:'} {name}: kernel {k_ms!r} / {k_wall!r} ms, plain "
              f"{p_ms!r} / {p_wall!r} ms"
              + (f", library {lib_ms!r} ms" if lib_ms is not None else "")
              + f", bound {b_ms!r} ms ({b_by}), {launches[name]} "
              f"{notes.get(name, 'launches')} on the main path" + (f"; {info}" if info else ""),
              flush=True)
        row = {"name": name, "tpu_kernel": tpu, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "app_launches": app_counts[name], "sharded_launches": sharded_counts[name],
               "max_abs_err": errs[name],
               "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms}
        if name == "ploc_finish":
            print(f"  B7 counters, last timed call: "
                  f"{finish_info(ploc_round.last_finish_stats, sm_mhz)}", flush=True)
        if name in notes:
            row["launches_are"] = notes[name]
        if tpu is None:
            row["replaces_no_tpu_kernel"] = f"{replaces} is XLA ops, not a pl.pallas_call"
        if name.startswith("traverse_"):  # and on the reversed shadow slice
            v = name[len("traverse_"):]
            row.update(host_ms=k_wall, simd_efficiency=t_simd[("frame", v)],
                       shadow_rev=t_times[("shadow_rev", v)])
        if name in FRONT_KERNELS:  # and on the 4M frame; device us after the timings
            row["at_4m"] = front_4m[name]
        rows_json.append(row)
    # one call of each hand kernel at the main path's shapes through
    # introspect.cost_analysis, whose counts the wrappers report from the
    # same functions as the bounds above
    rec_names = {"psv_nsv_packed_lanes": "psv_nsv_packed"}  # B12 and B13 share a kernel
    costs = {}
    for name, (kfn, *_) in timed.items():
        op = introspect.cost_analysis(kfn)["ops"][rec_names.get(name, name)]
        costs[name] = {"bytes": op["bytes accessed"], "flops": op["flops"],
                       "optimal_seconds": op["optimal_seconds"], "calls": op["calls"]}
    print(f"  cost_analysis, one call of each hand kernel (bytes, flops, optimal_seconds, calls): "
          f"{json.dumps(costs)}", flush=True)
    require(all(c["bytes"] == counts[name][0] and c["flops"] == counts[name][1]
                and c["optimal_seconds"] * 1e3 == bounds[name][0][0] for name, c in costs.items()),
            f"cost_analysis: every hand kernel's bytes, flops and optimal_seconds equal the "
            f"count and bound printed for it ({len(costs)} kernels)")
    k_ms, _ = time_ms(torch, lambda: refit_dense.refit_dense_cols(r_pt, r_first, r_last, n,
                                                                  refit.RADIUS), 20)
    print(f"  refit_dense_cols (the main path's entry, same kernel): kernel {k_ms!r} ms", flush=True)
    for is_min in (True, False):  # B11's other modes, on the plane of its own op
        for reverse in (False, True):
            x = inputs["planes"][is_min]
            k_ms, _ = time_ms(torch, lambda: plane_scan.plane_scan(x, is_min=is_min,
                                                                   reverse=reverse), 20)
            p_ms, _ = time_ms(torch, lambda: plane_scan.plane_scan_reference(
                x, is_min=is_min, reverse=reverse), 3, warmup=1)
            lib = ""
            if not reverse:  # one call computes only the forward scan
                fn = torch.cummin if is_min else torch.cummax
                lib = f", torch.{fn.__name__} {time_ms(torch, lambda: fn(x, dim=0), 20)[0]!r} ms"
            print(f"  plane_scan {'min' if is_min else 'max'} {'reverse' if reverse else 'forward'}:"
                  f" kernel {k_ms!r} ms, plain {p_ms!r} ms{lib}", flush=True)
    for key, what, occl in (("occl", "the shadow rays, occlusion", True),
                            ("closest", "the slice, closest-hit", False),
                            ("primary", "the 1080p primary rays, closest-hit", False)):
        c_args, c_out = inputs[f"ray_sweep_{key}"]
        (b_c, _), info_c = bounded(work.sweep("ray_sweep", c_args, c_out))
        k_ms, _ = time_ms(torch, lambda: ray_sweep.ray_sweep_kernel(*c_args, occl), 20)
        split = split_info(torch, ray_sweep.last_stats, c_out, c_args[1].shape[1])
        p_ms = (time_ms(torch, lambda: ray_sweep.ray_sweep_reference(*c_args, occl), 3,
                        warmup=1)[0] if not occl else None)
        print(f"  ray_sweep on {what}: kernel {k_ms!r} ms"
              + (f", plain {p_ms!r} ms" if p_ms is not None else "")
              + f", bound {b_c!r} ms; {info_c}; last timed call: {split}", flush=True)
    for (rw, rh) in RENDERS:
        c_args, c_out = inputs[f"raster_{rw}x{rh}"]
        (b_c, _), info_c = bounded(work.sweep("raster_sweep", c_args, c_out))
        k_ms, _ = time_ms(torch, lambda: raster_gpu.raster_sweep(*c_args), 20)
        split = split_info(torch, raster_gpu.last_stats, c_out, c_args[1].shape[1], "subtiles")
        print(f"  raster_sweep at {rw}x{rh}: kernel {k_ms!r} ms, bound {b_c!r} ms; {info_c}; "
              f"last timed call: {split}", flush=True)
    for width, (mat, nc, shift, base) in sorted(inputs["hand_overs"].items()):
        buf = junk((8, base + nc - 1))  # B7 at each hand-over width
        k_ms, _ = time_ms(torch, lambda: ploc_round.ploc_finish(mat, buf, nc, shift, base, R,
                                                                step), 20)
        print(f"  ploc_finish on the HPLOC hand-over state at {width} (nc={nc}): kernel "
              f"{k_ms!r} ms; last timed call: "
              f"{finish_info(ploc_round.last_finish_stats, sm_mhz)}", flush=True)

    # one kernel a call: B2, B3, B1, B12/B13, B14, B15, B11, B16, B9 and the
    # batched builds from a profiler trace each (after the timings: a
    # profiler session can slow the host's later launches); all but B2 and
    # B3 also with no memset
    for name, fn, no_memset in (
            ("refit_dense (column entry)",
             lambda: refit_dense.refit_dense_cols(r_pt, r_first, r_last, n, refit.RADIUS), False),
            ("refit_dense (mat entry)", lambda: refit_dense.refit_dense(mat, n, refit.RADIUS),
             False),
            ("collapse_block", lambda: collapse_block.collapse_block(*rows, m_c), False),
            ("scan32", lambda: scan32.scan_core(inputs["scan"]), True),
            ("psv_nsv_packed", lambda: threshold_core.psv_nsv_packed(t_dlt), True),
            ("psv_nsv_payload", lambda: threshold_core.psv_nsv_payload_auto(t_dlt, t_pay), True),
            ("child_positions", lambda: threshold_core.child_positions_auto(t_dlt), True),
            ("plane_scan (max, forward)",
             lambda: plane_scan.plane_scan(inputs["planes"][False], is_min=False, reverse=False),
             True),
            ("plane_scan (min, reverse)",
             lambda: plane_scan.plane_scan(plane, is_min=True, reverse=True), True),
            ("scan32_halves (forward)", lambda: scan32.scan_fwd(h32), True),
            ("scan32_halves (reverse)", lambda: scan32.scan_rev(h32f, h_m), True),
            ("ploc_emit_compact",
             lambda: ploc_round.ploc_emit_compact(p_mat, p_nn, p_nodes, n_tris, 0), True),
            ("batched_build (the demo)", lambda: batched.build_batched(demo_t), True),
            ("batched_block ((a) at capacity 1024)", lambda: batched.build_batched(wide_t), True),
            *((f"{k} (sponza)", front_calls(front_inputs["sponza"])[k][0], True)
              for k in FRONT_KERNELS)):
        names, memsets = kernels_per_call(torch, fn)
        require(len(names) == 1 and (memsets == 0 or not no_memset),
                f"{name}: one kernel a call in a torch.profiler trace {names}"
                + (f", no memset ({memsets})" if no_memset else ""))
    for v in TRAVERSALS:  # the frame's camera rays: a stride-0 origin, read in place
        names, memsets = kernels_per_call(torch, lambda: traversal(v, t_rays))
        require(len(names) == 1 and memsets == 1,
                f"traverse_{v} (the {WAVEFRONT[0]}x{WAVEFRONT[1]} frame, a stride-0 origin): one "
                f"kernel and one memset (the counters) a call in a torch.profiler trace {names}")
    # the front half's kernels' device time from a profiler trace, and the
    # kernels their plain steps launch, at 262K and on the 4M frame
    rows_by_name = {row["name"]: row for row in rows_json}
    for what, inp, into in (("sponza", front_inputs["sponza"], rows_by_name),
                            ("the 4M frame", front_inputs["4M frame"], front_4m)):
        calls = front_calls(inp)
        for name in FRONT_KERNELS:
            kfn, pfn = calls[name]
            dev_us = device_us(torch, kfn, KERNEL_SYMBOLS[name])
            n_plain = len(kernels_per_call(torch, pfn)[0])
            row = into[name]
            row.update(device_us=dev_us, plain_kernels=n_plain)
            print(f"  {name} on {what} (n={inp[0].shape[0]}), {smi}: device {dev_us!r} us a call "
                  f"(torch.profiler, 5 calls), bound {row['bound_ms'] * 1e3!r} us "
                  f"({row['bound_ms'] * 1e3 / dev_us!r} of it reached); the plain steps launch "
                  f"{n_plain} kernels", flush=True)
    for name, topo_grid in (("scan32", True), ("psv_nsv_packed", False)):
        print(f"  {name} on sponza's deltas (m={m_t}): grid "
              f"{threshold_core.launch_grid(m_t, dev, topology=topo_grid)}", flush=True)
    cyc = [threshold_core.psv_nsv_phase_cycles(t_dlt) for _ in range(5)][-1]
    print(f"  psv_nsv_packed phase clocks, 5th call (SM cycles, median and most over the "
          f"blocks; at most {sm_mhz} MHz): {cyc}", flush=True)

    print(f"  done at {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows_json}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
