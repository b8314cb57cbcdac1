#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (`tpu_bvh_torch`) on one card.

Drives the port's main path at sponza scale (262K triangles): the
single-pass LBVH build, then `pack_raster` and the raster render at 512^2
and 1920x1080. On the way it

1. prints the card (name and power limit from nvidia-smi) and versions;
2. builds the three CUDA kernels from `tpu_bvh_torch/csrc/` and times it;
3. holds each kernel against its plain PyTorch version on the card: the
   topology scan and the dense refit bit-exact on sponza and on a soup of
   duplicated triangles (tie-heavy Morton codes), the raster sweep
   bit-exact in all five outputs (t, prim, u, v, count) at 512^2 and at
   1920x1080 with the renders' caps;
4. runs the slice with every launch counter reset first, and checks the
   GPU tree is bit-identical to the port's CPU build, the validity checks,
   the SAH against its pin, no raster overflow, and that every kernel of
   the path launched; the 512^2 image is written as a PNG;
5. times the build and the renders (medians after warm-up, on CUDA events
   and on the host clock) and each kernel beside its plain version.

Any failure raises. The last two lines are the nvidia-smi line and
{"ok": true, "device": {...}}. Needs one CUDA device and nvcc; it imports
no JAX.

Usage: python3 chip_smoke.py [--image PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

SPONZA_TRIS = 262_000
SAH_PIN = 333.01  # BVH2 SAH of the sponza_like single-pass tree (a tree property)
LEAF = 64
RENDERS = {  # (width, height): (cand_cap, pair_cap, group), as the JAX bench uses them
    (512, 512): (1024, 4096, 32),
    (1920, 1080): (1024, 8192, 32),
}


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", default=os.path.join(tempfile.gettempdir(),
                                                    "tpu_bvh_torch_sponza_512.png"),
                    help="where to write the 512^2 render (PNG)")
    return ap.parse_args()


def time_ms(torch, fn, reps, warmup=2):
    """Median milliseconds of `fn` after warm-up, two ways: between CUDA
    events on the stream, and on the host clock up to the end of a
    synchronize. End-to-end times (build, render) are read on the host
    clock: those calls are bound by the host's launch rate, which the
    events do not fully see."""
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


def main():
    args = parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_bvh_torch.models import lbvh
    from tpu_bvh_torch.ops import raster, raster_gpu, radix_tree, refit, refit_dense, scan32
    from tpu_bvh_torch.utils import camera, image, kernels, scenes, validate
    from tpu_bvh_torch.utils.cost import sah_cost_bvh2

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
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
        print(f"[2] kernel build: {time.perf_counter() - t0:.2f} s "
              f"(nvcc {kernels.build_seconds:.2f} s)", flush=True)

    # phase 3: each kernel against its plain version on the card
    print("[3] kernels vs plain versions", flush=True)
    sponza = scenes.sponza_like(SPONZA_TRIS)
    rng = np.random.default_rng(0)
    dup = np.repeat(sponza[rng.choice(len(sponza), 4096, replace=False)], 64, axis=0)
    errs = {"scan32": 0.0, "refit_dense": 0.0}
    inputs = {}

    def max_err(got, want):
        return max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))

    for name, soup in (("sponza", sponza), ("dup", dup)):
        tris = torch.from_numpy(soup).to(dev)
        codes, leaf_packed_t, _ = lbvh._sorted_leaves_from_tris(tris, True)
        dlt_raw = radix_tree.adjacent_deltas(codes)
        m = dlt_raw.shape[0]
        got = scan32.scan_core(dlt_raw)
        want = scan32.scan_core_reference(dlt_raw)
        torch.cuda.synchronize()
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"scan kernel == plain, bit-exact, {name} m={m}")
        errs["scan32"] = max(errs["scan32"], max_err(got, want))
        first, last = got[0] + 1, got[3]
        n = m + 1
        edge = torch.full((1,), n - 1, dtype=torch.int32, device=dev)
        mat = torch.cat([leaf_packed_t.contiguous().view(torch.int32),
                         torch.cat([first, edge])[None], torch.cat([last, edge])[None]])
        got = refit_dense.refit_dense(mat, n, refit.RADIUS)
        want = refit_dense.refit_dense_reference(mat, n, refit.RADIUS)
        torch.cuda.synchronize()
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"refit kernel == plain, bit-exact, {name} n={n}")
        errs["refit_dense"] = max(errs["refit_dense"], max_err(got, want))
        if name == "sponza":
            inputs["scan"] = dlt_raw
            inputs["refit"] = (mat, n)

    tris = torch.from_numpy(sponza).to(dev)
    tr, cam = scenes.preset("sponza", dev)
    bvh = lbvh.build_single_pass(tris)
    packed = raster.pack_raster(bvh, tris, leaf_size=LEAF)
    # The sweep is bit-exact by design (no FMA, IEEE division, the plain
    # version's order), so all five outputs must be equal, at the shapes
    # and caps of both renders of the main path (1080p padded to 1920x1088).
    errs["raster_sweep"] = 0.0
    for (rw, rh), caps in RENDERS.items():
        rays, w, h = raster_gpu.pad_rays(camera.generate_rays(cam, rw, rh), rw, rh)
        sweep, _, ovf = raster_gpu.prepare_sweep(packed, rays, tr, w, h, *caps)
        require(not bool(ovf), f"{rw}x{rh} pair list fits its caps {caps}")
        got = raster_gpu.raster_sweep(*sweep)
        want = raster_gpu.raster_sweep_reference(*sweep)
        torch.cuda.synchronize()
        for field, g, x in zip(("t", "prim", "u", "v", "count"), got, want):
            require(torch.equal(g, x), f"raster kernel {field} == plain, bit-exact, {rw}x{rh}")
        require(bool((got[1] >= 0).any()), f"raster {rw}x{rh}: {int((got[1] >= 0).sum())} hits")
        errs["raster_sweep"] = max(errs["raster_sweep"], max_err(got, want))
        if (rw, rh) == (512, 512):
            sweep_args = sweep

    # phase 4: the slice, through the entry points a user calls
    print(f"[4] slice: sponza_like({SPONZA_TRIS}) build -> pack_raster -> render", flush=True)
    modules = {"scan32": scan32, "refit_dense": refit_dense, "raster_sweep": raster_gpu}
    for mod in modules.values():
        mod.launches = 0
    bvh, parent, first, last = lbvh.build_single_pass_aux(tris)
    packed = raster.pack_raster(bvh, tris, leaf_size=LEAF)
    renders = {}
    for (rw, rh), caps in RENDERS.items():
        rr = camera.generate_rays(cam, rw, rh)
        renders[(rw, rh)] = (rr, raster_gpu.render_raster_gpu(packed, rr, tr, rw, rh, *caps))
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in modules.items()}
    print(f"  launches in the slice: {launches}", flush=True)
    require(all(v > 0 for v in launches.values()), "every kernel of the path launched")

    cpu = lbvh.build_single_pass_aux(tris.cpu())
    gpu = (bvh, parent, first, last)
    same = all(torch.equal(g.cpu(), c) and g.dtype == c.dtype
               for g, c in zip(list(gpu[0]) + list(gpu[1:]), list(cpu[0]) + list(cpu[1:])))
    require(same, "GPU Bvh2 (packed_t, left, right, root, parent, first, last) == CPU build")
    require(validate.check_root_aabb(bvh), "check_root_aabb")
    require(validate.check_bvh2_correctness(bvh, tris.shape[0]), "check_bvh2_correctness")
    require(validate.check_parent_child_consistency(bvh), "check_parent_child_consistency")
    sah = float(sah_cost_bvh2(bvh))
    require(abs(sah - SAH_PIN) <= 0.01 * SAH_PIN, f"BVH2 SAH {sah:.4f} within 1% of {SAH_PIN}")
    for (rw, rh), (rr, (hit, counts, ovf)) in renders.items():
        n_hit = int((hit.prim_idx >= 0).sum())
        good = (hit.prim_idx.shape == (rw * rh,) and bool(torch.isfinite(hit.t).all())
                and bool(torch.isfinite(hit.u).all()) and 0 < n_hit)
        require(not bool(ovf), f"{rw}x{rh}: no overflow")
        require(good, f"{rw}x{rh}: {n_hit} hits, finite t/u/v of shape ({rw * rh},)")
    hit512 = renders[(512, 512)][1][0]
    image.write_png(args.image, image.shade_barycentric(hit512.prim_idx, hit512.u, hit512.v, 512, 512))
    print(f"  image: {args.image}", flush=True)

    # phase 5: timings (medians after warm-up; host clock end to end)
    print(f"[5] timings on {smi} (ms: CUDA events / host clock to synchronize)", flush=True)
    ev, wall = time_ms(torch, lambda: lbvh.build_single_pass(tris), reps=10)
    print(f"  sponza_like {SPONZA_TRIS} single-pass build: {ev!r} / {wall!r} ms", flush=True)
    for (rw, rh), caps in RENDERS.items():
        rr = renders[(rw, rh)][0]
        ev, wall = time_ms(
            torch, lambda: raster_gpu.render_raster_gpu(packed, rr, tr, rw, rh, *caps), reps=10
        )
        print(f"  render {rw}x{rh}: {ev!r} / {wall!r} ms = {rw * rh / wall / 1e3!r} Mrays/s "
              f"(host clock)", flush=True)
    mat, n = inputs["refit"]
    timed = {
        "scan32": (lambda: scan32.scan_core(inputs["scan"]),
                   lambda: scan32.scan_core_reference(inputs["scan"]), 20, 5),
        "refit_dense": (lambda: refit_dense.refit_dense(mat, n, refit.RADIUS),
                        lambda: refit_dense.refit_dense_reference(mat, n, refit.RADIUS), 20, 5),
        "raster_sweep": (lambda: raster_gpu.raster_sweep(*sweep_args),
                         lambda: raster_gpu.raster_sweep_reference(*sweep_args), 20, 3),
    }
    info = {
        "scan32": ("tpu_bvh_torch/csrc/scan32.cu", "tpu_bvh/ops/pallas/scan32.py:280"),
        "refit_dense": ("tpu_bvh_torch/csrc/refit_dense.cu", "tpu_bvh/ops/pallas/refit_dense.py:102"),
        "raster_sweep": ("tpu_bvh_torch/csrc/raster.cu", "tpu_bvh/ops/raster_tpu.py:366"),
    }
    rows = []
    for name, (kfn, pfn, kreps, preps) in timed.items():
        k_ms, k_wall = time_ms(torch, kfn, kreps)
        p_ms, p_wall = time_ms(torch, pfn, preps, warmup=1)
        print(f"  {name}: kernel {k_ms!r} / {k_wall!r} ms, plain {p_ms!r} / {p_wall!r} ms",
              flush=True)
        rows.append({"name": name, "route": "cuda", "source": info[name][0],
                     "replaces": info[name][1], "launches": launches[name],
                     "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms})

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
