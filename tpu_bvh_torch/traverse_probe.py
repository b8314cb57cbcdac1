"""Probe of the one-thread-a-ray traversal kernel: what holds it back.

The wavefront traversal's first CUDA kernel (`csrc/traverse.cu` as of
commit 4b1de15: one thread a ray for life, a grid of ceil(n / 128) blocks,
three 64-bit counters added once a warp with `atomicAdd`) is built here
from a checkout of that commit in three copies, each from its source with
a few lines patched in:

* as it is: its registers and spills (`ptxas -v`), its occupancy limit
  (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`) and its device time;
* with the counters' global atomics removed (the warp sums are kept, so
  only the atomics go): its device time, timed in turns with the first;
* with probes: every warp's life on its SM (`clock64` at its start and
  end, `%smid`), from which the achieved occupancy is the warps' summed
  lives over each SM's busy span, over 64 warps an SM; and the SIMD
  efficiency two ways, lane steps over 32 x the warps' step issues (the
  lanes that run a step together, `__activemask`) and lane steps over 32 x
  the most steps any lane of the warp took.

Inputs: the sponza_like(262,000) single-pass tree; the 512^2 sponza frame
(262,144 rays, mostly misses) and the reversed shadow slice (65,536 rays
from the point light toward the 1080p frame's hit points, all hit), on the
packed rows and on the Bvh2 layout. Device time: CUDA events around 20
back-to-back launches (each with its counters' memset), over 20, median of
the turns. Needs one CUDA device and nvcc.

Usage: python3 -m tpu_bvh_torch.traverse_probe --src DIR [--out FILE]
(DIR: the root of the checkout whose traverse.cu is probed.) The last
line of the output is a JSON summary.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import tempfile

import torch

from .utils import kernels

SM_WARPS = 64  # resident warps an SM holds at most (H100)
_P, _I = ctypes.c_void_p, ctypes.c_int
# the probed kernel's C entries: contiguous origins and directions, the
# transform as f32[10], three counters
SIGNATURES = {
    "tbvh_traverse_bvh2": [_I, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _I, _P,
                           _P, _P, _P, _P, _P, _P, _P, _P],
    "tbvh_traverse_packed": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "tbvh_probe_occupancy": [_I, _P],
}
PROBE_WORDS = 8 + 4 * 256  # totals, then per SM: lives, ~first start, last end, warps
SHAPES = {"packed": None, "if_if": 0, "while_while": 1, "speculative": 2, "restart_trail": 3}

_HEAD = """
__device__ unsigned long long tbvh_probe[%d];
extern "C" int tbvh_probe_reset(cudaStream_t s) {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, tbvh_probe);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemsetAsync(p, 0, sizeof(tbvh_probe), s);
}
extern "C" int tbvh_probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, tbvh_probe, sizeof(tbvh_probe));
}
""" % PROBE_WORDS

_TAIL = """
extern "C" int tbvh_probe_occupancy(int shape, int* out) {
  const void* f = nullptr;
  switch (shape) {
    case 0: f = (const void*)traverse_kernel<Bvh2Nodes, kIfIf>; break;
    case 1: f = (const void*)traverse_kernel<Bvh2Nodes, kWhileWhile>; break;
    case 2: f = (const void*)traverse_kernel<Bvh2Nodes, kSpeculative>; break;
    case 3: f = (const void*)traverse_kernel<Bvh2Nodes, kRestart>; break;
    default: f = (const void*)traverse_kernel<PackedNodes, kIfIf>;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, f, kBlock, 0);
}
"""

_ISSUE = "if ((threadIdx.x & 31) == __ffs(__activemask()) - 1) ++issues;"

_EPILOGUE = """  {  // probe: the warp's most lane steps, step issues and life on its SM
    const unsigned mx = __reduce_max_sync(kFull, ray.node_steps + ray.leaf_steps);
    const unsigned iss = __reduce_add_sync(kFull, ray.issues);
    const long long probe_t1 = clock64();
    if ((threadIdx.x & 31) == 0) {
      unsigned smid;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
      atomicAdd(&tbvh_probe[0], static_cast<u64>(mx));
      atomicAdd(&tbvh_probe[1], static_cast<u64>(iss));
      atomicAdd(&tbvh_probe[2], 1ull);
      u64* sm = tbvh_probe + 8 + 4 * (smid & 255);
      atomicAdd(&sm[0], static_cast<u64>(probe_t1 - probe_t0));
      atomicMax(&sm[1], ~static_cast<u64>(probe_t0));
      atomicMax(&sm[2], static_cast<u64>(probe_t1));
      atomicAdd(&sm[3], 1ull);
    }
  }
"""

_ATOMICS = """  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&stats[0], static_cast<u64>(ns));
    atomicAdd(&stats[1], static_cast<u64>(ls));
    if (ov) atomicAdd(&stats[2], static_cast<u64>(ov));
  }"""

# a store that never fires keeps the warp sums (and the counts) alive
_NO_ATOMICS = """  if ((threadIdx.x & 31) == 0 && (ns & ls & ov) == 0xffffffffu) stats[0] = ns;"""


def _patch(src, old, new):
    if src.count(old) != 1:
        raise RuntimeError(f"traverse_probe: expected one {old.strip()[:60]!r} in the source")
    return src.replace(old, new)


def variants(src):
    """The three sources: as it is, without the counters' atomics, with probes."""
    base = src + _TAIL
    bare = _patch(base, _ATOMICS, _NO_ATOMICS)
    probe = _patch(base, '#include "common.cuh"\n', '#include "common.cuh"\n' + _HEAD)
    probe = _patch(probe, "  const int i = blockIdx.x * kBlock + threadIdx.x;\n",
                   "  const int i = blockIdx.x * kBlock + threadIdx.x;\n"
                   "  const long long probe_t0 = clock64();\n")
    probe = _patch(probe, "  unsigned node_steps, leaf_steps;\n",
                   "  unsigned node_steps, leaf_steps, issues = 0;\n")
    probe = _patch(probe, "    ++node_steps;\n", f"    ++node_steps;\n    {_ISSUE}\n")
    probe = _patch(probe, "    ++leaf_steps;\n", f"    ++leaf_steps;\n    {_ISSUE}\n")
    probe = _patch(probe, "  const unsigned ns = __reduce_add_sync(kFull, ray.node_steps);\n",
                   _EPILOGUE + "  const unsigned ns = __reduce_add_sync(kFull, ray.node_steps);\n")
    return {"as_is": base, "no_atomics": bare, "probe": probe}


def build(src_root, work):
    """nvcc each variant into a shared library (all at once); returns the
    loaded libraries and the as-is build's ptxas report."""
    csrc = os.path.join(src_root, "tpu_bvh_torch", "csrc")
    with open(os.path.join(csrc, "traverse.cu")) as f:
        srcs = variants(f.read())
    nvcc = kernels._nvcc()
    procs = {}
    for name, text in srcs.items():
        cu = os.path.join(work, f"traverse_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(work, f"libprobe_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", csrc, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, reports = {}, {}
    for name, (so, p) in procs.items():
        reports[name] = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{reports[name]}")
        lib = ctypes.CDLL(so)
        for fn, args in SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        if name == "probe":
            lib.tbvh_probe_reset.argtypes = [_P]
            lib.tbvh_probe_read.argtypes = [_P]
        libs[name] = lib
    return libs, reports["as_is"]


def kernel_report(report):
    """ptxas's registers, stack and spills of each traverse_kernel instance."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S*traverse_kernel\S*)'", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and ("stack frame" in line or "Used" in line):
            out[name].append(line.split(":", 1)[-1].strip() if "Used" in line else line.strip())
    return {k: "; ".join(v) for k, v in out.items()}


class Launcher:
    """One variant's launch on fixed inputs (the old C signature: contiguous
    origins, the transform as f32[10])."""

    def __init__(self, lib, kernel, bvh, tris, packed, rays, tr):
        self.lib, self.kernel = lib, kernel
        dev = tris.device
        self.origin = rays.origin.contiguous()
        self.direction = rays.direction.contiguous()
        self.n = self.origin.shape[0]
        self.trv = torch.cat([tr.translation, tr.scale, tr.quat]).contiguous()
        self.root = torch.as_tensor(bvh.root, device=dev).to(torch.int32).reshape(())
        self.outs = [torch.empty(self.n, dtype=d, device=dev)
                     for d in (torch.int32, torch.float32, torch.float32, torch.float32,
                               torch.int32)]
        self.stats = torch.zeros(3, dtype=torch.int64, device=dev)
        self.bvh, self.tris, self.packed = bvh, tris, packed
        self.stream = kernels.stream_of(self.origin)

    def __call__(self):
        self.stats.zero_()
        o = [x.data_ptr() for x in self.outs]
        b = self.bvh
        if self.kernel == "packed":
            err = self.lib.tbvh_traverse_packed(
                self.packed.data_ptr(), self.packed.shape[0], b.n_internal, self.root.data_ptr(),
                self.origin.data_ptr(), self.direction.data_ptr(), self.n, self.trv.data_ptr(),
                *o, self.stats.data_ptr(), None, self.stream)
        else:
            err = self.lib.tbvh_traverse_bvh2(
                SHAPES[self.kernel], b.packed_t.data_ptr(), b.left.data_ptr(),
                b.right.data_ptr(), b.n_nodes, b.n_internal, self.root.data_ptr(),
                self.tris.data_ptr(), self.tris.shape[0], self.origin.data_ptr(),
                self.direction.data_ptr(), self.n, self.trv.data_ptr(), *o,
                self.stats.data_ptr(), None, self.stream)
        kernels.check(f"probe {self.kernel}", err)


def device_ms(fn, launches=20):
    """CUDA-event ms per launch over back-to-back launches."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(launches):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / launches


def probe(lib, run):
    """One probed launch: (SIMD efficiency by issues, by the most lane steps,
    achieved occupancy, warps, SMs used)."""
    kernels.check("probe reset", lib.tbvh_probe_reset(run.stream))
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * PROBE_WORDS)()
    kernels.check("probe read", lib.tbvh_probe_read(buf))
    st = run.stats.cpu().tolist()
    lane_steps = st[0] + st[1]
    max_lane, issues, warps = buf[0], buf[1], buf[2]
    lives = spans = used = 0
    for s in range(256):
        life, first, last, nw = buf[8 + 4 * s: 12 + 4 * s]
        if nw:
            lives += life
            spans += last - ((1 << 64) - 1 - first)
            used += 1
    return {"stats": st, "warps": warps, "sms": used,
            "simd_by_issues": lane_steps / (32 * issues),
            "simd_by_max_lane": lane_steps / (32 * max_lane),
            "achieved_occupancy": lives / spans / SM_WARPS}


def inputs(dev):
    """The sponza tree and its two inputs: the 512^2 frame and the reversed
    shadow slice (as profile_slice builds them)."""
    from .models import lbvh
    from .ops import raster, raster_gpu, traverse
    from .profile_slice import LEAF, RENDERS, SPONZA_TRIS, reversed_shadow_slice
    from .utils import camera, scenes

    tris = torch.from_numpy(scenes.sponza_like(SPONZA_TRIS)).to(dev)
    tr, cam = scenes.preset("sponza", dev)
    bvh = lbvh.build_single_pass(tris)
    rays = camera.generate_rays(cam, 1920, 1080)
    rp = raster.pack_raster(bvh, tris, leaf_size=LEAF)
    hit = raster_gpu.render_raster_gpu(rp, rays, tr, 1920, 1080, *RENDERS[(1920, 1080)])[0]
    work = scenes.shadow_workload(tris, rays, hit)
    return bvh, tris, traverse.pack_bvh2(bvh, tris), tr, {
        "frame_512": camera.generate_rays(cam, 512, 512),
        "shadow_rev": reversed_shadow_slice(work[2], work[4], work[5])}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="root of the checkout whose traverse.cu to probe")
    ap.add_argument("--kernels", nargs="*", default=list(SHAPES))
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("traverse_probe: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi} | torch {torch.__version__} | cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda:0")
    with tempfile.TemporaryDirectory() as work:
        libs, report = build(args.src, work)
        regs = kernel_report(report)
        for k, v in regs.items():
            print(f"  ptxas {k}: {v}", flush=True)
        bvh, tris, packed, tr, ray_sets = inputs(dev)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rows = []
        for what, rays in ray_sets.items():
            for kernel in args.kernels:
                runs = {name: Launcher(lib, kernel, bvh, tris, packed, rays, tr)
                        for name, lib in libs.items()}
                per_sm = ctypes.c_int(0)
                kernels.check("occupancy", libs["as_is"].tbvh_probe_occupancy(
                    -1 if kernel == "packed" else SHAPES[kernel], ctypes.byref(per_sm)))
                for r in runs.values():
                    r()
                torch.cuda.synchronize()
                times = {"as_is": [], "no_atomics": []}
                for _ in range(args.turns):  # in turns: as is, bare, bare, as is
                    for name in ("as_is", "no_atomics", "no_atomics", "as_is"):
                        times[name].append(device_ms(runs[name]))
                row = {"input": what, "kernel": kernel, "rays": runs["as_is"].n,
                       "blocks_per_sm": per_sm.value,
                       "theoretical_occupancy": per_sm.value * 4 / SM_WARPS,
                       "grid": -(-runs["as_is"].n // 128), "sms": sms,
                       "device_ms": statistics.median(times["as_is"]),
                       "device_ms_no_atomics": statistics.median(times["no_atomics"]),
                       **probe(libs["probe"], runs["probe"])}
                if row["stats"] != runs["as_is"].stats.cpu().tolist():
                    raise AssertionError(f"{kernel} on {what}: the probed counters differ")
                rows.append(row)
                print(f"  {what} {kernel}: {json.dumps(row)}", flush=True)
    print(json.dumps({"card": smi, "registers": regs, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
