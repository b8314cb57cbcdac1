"""Rank bodies of the multi-rank tests (`comm.spawn` runs them, one
process a rank). Spawned ranks import this module by its name, so it
imports neither jax nor `tests.conftest`; the tests compare what the ranks
return, as numpy arrays, with the JAX package in the pytest process. The
tests import it as `torch_ranks` (pytest puts `tests/` on the path):
where another installed package is named `tests`, it shadows this
directory."""
import time

import numpy as np
import torch

from tpu_bvh_torch.models import lbvh
from tpu_bvh_torch.ops import plane_scan, raster
from tpu_bvh_torch.parallel import sharded, sharded_build
from tpu_bvh_torch.types import Bvh2, Rays, Transformation
from tpu_bvh_torch.utils import convert


def _np(t):
    return t.detach().cpu().numpy()


def _fields(nt):
    return {f: _np(v) for f, v in nt._asdict().items()}


def sharded_builds(dev, cases):
    """cases: name -> (tris f32[n, 3, 3], keyword arguments). Per case: the
    assembled Bvh2, the gathered ShardedBvh2, the overflow flag and the
    build's calls of `plane_scan.plane_scan` on this rank (counted by a
    wrapper put in its place for the build)."""
    mesh = sharded.default_mesh()
    out = {}
    real = plane_scan.plane_scan
    for name, (tris, kw) in cases.items():
        t = torch.from_numpy(tris).to(dev)
        calls = []

        def counted(*args, **kwargs):
            calls.append(kwargs)
            return real(*args, **kwargs)

        plane_scan.plane_scan = counted
        try:
            sb = sharded_build.build_single_pass_sharded(mesh, t, **kw)
        finally:
            plane_scan.plane_scan = real
        out[name] = {"bvh": _fields(sharded_build.to_bvh2(sb, t.shape[0], mesh)),
                     "gathered": _fields(sharded_build.gather(mesh, sb)),
                     "overflow": bool(sb.overflow), "plane_scans": calls}
    return out


def sharded_paths(dev, inputs):
    """`sharded.py`'s calls on the inputs given, each a dict of numpy
    arrays; returns this rank's shard of each result."""
    mesh = sharded.default_mesh()
    out = {}
    if "extents" in inputs:
        lo, hi = sharded.sharded_scene_extents(mesh, torch.from_numpy(inputs["extents"]).to(dev))
        out["extents"] = (_np(lo), _np(hi))
    if "batched" in inputs:
        out["batched"] = _fields(sharded.build_batched_sharded(
            mesh, torch.from_numpy(inputs["batched"]).to(dev)))
    if "traverse" in inputs:
        bvh, tris, rays, tr = inputs["traverse"]
        hit, counts = sharded.traverse_sharded(
            mesh, convert.to_torch(Bvh2, bvh, dev), torch.from_numpy(tris).to(dev),
            convert.to_torch(Rays, rays, dev), convert.to_torch(Transformation, tr, dev))
        out["traverse"] = (_fields(hit), _np(counts))
    if "raster" in inputs:
        scene, rays, tr, w, h, kw = inputs["raster"]
        hit = sharded.render_raster_sharded(
            mesh, convert.to_torch(raster.RasterScene, scene, dev),
            convert.to_torch(Rays, rays, dev), convert.to_torch(Transformation, tr, dev), w, h,
            **kw)
        out["raster"] = _fields(hit)
    return out


def collectives(dev):
    """Each collective of `comm.Mesh` on small per-rank tensors."""
    mesh = sharded.default_mesh()
    r, p = mesh.axis_index(), mesh.size
    x = torch.tensor([r + 1.0, -r - 0.5], device=dev)
    shift = [(s, s + 1) for s in range(p - 1)]
    ring = [(s, (s + 1) % p) for s in range(p)]
    try:
        sharded.default_mesh(p + 1)
        mismatch = None
    except ValueError as e:
        mismatch = str(e)
    return {"rank": r, "all_gather": _np(mesh.all_gather(x)),
            "all_gather_bool": _np(mesh.all_gather(torch.tensor([r % 2 == 0], device=dev))),
            "pmin": _np(mesh.pmin(x)), "pmax": _np(mesh.pmax(x)),
            "pmax_int": _np(mesh.pmax(torch.tensor(r * 3, device=dev))),
            "shift": _np(mesh.ppermute(x, shift)), "ring": _np(mesh.ppermute(x, ring)),
            "int_shift": _np(mesh.ppermute(torch.arange(3, device=dev) + 10 * r, shift)),
            "mismatch": mismatch}


def sleeper(dev, seconds):
    """A rank that outlives its launch's deadline."""
    time.sleep(seconds)


def fails_on_rank_1(dev):
    """Rank 1 raises; rank 0 waits on a collective rank 1 never joins."""
    mesh = sharded.default_mesh()
    if mesh.axis_index() == 1:
        raise RuntimeError("rank 1 gives up")
    mesh.all_gather(torch.zeros(1, device=dev))


def sharded_vs_single(dev, tris):
    """The sharded build against the single-device build on this rank's
    device, bit for bit (floats by their i32 bits); True on every rank that
    agrees."""
    mesh = sharded.default_mesh()
    t = torch.from_numpy(tris).to(dev)
    sb = sharded_build.build_single_pass_sharded(mesh, t)
    got = sharded_build.to_bvh2(sb, t.shape[0], mesh)
    want = lbvh.build_single_pass(t)
    bits = lambda v: v.view(torch.int32) if v.dtype == torch.float32 else v  # noqa: E731
    same = all(g.dtype == w.dtype and torch.equal(bits(g), bits(w)) for g, w in zip(got, want))
    return {"same": bool(same), "overflow": bool(sb.overflow), "device": str(t.device),
            "backend": mesh.backend}


def fields_equal(a, b):
    """Dicts of numpy arrays equal byte for byte."""
    return a.keys() == b.keys() and all(
        np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        and np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a)
