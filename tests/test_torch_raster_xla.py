"""The XLA raster engine's port (`ops/raster.py`: `tile_order`,
`bin_treelets`, `_sweep`, `render_raster_xla`) against
`tpu_bvh.ops.raster` on the CPU.

Prims and counts are exact. t, u and v are compared by their bits
against JAX run op by op (`jax.disable_jit()`, or eagerly for the small
functions) at 64^2 through both passes past the overflow: jitted XLA
contracts the sweep's plane sums and products into FMAs. Where the
op-by-op JAX run is too slow for the suite (the cornellbox at 256^2,
about 10 s, and `sponza_like(8192)` at 128^2, about 30 s), t, u and v
are held against the jitted run within rtol 1e-5 and atol 1e-5 (the
contraction moves them by a few ulps of the plane values they are formed
from).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bvh.models import lbvh as jlbvh
from tpu_bvh.ops import raster as jraster
from tpu_bvh.utils import camera as jcamera
from tpu_bvh.utils import scenes as jscenes
from tpu_bvh_torch.ops import raster
from tpu_bvh_torch.ops.aabb import transform_point
from tpu_bvh_torch.types import Rays, Transformation
from tpu_bvh_torch.utils import convert


def bits(x):
    return x.numpy().tobytes() if isinstance(x, torch.Tensor) else np.asarray(x).tobytes()


def frame(make, preset, w, h, leaf):
    """A JAX single-pass tree, its packing, the rays and transform, and
    the port's copies."""
    tris_np = make()
    tris = jnp.asarray(tris_np)
    tr, cam = jscenes.preset(preset)
    rays = jcamera.generate_rays(cam, w, h)
    pk = jraster.pack_raster(jlbvh.build_single_pass(tris), tris, leaf_size=leaf)
    port = (raster.RasterScene(torch.from_numpy(np.array(pk.tris_sorted)),
                               torch.from_numpy(np.array(pk.prim_ids)), pk.n_real, leaf),
            convert.to_torch(Rays, rays, "cpu"), convert.to_torch(Transformation, tr, "cpu"))
    return (pk, rays, tr), port


@pytest.mark.parametrize("w,h,tile", [(32, 32, 16), (64, 48, 16), (96, 80, 8)])
def test_tile_order_matches_jax(w, h, tile):
    got = raster.tile_order(w, h, tile)
    assert np.array_equal(got.numpy(), np.asarray(jraster.tile_order(w, h, tile)))
    assert torch.equal(torch.sort(got).values, torch.arange(w * h))


def test_tile_order_refuses_partial_tiles():
    with pytest.raises(ValueError):
        raster.tile_order(40, 32, 16)


def test_sweep_matches_jax():
    (jpk, jrays, jtr), (pk, rays, tr) = frame(jscenes.cornellbox, "cornellbox", 32, 32, 16)
    wt = transform_point(pk.tris_sorted, tr.scale, tr.quat, tr.translation)
    coefs, t0 = raster._moller_coefs(wt, rays.origin[0])
    t0 = torch.where(pk.prim_ids >= 0, t0, 0.0)
    dirs = rays.direction.reshape(4, 256, 3)
    got = raster._sweep(dirs, coefs[None].expand(4, -1, -1, -1), t0[None].expand(4, -1))
    want = jraster._sweep(jnp.asarray(dirs[1].numpy()), jnp.asarray(coefs.numpy()),
                          jnp.asarray(t0.numpy()))
    assert all(bits(g[1]) == bits(w) for g, w in zip(got, want))
    for b in range(4):  # the batched sweep is the sweep of each tile
        one = raster._sweep(dirs[b], coefs, t0)
        assert all(bits(g[b]) == bits(o) for g, o in zip(got, one))
    assert (got[0] < raster.BIG).any() and (got[0] == raster.BIG).any()


def test_bin_treelets_matches_jax():
    (jpk, jrays, jtr), (pk, rays, tr) = frame(jscenes.cornellbox, "cornellbox", 64, 64, 4)
    wt = transform_point(pk.tris_sorted, tr.scale, tr.quat, tr.translation)
    bmin, bmax = raster._treelet_aabbs(wt, pk.prim_ids, 4)
    eye = rays.origin[0]
    perm = raster.tile_order(64, 64, 16)
    dirs = rays.direction[perm]
    for cap in (4, 32):  # overflowing and not
        got = raster.bin_treelets(eye, dirs, bmin, bmax, 16, 256, cap)
        want = jraster.bin_treelets(*(jnp.asarray(x.numpy()) for x in (eye, dirs, bmin, bmax)),
                                    16, 256, cap)
        assert bits(got.cand) == bits(want.cand) and bits(got.t_lb) == bits(want.t_lb)
        assert bits(got.counts) == bits(want.counts)
        assert bool(got.overflow) == bool(want.overflow) == (cap == 4)


def assert_hits(got, want, exact=True):
    (gh, gc, govf), (wh, wc, wovf) = got, want
    assert bool(govf) == bool(wovf)
    assert np.array_equal(gh.prim_idx.numpy(), np.asarray(wh.prim_idx))
    assert np.array_equal(gc.numpy(), np.asarray(wc).astype(np.int32))
    for f in ("t", "u", "v"):
        g, w = getattr(gh, f).numpy(), np.asarray(getattr(wh, f))
        if exact:
            assert g.tobytes() == w.tobytes(), f
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=f)
    assert (gh.prim_idx >= 0).any()


def test_render_raster_xla_matches_jax_op_by_op():
    """Pass A, pass B, and more than tiles_b tiles needing pass B (where
    several tiles share its last slot and the highest keeps it)."""
    (jpk, jrays, jtr), (pk, rays, tr) = frame(jscenes.cornellbox, "cornellbox", 64, 64, 4)
    got = raster.render_raster_xla(pk, rays, tr, 64, 64, 16, 2, 6, 3)
    with jax.disable_jit():
        want = jraster.render_raster_xla(jpk, jrays, jtr, 64, 64, 16, 2, 6, 3)
    assert_hits(got, want)
    assert bool(got[2]) and int((got[1] > 2 * 4).sum()) > 0  # past pass A, overflowed


CASES = {  # name: (scene, preset, size, leaf, caps (cap_a, cap_b, tiles_b) or the defaults)
    "cornellbox_256": (jscenes.cornellbox, "cornellbox", 256, 16, ()),
    "cornellbox_64_pass_b": (jscenes.cornellbox, "cornellbox", 64, 4, (2, 64, 16)),
    "sponza_8192_128": (lambda: jscenes.sponza_like(8192), "sponza", 128, 64, ()),
}


@pytest.mark.parametrize("name", list(CASES))
def test_render_raster_xla_matches_jax(name):
    make, preset, size, leaf, caps = CASES[name]
    (jpk, jrays, jtr), (pk, rays, tr) = frame(make, preset, size, size, leaf)
    got = raster.render_raster_xla(pk, rays, tr, size, size, 16, *caps)
    want = jraster.render_raster_xla(jpk, jrays, jtr, size, size, 16, *caps)
    assert_hits(got, want, exact=False)
    assert not bool(got[2])
