"""Kernel 3 (raster sweep): the port's render on the plain path vs the
Pallas raster kernel in interpret mode, on the same tree, rays and caps.

Tolerances: the Pallas sweep forms its planes with a bf16 hi/lo split,
about 2^-17 relative error per product, amplified by coefficient
cancellation on random soups (the tolerance of test_raster_tpu.py); the
port sweeps in plain f32. The hit mask and the per-ray sweep counts must
be equal; prim ids may differ only on t ties at rtol 1e-3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bvh.models import lbvh as jlbvh
from tpu_bvh.ops import raster as jraster
from tpu_bvh.ops import raster_tpu
from tpu_bvh.utils import camera as jcamera
from tpu_bvh.utils import scenes as jscenes
from tpu_bvh_torch.ops import raster, raster_gpu
from tpu_bvh_torch.types import Bvh2, Rays, Transformation
from tpu_bvh_torch.utils import camera, convert, scenes


def jax_render(tris_np, scene_name, w, h, leaf, caps):
    """JAX build + pack + interpret-mode raster; returns what the port needs."""
    tris = jnp.asarray(tris_np)
    tr, cam = jscenes.preset(scene_name)
    rays = jcamera.generate_rays(cam, w, h)
    bvh = jlbvh.build_single_pass(tris)
    packed = jraster.pack_raster(bvh, tris, leaf_size=leaf)
    hit, counts, ovf = raster_tpu.render_raster_tpu(
        packed, rays, tr, w, h, *caps, interpret=True)
    return bvh, rays, tr, (hit, counts, ovf)


def assert_render_close(got, want):
    """The raster agreement rules (hit mask, t/u/v, ties, counts)."""
    (gh, gc, govf), (wh, wc, wovf) = got, want
    assert not bool(govf) and not bool(wovf)
    gp, wp = gh.prim_idx.cpu().numpy(), np.asarray(wh.prim_idx)
    np.testing.assert_array_equal(gp >= 0, wp >= 0)
    both = gp >= 0
    assert both.any()
    gt, wt = gh.t.cpu().numpy(), np.asarray(wh.t)
    np.testing.assert_allclose(gt[both], wt[both], rtol=1e-3, atol=1e-3)
    diff = both & (gp != wp)
    np.testing.assert_allclose(gt[diff], wt[diff], rtol=1e-3)
    same = both & (gp == wp)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(gh, f).cpu().numpy()[same],
                                   np.asarray(getattr(wh, f))[same], rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(gc.cpu().numpy(), np.asarray(wc).astype(np.int64))


def port_render(bvh_np, tris_np, rays, tr, w, h, leaf, caps, device="cpu"):
    bvh = convert.to_torch(Bvh2, bvh_np, device)
    tris = torch.from_numpy(tris_np).to(device)
    packed = raster.pack_raster(bvh, tris, leaf_size=leaf)
    return raster_gpu.render_raster_gpu(
        packed, convert.to_torch(Rays, rays, device),
        convert.to_torch(Transformation, tr, device), w, h, *caps)


def _soup():
    rng = np.random.default_rng(5)
    base = rng.uniform(-1.5, 1.5, (200, 1, 3)).astype(np.float32)
    return base + rng.uniform(-0.3, 0.3, (200, 3, 3)).astype(np.float32)


CASES = {
    # (tris, preset, w, h, leaf, (cand_cap, pair_cap, group))
    "cornellbox_128": (jscenes.cornellbox, "cornellbox", 128, 128, 16, (64, 512, 4)),
    "random_soup": (_soup, "cornellbox", 128, 128, 16, (64, 512, 4)),
    "unaligned_96x80": (jscenes.cornellbox, "cornellbox", 96, 80, 8, (32, 1024, 8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_render_matches_pallas(case):
    make, preset, w, h, leaf, caps = CASES[case]
    tris = make()
    jbvh, rays, tr, want = jax_render(tris, preset, w, h, leaf, caps)
    got = port_render(jbvh._asdict(), tris, rays, tr, w, h, leaf, caps)
    assert got[0].prim_idx.shape == (w * h,) and got[1].shape == (w * h,)
    assert_render_close(got, want)


@pytest.mark.parametrize("caps", [(64, 4, 4), (2, 512, 4)])
def test_overflow_flag_matches_pallas(caps):
    """8 treelets in one tile: pair_cap 4 or cand_cap 2 is too small, and
    both report overflow."""
    tris = jscenes.cornellbox()
    jbvh, rays, tr, (_, _, want) = jax_render(tris, "cornellbox", 64, 64, 4, caps)
    got = port_render(jbvh._asdict(), tris, rays, tr, 64, 64, 4, caps)[2]
    assert (bool(want), bool(got)) == (True, True)


@pytest.mark.parametrize("preset", ["cornellbox", "sponza"])
def test_generate_rays_match_jax(preset):
    _, jcam = jscenes.preset(preset)
    _, cam = scenes.preset(preset, device="cpu")
    want = jcamera.generate_rays(jcam, 96, 80)
    got = camera.generate_rays(cam, 96, 80)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_coarse_layout_roundtrip():
    w, h = 128, 64
    x = torch.arange(w * h * 3, dtype=torch.float32).reshape(w * h, 3)
    ct = raster_gpu._to_coarse_layout(x.reshape(w, h, 3), w, h)
    np.testing.assert_array_equal(
        ct.numpy(), np.asarray(raster_tpu._to_coarse_layout(jnp.asarray(x.numpy()).reshape(w, h, 3), w, h)))
    assert torch.equal(raster_gpu._from_coarse_layout(ct, w, h), x)
