"""Kernel 5 (general-ray sweep): the port's `trace_rays` and
`shadow_occlusion` on the plain path against the Pallas sweep in
interpret mode, on the same tree, rays and caps (the cases of
test_ray_sweep.py).

Tolerances: the Pallas sweep forms its ten-channel Plücker dot products
with a bf16 hi/lo split (about 2^-17 relative error per product), and the
moments m = o x d cancel against the triangle's moments; the port sums
the same terms in plain f32. On these cases t differs by at most 3.5e-5
relative (the short shadow segments; 1.3e-5 for primary and random
rays). So the hit masks must be equal, t must agree to rtol 1e-4 (about
three times the largest difference seen), and prim ids may differ only
where both hit at the same t within that tolerance (a tie). The occlusion masks must
be equal outside the boundary strips of bench.py (a blocker within 10 eps
of either end of the segment may flip either way).
"""
import jax.numpy as jnp
import numpy as np
import torch

from tpu_bvh.models import lbvh as jlbvh
from tpu_bvh.ops import raster as jraster
from tpu_bvh.ops import ray_sweep as jray_sweep
from tpu_bvh.ops import traverse as jtraverse
from tpu_bvh.types import Rays as JRays
from tpu_bvh.utils import camera as jcamera
from tpu_bvh.utils import scenes as jscenes
from tpu_bvh_torch.ops import raster, ray_sweep
from tpu_bvh_torch.types import Bvh2, Rays, Transformation
from tpu_bvh_torch.utils import convert

RTOL = 1e-4
EPS = 1e-3
LIGHT = np.array([0.0, 0.9, 0.2], np.float32)


def _pack(tris_np, leaf=16):
    """JAX's two-pass tree and packing, and the port's packing of the same
    tree carried across."""
    tris = jnp.asarray(tris_np)
    jbvh = jlbvh.build_two_pass(tris)
    bvh = convert.to_torch(Bvh2, jbvh, device="cpu")
    packed = raster.pack_raster(bvh, torch.from_numpy(tris_np), leaf_size=leaf)
    return jbvh, tris, jraster.pack_raster(jbvh, tris, leaf_size=leaf), packed


def _port_tr(tr):
    return convert.to_torch(Transformation, tr, device="cpu")


def assert_hits_close(got, want):
    (gh, gc, govf), (wh, wc, wovf) = got, want
    assert not bool(govf) and not bool(wovf)
    gp, wp = gh.prim_idx.numpy(), np.asarray(wh.prim_idx)
    np.testing.assert_array_equal(gp >= 0, wp >= 0)
    both = gp >= 0
    gt, wt = gh.t.numpy(), np.asarray(wh.t)
    np.testing.assert_allclose(gt[both], wt[both], rtol=RTOL)
    same = both & (gp == wp)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(gh, f).numpy()[same],
                                   np.asarray(getattr(wh, f))[same], rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc).astype(np.int64))
    return both


def _trace_both(jpacked, packed, rays_np, tr, caps):
    want = jray_sweep.trace_rays(jpacked, JRays(*(jnp.asarray(x) for x in rays_np)), tr, *caps,
                                 interpret=True)
    got = ray_sweep.trace_rays(packed, Rays(*(torch.from_numpy(np.array(x))
                                              for x in rays_np)), _port_tr(tr), *caps)
    return got, want


def _surface_points(jbvh, tris, w, h):
    """Primary hits of the cornellbox view (misses parked at the eye)."""
    tr, cam = jscenes.preset("cornellbox")
    prim_rays = jcamera.generate_rays(cam, w, h)
    hit_p, _ = jtraverse.traverse_bvh2(jbvh, tris, prim_rays, tr, variant="speculative")
    hitm = np.asarray(hit_p.prim_idx) >= 0
    t = np.where(hitm, np.asarray(hit_p.t), 0.0)
    o = np.asarray(prim_rays.origin) + np.asarray(prim_rays.direction) * t[:, None]
    return tr, o.astype(np.float32), hitm


def test_primary_rays_cornellbox():
    jbvh, tris, jpacked, packed = _pack(jscenes.cornellbox())
    tr, cam = jscenes.preset("cornellbox")
    rays = jcamera.generate_rays(cam, 64, 64)
    got, want = _trace_both(jpacked, packed, rays, tr, (64, 1024, 4))
    assert assert_hits_close(got, want).any()


def test_shadow_rays_surface_origins():
    jbvh, tris, jpacked, packed = _pack(jscenes.cornellbox())
    tr, o, hitm = _surface_points(jbvh, tris, 48, 48)
    dvec = LIGHT[None, :] - o
    dist = np.linalg.norm(dvec, axis=1)
    dirs = (dvec / np.maximum(dist, 1e-9)[:, None]).astype(np.float32)
    rays = (o + dirs * EPS, dirs, np.zeros(len(o), np.float32),
            np.where(hitm, dist - 2 * EPS, -1.0).astype(np.float32))
    got, want = _trace_both(jpacked, packed, rays, tr, (64, 1024, 4))
    both = assert_hits_close(got, want)
    assert both.any() and (~both & hitm).any()  # lit and occluded points


def test_random_ray_set():
    rng = np.random.default_rng(11)
    base = rng.uniform(-1.5, 1.5, (150, 1, 3)).astype(np.float32)
    tris_np = base + rng.uniform(-0.4, 0.4, (150, 3, 3)).astype(np.float32)
    jbvh, tris, jpacked, packed = _pack(tris_np)
    tr, _ = jscenes.preset("cornellbox")
    n = 500
    o = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = (o, d, np.zeros(n, np.float32), np.full(n, 3.4e38, np.float32))
    got, want = _trace_both(jpacked, packed, rays, tr, (32, 2048, 4))
    assert assert_hits_close(got, want).any()


def test_overflow_flag_fires():
    """An undersized candidate cap raises the flag in both packages."""
    jbvh, tris, jpacked, packed = _pack(jscenes.cornellbox(), leaf=8)
    tr, cam = jscenes.preset("cornellbox")
    rays = jcamera.generate_rays(cam, 16, 16)
    got, want = _trace_both(jpacked, packed, rays, tr, (1, 64, 4))
    assert (bool(got[2]), bool(want[2])) == (True, True)


def test_shadow_occlusion_reversed():
    """Reversed point-light occlusion: the port equals JAX's, and both equal
    the forward capped answer outside the boundary strips."""
    jbvh, tris, jpacked, packed = _pack(jscenes.cornellbox())
    tr, o, hitm = _surface_points(jbvh, tris, 48, 48)
    caps = (64, 1024, 4)
    occ, counts, ovf = ray_sweep.shadow_occlusion(
        packed, torch.from_numpy(o), torch.from_numpy(hitm), torch.from_numpy(LIGHT),
        _port_tr(tr), EPS, *caps)
    jocc, jcounts, jovf = jray_sweep.shadow_occlusion(
        jpacked, jnp.asarray(o), jnp.asarray(hitm), jnp.asarray(LIGHT), tr, EPS, *caps,
        interpret=True)
    assert not bool(ovf) and not bool(jovf)
    # the forward trace with the same segment, to find the boundary strips
    dvec = LIGHT[None, :] - o
    dist = np.linalg.norm(dvec, axis=1)
    dirs = (dvec / np.maximum(dist, 1e-9)[:, None]).astype(np.float32)
    tmax = np.where(hitm, dist - 2 * EPS, -1.0).astype(np.float32)
    frays = JRays(jnp.asarray(o + dirs * EPS), jnp.asarray(dirs),
                  jnp.zeros(len(o), jnp.float32), jnp.asarray(tmax))
    hit_o, _ = jtraverse.traverse_bvh2(jbvh, tris, frays, tr, variant="speculative")
    to, po = np.asarray(hit_o.t), np.asarray(hit_o.prim_idx)
    occ_fwd = (po >= 0) & (to < tmax)
    to_safe = np.where(po >= 0, to, np.inf)
    boundary = (np.abs(to_safe - tmax) < 10 * EPS) | (to_safe < 10 * EPS)
    occ_np = occ.numpy()
    np.testing.assert_array_equal(occ_np[~boundary], np.asarray(jocc)[~boundary])
    np.testing.assert_array_equal(occ_np[~boundary], occ_fwd[~boundary])
    assert occ_np.any() and (~occ_np & hitm).any()
    assert not occ_np[~hitm].any()  # dead rays are never occluded
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts).astype(np.int64))
